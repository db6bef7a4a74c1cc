"""Architecture + shape + plan configuration (copy of ``repro.configs.base``).

Every assigned architecture is an ``ArchConfig``; every workload shape is a
``ShapeSpec``.  The *execution plan* (``PlanConfig``) holds the knobs of the
paper's offload search: per-site destinations, the sharding genes (FSDP,
sequence parallelism, expert parallelism, tensor parallelism, collective
overlap), the chunk size of chunked attention, the train step's remat
policy, microbatching, gradient reduction and compression, and the dtypes,
in the reference's field order with its defaults.  Two reference fields
have no counterpart: ``moe_impl`` (one allele) and ``scan_layers`` (a
``lax.scan`` over stacked layers; the port walks its layers in a loop).
The sharding genes take effect through ``repro_torch.parallel`` on a
``DeviceMesh`` and in ``core.intensity.estimate_program``.

The port reads the destination strings as: ``xla`` -> stock PyTorch ops,
``xla_chunked`` -> the chunked online-softmax PyTorch path, ``pallas`` ->
the hand-written CUDA kernel (its plain version on CPU tensors).
"""
from __future__ import annotations

from dataclasses import dataclass, field, fields, replace
from typing import Any, Optional

# ---------------------------------------------------------------------------
# Execution plan — the search space of the paper's offload method.
# ---------------------------------------------------------------------------

#: destinations each compute site accepts
ATTN_IMPLS = ("xla", "xla_chunked", "pallas")
MLP_IMPLS = ("xla", "pallas")
SSM_IMPLS = ("xla", "pallas")
RGLRU_IMPLS = ("xla", "pallas")
REMATS = ("none", "dots", "full")
GRAD_COMPRESS = ("none", "int8_ef")


@dataclass(frozen=True)
class PlanConfig:
    """One concrete execution plan (a decoded genome).

    Per-site destinations mirror the paper's per-loop offload bits; the
    sharding and train genes are the reference's, with its defaults.
    """

    # --- per-site destinations ("which loop goes to which device") ---------
    attn_impl: str = "xla_chunked"      # xla | xla_chunked | pallas
    mlp_impl: str = "xla"               # xla | pallas  (fused swiglu)
    ssm_impl: str = "xla"               # xla | pallas  (SSD chunked kernel)
    rglru_impl: str = "xla"             # xla | pallas  (RG-LRU scan kernel)

    # --- sharding / distribution genes --------------------------------------
    fsdp: bool = True                   # shard weights over the data axis too
    seq_shard: bool = True              # sequence-parallel residual stream
    shard_moe_experts: bool = True      # expert parallelism over 'model'
    use_tp: bool = True                 # False: model axis joins DP (pure
                                        # data parallel + ZeRO; small archs)
    overlap_collectives: bool = False   # async collectives hidden under
                                        # compute (modeled 50% overlap)

    # --- memory / schedule genes --------------------------------------------
    remat: str = "full"                 # none | dots | full
    microbatches: int = 1               # gradient-accumulation steps
    attn_chunk: int = 1024              # kv-block size for chunked attention

    # --- transfer-batching analogue (paper §3.1) -----------------------------
    fused_grad_reduce: bool = True      # single fused reduction vs per-layer
    grad_compress: str = "none"         # none | int8_ef (error feedback)

    # --- numerics -----------------------------------------------------------
    compute_dtype: str = "bfloat16"
    param_dtype: str = "float32"
    kv_cache_dtype: str = "bfloat16"
    accum_dtype: str = "float32"        # microbatch gradient accumulator

    def __post_init__(self) -> None:
        if self.attn_impl not in ATTN_IMPLS:
            raise ValueError(f"attn_impl {self.attn_impl!r} not in "
                             f"{ATTN_IMPLS}")
        if self.mlp_impl not in MLP_IMPLS:
            raise ValueError(f"mlp_impl {self.mlp_impl!r} not in {MLP_IMPLS}")
        if self.ssm_impl not in SSM_IMPLS:
            raise ValueError(f"ssm_impl {self.ssm_impl!r} not in {SSM_IMPLS}")
        if self.rglru_impl not in RGLRU_IMPLS:
            raise ValueError(f"rglru_impl {self.rglru_impl!r} not in "
                             f"{RGLRU_IMPLS}")
        if self.remat not in REMATS:
            raise ValueError(f"remat {self.remat!r} not in {REMATS}")
        if self.grad_compress not in GRAD_COMPRESS:
            raise ValueError(f"grad_compress {self.grad_compress!r} not in "
                             f"{GRAD_COMPRESS}")
        for name in ("fsdp", "seq_shard", "shard_moe_experts", "use_tp",
                     "overlap_collectives"):
            if not isinstance(getattr(self, name), bool):
                raise ValueError(f"{name} {getattr(self, name)!r} is not a "
                                 f"bool")
        if self.microbatches < 1:
            raise ValueError(f"microbatches {self.microbatches} < 1")

    def replace(self, **kw: Any) -> "PlanConfig":
        return replace(self, **kw)

    def describe(self) -> str:
        """``field=value`` pairs in field order (the reference's format,
        over the port's fields)."""
        return ",".join(f"{f.name}={getattr(self, f.name)}"
                        for f in fields(self))


# ---------------------------------------------------------------------------
# Workload shapes (assigned shape set for the LM family).
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode

    @property
    def tokens(self) -> int:
        return self.seq_len * self.global_batch


SHAPES: dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524288, 1, "decode"),
}

#: shapes the measured rung runs on one H100 (``core.backends``).  The
#: reference's SHAPES are pod shapes: qwen2-7b's prefill_32k is 32 x 32768
#: tokens, far above one card's 80 GB.  These cut only the batch, and stay
#: out of SHAPES so ``ArchConfig.applicable_shapes`` match the
#: reference's.
CARD_SHAPES: dict[str, ShapeSpec] = {
    "train_4k_b4": ShapeSpec("train_4k_b4", 4096, 4, "train"),
    "prefill_32k_b1": ShapeSpec("prefill_32k_b1", 32768, 1, "prefill"),
    "decode_32k_b8": ShapeSpec("decode_32k_b8", 32768, 8, "decode"),
}


def get_shape(name: str) -> ShapeSpec:
    """A shape by name: SHAPES, then CARD_SHAPES."""
    if name in SHAPES:
        return SHAPES[name]
    if name in CARD_SHAPES:
        return CARD_SHAPES[name]
    raise KeyError(f"unknown shape {name!r}; have "
                   f"{sorted(SHAPES) + sorted(CARD_SHAPES)}")


# ---------------------------------------------------------------------------
# Architecture configuration.
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_ff_expert: int
    capacity_factor: float = 1.25


@dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                 # dense | moe | ssm | hybrid | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int                # query heads (0 for attention-free)
    n_kv_heads: int
    d_ff: int
    vocab_size: int

    d_head: int = 0             # derived if 0
    qkv_bias: bool = False
    tie_embeddings: bool = False
    act: str = "swiglu"         # swiglu | gelu
    norm: str = "rmsnorm"       # rmsnorm | layernorm
    rope_theta: float = 10_000.0

    # MoE
    moe: Optional[MoEConfig] = None

    # SSM (mamba2)
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_headdim: int = 64
    ssm_conv: int = 4
    ssm_chunk: int = 256

    # hybrid (recurrentgemma): pattern unit, e.g. ("rec", "rec", "attn")
    layer_pattern: tuple[str, ...] = ()
    local_window: int = 0       # sliding-window size for local attention
    lru_width: int = 0          # RG-LRU recurrence width (defaults to d_model)

    # modality stubs
    is_encoder: bool = False    # encoder-only: bidirectional, no decode
    frontend: str = "none"      # none | audio_frames | vision_patches
    n_patches: int = 256        # vision stub prefix length

    # default execution plan + per-arch memory strategy
    plan: PlanConfig = field(default_factory=PlanConfig)
    optimizer: str = "adamw"    # adamw | adafactor
    learning_rate: float = 3e-4

    # which shapes are inapplicable, mapped to the reason (DESIGN.md §4)
    skip_shapes: dict[str, str] = field(default_factory=dict)

    def __post_init__(self) -> None:
        if self.d_head == 0 and self.n_heads:
            object.__setattr__(self, "d_head", self.d_model // self.n_heads)
        if self.family == "hybrid" and self.lru_width == 0:
            object.__setattr__(self, "lru_width", self.d_model)

    # -- derived sizes -------------------------------------------------------

    @property
    def q_per_kv(self) -> int:
        return self.n_heads // max(self.n_kv_heads, 1)

    @property
    def d_inner(self) -> int:
        """Mamba2 inner width."""
        return self.ssm_expand * self.d_model

    @property
    def ssm_nheads(self) -> int:
        return self.d_inner // self.ssm_headdim

    def layer_kinds(self) -> list[str]:
        """Per-layer temporal-mixing kind for the full stack."""
        if self.family == "ssm":
            return ["ssm"] * self.n_layers
        if self.family == "hybrid":
            pat = self.layer_pattern or ("rec",)
            return [pat[i % len(pat)] for i in range(self.n_layers)]
        return ["attn"] * self.n_layers

    def param_count(self) -> int:
        """Analytic parameter count (embedding + blocks + head)."""
        d, L = self.d_model, self.n_layers
        n = self.vocab_size * d  # embedding
        if not self.tie_embeddings:
            n += d * self.vocab_size
        per_kind = {}
        hq, hkv, dh = self.n_heads, self.n_kv_heads, self.d_head
        attn = d * hq * dh + 2 * d * hkv * dh + hq * dh * d
        if self.act == "swiglu":
            mlp = 3 * d * self.d_ff
        else:
            mlp = 2 * d * self.d_ff
        if self.moe is not None:
            e = self.moe
            moe_ff = e.n_experts * (3 * d * e.d_ff_expert) + d * e.n_experts
            per_kind["attn"] = attn + moe_ff + 2 * d
        else:
            per_kind["attn"] = attn + mlp + 2 * d
        di, ns = self.d_inner, self.ssm_state
        nh = self.ssm_nheads if self.ssm_headdim else 0
        per_kind["ssm"] = (
            d * (2 * di + 2 * ns + nh)  # in_proj(z,x,B,C,dt)
            + di * d                    # out_proj
            + (di + 2 * ns) * self.ssm_conv
            + 2 * nh + di               # A, D, norm
            + 2 * d
        )
        w = self.lru_width or d
        per_kind["rec"] = (
            d * w * 2 + w * d           # in (x, gate), out
            + w * self.ssm_conv         # temporal conv
            + 2 * w * w + 3 * w         # RG-LRU input/recurrence gates + Lambda
            + 2 * d
        )
        if self.family == "hybrid":
            # hybrid attention layers also carry an MLP; rec layers too
            per_kind["attn"] = attn + mlp + 2 * d
            per_kind["rec"] += mlp
        for kind in self.layer_kinds():
            n += per_kind[kind]
        n += d  # final norm
        return n

    def active_param_count(self) -> int:
        """Parameters touched per token (MoE: only routed experts)."""
        if self.moe is None:
            return self.param_count()
        e = self.moe
        d = self.d_model
        dead = (e.n_experts - e.top_k) * 3 * d * e.d_ff_expert * self.n_layers
        return self.param_count() - dead

    def applicable_shapes(self) -> list[str]:
        return [s for s in SHAPES if s not in self.skip_shapes]


# ---------------------------------------------------------------------------
# Registry.
# ---------------------------------------------------------------------------

_REGISTRY: dict[str, ArchConfig] = {}
_REDUCED: dict[str, ArchConfig] = {}


def register(cfg: ArchConfig, reduced: ArchConfig) -> ArchConfig:
    _REGISTRY[cfg.name] = cfg
    _REDUCED[cfg.name] = reduced
    return cfg


def get_config(name: str, reduced: bool = False) -> ArchConfig:
    import repro_torch.configs  # noqa: F401  (triggers per-arch registration)

    table = _REDUCED if reduced else _REGISTRY
    if name not in table:
        raise KeyError(f"unknown arch {name!r}; have {sorted(table)}")
    return table[name]


def list_archs() -> list[str]:
    import repro_torch.configs  # noqa: F401

    return sorted(_REGISTRY)


FULL_ATTENTION_SKIPS = {
    "long_500k": (
        "pure full-attention arch: 524288-token dense decode is quadratic "
        "with an unbounded KV cache; no sub-quadratic mode in the source "
        "config (DESIGN.md §4)"
    )
}

ENCODER_SKIPS = {
    "decode_32k": "encoder-only arch: no autoregressive decode step",
    "long_500k": "encoder-only arch: no autoregressive decode step",
}
