"""The layer stack: an ``nn.Module`` of attention, mamba2 and RG-LRU layers.

Counterpart of ``repro.models.transformer``.  The reference scans one
stacked parameter unit (the arch's layer pattern, e.g. (rec, rec, attn))
with ``lax.scan`` and unrolls a tail; here the layers are an
``nn.ModuleList`` in the same order (``cfg.layer_kinds()``: unit-major,
then the tail) walked by a Python loop.  Each layer's parameters are
``nn.ParameterDict``s keyed as in the reference pytree (``norm1``,
``mixer`` and, except in an ``ssm`` layer, ``norm2`` and ``mlp``, or
``moe`` in the attention layers of a MoE arch), so the functions of
``models.layers``, ``models.ssm`` and ``models.rglru`` read them exactly as
the reference reads its dicts, and ``repro_torch.convert`` maps the pytree
onto ``state_dict`` keys one to one.  ``embed_inputs`` is the reference's
front end: token embeddings, audio frames through ``frontend``, or vision
patch embeddings over the first ``n_patches`` positions.

``rules`` (``parallel.sharding.ShardingRules``, optional) constrains the
residual stream after the embedding and after every layer to (batch,
seq_sharded, act_embed), and the logits to (batch, -, vocab), at the
reference's four points.  A plain tensor lies on no mesh and passes
through unchanged, so on one card, or with ``rules=None``, every output is
what it is without them.  Parameters that are ``DTensor``s
(``parallel.param_sharding.distribute``) run on their shards under
tensor-parallel rules (``parallel.tp``: the embedding, every layer and the
logits, each product split over the model axis); under rules that split
no product they are gathered where they are used (the embedding table and
the output projection once, each layer's weights and cache around the
layer, ``parallel.sharding.layer_operands``); plain inputs beside them
(tokens, positions, masks) count as replicated.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from repro_torch import obs
from repro_torch.configs.base import ArchConfig, PlanConfig
from repro_torch.models import layers as L
from repro_torch.models import rglru as R
from repro_torch.models import ssm as S
from repro_torch.parallel import tp
from repro_torch.parallel.sharding import (batch_only, constrain,
                                           is_dtensor, layer_operands,
                                           mixed_inputs, replicate,
                                           write_back)

# init rules: ("normal", scale) | ("zeros",) | ("ones",) | ("lru_lambda",)


def _norm_spec(cfg: ArchConfig) -> dict:
    if cfg.norm == "layernorm":
        return {"scale": ((cfg.d_model,), ("ones",)),
                "bias": ((cfg.d_model,), ("zeros",))}
    return {"scale": ((cfg.d_model,), ("ones",))}


def _mlp_spec(cfg: ArchConfig) -> dict:
    d, f = cfg.d_model, cfg.d_ff
    s_in, s_out = 1.0 / math.sqrt(d), 1.0 / math.sqrt(f)
    if cfg.act == "gelu":
        return {"wi": ((d, f), ("normal", s_in)), "bi": ((f,), ("zeros",)),
                "wo": ((f, d), ("normal", s_out)), "bo": ((d,), ("zeros",))}
    return {"wi": ((d, f), ("normal", s_in)),
            "wg": ((d, f), ("normal", s_in)),
            "wo": ((f, d), ("normal", s_out))}


def _moe_spec(cfg: ArchConfig) -> dict:
    e, d, f = cfg.moe.n_experts, cfg.d_model, cfg.moe.d_ff_expert
    s_in, s_out = 1.0 / math.sqrt(d), 1.0 / math.sqrt(f)
    return {"router": ((d, e), ("normal", s_in)),
            "wi": ((e, d, f), ("normal", s_in)),
            "wg": ((e, d, f), ("normal", s_in)),
            "wo": ((e, f, d), ("normal", s_out))}


def _attn_spec(cfg: ArchConfig) -> dict:
    d, hq, hkv, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    s_in = 1.0 / math.sqrt(d)
    mixer = {"wq": ((d, hq, dh), ("normal", s_in)),
             "wk": ((d, hkv, dh), ("normal", s_in)),
             "wv": ((d, hkv, dh), ("normal", s_in)),
             "wo": ((hq, dh, d), ("normal", 1.0 / math.sqrt(hq * dh)))}
    if cfg.qkv_bias:
        mixer.update(bq=((hq, dh), ("zeros",)), bk=((hkv, dh), ("zeros",)),
                     bv=((hkv, dh), ("zeros",)))
    return mixer


def layer_spec(cfg: ArchConfig, kind: str) -> dict:
    """name -> {param -> (shape, init rule)} for one layer of ``kind``,
    with the reference's shapes and scales (``transformer.init_layer``)."""
    if kind == "ssm":
        return {"norm1": _norm_spec(cfg), "mixer": S.mamba2_spec(cfg)}
    if kind == "attn":
        mixer = _attn_spec(cfg)
    elif kind == "rec":
        mixer = R.rglru_spec(cfg)
    else:
        raise ValueError(kind)
    spec = {"norm1": _norm_spec(cfg), "mixer": mixer,
            "norm2": _norm_spec(cfg)}
    if kind == "attn" and cfg.moe is not None and cfg.family == "moe":
        spec["moe"] = _moe_spec(cfg)
    else:
        spec["mlp"] = _mlp_spec(cfg)
    return spec


def attn_window(cfg: ArchConfig) -> int:
    """The local-attention window of the arch's attention layers (0: full
    attention)."""
    return cfg.local_window if cfg.family == "hybrid" else 0


#: the norms, activations and front ends the reference defines
NORMS = ("rmsnorm", "layernorm")
ACTS = ("swiglu", "gelu")
FRONTENDS = ("none", "audio_frames", "vision_patches")


def check_supported(cfg: ArchConfig) -> None:
    """Refuse a norm, activation or front end the reference does not
    define (it would silently take another branch there)."""
    if cfg.norm not in NORMS or cfg.act not in ACTS \
            or cfg.frontend not in FRONTENDS:
        raise NotImplementedError(
            f"norm {cfg.norm!r}, act {cfg.act!r}, frontend "
            f"{cfg.frontend!r}: the reference defines norms {NORMS}, "
            f"acts {ACTS} and front ends {FRONTENDS}")


def _param(shape, dtype, device) -> nn.Parameter:
    return nn.Parameter(torch.empty(shape, dtype=dtype, device=device),
                        requires_grad=False)


class Layer(nn.Module):
    def __init__(self, cfg: ArchConfig, kind: str, device: torch.device):
        super().__init__()
        self.kind = kind
        dt = L.pdtype(cfg.plan)
        for name, params in layer_spec(cfg, kind).items():
            setattr(self, name, nn.ParameterDict(
                {k: _param(shape, dt, device)
                 for k, (shape, _) in params.items()}))


class Transformer(nn.Module):
    """The weights of one model, allocated (uninitialized) on ``device``;
    ``init_`` fills them from a generator, ``load_state_dict`` from a
    state."""

    def __init__(self, cfg: ArchConfig, device: torch.device):
        super().__init__()
        check_supported(cfg)
        self.cfg = cfg
        dt = L.pdtype(cfg.plan)
        d, v = cfg.d_model, cfg.vocab_size
        self.embed = _param((v, d), dt, device)
        self.final_norm = nn.ParameterDict(
            {k: _param(shape, dt, device)
             for k, (shape, _) in _norm_spec(cfg).items()})
        if not cfg.tie_embeddings:
            self.lm_head = _param((d, v), dt, device)
        if cfg.frontend == "audio_frames":
            self.frontend = _param((d, d), dt, device)
        self.layers = nn.ModuleList(Layer(cfg, kind, device)
                                    for kind in cfg.layer_kinds())

    @torch.no_grad()
    def init_(self, generator: torch.Generator) -> "Transformer":
        """Normal x the reference's scales, biases 0, norm scales 1, RG-LRU
        Lambdas by their own rule, generated directly on the parameters'
        device (no host copy)."""
        cfg = self.cfg
        rules = {"embed": ("normal", 0.02),
                 "lm_head": ("normal", 1.0 / math.sqrt(cfg.d_model)),
                 "frontend": ("normal", 1.0 / math.sqrt(cfg.d_model))}
        for k, (_, rule) in _norm_spec(cfg).items():
            rules[f"final_norm.{k}"] = rule
        for i, kind in enumerate(cfg.layer_kinds()):
            for name, params in layer_spec(cfg, kind).items():
                for k, (_, rule) in params.items():
                    rules[f"layers.{i}.{name}.{k}"] = rule
        for name, p in self.named_parameters():
            rule = rules[name]
            if rule[0] == "normal":     # f32 normal x scale, then cast
                p.copy_(torch.empty_like(p, dtype=torch.float32)
                        .normal_(generator=generator).mul_(rule[1]))
            elif rule[0] == "ones":
                p.fill_(1.0)
            elif rule[0] == "lru_lambda":
                R.lru_lambda_(p, generator)
            else:
                p.zero_()
        return self


def init_layer_cache(cfg: ArchConfig, kind: str, batch: int, seq_len: int,
                     device: torch.device) -> dict:
    """One layer's cache: a rolling KV buffer for ``attn`` (kv dtype from
    ``cfg.plan``; ``min(window, seq_len)`` long for local attention), the
    conv window and state for ``rec`` and ``ssm``."""
    if kind == "rec":
        return R.init_rglru_cache(cfg, batch, device)
    if kind == "ssm":
        return S.init_ssm_cache(cfg, batch, device)
    if kind != "attn":
        raise ValueError(kind)
    dtype = L.dtype_of(cfg.plan.kv_cache_dtype)
    window = attn_window(cfg)
    t = min(window, seq_len) if window else seq_len
    shp = (batch, t, cfg.n_kv_heads, cfg.d_head)
    out = {"k": torch.zeros(shp, dtype=dtype, device=device),
           "v": torch.zeros(shp, dtype=dtype, device=device),
           "kpos": torch.full((t,), -1, dtype=torch.int32, device=device)}
    if dtype == torch.int8:
        sshp = (batch, t, cfg.n_kv_heads, 1)
        out["k_scale"] = torch.zeros(sshp, dtype=torch.float32,
                                     device=device)
        out["v_scale"] = torch.zeros(sshp, dtype=torch.float32,
                                     device=device)
    return out


def init_cache(cfg: ArchConfig, batch: int, seq_len: int,
               device: torch.device) -> list:
    """One cache dict per layer, in the layers' order."""
    check_supported(cfg)
    return [init_layer_cache(cfg, kind, batch, seq_len, device)
            for kind in cfg.layer_kinds()]


def apply_layer(p: Layer, x, cfg: ArchConfig, plan: PlanConfig, positions,
                cache, decode: bool, rules=None):
    """One layer: returns (x, cache, aux), aux the MoE layer's load-balance
    loss (0 elsewhere), as the reference's ``apply_layer``.  On a
    ``DTensor`` stream the layer runs on its shards under tensor-parallel
    rules (``parallel.tp``); under rules without a model-axis split it
    runs on its gathered operands and writes its cache back into the
    cache's own placements."""
    if rules is not None and is_dtensor(x):
        if tp.enabled(rules):
            return tp.apply_layer(p, x, cfg, plan, positions, cache, decode,
                                  attn_window(cfg))
        for kind in (p.kind,) + tuple(b for b in ("mlp", "moe")
                                      if hasattr(p, b)):
            tp.note(kind, "zero3")
        view, xl, local = layer_operands(p, x, cache, rules)
        x, local, aux = _apply_layer(view, xl, cfg, plan, positions, local,
                                     decode, rules)
        write_back(cache, local)
        return x, cache, aux
    return _apply_layer(p, x, cfg, plan, positions, cache, decode, rules)


#: the device range of a decode step's sublayer, by layer kind
#: (``obs.device_range``; none in a forward pass or prefill)
DECODE_RANGES = {"attn": "decode.attention", "ssm": "decode.ssm",
                 "rec": "decode.rglru", "mlp": "decode.mlp",
                 "moe": "decode.moe"}


def _apply_layer(p, x, cfg: ArchConfig, plan: PlanConfig, positions,
                 cache, decode: bool, rules=None):
    aux = x.new_zeros((), dtype=torch.float32)
    with obs.device_range(DECODE_RANGES[p.kind], decode):
        h = L.apply_norm(p.norm1, x, cfg)
        if p.kind == "ssm":
            mix, cache = S.run_mamba2(p.mixer, h, cfg, plan, cache, decode)
        elif p.kind == "rec":
            mix, cache = R.run_rglru_block(p.mixer, h, cfg, plan, cache,
                                           decode)
        else:
            mix, cache = L.run_attention(p.mixer, h, cfg, plan, positions,
                                         cache, decode, attn_window(cfg))
        x = x + mix
    if p.kind == "ssm":
        if rules is not None:
            x = constrain(x, rules, "batch", "seq_sharded", "act_embed")
        return x, cache, aux
    ff_kind = "moe" if hasattr(p, "moe") else "mlp"
    with obs.device_range(DECODE_RANGES[ff_kind], decode):
        h = L.apply_norm(p.norm2, x, cfg)
        if ff_kind == "moe":
            ff, aux = L.run_moe(p.moe, h, cfg, plan)
        else:
            ff = L.run_mlp(p.mlp, h, cfg, plan)
        x = x + ff
    if rules is not None:
        x = constrain(x, rules, "batch", "seq_sharded", "act_embed")
    return x, cache, aux


def unit_structure(cfg: ArchConfig) -> tuple[int, int]:
    """(layers a unit, full units): the reference's ``unit_structure``
    (the arch's layer pattern, else one layer, repeated; the layers past
    the last full unit are its unrolled tail)."""
    kinds = cfg.layer_kinds()
    size = len(cfg.layer_pattern) if cfg.family == "hybrid" \
        and cfg.layer_pattern else 1
    return size, len(kinds) // size


#: the ops whose outputs ``remat="dots"`` keeps (``checkpoint_dots``: the
#: matrix products); every other activation is recomputed
DOT_OPS = (torch.ops.aten.mm.default, torch.ops.aten.bmm.default,
           torch.ops.aten.addmm.default)


def _save_dots(ctx, op, *args, **kwargs):
    from torch.utils.checkpoint import CheckpointPolicy
    return CheckpointPolicy.MUST_SAVE if op in DOT_OPS \
        else CheckpointPolicy.PREFER_RECOMPUTE


def _remat(fn, plan: PlanConfig, grad: bool):
    """``fn`` under the plan's remat policy, as the reference's
    ``_remat_wrap``: ``none`` keeps every activation, ``full`` recomputes
    the unit's forward in the backward, ``dots`` keeps the matrix products
    and recomputes the rest.  Without autograd (serving) there is nothing
    to keep, and ``fn`` runs as it is."""
    if plan.remat == "none" or not grad:
        return fn
    from torch.utils.checkpoint import (checkpoint,
                                        create_selective_checkpoint_contexts)

    def wrapped(*args):
        kw = {}
        if plan.remat == "dots":
            kw["context_fn"] = lambda: create_selective_checkpoint_contexts(
                _save_dots)
        return checkpoint(fn, *args, use_reentrant=False, **kw)
    return wrapped


def embed_inputs(params: Transformer, batch: dict, cfg: ArchConfig,
                 plan: PlanConfig, rules=None):
    """(B,S,d) inputs in the compute dtype: ``batch["features"] @
    frontend`` for audio frames; else the tokens' embeddings, whose first
    ``n_patches`` positions ``batch["patch_embeds"]`` (B,n_patches,d)
    overwrites when given (vision).  Under ``rules`` the reference takes
    the embeddings as a one-hot product, which keeps a vocab-sharded table
    sharded; its numbers are the gather's, which the port's tables (plain
    tensors) keep."""
    if rules is not None and is_dtensor(params.embed) and tp.enabled(rules):
        return tp.embed(params, batch, cfg, plan, rules)
    dt = L.cdtype(plan)
    if cfg.frontend == "audio_frames":
        return batch["features"].to(dt) @ L.cast_weight(
            replicate(params.frontend), dt)
    # gather, then cast the B*S rows: the same numbers as the reference's
    # cast-then-gather without casting the whole table every step
    h = replicate(params.embed)[batch["tokens"]].to(dt)
    if cfg.frontend == "vision_patches" and "patch_embeds" in batch:
        pe = batch["patch_embeds"]
        npatch = pe.shape[1]
        if npatch > h.shape[1]:
            raise ValueError(f"{npatch} patch embeddings do not fit a "
                             f"prompt of {h.shape[1]} positions")
        h[:, :npatch] = pe.to(dt)
    return h


def forward(params: Transformer, batch: dict, cfg: ArchConfig,
            plan: PlanConfig, cache: Optional[list] = None,
            decode: bool = False, rules=None):
    """Returns (logits, cache, aux), aux the summed MoE load-balance loss
    (f32, 0 without MoE layers).

    train:   cache=None, decode=False  -> logits (B,S,V)
    prefill: cache=list, decode=False  -> logits (B,S,V) + filled cache
    decode:  cache=list, decode=True   -> logits (B,1,V) + updated cache

    ``batch["tokens"]`` is a (B,S) integer tensor on the weights' device
    (audio: ``batch["features"]`` (B,S,d); vision: also
    ``batch["patch_embeds"]``, see ``embed_inputs``); in decode
    ``batch["pos"]`` (an int or a 0-d tensor) is the position of the whole
    batch.  Under autograd each unit of ``unit_structure`` runs under the
    plan's ``remat`` (the tail does not, as in the reference).  ``rules``
    constrains the residual stream and the logits (module docstring).
    """
    with _dtensor_inputs(params, rules):
        return _forward(params, batch, cfg, plan, cache, decode, rules)


def _dtensor_inputs(params: Transformer, rules):
    """Plain tensors count as replicated beside ``DTensor`` parameters,
    which need the ``rules`` that laid them out."""
    if is_dtensor(params.embed) and rules is None:
        raise ValueError("DTensor parameters need the sharding rules they "
                         "were distributed with")
    return mixed_inputs(params.embed)


def _forward(params: Transformer, batch: dict, cfg: ArchConfig,
             plan: PlanConfig, cache: Optional[list], decode: bool, rules):
    h = embed_inputs(params, batch, cfg, plan, rules)
    if decode:
        positions = torch.as_tensor(batch["pos"], dtype=torch.int32,
                                    device=h.device).reshape(1)
    else:
        positions = torch.arange(h.shape[1], dtype=torch.int32,
                                 device=h.device)
    if rules is not None:
        h = constrain(h, rules, "batch", "seq_sharded", "act_embed")
    aux = h.new_zeros((), dtype=torch.float32)
    size, n_full = unit_structure(cfg)
    layers = list(params.layers)

    def unit(i0: int, h, aux):
        for i in range(i0, i0 + size):
            h, _, a = apply_layer(layers[i], h, cfg, plan, positions,
                                  cache[i] if cache is not None else None,
                                  decode, rules)
            aux = aux + a
        return h, aux

    body = _remat(unit, plan, torch.is_grad_enabled() and cache is None)
    for u in range(n_full):
        h, aux = body(u * size, h, aux)
    for i in range(n_full * size, len(layers)):
        h, _, a = apply_layer(layers[i], h, cfg, plan, positions,
                              cache[i] if cache is not None else None,
                              decode, rules)
        aux = aux + a
    with obs.device_range("decode.head", decode):
        h = L.apply_norm(params.final_norm, h, cfg)
        if rules is not None and is_dtensor(h) and tp.enabled(rules):
            return tp.logits(params, h, cfg, rules), cache, aux
        wout = params.embed.T if cfg.tie_embeddings else params.lm_head
        if is_dtensor(wout):
            h, wout = batch_only(h, rules), replicate(wout)
        logits = torch.einsum("bsd,dv->bsv", h, L.cast_weight(wout, h.dtype))
        if rules is not None:
            # vocab gets the model axis (loss reductions stay sharded)
            logits = constrain(logits, rules, "batch", None, "vocab")
    return logits, cache, aux
