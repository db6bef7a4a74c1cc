"""Model facade: init / loss / prefill / decode + abstract input specs.

Counterpart of ``repro.models.model.Model``.  ``Model`` holds the config,
the plan and the device; the weights are a ``models.transformer.Transformer``
that ``init`` or ``load`` returns and every step takes, as the reference's
steps take their params pytree.  Every step takes the reference's optional
``rules`` (``parallel.sharding.ShardingRules``): the residual stream and
the logits are constrained to them where the reference constrains them.

``input_specs`` returns the shape and dtype of every input of a step, no
tensor allocated (the reference's ``jax.ShapeDtypeStruct`` stand-ins).
"""
from __future__ import annotations

from typing import Any, NamedTuple, Optional

import torch

from repro_torch import obs
from repro_torch.configs.base import ArchConfig, PlanConfig, ShapeSpec
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import transformer as T
from repro_torch.parallel import tp
from repro_torch.parallel.sharding import batch_only, is_dtensor


class InputSpec(NamedTuple):
    """One step input's shape and dtype."""
    shape: tuple
    dtype: torch.dtype


def cross_entropy(logits, targets):
    """Mean next-token CE in f32. logits (B,S,V), targets (B,S).  The
    log-sum-exp is spelled out, its max a constant (the gradient is the
    softmax's either way), so that a vocab-sharded twin
    (``parallel.tp.cross_entropy``) runs the same ops on each shard; the
    target's logit is a gather."""
    logits = logits.float()
    m = logits.amax(-1, keepdim=True).detach()
    lse = torch.log(torch.exp(logits - m).sum(-1)) + m[..., 0]
    ll = torch.gather(logits, -1, targets.long().unsqueeze(-1))[..., 0]
    return (lse - ll).mean()


class Model:
    def __init__(self, cfg: ArchConfig, plan: Optional[PlanConfig] = None,
                 device: DeviceLike = None):
        self.cfg = cfg
        self.plan = plan or cfg.plan
        self.device = resolve_device(device)
        T.check_supported(cfg)

    def with_plan(self, plan: PlanConfig) -> "Model":
        return Model(self.cfg, plan, self.device)

    # -- parameters ----------------------------------------------------------

    def init(self, generator: torch.Generator) -> T.Transformer:
        """Random weights from ``generator`` (which lies on this model's
        device), allocated directly on the device."""
        return T.Transformer(self.cfg, self.device).init_(generator)

    def load(self, state: dict) -> T.Transformer:
        """Weights from a state dict (e.g. ``convert.params_from_jax``)."""
        params = T.Transformer(self.cfg, self.device)
        params.load_state_dict(state)
        return params

    def init_cache(self, batch: int, seq_len: int) -> list:
        return T.init_cache(self.cfg, batch, seq_len, self.device)

    # -- steps ---------------------------------------------------------------

    def forward(self, params: T.Transformer, batch: dict, rules=None):
        """Teacher-forced logits (B,S,V) over the whole batch."""
        return T.forward(params, batch, self.cfg, self.plan,
                         rules=rules)[0]

    def loss(self, params: T.Transformer, batch: dict, rules=None):
        """(loss, {"ce", "aux"}): the mean next-token cross-entropy of
        ``batch["targets"]`` plus 0.01 x the summed MoE aux loss."""
        logits, _, aux = T.forward(params, batch, self.cfg, self.plan,
                                   rules=rules)
        if rules is not None and is_dtensor(logits) and tp.enabled(rules):
            ce = tp.cross_entropy(logits, batch["targets"], rules)
        else:
            if rules is not None:
                # DTensor logits: the target's gather reads whole vocab rows
                logits = batch_only(logits, rules)
            ce = cross_entropy(logits, batch["targets"])
        loss = ce + 0.01 * aux
        return loss, {"ce": ce, "aux": aux}

    # serving builds no autograd graph: the parameters are frozen
    # (``requires_grad=False``) outside a train step, which turns them on
    # for its own step only (``train.step``)

    def prefill(self, params: T.Transformer, batch: dict, cache: list,
                rules=None):
        logits, cache, _ = T.forward(params, batch, self.cfg, self.plan,
                                     cache=cache, rules=rules)
        return logits[:, -1], cache

    def decode_step(self, params: T.Transformer, batch: dict, cache: list,
                    rules=None):
        """(logits (B,V), cache) of one decode step, inside the device
        range ``decode.step`` (its sublayers' ranges nest in it:
        ``transformer.DECODE_RANGES``, ``decode.head``)."""
        with obs.device_range("decode.step"):
            logits, cache, _ = T.forward(params, batch, self.cfg, self.plan,
                                         cache=cache, decode=True,
                                         rules=rules)
        return logits[:, -1], cache

    # -- abstract inputs -----------------------------------------------------

    def input_specs(self, shape: ShapeSpec) -> dict[str, InputSpec]:
        cfg = self.cfg
        b = shape.global_batch
        s = shape.seq_len
        i32 = torch.int32
        bf16 = torch.bfloat16
        sds = InputSpec
        if shape.kind in ("train", "prefill"):
            specs: dict[str, Any] = {}
            if cfg.frontend == "audio_frames":
                specs["features"] = sds((b, s, cfg.d_model), bf16)
            else:
                specs["tokens"] = sds((b, s), i32)
            if cfg.frontend == "vision_patches":
                specs["patch_embeds"] = sds((b, cfg.n_patches, cfg.d_model),
                                            bf16)
            if shape.kind == "train":
                specs["targets"] = sds((b, s), i32)
            return specs
        # decode: one new token against a seq_len-deep cache
        return {"tokens": sds((b, 1), i32),
                "pos": sds((), i32)}

    def batch_spec_names(self, shape: ShapeSpec) -> dict[str, tuple]:
        """Logical axis names per input (for the batch's shardings)."""
        out: dict[str, tuple] = {}
        for k in self.input_specs(shape):
            if k == "pos":
                out[k] = ()
            elif k in ("features", "patch_embeds"):
                out[k] = ("batch", None, None)
            else:
                out[k] = ("batch", None)
        return out
