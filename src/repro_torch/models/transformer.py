"""The layer stack: an ``nn.Module`` of dense attention layers.

Counterpart of ``repro.models.transformer`` for the dense family.  The
reference scans one stacked parameter unit with ``lax.scan``; here the
layers are an ``nn.ModuleList`` walked by a Python loop.  Each layer's
parameters are ``nn.ParameterDict``s keyed as in the reference pytree
(``norm1``, ``mixer``, ``norm2``, ``mlp``), so the functions of
``models.layers`` read them exactly as the reference reads its dicts, and
``repro_torch.convert`` maps the pytree onto ``state_dict`` keys one to one.

Layer kinds ``ssm`` (mamba2) and ``rec`` (recurrentgemma), MoE layers,
the audio/vision front ends, LayerNorm and GELU raise
``NotImplementedError``: their model families are later slices of the
port.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from repro_torch.configs.base import ArchConfig, PlanConfig
from repro_torch.models import layers as L

# init rules: ("normal", scale) | ("zeros",) | ("ones",)


def _norm_spec(cfg: ArchConfig) -> dict:
    return {"scale": ((cfg.d_model,), ("ones",))}


def layer_spec(cfg: ArchConfig) -> dict:
    """name -> {param -> (shape, init rule)} for one attention layer, with
    the reference's shapes and scales (``layers.init_attention``,
    ``layers.init_mlp``)."""
    d, hq, hkv, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    f = cfg.d_ff
    s_in = 1.0 / math.sqrt(d)
    mixer = {"wq": ((d, hq, dh), ("normal", s_in)),
             "wk": ((d, hkv, dh), ("normal", s_in)),
             "wv": ((d, hkv, dh), ("normal", s_in)),
             "wo": ((hq, dh, d), ("normal", 1.0 / math.sqrt(hq * dh)))}
    if cfg.qkv_bias:
        mixer.update(bq=((hq, dh), ("zeros",)), bk=((hkv, dh), ("zeros",)),
                     bv=((hkv, dh), ("zeros",)))
    mlp = {"wi": ((d, f), ("normal", s_in)),
           "wg": ((d, f), ("normal", s_in)),
           "wo": ((f, d), ("normal", 1.0 / math.sqrt(f)))}
    return {"norm1": _norm_spec(cfg), "mixer": mixer,
            "norm2": _norm_spec(cfg), "mlp": mlp}


def check_supported(cfg: ArchConfig) -> None:
    kinds = set(cfg.layer_kinds())
    if kinds != {"attn"}:
        raise NotImplementedError(
            f"layer kinds {sorted(kinds - {'attn'})} are not ported yet "
            f"(ROADMAP.md, port queue: ssd with mamba2, rglru with "
            f"recurrentgemma)")
    if cfg.moe is not None and cfg.family == "moe":
        raise NotImplementedError(
            "MoE layers are not ported yet (ROADMAP.md, port queue: MoE)")
    if cfg.frontend != "none" or cfg.norm != "rmsnorm" \
            or cfg.act != "swiglu":
        raise NotImplementedError(
            f"frontend {cfg.frontend!r}, norm {cfg.norm!r} and act "
            f"{cfg.act!r} are not ported yet (ROADMAP.md, port queue)")


def _param(shape, dtype, device) -> nn.Parameter:
    return nn.Parameter(torch.empty(shape, dtype=dtype, device=device),
                        requires_grad=False)


class Layer(nn.Module):
    def __init__(self, cfg: ArchConfig, device: torch.device):
        super().__init__()
        dt = L.pdtype(cfg.plan)
        for name, params in layer_spec(cfg).items():
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
        self.layers = nn.ModuleList(Layer(cfg, device)
                                    for _ in range(cfg.n_layers))

    @torch.no_grad()
    def init_(self, generator: torch.Generator) -> "Transformer":
        """Normal x the reference's scales, biases 0, norm scales 1,
        generated directly on the parameters' device (no host copy)."""
        cfg = self.cfg
        rules = {"embed": ("normal", 0.02),
                 "lm_head": ("normal", 1.0 / math.sqrt(cfg.d_model))}
        for k, (_, rule) in _norm_spec(cfg).items():
            rules[f"final_norm.{k}"] = rule
        for i in range(cfg.n_layers):
            for name, params in layer_spec(cfg).items():
                for k, (_, rule) in params.items():
                    rules[f"layers.{i}.{name}.{k}"] = rule
        for name, p in self.named_parameters():
            rule = rules[name]
            if rule[0] == "normal":     # f32 normal x scale, then cast
                p.copy_(torch.empty_like(p, dtype=torch.float32)
                        .normal_(generator=generator).mul_(rule[1]))
            elif rule[0] == "ones":
                p.fill_(1.0)
            else:
                p.zero_()
        return self


def init_layer_cache(cfg: ArchConfig, batch: int, seq_len: int,
                     device: torch.device) -> dict:
    dtype = L.dtype_of(cfg.plan.kv_cache_dtype)
    shp = (batch, seq_len, cfg.n_kv_heads, cfg.d_head)
    out = {"k": torch.zeros(shp, dtype=dtype, device=device),
           "v": torch.zeros(shp, dtype=dtype, device=device),
           "kpos": torch.full((seq_len,), -1, dtype=torch.int32,
                              device=device)}
    if dtype == torch.int8:
        sshp = (batch, seq_len, cfg.n_kv_heads, 1)
        out["k_scale"] = torch.zeros(sshp, dtype=torch.float32,
                                     device=device)
        out["v_scale"] = torch.zeros(sshp, dtype=torch.float32,
                                     device=device)
    return out


def init_cache(cfg: ArchConfig, batch: int, seq_len: int,
               device: torch.device) -> list:
    """One rolling KV cache dict per layer (kv dtype from ``cfg.plan``, as
    in the reference)."""
    check_supported(cfg)
    return [init_layer_cache(cfg, batch, seq_len, device)
            for _ in range(cfg.n_layers)]


def apply_layer(p: Layer, x, cfg: ArchConfig, plan: PlanConfig, positions,
                cache, decode: bool):
    h = L.apply_norm(p.norm1, x, cfg)
    mix, cache = L.run_attention(p.mixer, h, cfg, plan, positions, cache,
                                 decode)
    x = x + mix
    h = L.apply_norm(p.norm2, x, cfg)
    return x + L.run_mlp(p.mlp, h, cfg, plan), cache


def forward(params: Transformer, batch: dict, cfg: ArchConfig,
            plan: PlanConfig, cache: Optional[list] = None,
            decode: bool = False):
    """Returns (logits, cache).

    train:   cache=None, decode=False  -> logits (B,S,V)
    prefill: cache=list, decode=False  -> logits (B,S,V) + filled cache
    decode:  cache=list, decode=True   -> logits (B,1,V) + updated cache

    ``batch["tokens"]`` is a (B,S) integer tensor on the weights' device;
    in decode ``batch["pos"]`` (an int or a 0-d tensor) is the position of
    the whole batch.
    """
    dt = L.cdtype(plan)
    tokens = batch["tokens"]
    # gather, then cast the B*S rows: the same numbers as the reference's
    # cast-then-gather without casting the whole table every step
    h = params.embed[tokens].to(dt)
    if decode:
        positions = torch.as_tensor(batch["pos"], dtype=torch.int32,
                                    device=h.device).reshape(1)
    else:
        positions = torch.arange(h.shape[1], dtype=torch.int32,
                                 device=h.device)
    for i, layer in enumerate(params.layers):
        h, _ = apply_layer(layer, h, cfg, plan, positions,
                           cache[i] if cache is not None else None, decode)
    h = L.apply_norm(params.final_norm, h, cfg)
    wout = params.embed.T if cfg.tie_embeddings else params.lm_head
    logits = torch.einsum("bsd,dv->bsv", h, wout.to(h.dtype))
    return logits, cache
