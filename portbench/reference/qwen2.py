"""Plain float32 Qwen2 (arXiv:2407.10671): the decode step as the port's
serve loop runs it.

A decoder of ``num_hidden_layers`` blocks: RMSNorm, grouped-query
attention with a bias on q, k and v and RoPE by halves, RMSNorm, the
SwiGLU MLP; a final RMSNorm and an untied head.  Parameter names and
layouts are the port's (``wq`` (d, heads, head dim), ``wo`` (heads, head
dim, d), the MLP's ``wi``/``wg`` (d, f) and ``wo`` (f, d)).

``step`` is one step of the whole slot batch at one position, as the
port's ``ServeLoop`` takes it: every slot's key and value are written at
that position, the position is marked filled for every slot, and each
slot attends over every filled position at or before it.  That is the
port's definition of the step (one position for the batch, the maximum
over the active slots; a teacher-forced prompt step writes every slot's
rows), not an isolated decode of each request.  ``chunk`` takes a run of
such steps at consecutive positions at once, with the same numbers.

``port_numbers`` maps the port's configuration to the published keys
this module reads; ``matmul_params``, ``token_flops`` and
``train_step_flops`` are the model's operations, which ``mfu`` reads.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from portbench import weights
from portbench.reference.common import rms, rope, silu


def port_numbers(arch) -> dict:
    """The port's configuration ``arch`` under the published keys."""
    return {"hidden_size": arch.d_model,
            "num_hidden_layers": arch.n_layers,
            "num_attention_heads": arch.n_heads,
            "num_key_value_heads": arch.n_kv_heads,
            "intermediate_size": arch.d_ff,
            "vocab_size": arch.vocab_size,
            "rope_theta": arch.rope_theta, "rms_norm_eps": 1e-6,
            "tie_word_embeddings": arch.tie_embeddings,
            "qkv_bias": arch.qkv_bias}


def matmul_params(cfg: dict) -> int:
    """Weights a token multiplies through, the head included."""
    k = dims(cfg)
    d, dh = k["d"], k["dh"]
    per = d * k["hq"] * dh + 2 * d * k["hkv"] * dh + k["hq"] * dh * d \
        + 3 * d * k["f"]
    return k["L"] * per + d * k["V"]


def token_flops(cfg: dict, tokens: int, ctx_sum: int) -> float:
    """Operations of ``tokens`` tokens through the model, one at a time,
    whose contexts (positions attended, itself included) sum to
    ``ctx_sum``: the products, and attention's scores and values."""
    return 2.0 * matmul_params(cfg) * tokens \
        + 4.0 * cfg["num_hidden_layers"] * cfg["hidden_size"] * ctx_sum


def train_step_flops(cfg: dict, batch: int, seq: int) -> float:
    """6 x the products' weights x tokens."""
    return 6.0 * matmul_params(cfg) * batch * seq


def dims(cfg: dict) -> dict:
    d, hq = cfg["hidden_size"], cfg["num_attention_heads"]
    return {"d": d, "L": cfg["num_hidden_layers"], "hq": hq,
            "hkv": cfg["num_key_value_heads"], "dh": d // hq,
            "f": cfg["intermediate_size"], "V": cfg["vocab_size"]}


def param_shapes(cfg: dict) -> dict:
    """name -> shape of every parameter, in the port's names."""
    k = dims(cfg)
    d, hq, hkv, dh, f = k["d"], k["hq"], k["hkv"], k["dh"], k["f"]
    out = {"embed": (k["V"], d), "final_norm.scale": (d,),
           "lm_head": (d, k["V"])}
    for i in range(k["L"]):
        p = f"layers.{i}."
        out.update({p + "norm1.scale": (d,), p + "norm2.scale": (d,),
                    p + "mixer.wq": (d, hq, dh), p + "mixer.wk": (d, hkv, dh),
                    p + "mixer.wv": (d, hkv, dh), p + "mixer.wo": (hq, dh, d),
                    p + "mixer.bq": (hq, dh), p + "mixer.bk": (hkv, dh),
                    p + "mixer.bv": (hkv, dh),
                    p + "mlp.wi": (d, f), p + "mlp.wg": (d, f),
                    p + "mlp.wo": (f, d)})
    return out


def init_rule(cfg: dict):
    """normal / sqrt(fan-in) for the products (the port's own scales),
    0.02 for the embedding, ones for the norms, zeros for the biases."""
    return weights.init_rule


def init_state(cfg: dict, batch: int, max_seq: int, device) -> list:
    k = dims(cfg)
    shp = (batch, max_seq, k["hkv"], k["dh"])
    return [{"k": torch.zeros(shp, device=device),
             "v": torch.zeros(shp, device=device),
             "filled": torch.zeros(max_seq, dtype=torch.bool,
                                   device=device)}
            for _ in range(k["L"])]


@torch.no_grad()
def chunk(p: dict, cfg: dict, ar, tokens, start: int, state: list):
    """Steps at the consecutive positions start.. of ``tokens`` (B, T) at
    once -> the final normed hidden states (B, T, d).  Step after step
    would write every slot's rows at each position, mark it filled, and
    attend over the filled positions at or before it; so the chunk writes
    rows start..start+T-1 and attends causally over them and the filled
    rows before ``start`` (a row past a step's position, left by a longer
    request, stays masked)."""
    k = dims(cfg)
    b, t = tokens.shape
    d, hq, hkv, dh = k["d"], k["hq"], k["hkv"], k["dh"]
    eps, theta = cfg["rms_norm_eps"], cfg["rope_theta"]
    dev = tokens.device
    at = torch.arange(start, start + t, dtype=torch.float32, device=dev)
    rows = torch.arange(state[0]["filled"].shape[0], device=dev)
    h = p["embed"][tokens]
    for i in range(k["L"]):
        pre, st = f"layers.{i}.", state[i]
        x = rms(h, p[pre + "norm1.scale"], eps)
        q = ar.mm(x, p[pre + "mixer.wq"].reshape(d, -1)) \
            + p[pre + "mixer.bq"].reshape(-1)
        kk = ar.mm(x, p[pre + "mixer.wk"].reshape(d, -1)) \
            + p[pre + "mixer.bk"].reshape(-1)
        vv = ar.mm(x, p[pre + "mixer.wv"].reshape(d, -1)) \
            + p[pre + "mixer.bv"].reshape(-1)
        q = rope(q.reshape(b, t, hq, dh), at, theta)
        st["k"][:, start:start + t] = rope(kk.reshape(b, t, hkv, dh), at,
                                           theta)
        st["v"][:, start:start + t] = vv.reshape(b, t, hkv, dh)
        st["filled"][start:start + t] = True
        seen = st["filled"][None, :] & (rows[None, :] <= at[:, None])
        qg = q.reshape(b, t, hkv, hq // hkv, dh)
        s = ar.einsum("bsngd,brnd->bngsr", qg, st["k"]) / math.sqrt(dh)
        s = s.masked_fill(~seen, float("-inf"))
        o = ar.einsum("bngsr,brnd->bsngd", torch.softmax(s, -1), st["v"])
        h = h + ar.mm(o.reshape(b, t, hq * dh),
                      p[pre + "mixer.wo"].reshape(hq * dh, d))
        x = rms(h, p[pre + "norm2.scale"], eps)
        a = silu(ar.mm(x, p[pre + "mlp.wg"])) * ar.mm(x, p[pre + "mlp.wi"])
        h = h + ar.mm(a, p[pre + "mlp.wo"])
    return rms(h, p["final_norm.scale"], eps)


def head(p: dict, cfg: dict, ar, h):
    """Logits of final hidden states."""
    return ar.mm(h, p["lm_head"])


def step(p: dict, cfg: dict, ar, tokens, pos: int, state: list,
         logits: bool = True):
    """One step of the slot batch: tokens (B,) at ``pos`` -> logits
    (B, V) (None when ``logits`` is False; the state is written either
    way)."""
    h = chunk(p, cfg, ar, tokens[:, None], pos, state)[:, 0]
    return head(p, cfg, ar, h) if logits else None


def forward(p: dict, cfg: dict, ar, tokens):
    """Teacher-forced logits (B, S, V) of a causal forward pass (the CPU
    tests hold ``step`` against it)."""
    k = dims(cfg)
    b, s = tokens.shape
    d, hq, hkv, dh = k["d"], k["hq"], k["hkv"], k["dh"]
    eps, theta = cfg["rms_norm_eps"], cfg["rope_theta"]
    at = torch.arange(s, dtype=torch.float32, device=tokens.device)
    h = p["embed"][tokens]
    causal = torch.ones(s, s, dtype=torch.bool, device=tokens.device).tril()
    for i in range(k["L"]):
        pre = f"layers.{i}."
        x = rms(h, p[pre + "norm1.scale"], eps)
        q = rope(torch.einsum("bsd,dhk->bshk", x, p[pre + "mixer.wq"])
                 + p[pre + "mixer.bq"], at, theta)
        kk = rope(torch.einsum("bsd,dhk->bshk", x, p[pre + "mixer.wk"])
                  + p[pre + "mixer.bk"], at, theta)
        vv = torch.einsum("bsd,dhk->bshk", x, p[pre + "mixer.wv"]) \
            + p[pre + "mixer.bv"]
        qg = q.reshape(b, s, hkv, hq // hkv, dh)
        sc = torch.einsum("bsngd,btnd->bngst", qg, kk) / math.sqrt(dh)
        sc = sc.masked_fill(~causal, float("-inf"))
        o = torch.einsum("bngst,btnd->bsngd", torch.softmax(sc, -1), vv)
        h = h + torch.einsum("bshk,hkd->bsd", o.reshape(b, s, hq, dh),
                             p[pre + "mixer.wo"])
        x = rms(h, p[pre + "norm2.scale"], eps)
        a = F.silu(x @ p[pre + "mlp.wg"]) * (x @ p[pre + "mlp.wi"])
        h = h + a @ p[pre + "mlp.wo"]
    return rms(h, p["final_norm.scale"], eps) @ p["lm_head"]
