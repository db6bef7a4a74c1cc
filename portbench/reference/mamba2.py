"""Plain float32 Mamba2 (arXiv:2405.21060): the decode step the port's
serve loop takes, and the training loss.

A stack of ``n_layer`` blocks, each RMSNorm then the Mamba2 mixer with a
residual: one input projection to (z, x, B, C, dt); a depthwise causal
convolution of width ``d_conv`` with a bias over (x, B, C); SiLU on x;
dt = softplus(dt + dt_bias), A = -exp(A_log); the SSD recurrence
h = exp(dt A) h + dt x B^T, y = C h + D x over ``nheads`` heads of
``headdim`` with one group of ``d_state``; the gated RMSNorm y silu(z);
the output projection.  A final RMSNorm and the tied embedding as the
head.  Parameter names and layouts are the port's.

Departure from the published block, taken from the port: SiLU is applied
to x alone after the convolution (the published block applies it to B and
C as well).  The norms use eps 1e-6.

``loss`` runs the SSD in the paper's minimal chunked form (the quadratic
form inside a chunk, the state across chunks; the decays from exact
segment sums, -inf above the diagonal before the exponential); it
recomputes each layer in the backward (``torch.utils.checkpoint``), which
changes no number, only the memory.

``port_numbers`` maps the port's configuration to the published keys
this module reads; ``matmul_params``, ``token_flops`` and
``train_step_flops`` are the model's operations, which ``mfu`` reads.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from portbench import work
from portbench.reference.common import cross_entropy, rms, silu

EPS = 1e-6


def port_numbers(arch) -> dict:
    """The port's configuration ``arch`` under the published keys."""
    return {"d_model": arch.d_model, "n_layer": arch.n_layers,
            "vocab_size": arch.vocab_size, "d_state": arch.ssm_state,
            "expand": arch.ssm_expand, "headdim": arch.ssm_headdim,
            "d_conv": arch.ssm_conv, "chunk_size": arch.ssm_chunk,
            "tie_embeddings": arch.tie_embeddings}


def matmul_params(cfg: dict) -> int:
    """Weights a token multiplies through, the head included."""
    k = dims(cfg)
    per = k["d"] * (2 * k["di"] + 2 * k["n"] + k["h"]) + k["di"] * k["d"]
    return k["L"] * per + k["d"] * k["V"]


def token_flops(cfg: dict, tokens: int, ctx_sum: int) -> float:
    """Operations of ``tokens`` tokens through the model, one at a time:
    the products, the convolution and the recurrence (``ctx_sum`` is not
    read: a token's work does not grow with its context)."""
    k = dims(cfg)
    per = 6 * k["di"] * k["n"] + 2 * k["k"] * (k["di"] + 2 * k["n"])
    return (2.0 * matmul_params(cfg) + float(k["L"] * per)) * tokens


def train_step_flops(cfg: dict, batch: int, seq: int) -> float:
    """6 x the products' weights x tokens, plus 3 x the SSD's forward
    operations a layer (forward and backward)."""
    k = dims(cfg)
    f, _ = work.ssd_work(batch, seq, k["h"], k["p"], k["n"], k["q"], 2)
    return 6.0 * matmul_params(cfg) * batch * seq + 3.0 * f * k["L"]


def dims(cfg: dict) -> dict:
    d = cfg["d_model"]
    di = cfg["expand"] * d
    return {"d": d, "L": cfg["n_layer"], "di": di, "n": cfg["d_state"],
            "p": cfg["headdim"], "h": di // cfg["headdim"],
            "k": cfg["d_conv"], "V": cfg["vocab_size"],
            "q": cfg["chunk_size"]}


def param_shapes(cfg: dict) -> dict:
    k = dims(cfg)
    d, di, n, h = k["d"], k["di"], k["n"], k["h"]
    out = {"embed": (k["V"], d), "final_norm.scale": (d,)}
    for i in range(k["L"]):
        p = f"layers.{i}."
        out.update({p + "norm1.scale": (d,),
                    p + "mixer.in_proj": (d, 2 * di + 2 * n + h),
                    p + "mixer.conv_w": (k["k"], di + 2 * n),
                    p + "mixer.conv_b": (di + 2 * n,),
                    p + "mixer.A_log": (h,), p + "mixer.D": (h,),
                    p + "mixer.dt_bias": (h,), p + "mixer.norm": (di,),
                    p + "mixer.out_proj": (di, d)})
    return out


def init_rule(cfg: dict):
    """Mamba2's published initialisation (the paper's code): the
    projections at the variance of PyTorch's default linear init,
    1 / (3 fan-in), the output projection's divided by the layers
    (its prenorm residual rescaling), the convolution's weights and bias
    at its default, 1 / (3 width); A = -U(1, 16); dt log-uniform on
    [0.001, 0.1] through dt_bias; D and the norms 1; the embedding
    normal at 0.02.  (With the port's own zero A_log and dt_bias, a
    48-layer stack turns bf16 rounding into logits that differ from the
    float32 reference by several standard deviations.)"""
    k = dims(cfg)

    def rule(name: str, shape: tuple) -> tuple:
        leaf = name.rsplit(".", 1)[-1]
        if name == "embed":
            return ("normal", 0.02)
        if leaf in ("scale", "norm", "D"):
            return ("ones",)
        if leaf == "in_proj":
            return ("normal", (3.0 * k["d"]) ** -0.5)
        if leaf == "out_proj":
            return ("normal", (3.0 * k["di"] * k["L"]) ** -0.5)
        if leaf in ("conv_w", "conv_b"):
            return ("normal", (3.0 * k["k"]) ** -0.5)
        if leaf == "A_log":
            return ("log_of_uniform", 1.0, 16.0)
        if leaf == "dt_bias":
            return ("softplus_inverse", 1e-3, 1e-1)
        raise ValueError(f"no init rule for {name}")
    return rule


def init_state(cfg: dict, batch: int, max_seq: int, device) -> list:
    k = dims(cfg)
    return [{"conv": torch.zeros((batch, k["k"] - 1, k["di"] + 2 * k["n"]),
                                 device=device),
             "ssm": torch.zeros((batch, k["h"], k["p"], k["n"]),
                                device=device)}
            for _ in range(k["L"])]


def _gate_out(p, pre, ar, y, z):
    y = y * silu(z)
    y = rms(y, p[pre + "mixer.norm"], EPS)
    return ar.mm(y, p[pre + "mixer.out_proj"])


@torch.no_grad()
def step(p: dict, cfg: dict, ar, tokens, pos: int, state: list,
         logits: bool = True):
    """tokens (B,) -> logits (B, V) in f32 (None when ``logits`` is
    False); the conv window and the SSM state advance for every slot.
    ``pos`` is not read: the recurrence has no positions."""
    k = dims(cfg)
    b, di, n, h, hp = tokens.shape[0], k["di"], k["n"], k["h"], k["p"]
    x = p["embed"][tokens]
    for i in range(k["L"]):
        pre, st = f"layers.{i}.", state[i]
        u = ar.mm(rms(x, p[pre + "norm1.scale"], EPS),
                  p[pre + "mixer.in_proj"])
        z, xbc, dt = u[:, :di], u[:, di:2 * di + 2 * n], u[:, 2 * di + 2 * n:]
        win = torch.cat([st["conv"], xbc[:, None]], dim=1)       # (B,K,C)
        conv = (win * p[pre + "mixer.conv_w"]).sum(1) + p[pre + "mixer.conv_b"]
        st["conv"].copy_(win[:, 1:])
        xin = silu(conv[:, :di]).reshape(b, h, hp)
        bm, cm = conv[:, di:di + n], conv[:, di + n:]
        dt = F.softplus(dt + p[pre + "mixer.dt_bias"])
        a = -torch.exp(p[pre + "mixer.A_log"])
        hs = torch.exp(dt * a)[..., None, None] * st["ssm"] \
            + torch.einsum("bhp,bn,bh->bhpn", xin, bm, dt)
        st["ssm"].copy_(hs)
        y = torch.einsum("bn,bhpn->bhp", cm, hs) \
            + p[pre + "mixer.D"][None, :, None] * xin
        x = x + _gate_out(p, pre, ar, y.reshape(b, di), z)
    if not logits:
        return None
    return ar.mm(rms(x, p["final_norm.scale"], EPS), p["embed"].T)


#: the reference's own chunk: the recurrence is the same at any chunk,
#: and 64 moves a quarter of 256's bytes through the (Q, Q) decays
CHUNK = 64


def segsum(x):
    """(..., T) -> (..., T, T): the sums x[j+1..i] for j <= i, -inf above
    the diagonal (the Mamba2 paper's ``segsum``, exact: no difference of
    two cumulative sums)."""
    t = x.shape[-1]
    x = x[..., None].expand(*x.shape, t)
    lower = torch.ones(t, t, dtype=torch.bool, device=x.device).tril(-1)
    x = torch.cumsum(x.masked_fill(~lower, 0), dim=-2)
    return x.masked_fill(~torch.ones(t, t, dtype=torch.bool,
                                     device=x.device).tril(), float("-inf"))


def ssd(x, dt, a, bm, cm, chunk: int = CHUNK):
    """The SSD scan, the Mamba2 paper's minimal chunked form.  x (B,S,H,P),
    dt (B,S,H), a (H,), bm/cm (B,S,N) -> y (B,S,H,P).  ``chunk`` (or,
    where it does not divide S, the largest common divisor of the two)."""
    b, s, h, hp = x.shape
    q = chunk if s % chunk == 0 else math.gcd(s, chunk)
    c = s // q
    xd = (x * dt[..., None]).reshape(b, c, q, h, hp)
    da = (dt * a).reshape(b, c, q, h).permute(0, 3, 1, 2)       # (B,H,C,Q)
    bc, cc = bm.reshape(b, c, q, -1), cm.reshape(b, c, q, -1)
    cum = torch.cumsum(da, dim=-1)
    decay = torch.exp(segsum(da))                               # (B,H,C,Q,Q)
    scores = torch.einsum("bcln,bcsn->bcls", cc, bc)
    y = torch.einsum("bhcls,bcshp->bclhp", scores[:, None] * decay, xd)
    tail = torch.exp(cum[..., -1:] - cum)                       # (B,H,C,Q)
    states = torch.einsum("bcln,bhcl,bclhp->bchpn", bc, tail, xd)
    states = torch.cat([torch.zeros_like(states[:, :1]), states], dim=1)
    carry = torch.exp(segsum(F.pad(cum[..., -1], (1, 0))))      # (B,H,C+1,C+1)
    states = torch.einsum("bhzc,bchpn->bzhpn", carry, states)[:, :-1]
    y = y + torch.einsum("bcln,bchpn,bhcl->bclhp", cc, states,
                         torch.exp(cum))
    return y.reshape(b, s, h, hp)


def _layer(p, pre, cfg, ar, x):
    k = dims(cfg)
    b, s = x.shape[:2]
    di, n, h, hp, kw = k["di"], k["n"], k["h"], k["p"], k["k"]
    u = ar.mm(rms(x, p[pre + "norm1.scale"], EPS), p[pre + "mixer.in_proj"])
    z, xbc, dt = (u[..., :di], u[..., di:2 * di + 2 * n],
                  u[..., 2 * di + 2 * n:])
    pad = F.pad(xbc, (0, 0, kw - 1, 0))
    w = p[pre + "mixer.conv_w"]
    conv = sum(pad[:, j:j + s] * w[j] for j in range(kw)) \
        + p[pre + "mixer.conv_b"]
    xin = silu(conv[..., :di]).reshape(b, s, h, hp)
    bm, cm = conv[..., di:di + n], conv[..., di + n:]
    dt = F.softplus(dt + p[pre + "mixer.dt_bias"])
    a = -torch.exp(p[pre + "mixer.A_log"])
    y = ssd(ar.q(xin), dt, a, ar.q(bm), ar.q(cm)) \
        + p[pre + "mixer.D"][:, None] * xin
    return x + _gate_out(p, pre, ar, y.reshape(b, s, di), z)


def hidden(p: dict, cfg: dict, ar, tokens):
    """The final normed hidden states (B, S, d) of a teacher-forced
    pass."""
    x = p["embed"][tokens]
    for i in range(dims(cfg)["L"]):
        if torch.is_grad_enabled():
            x = checkpoint(_layer, p, f"layers.{i}.", cfg, ar, x,
                           use_reentrant=False)
        else:
            x = _layer(p, f"layers.{i}.", cfg, ar, x)
    return rms(x, p["final_norm.scale"], EPS)


def forward(p: dict, cfg: dict, ar, tokens):
    """Teacher-forced logits (B, S, V)."""
    return ar.mm(hidden(p, cfg, ar, tokens), p["embed"].T)


@torch.no_grad()
def stream(p: dict, cfg: dict, ar, tokens, rows):
    """The serve loop's steps at once: ``tokens`` (slots, steps) holds each
    slot's token at every step.  The recurrence has no positions and every
    step advances every slot, so step j of slot i is position j of slot
    i's sequence: the logits (len(rows), V) at ``rows``, (slot, step)
    index tensors.  (``step`` one step at a time gives the same numbers:
    the CPU tests hold the two together.)  The steps are padded to a
    multiple of the chunk at the end, which changes no earlier output."""
    n = tokens.shape[1]
    pad = -n % CHUNK
    if pad:
        tokens = F.pad(tokens, (0, pad))
    h = hidden(p, cfg, ar, tokens)
    return ar.mm(h[rows[0], rows[1]], p["embed"].T)


def loss(p: dict, cfg: dict, ar, tokens, targets):
    """Mean next-token cross-entropy of ``targets`` (B,S)."""
    return cross_entropy(forward(p, cfg, ar, tokens), targets)
