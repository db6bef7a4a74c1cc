"""Tensor-parallel layers on a mesh: each layer computes on its own shards.

Under a plan with ``use_tp`` (``enabled``) the ``model`` axis splits every
product of a layer the way the stored specs (``parallel.param_sharding``)
cut its weights, the reference's tensor-parallel program:

  * a weight is gathered over the batch axes only (the plan's ``fsdp``),
    just before it is used (``fsdp_gather``); no weight and no cache entry
    is ever gathered over ``model``;
  * the collectives over ``model`` are placed by hand, on activations and
    small statistics only: the sequence-parallel residual is all-gathered
    before a block and each row-split product's ``Partial`` sum is
    reduce-scattered back onto it (all-reduced where the sequence does not
    split, as in decode);
  * each product runs in a *region*: a ``local_map`` body on the local
    tensors (``region``), whose outputs are ``Shard`` or ``Partial``
    ``DTensor``s that are then redistributed, so autograd holds the
    backward of every collective and each gradient lands on its
    parameter's stored placements.  The kernels run inside on local
    tensors, through their Functions: CUDA on the card, the plain versions
    on the CPU or the meta device.

Per layer kind:

  attention  q, k and v come out of their projections in the weights'
             layout (heads, or ``d_head`` where the heads do not divide:
             qwen2-7b's 28 on 16), and are moved, as activations, to whole
             heads by ``head_strategy``: ``kv`` splits the kv heads (q by
             its kv group); ``group`` the q group axis, k and v whole;
             ``flat`` the q heads padded to a multiple of the axis, k and
             v whole (a rank whose heads are all padding attends to none
             and launches nothing).  RoPE and the attention run on whole
             heads; ``wo`` ends in a ``Partial`` sum.
  cache      stays at its stored placements: kv heads on ``model`` for
             ``kv`` (each rank attends over its own heads), positions on
             ``model`` otherwise: prefill writes each rank's own slots,
             decode writes slot ``pos % T`` on the rank that owns it and
             attends over each rank's own positions with every head,
             combining the partial results by their max and sum (one
             max all-reduce and one sum all-reduce of small tensors, as
             flash-decoding combines its splits).  An int8 cache
             dequantises its local shard only.
  mlp        ``wi``/``wg`` split on ``ff``, ``wo`` on its rows: the
             SwiGLU (its kernel's Function) or GELU on the local ``ff``
             slice, ``bo`` added once after the reduction.
  moe        the router's logits are gathered over ``model`` (an
             activation), ``moe_route`` and ``moe_slots`` run on plain
             tensors, the experts' assignments on ``idx`` gathered over
             the batch axes, so each rank keeps and drops exactly what
             ``run_moe`` keeps and drops on the whole batch; each rank
             runs its own experts' ``bmm``s; the combine is a ``Partial``
             sum.
  rec        the RG-LRU's input projections, conv and recurrence on the
             local width; the gates' input width is all-gathered (an
             activation); ``w_out`` row-split.
  ssm        mamba2's ``in_proj`` output (its columns cut across z, x, B,
             C and dt) all-gathered, the conv on the conv weights' own
             columns, then ``ssd`` on the local heads; the gated RMSNorm
             all-reduces its sum of squares; ``out_proj`` row-split.
  embed      a vocab-split table looks up the rank's own rows (a
             ``Partial`` sum); a ``d``-split one its own columns.
  logits     stay vocab-sharded; ``cross_entropy`` takes the log-softmax
             over the sharded vocab with max and sum all-reduces.

On the one card's ``(1, 1)`` mesh the same regions run with one rank: every
local tensor is the whole tensor and every collective moves nothing, so
a step equals the step without rules.  A plan without ``use_tp`` folds
``model`` into the batch axes (``sharding.make_rules``): its layers run on
their gathered operands (``sharding.layer_operands``), ZeRO-3, the plan's
own execution.  The stored specs decide each split: where a spec leaves a
weight whole over ``model`` (no dim of it divides by the axis, as
tiny-test's 4 heads of 8 on 16 ranks, or mamba2-1.3b's 50280-token vocab
tying with its ``d_model``), every model rank computes that product whole
on the weight it holds (``model_split``: attention, MLP, MoE, embedding
and logits).  Nothing is gathered over ``model`` to run a product whole:
a layout a region does not know raises, as does an RG-LRU or mamba2
width the axis does not divide.
"""
from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F

from repro_torch.models import layers as L
from repro_torch.parallel.sharding import (constrain, head_strategy,
                                           is_dtensor)

MODEL = "model"


def enabled(rules) -> bool:
    """Whether ``rules`` split products over the model axis (a
    ``use_tp`` plan's rules)."""
    return rules is not None and rules.rules.get("ff") == (MODEL,)


# ---------------------------------------------------------------------------
# What ran: the dry run records each layer kind's route
# ---------------------------------------------------------------------------

_ROUTES: list = []


@contextlib.contextmanager
def record_routes():
    """A dict, filled while the block runs, of layer kind -> the route it
    ran (``"tp"``: on its shards; ``"zero3"``: on its gathered
    operands)."""
    seen: dict = {}
    _ROUTES.append(seen)
    try:
        yield seen
    finally:
        _ROUTES.remove(seen)


def note(kind: str, route: str) -> None:
    for seen in _ROUTES:
        seen[kind] = route


def describe_routes(seen: dict) -> str:
    """One line for a record's ``execution``: each kind's route."""
    if not seen:
        return "no layer ran"
    tp = sorted(k for k, v in seen.items() if v == "tp")
    z3 = sorted(k for k, v in seen.items() if v != "tp")
    parts = []
    if tp:
        parts.append("tp (products split over 'model', weights gathered "
                     "over the batch axes only): " + ", ".join(tp))
    if z3:
        parts.append("zero3 (operands gathered to Replicate): "
                     + ", ".join(z3))
    return "; ".join(parts)


# ---------------------------------------------------------------------------
# Placements
# ---------------------------------------------------------------------------


def _mi(mesh) -> int:
    return mesh.mesh_dim_names.index(MODEL)


def tp_size(mesh) -> int:
    return mesh.size(_mi(mesh))


def tp_rank(mesh) -> int:
    return mesh.get_local_rank(_mi(mesh))


def _set(placements, i: int, p) -> tuple:
    out = list(placements)
    out[i] = p
    return tuple(out)


def _at(like, p) -> tuple:
    """``like``'s placements with ``p`` on the model axis."""
    return _set(like.placements, _mi(like.device_mesh), p)


def _stat(like) -> tuple:
    """Placements of a statistic summed over ``like``'s batch rows:
    ``Partial`` where ``like`` is sharded, replicated elsewhere."""
    from torch.distributed.tensor import Partial, Replicate
    return tuple(Partial() if p.is_shard() else Replicate()
                 for p in like.placements)


def _to(x, placements):
    placements = tuple(placements)
    if tuple(x.placements) == placements:
        return x
    return x.redistribute(x.device_mesh, placements)


def on_model(x, p):
    """``x`` with placement ``p`` on the model axis, its other axes
    kept."""
    return _to(x, _at(x, p))


def fsdp_gather(w):
    """A weight gathered over the batch axes only (``Replicate`` there),
    its model-axis placement kept."""
    from torch.distributed.tensor import Replicate
    i = _mi(w.device_mesh)
    return _to(w, tuple(p if d == i else Replicate()
                        for d, p in enumerate(w.placements)))


def split_dim(w, what: str) -> int:
    """The dim of ``w`` that the model axis splits; a weight whole over
    the axis raises."""
    p = w.placements[_mi(w.device_mesh)]
    if not p.is_shard():
        raise ValueError(f"{what} {tuple(w.shape)} is not split over the "
                         f"model axis ({w.placements}): the region cannot "
                         f"split its product")
    return p.dim


def model_split(ws: dict, want: dict, what: str) -> bool:
    """Whether the model axis splits the weights ``ws`` (name ->
    ``DTensor``) on the dims ``want`` names: True when it splits each on
    its dim; False when the stored specs leave every one whole over the
    axis (they divide no dim by it, as tiny-test's 4 heads of 8 on 16
    ranks): each model rank then computes the whole product on the
    weights it holds, nothing gathered.  Any other layout raises."""
    mi = _mi(next(iter(ws.values())).device_mesh)
    if not any(w.placements[mi].is_shard() for w in ws.values()):
        return False
    for n, w in ws.items():
        d = split_dim(w, f"{what}.{n}")
        if d not in want[n]:
            raise ValueError(f"{what}.{n} is split on dim {d}, not one of "
                             f"{want[n]}")
    return True


def _row_block(x) -> int:
    """Which block of ``x``'s dim 0 this rank holds (its shards over the
    mesh dims that split dim 0, the first the most significant)."""
    mesh = x.device_mesh
    j = 0
    for i, p in enumerate(x.placements):
        if p.is_shard(0):
            j = j * mesh.size(i) + mesh.get_local_rank(i)
    return j


def batched(t, rules):
    """``t`` (a step input: dim 0 the batch) as a ``DTensor`` sharded over
    the batch axes where they divide it, replicated otherwise; a plain
    tensor (the whole, the same on every rank) keeps its own slice,
    nothing sent."""
    from torch.distributed.tensor import Replicate, distribute_tensor
    spec = ("batch",) + (None,) * (t.ndim - 1)
    if is_dtensor(t):
        return constrain(t, rules, *spec)
    mesh = rules.mesh
    whole = distribute_tensor(t, mesh, [Replicate()] * mesh.ndim,
                              src_data_rank=None)
    return constrain(whole, rules, *spec)


def region(fn, outs, *args, model_share=None):
    """``fn`` on the local tensors of its ``DTensor`` arguments (other
    arguments pass as they are) through ``local_map``; its outputs are
    ``DTensor``s at ``outs`` (one placement tuple each; a single output
    when ``outs`` holds one).

    The input gradients' placements follow from the work's split: on a
    mesh dim where an input or an output is sharded or partial, each rank
    computes its own part, so an input replicated there gets a
    ``Partial`` gradient; an output replicated beside such a split would
    have its gradient counted once a rank, and raises.

    Under ``weigh_flops`` the body's ops, forward and backward, weigh as
    many ranks' work as the split covers: the product of the split mesh
    dims' sizes, the model axis counted as ``model_share`` ranks where a
    rank's part is not the average (padding heads)."""
    from torch.distributed.tensor import Partial, Replicate
    from torch.distributed.tensor.experimental import local_map
    dts = [a for a in args if is_dtensor(a)]
    mesh = dts[0].device_mesh
    outs = [tuple(o) for o in outs]
    split = [any(not a.placements[i].is_replicate() for a in dts)
             or any(not o[i].is_replicate() for o in outs)
             for i in range(mesh.ndim)]
    for o in outs:
        if any(split[i] and o[i].is_replicate() for i in range(mesh.ndim)):
            raise ValueError(f"a replicated output {o} beside work split "
                             f"over the mesh")

    def grad_pl(p, i):
        if p.is_partial():
            return Replicate()
        return Partial() if split[i] and p.is_replicate() else p
    ins = tuple(tuple(a.placements) if is_dtensor(a) else None
                for a in args)
    grads = tuple(tuple(grad_pl(p, i) for i, p in enumerate(a.placements))
                  if is_dtensor(a) else None for a in args)
    # one output's placements are a list: local_map reads a tuple as one
    # placement list per output
    out_pl = list(outs[0]) if len(outs) == 1 \
        else tuple(list(o) for o in outs)
    if _WEIGH:
        mi = _mi(mesh)
        weight = 1.0
        for i in range(mesh.ndim):
            if split[i]:
                weight *= model_share if i == mi and model_share \
                    is not None else mesh.size(i)
        fn = _weighed(fn, weight)
    return local_map(fn, out_placements=out_pl, in_placements=ins,
                     in_grad_placements=grads, device_mesh=mesh)(*args)


# ---------------------------------------------------------------------------
# FLOPs a region stands for (the dry run's global count)
# ---------------------------------------------------------------------------

_WEIGH: list = []
_WEIGHTS: list = []


@contextlib.contextmanager
def weigh_flops():
    """While the block runs, each region's ops carry the number of ranks'
    work they stand for (``flop_weight``): the dry run traces rank 0
    alone."""
    _WEIGH.append(True)
    try:
        yield
    finally:
        _WEIGH.pop()
        _WEIGHTS.clear()


def flop_weight() -> float:
    """How many ranks' work the op running now stands for (1 outside a
    region)."""
    return _WEIGHTS[-1] if _WEIGHTS else 1.0


class _Exit(torch.autograd.Function):
    """A region's outputs: the backward that reaches them first sets
    their region's weight, for the body's backward ops."""

    @staticmethod
    def forward(ctx, weight, *xs):
        ctx.weight = weight
        return tuple(x.view_as(x) for x in xs)

    @staticmethod
    def backward(ctx, *gs):
        _WEIGHTS.append(ctx.weight)
        return (None, *gs)


class _Enter(torch.autograd.Function):
    """A region's inputs: their backward runs after the body's, and
    drops its weight (the engine runs a later region's backward nodes
    before an earlier one's: the weights nest)."""

    @staticmethod
    def forward(ctx, *xs):
        return tuple(x.view_as(x) for x in xs)

    @staticmethod
    def backward(ctx, *gs):
        _WEIGHTS.pop()
        return gs


def _weighed(fn, weight: float):
    def body(*args):
        grad = [i for i, a in enumerate(args)
                if isinstance(a, torch.Tensor) and a.requires_grad]
        if grad:
            args = list(args)
            for i, a in zip(grad, _Enter.apply(*(args[i] for i in grad))):
                args[i] = a
        _WEIGHTS.append(weight)
        try:
            out = fn(*args)
        finally:
            _WEIGHTS.pop()
        if not grad:
            return out
        single = isinstance(out, torch.Tensor)
        outs = [out] if single else list(out)
        rg = [i for i, o in enumerate(outs) if o.requires_grad]
        if rg:
            for i, o in zip(rg, _Exit.apply(weight,
                                            *(outs[i] for i in rg))):
                outs[i] = o
        else:                   # nothing flows back through the body
            return out
        return outs[0] if single else tuple(outs)
    return body


# ---------------------------------------------------------------------------
# The layer
# ---------------------------------------------------------------------------


def apply_layer(p, x, cfg, plan, positions, cache, decode: bool,
                window: int):
    """One layer on its shards: returns (x, cache, aux) as
    ``transformer.apply_layer``; ``x`` keeps its placements."""
    out_pl = tuple(x.placements)
    if is_dtensor(positions):
        positions = positions.to_local()      # replicated: the whole
    aux = x.new_zeros((), dtype=torch.float32)
    # the norms run as DTensor ops on the local rows: the plain path's ops,
    # so their gradients accumulate in its order
    h = L.apply_norm(p.norm1, x, cfg)
    if p.kind == "ssm":
        return x + mamba2(p.mixer, h, cfg, plan, cache, decode, out_pl), \
            cache, aux
    if p.kind == "rec":
        mix = rglru(p.mixer, h, cfg, plan, cache, decode, out_pl)
    else:
        mix = attention(p.mixer, h, cfg, plan, positions, cache, decode,
                        window, out_pl)
    x = x + mix
    h = L.apply_norm(p.norm2, x, cfg)
    if hasattr(p, "moe"):
        ff, aux = moe(p.moe, h, cfg, plan, out_pl)
    else:
        ff = mlp(p.mlp, h, cfg, plan, out_pl)
    return x + ff, cache, aux


# ---------------------------------------------------------------------------
# MLP
# ---------------------------------------------------------------------------

#: the MLP weights' dims that the model axis splits
_MLP_SPLIT = {"wi": (1,), "wg": (1,), "bi": (0,), "wo": (0,)}


def mlp(params, h, cfg, plan, out_pl):
    from torch.distributed.tensor import Partial, Replicate
    note("mlp", "tp")
    x = on_model(h, Replicate())
    names = sorted(k for k in params if k != "bo")
    ws = [fsdp_gather(params[n]) for n in names]
    split = model_split(dict(zip(names, ws)), _MLP_SPLIT, "mlp")

    def body(x, *ws):
        return L.mlp_products(dict(zip(names, ws)), x, cfg, plan)
    y = region(body, [_at(x, Partial() if split else Replicate())], x, *ws)
    y = _to(y, out_pl)
    if cfg.act == "gelu":
        y = y + L.cast_weight(params["bo"], L.cdtype(plan))
    return y


# ---------------------------------------------------------------------------
# Attention
# ---------------------------------------------------------------------------


def _project(params, name: str, x, cfg, plan, form: str, pad: int):
    """``x @ w{name}`` (+ its bias) in the weight's own layout: heads or
    ``d_head`` split over the model axis.  ``form`` shapes the local
    output: ``"flat"`` (B,S,H,D) with the heads padded to ``pad``,
    ``"grouped"`` (B,S,Hkv,G,D) for q.  Returns the ``DTensor`` and the
    weight's split dim (``None``: whole over the axis,
    ``model_split``)."""
    from torch.distributed.tensor import Replicate, Shard
    dt = L.cdtype(plan)
    ws = {"w": fsdp_gather(params["w" + name])}
    if cfg.qkv_bias:
        ws["b"] = fsdp_gather(params["b" + name])
    d = None
    if model_split(ws, {"w": (1, 2), "b": (0, 1)}, f"attn.{name}"):
        d = ws["w"].placements[_mi(x.device_mesh)].dim  # 1: heads, 2: d_head
        if cfg.qkv_bias and \
                ws["b"].placements[_mi(x.device_mesh)].dim != d - 1:
            raise ValueError(f"attn.b{name} is split unlike attn.w{name}")
    hkv = cfg.n_kv_heads
    grouped = form == "grouped"
    out = Replicate() if d is None else \
        Shard((4 if d == 2 else 2) if grouped else d + 1)

    def body(x, w, b=None):
        y = torch.einsum("bsd,dhk->bshk", x, L.cast_weight(w, dt))
        if b is not None:
            y = y + L.cast_weight(b, dt)
        bs, s, h, dh = y.shape
        if d != 1 and pad > h:
            y = torch.cat([y, y.new_zeros((bs, s, pad - h, dh))], dim=2)
        if grouped:
            g = cfg.n_heads // hkv
            y = y.reshape(bs, s, h // g, g, dh)
        return y
    return region(body, [_at(x, out)], x, *ws.values()), d


def _same_split(*dims) -> None:
    """q, k and v split over the model axis together, or none of them."""
    if len({d is None for d in dims}) > 1:
        raise ValueError(f"attention projections split on dims {dims}: "
                         f"some whole over the model axis, some not")


def attention(params, h, cfg, plan, positions, cache, decode: bool,
              window: int, out_pl):
    from torch.distributed.tensor import Replicate, Shard
    note("attn", "tp")
    mesh = h.device_mesh
    tp, r = tp_size(mesh), tp_rank(mesh)
    hs = head_strategy(cfg, tp)
    hq, hkv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    x = on_model(h, Replicate())
    if decode and hs != "kv":
        # the cache splits its positions: every rank, every head
        q, dq = _project(params, "q", x, cfg, plan, "flat", hq)
        q = on_model(q, Replicate())
        k, dk = _project(params, "k", x, cfg, plan, "flat", hkv)
        v, dv = _project(params, "v", x, cfg, plan, "flat", hkv)
        _same_split(dq, dk, dv)
        return _decode_seq(params, q, on_model(k, Replicate()),
                           on_model(v, Replicate()), cfg, plan, positions,
                           cache, window, out_pl, r)
    if hs == "flat":
        pad = -(-hq // tp) * tp
        q, dq = _project(params, "q", x, cfg, plan, "flat", pad)
        q = on_model(q, Shard(2))
    else:
        q, dq = _project(params, "q", x, cfg, plan, "grouped", hq)
        q = on_model(q, Shard(2 if hs == "kv" else 3))
    kv_pl = Shard(2) if hs == "kv" else Replicate()
    k, dk = _project(params, "k", x, cfg, plan, "flat", hkv)
    v, dv = _project(params, "v", x, cfg, plan, "flat", hkv)
    _same_split(dq, dk, dv)
    k, v = on_model(k, kv_pl), on_model(v, kv_pl)
    names = sorted(cache) if cache is not None else []
    theta = cfg.rope_theta
    int8 = cache is not None and cache["k"].dtype == torch.int8

    def body(q, k, v, *cl):
        cl = dict(zip(names, cl))
        bs, s = q.shape[:2]
        q4 = L.rope(q.reshape(bs, s, -1, dh), positions, theta)
        k = L.rope(k, positions, theta)
        if hs == "kv":
            # the cache's kv heads are this rank's: the plain site on them
            o = L.attend(q4, k, v, cfg, plan, positions, cl or None,
                         decode, window)
            return o.reshape(q.shape)
        if hs == "flat":
            c = q4.shape[2]
            n = max(min(hq - r * c, c), 0)        # real heads here
            # padding heads attend to nothing; zeros that still depend on
            # q, k and v, so that every rank's backward takes the same
            # collectives
            o = q4 * 0 + (k.sum() + v.sum()) * 0
            if n:
                kvi = torch.arange(r * c, r * c + n,
                                   device=q4.device) // (hq // hkv)
                o_real = L.attend(q4[:, :, :n], k[:, :, kvi], v[:, :, kvi],
                                  cfg, plan, positions, None, False, window)
                o = o_real if n == c else torch.cat([o_real, o[:, :, n:]],
                                                    dim=2)
        else:
            o = L.attend(q4, k, v, cfg, plan, positions, None, False,
                         window)
        if cl:
            _write_own_positions(cl, k, v, r, int8)
        return o.reshape(q.shape)
    share = None
    if hs == "flat":                # rank 0's real heads among the padding
        c = q.shape[2] // tp
        n = max(min(hq - r * c, c), 0)
        share = hq / n if n else None
    o = region(body, [q.placements], q, k, v, *(cache[n] for n in names),
               model_share=share)
    return _out_proj(params, o, cfg, out_pl, r)


def _write_own_positions(cl, k, v, r: int, int8: bool) -> None:
    """Prefill into a cache whose positions are split over the model
    axis: this rank writes, of the last T positions of ``k``/``v``
    (whole), those whose slot ``p % T`` it holds; ``kpos`` (replicated)
    takes every slot, as ``layers.attend`` writes it."""
    t = cl["kpos"].shape[0]
    tl = cl["k"].shape[1]
    lo = r * tl
    s = k.shape[1]
    s0 = max(s - t, 0)
    p = torch.arange(s0, s)                           # host: no sync
    slot = p % t
    mine = (slot >= lo) & (slot < lo + tl)
    dst = (slot[mine] - lo).to(k.device)
    src = (p[mine] - s0).to(k.device)
    rows = L.cache_rows(k[:, s0:].index_select(1, src),
                        v[:, s0:].index_select(1, src), int8, cl)
    for name, rr in rows.items():
        cl[name].index_copy_(1, dst, rr)
    tailpos = torch.arange(s0, s, dtype=torch.int32, device=k.device)
    cl["kpos"].index_copy_(0, (tailpos % t).long(), tailpos)


def _decode_seq(params, q, k, v, cfg, plan, positions, cache, window,
                out_pl, r: int):
    """Decode over a cache whose positions are split over the model axis:
    the owner of slot ``pos % T`` writes it; every rank scores every head
    against its own positions; the softmax is combined by one max and one
    sum all-reduce (``[acc | l]`` packed)."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    hkv, dh = cfg.n_kv_heads, cfg.d_head
    theta = cfg.rope_theta
    int8 = cache["k"].dtype == torch.int8
    names = sorted(cache)

    def scores(q, k, v, *cl):
        cl = dict(zip(names, cl))
        q = L.rope(q, positions, theta)
        k = L.rope(k, positions, theta)
        kpos = cl["kpos"]
        t, tl = kpos.shape[0], cl["k"].shape[1]
        lo = r * tl
        pos = positions[:1]
        slot = (pos % t).long()
        own = ((slot >= lo) & (slot < lo + tl))[0]
        ls = (slot - lo).clamp(0, tl - 1)
        for name, new in L.cache_rows(k, v, int8, cl).items():
            dst = cl[name]
            dst.index_copy_(1, ls, torch.where(own, new,
                                               dst.index_select(1, ls)))
        kpos.index_copy_(0, slot, pos.to(kpos.dtype))
        kk = L._kv_dequant(cl["k"], cl["k_scale"], q.dtype) if int8 \
            else cl["k"].to(q.dtype)
        kp = kpos[lo:lo + tl]
        valid = (kp >= 0) & (kp <= pos)
        kp = torch.where(valid, kp, pos + t + 10)     # fails causal rule
        qg = L._group(q, hkv)
        s = torch.einsum("bsngd,btnd->bngst", qg, kk).float() \
            * (1.0 / dh ** 0.5)
        s = s + L._mask(pos.expand(q.shape[1]), kp, True, window)
        return s, s.amax(-1)
    cl = [cache[n] for n in names]
    s, m = region(scores, [_at(q, Shard(4)), _at(q, Partial("max"))],
                  q, k, v, *cl)
    m = on_model(m, Replicate())
    vnames = ["v", "v_scale"] if int8 else ["v"]

    def weighted(s, m, cv, vs=None):
        p = torch.exp(s - m[..., None])
        vv = L._kv_dequant(cv, vs, q.dtype) if int8 else cv.to(q.dtype)
        acc = torch.einsum("bngst,btnd->bngsd", p.to(vv.dtype), vv).float()
        return torch.cat([acc, p.sum(-1)[..., None]], dim=-1)
    pack = region(weighted, [_at(q, Partial())], s, m,
                  *(cache[n] for n in vnames))
    pack = on_model(pack, Replicate())
    wo = fsdp_gather(params["wo"])
    split = model_split({"wo": wo}, {"wo": (0, 1)}, "attn")
    d = wo.placements[_mi(wo.device_mesh)].dim if split else None
    dt = q.dtype

    def out(pack, wo):
        o = pack[..., :dh] / torch.clamp(pack[..., dh:], min=1e-30)
        bs, n, g, s, _ = o.shape
        o = o.permute(0, 3, 1, 2, 4).reshape(bs, s, n * g, dh).to(dt)
        if d is not None:                   # this rank's part of wo's rows
            w = wo.shape[d]
            o = o[..., r * w:(r + 1) * w] if d == 1 \
                else o[:, :, r * w:(r + 1) * w]
        return torch.einsum("bshk,hkd->bsd", o, L.cast_weight(wo, dt))
    y = region(out, [_at(pack, Partial() if split else Replicate())],
               pack, wo)
    return _to(y, out_pl)


def _out_proj(params, o, cfg, out_pl, r: int):
    """``o @ wo`` on the model axis's split of ``wo``: ``o`` (whole heads,
    in q's layout) moves to ``wo``'s layout, the product is a ``Partial``
    sum, reduced onto ``out_pl``."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    hq = cfg.n_heads
    wo = fsdp_gather(params["wo"])
    split = model_split({"wo": wo}, {"wo": (0, 1)}, "attn")
    d = wo.placements[_mi(wo.device_mesh)].dim if split else None
    if d is None:                           # every rank, the whole product
        o = on_model(o, Replicate())
    elif d == 1:
        o = on_model(o, Shard(o.ndim - 1))
    elif o.ndim == 4 and o.shape[2] == hq:
        o = on_model(o, Shard(2))
    else:
        raise ValueError(f"attn.wo split on its heads beside q's layout "
                         f"{tuple(o.shape)}")

    def body(o, wo):
        bs, s = o.shape[:2]
        o4 = o.reshape(bs, s, -1, o.shape[-1])[:, :, :hq]   # pad heads off
        return torch.einsum("bshk,hkd->bsd", o4, wo.to(o4.dtype))
    y = region(body, [_at(o, Partial() if split else Replicate())], o, wo)
    return _to(y, out_pl)


# ---------------------------------------------------------------------------
# MoE
# ---------------------------------------------------------------------------


def moe(params, h, cfg, plan, out_pl):
    """Token-choice MoE with the experts split over the model axis: the
    same assignments kept and dropped as ``layers.run_moe`` on the whole
    batch.  Returns (y, aux)."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    note("moe", "tp")
    m = cfg.moe
    b, s, d = h.shape
    t, k, e = b * s, m.top_k, m.n_experts
    cap = L.moe_capacity(cfg, t)
    dt = L.cdtype(plan)
    x = on_model(h, Replicate())
    router = fsdp_gather(params["router"])
    ws = [fsdp_gather(params[n]) for n in ("wi", "wg", "wo")]
    # the experts split, or (without shard_moe_experts) every one whole
    split = model_split(dict(zip(("router", "wi", "wg", "wo"),
                                 [router, *ws])),
                        {"router": (1,), "wi": (0,), "wg": (0,), "wo": (0,)},
                        "moe")

    def logits(x, router):
        return L.moe_logits(router, x.reshape(-1, d), plan)
    lg = region(logits, [_at(x, Shard(1) if split else Replicate())],
                x, router)
    lg = on_model(lg, Replicate())

    def gates(lg):
        probs, gate, idx = L.moe_gates(lg, k)
        dsum = F.one_hot(idx[:, 0], e).float().sum(0)
        return gate, idx.to(torch.int32), dsum, probs.sum(0)
    stat = _stat(lg)
    gate, idx, dsum, psum = region(gates, [lg.placements, lg.placements,
                                           stat, stat], lg)
    whole = (Replicate(),) * len(stat)
    # the Switch aux loss: first-choice density and mean probability
    aux = e * ((_to(dsum, whole) / t) * (_to(psum, whole) / t)).sum()
    idx_all = _to(idx, whole)                 # gathered over the batch axes
    mesh = x.device_mesh
    j = _row_block(x)
    r = tp_rank(mesh) if split else 0

    def experts(x, idx_all, gate, wi, wg, wo):
        bl, sl, _ = x.shape
        tl = bl * sl
        el = wi.shape[0]
        e0 = r * el
        slot, keep = L.moe_slots(idx_all.long(), e, cap)
        rows = slice(j * tl * k, (j + 1) * tl * k)
        eid = idx_all.reshape(-1)[rows].long()
        mine = keep[rows] & (eid >= e0) & (eid < e0 + el)
        # an expert takes at most one assignment a token (top-k experts
        # are distinct): this rank's tokens fill at most tl of its rows
        capl = min(cap, tl)
        lslot, _ = L.moe_slots(torch.where(mine, eid - e0, el), el + 1,
                               capl)
        lslot = torch.where(mine, lslot, el * capl)
        tok = torch.arange(tl, device=x.device).repeat_interleave(k)
        xt = x.reshape(tl, d)
        buf = torch.zeros((el * capl + 1, d), dtype=dt, device=x.device)
        buf.index_copy_(0, lslot, xt[tok].to(dt))
        buf = buf[:-1].reshape(el, capl, d)
        hh = torch.bmm(buf, L.cast_weight(wi, dt))
        g = torch.bmm(buf, L.cast_weight(wg, dt))
        yb = torch.bmm(F.silu(g) * hh, L.cast_weight(wo, dt))
        yfl = torch.cat([yb.reshape(el * capl, d),
                         torch.zeros((1, d), dtype=dt, device=x.device)])
        y = yfl[lslot] * (gate.reshape(-1, 1).to(dt) * mine[:, None])
        return y.reshape(tl, k, d).sum(1).reshape(bl, sl, d)
    y = region(experts, [_at(x, Partial() if split else Replicate())],
               x, idx_all, gate, *ws)
    return _to(y, out_pl), aux


# ---------------------------------------------------------------------------
# RG-LRU and mamba2 mixers
# ---------------------------------------------------------------------------


#: the RG-LRU's and mamba2's weights: the dim the model axis splits
_RGLRU_SPLIT = {"w_in_x": (1,), "w_in_g": (1,), "conv_w": (1,),
                "conv_b": (0,), "w_a": (1,), "b_a": (0,), "w_x": (1,),
                "b_x": (0,), "lam": (0,), "w_out": (0,)}
_SSM_SPLIT = {"in_proj": (1,), "conv_w": (1,), "conv_b": (0,),
              "norm": (0,), "out_proj": (0,)}


def _need_split(ws: dict, want: dict, what: str) -> None:
    """A mixer whose width the model axis must split (its regions have no
    whole route)."""
    if not model_split(ws, want, what):
        raise ValueError(f"{what}: the model axis splits none of "
                         f"{sorted(ws)}")


def rglru(params, h, cfg, plan, cache, decode: bool, out_pl):
    from torch.distributed.tensor import Partial, Replicate, Shard
    from repro_torch.models import rglru as R
    from repro_torch.models.ssm import _causal_conv
    note("rec", "tp")
    dt = L.cdtype(plan)
    x = on_model(h, Replicate())
    w = {n: fsdp_gather(params[n]) for n in _RGLRU_SPLIT}
    _need_split(w, _RGLRU_SPLIT, "rec")
    conv = [cache["conv"]] if cache is not None else []

    def inputs(x, wx, wg, cw, cb, *conv):
        gate = F.gelu(torch.einsum("bsd,dw->bsw", x, L.cast_weight(wg, dt)),
                      approximate="tanh")
        u = torch.einsum("bsd,dw->bsw", x, L.cast_weight(wx, dt))
        u, new_conv = _causal_conv(u, L.cast_weight(cw, dt),
                                   L.cast_weight(cb, dt),
                                   conv[0] if conv else None)
        if conv:
            conv[0].copy_(new_conv)
        return u, gate
    cols = _at(x, Shard(2))
    u, gate = region(inputs, [cols, cols], x, w["w_in_x"], w["w_in_g"],
                     w["conv_w"], w["conv_b"], *conv)
    uf = on_model(u, Replicate())
    hc = [cache["h"]] if cache is not None else []
    gn = ("w_a", "b_a", "w_x", "b_x", "lam")

    def recur(uf, u, gate, wo, *rest):
        gw = dict(zip(gn, rest[:5]))
        log_a, b = R.rglru_gates(gw, uf, u)
        if decode:
            hs = (torch.exp(log_a[:, 0]) * rest[5] + b[:, 0])[:, None]
        elif plan.rglru_impl == "pallas":
            from repro_torch.kernels import ops as kops
            hs = kops.rglru(log_a, b)
        else:
            hs = R.rglru_scan(log_a, b)
        if len(rest) > 5:
            rest[5].copy_(hs[:, -1])
        y = hs.to(dt) * gate
        return torch.einsum("bsw,wd->bsd", y, L.cast_weight(wo, dt))
    y = region(recur, [_at(x, Partial())], uf, u, gate, w["w_out"],
               *(w[n] for n in gn), *hc)
    return _to(y, out_pl)


def mamba2(params, h, cfg, plan, cache, decode: bool, out_pl):
    from torch.distributed.tensor import Partial, Replicate, Shard
    from repro_torch.models import ssm as S
    note("ssm", "tp")
    dt_c = L.cdtype(plan)
    mesh = h.device_mesh
    r = tp_rank(mesh)
    di, n, nh, hp = cfg.d_inner, cfg.ssm_state, cfg.ssm_nheads, \
        cfg.ssm_headdim
    x = on_model(h, Replicate())
    w = {n: fsdp_gather(params[n]) for n in _SSM_SPLIT}
    _need_split(w, _SSM_SPLIT, "ssm")
    cols = _at(x, Shard(2))
    zx = region(lambda x, wp: torch.einsum("bsd,dw->bsw", x,
                                           L.cast_weight(wp, dt_c)),
                [cols], x, w["in_proj"])
    # in_proj's columns cut across z, x, B, C and dt: the whole
    # activation, then each rank's own parts of it
    zx = on_model(zx, Replicate())
    conv = [cache["conv"]] if cache is not None else []

    def convolve(zx, cw, cb, *conv):
        c = cw.shape[1]                        # the conv weights' columns
        xbc = zx[..., di + r * c:di + (r + 1) * c]
        y, new_conv = S._causal_conv(xbc, L.cast_weight(cw, dt_c),
                                     L.cast_weight(cb, dt_c),
                                     conv[0] if decode else None)
        if conv:
            conv[0].copy_(new_conv)
        return y
    xbc = region(convolve, [cols], zx, w["conv_w"], w["conv_b"], *conv)
    xbc = on_model(xbc, Replicate())
    hl = nh // tp_size(mesh)
    if hl * tp_size(mesh) != nh:
        raise ValueError(f"ssm: {nh} heads do not split over the model axis")
    ssm = [cache["ssm"]] if cache is not None else []
    small = [params[k] for k in ("A_log", "D", "dt_bias")]

    def scan(zx, xbc, a_log, dd, dt_bias, *ssm):
        hh = slice(r * hl, (r + 1) * hl)
        cc = slice(r * hl * hp, (r + 1) * hl * hp)
        bs, s = zx.shape[:2]
        z = zx[..., :di][..., cc]
        dtt = zx[..., 2 * di + 2 * n:][..., hh]
        A = -torch.exp(a_log.float()[hh])
        dt_act = F.softplus(dtt.float() + dt_bias.float()[hh])
        xin = S._silu(xbc[..., :di][..., cc])
        Bm = xbc[..., di:di + n]
        Cm = xbc[..., di + n:]
        if decode:
            xin = xin.reshape(bs, 1, hl, hp)
            hs = ssm[0]
            da = torch.exp(dt_act[:, 0, :] * A)
            dbx = torch.einsum("bhp,bn,bh->bhpn", xin[:, 0].float(),
                               Bm[:, 0].float(), dt_act[:, 0])
            hs = da[..., None, None] * hs + dbx
            y = torch.einsum("bn,bhpn->bhp", Cm[:, 0].float(), hs)
            y = y + dd.float()[hh][None, :, None] * xin[:, 0].float()
            y = y[:, None].to(dt_c)
            ssm[0].copy_(hs)
        else:
            xh = xin.reshape(bs, s, hl, hp)
            if plan.ssm_impl == "pallas":
                from repro_torch.kernels import ops as kops
                y, hstate = kops.ssd(xh, dt_act, A, Bm, Cm,
                                     chunk=cfg.ssm_chunk)
            else:
                y, hstate = S.ssd_chunked(xh, dt_act, A, Bm, Cm,
                                          cfg.ssm_chunk)
            y = y + dd.to(y.dtype)[hh][None, None, :, None] * xh
            if ssm:
                ssm[0].copy_(hstate)
        y32 = y.reshape(bs, s, hl * hp).float() * F.silu(z.float())
        return y32, y32.square().sum(-1, keepdim=True)
    y32, ss = region(scan, [cols, _at(x, Partial())], zx, xbc, *small, *ssm)
    ss = on_model(ss, Replicate())

    def out(y32, ss, nw, wo):
        y32 = y32 * torch.rsqrt(ss / di + 1e-6)
        y = (y32 * nw.float()).to(dt_c)
        return torch.einsum("bsw,wd->bsd", y, L.cast_weight(wo, dt_c))
    y = region(out, [_at(x, Partial())], y32, ss, w["norm"], w["out_proj"])
    return _to(y, out_pl)


# ---------------------------------------------------------------------------
# Embedding, logits and the loss
# ---------------------------------------------------------------------------


def embed(params, batch, cfg, plan, rules):
    """The step's inputs embedded on the shards: a ``Partial`` (vocab-split
    table) or column-split (B,S,d) ``DTensor`` for the caller to
    constrain onto the residual stream."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    note("embed", "tp")
    dt = L.cdtype(plan)
    mesh = rules.mesh
    r = tp_rank(mesh)
    if cfg.frontend == "audio_frames":
        f = batched(batch["features"], rules)
        w = fsdp_gather(params.frontend)
        split = model_split({"frontend": w}, {"frontend": (1,)}, "embed")
        return region(lambda f, w: f.to(dt) @ L.cast_weight(w, dt),
                      [_at(f, Shard(2) if split else Replicate())], f, w)
    tok = batched(batch["tokens"], rules)
    w = fsdp_gather(params.embed)
    split = model_split({"embed": w}, {"embed": (0, 1)}, "embed")
    if split and split_dim(w, "embed") == 0:        # the vocab is split
        def rows(tok, w):
            vl = w.shape[0]
            loc = tok.long() - r * vl
            ok = (loc >= 0) & (loc < vl)
            got = w[loc.clamp(0, vl - 1)]
            return torch.where(ok[..., None], got, got.new_zeros(())).to(dt)
        h = region(rows, [_at(tok, Partial())], tok, w)
    else:
        h = region(lambda tok, w: w[tok].to(dt),
                   [_at(tok, Shard(2) if split else Replicate())], tok, w)
    if cfg.frontend == "vision_patches" and "patch_embeds" in batch:
        h = on_model(h, Replicate())
        pe = batched(batch["patch_embeds"], rules)
        if pe.shape[1] > h.shape[1]:
            raise ValueError(f"{pe.shape[1]} patch embeddings do not fit a "
                             f"prompt of {h.shape[1]} positions")
        h = region(lambda h, pe: torch.cat([pe.to(dt), h[:, pe.shape[1]:]],
                                           dim=1), [h.placements], h, pe)
    return h


def logits(params, h, cfg, rules):
    """(B,S,V) logits: vocab-sharded where the output matrix splits its
    vocab over the model axis, else the ``Partial`` sum of its
    ``d``-split rows, reduced; constrained as the reference constrains
    them."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    note("logits", "tp")
    tied = cfg.tie_embeddings
    w = fsdp_gather(params.embed if tied else params.lm_head)

    def body(x, w):
        return torch.einsum("bsd,dv->bsv", x,
                            L.cast_weight(w.T if tied else w, x.dtype))
    name = "embed" if tied else "lm_head"
    split = model_split({name: w}, {name: (0, 1)}, "logits")
    if not split or split_dim(w, name) == (0 if tied else 1):
        # the vocab split, or the whole matrix on every model rank
        x = on_model(h, Replicate())
        out = region(body, [_at(x, Shard(2) if split else Replicate())],
                     x, w)
    else:                                          # d_model split
        x = on_model(h, Shard(2))
        out = region(body, [_at(x, Partial())], x, w)
    return constrain(out, rules, "batch", None, "vocab")


def cross_entropy(lg, targets, rules):
    """``models.model.cross_entropy`` over logits that may be
    vocab-sharded: the max and the sum of the log-sum-exp, and the
    target's logit, are each rank's own, reduced by a max and a sum
    all-reduce."""
    from torch.distributed.tensor import Partial, Replicate
    note("loss", "tp")
    tg = batched(targets, rules)
    split = lg.placements[_mi(lg.device_mesh)].is_shard()
    r = tp_rank(lg.device_mesh) if split else 0
    m = region(lambda lg: lg.float().amax(-1, keepdim=True),
               [_at(lg, Partial("max") if split else Replicate())], lg)
    m = on_model(m, Replicate()).detach()

    def sums(lg, m, tg):
        lg = lg.float()
        vl = lg.shape[-1]
        s = torch.exp(lg - m).sum(-1)
        loc = tg.long() - r * vl
        ok = (loc >= 0) & (loc < vl)
        ll = torch.gather(lg, -1, loc.clamp(0, vl - 1).unsqueeze(-1))[..., 0]
        return torch.stack([s, torch.where(ok, ll, ll.new_zeros(()))], -1)
    sl = region(sums, [_at(lg, Partial() if split else Replicate())],
                lg, m, tg)
    sl = on_model(sl, Replicate())
    lse = torch.log(sl[..., 0]) + m[..., 0]
    return (lse - sl[..., 1]).mean()
