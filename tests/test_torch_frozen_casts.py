"""The weights' casts frozen for a step whose weights do not change
(``models.layers.FrozenCasts``), on the CPU at reduced sizes.

A decode step served under the memo, after one recorded step, leaves the
logits and the cache of the same steps casting at every call, bit for
bit, for a dense model, an SSM and an RG-LRU model, and on a one-rank
gloo mesh (``DTensor`` parameters and cache); recording counts as casts
exactly what serving then counts as frozen casts, and serving casts no
byte; an in-place write to a weight makes the memo stale, and a
``ServeLoop`` whose graph froze it captures again before its next step;
the captured step freezes only where the free memory holds the copies.
The card's counterparts (``DecodeGraph`` itself) are in
``tests/test_torch_frozen_casts_cuda.py``.
"""
import dataclasses
import gc
import weakref

import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro_torch import obs
from repro_torch.configs import get_config
from repro_torch.configs.optimized import optimized_plan
from repro_torch.launch import mesh as M
from repro_torch.models import layers as L
from repro_torch.models.model import Model
from repro_torch.parallel.param_sharding import distribute
from repro_torch.parallel.sharding import is_dtensor, make_rules
from repro_torch.serve import engine
from repro_torch.serve.engine import ServeLoop, make_decode_step

#: a dense model and one each of SSM and RG-LRU layers, under the offload
#: plan the card serves (its kernels' plain versions here)
KINDS = {"dense": ("tiny-test", False), "ssm": ("mamba2-1.3b", True),
         "rglru": ("recurrentgemma-9b", True)}
OFFLOAD = dict(attn_impl="pallas", mlp_impl="pallas", ssm_impl="pallas",
               rglru_impl="pallas")
STEPS = 4


def _model(kind, seed=0):
    arch, reduced = KINDS[kind]
    cfg = get_config(arch, reduced)
    cfg = dataclasses.replace(cfg, plan=cfg.plan.replace(**OFFLOAD))
    model = Model(cfg, device="cpu")
    params = model.init(torch.Generator().manual_seed(seed))
    assert {p.dtype for p in params.parameters()} == {torch.float32}
    assert L.cdtype(model.plan) == torch.bfloat16
    return model, params


def _clone(cache):
    return [{k: v.clone() for k, v in c.items()} for c in cache]


def _batch(model, pos, seed):
    toks = np.random.default_rng(seed).integers(
        2, model.cfg.vocab_size, (2, 1)).astype(np.int32)
    return {"tokens": torch.from_numpy(toks),
            "pos": torch.tensor(pos, dtype=torch.int32)}


def _record(model, params, cache, rules=None, watch=()):
    """A memo that recorded one step on a copy of ``cache``."""
    frozen = L.FrozenCasts(watch)
    with torch.no_grad(), frozen.recording():
        make_decode_step(model, rules)(params, _batch(model, 0, 99),
                                       _clone(cache))
    return frozen


def _a_cast_weight(params):
    """The first matrix of the first layer, which every step casts."""
    return next(p for p in params.layers[0].parameters() if p.dim() == 2)


@pytest.fixture
def traced():
    try:
        yield obs.enable()[1]
    finally:
        obs.disable()


@pytest.mark.parametrize("kind", KINDS)
def test_frozen_steps_equal_the_per_call_steps_bit_for_bit(kind):
    model, params = _model(kind)
    cache = model.init_cache(2, 16)
    frozen = _record(model, params, cache)
    assert frozen.nbytes > 0
    step = make_decode_step(model)
    per_call = _clone(cache)
    with torch.no_grad():
        for pos in range(STEPS):
            b = _batch(model, pos, pos)
            want = step(params, b, per_call)[0]
            with frozen.serving():
                got = step(params, b, cache)[0]
            assert torch.equal(got, want), pos
            for c, w in zip(cache, per_call):
                assert c.keys() == w.keys()
                for k in c:
                    assert torch.equal(c[k], w[k]), (pos, k)


@pytest.mark.parametrize("kind", KINDS)
def test_serving_freezes_exactly_what_recording_cast(kind, traced):
    """Recording casts (and counts) as ever; serving counts the same casts
    as frozen, their source bytes as frozen bytes, and casts nothing.  The
    copies are at most ``cast_bound``'s, in the compute dtype."""
    mx = traced
    model, params = _model(kind)
    cache = model.init_cache(2, 16)
    before = mx.counter_values()
    frozen = _record(model, params, cache)
    rec = {k: v - before.get(k, 0) for k, v in mx.counter_values().items()}
    assert rec["weights.casts"] > 0
    assert rec["weights.cast_bytes"] == 2 * frozen.nbytes
    assert frozen.nbytes <= L.cast_bound(params, torch.bfloat16)[0]
    for n in (1, 2):
        before = mx.counter_values()
        with torch.no_grad(), frozen.serving():
            make_decode_step(model)(params, _batch(model, n, n), cache)
        got = {k: v - before.get(k, 0)
               for k, v in mx.counter_values().items()}
        assert got.get("weights.casts", 0) == 0
        assert got.get("weights.cast_bytes", 0) == 0
        assert got["weights.frozen_casts"] == rec["weights.casts"]
        assert got["weights.frozen_bytes"] == rec["weights.cast_bytes"]


@pytest.mark.parametrize("kind", KINDS)
def test_an_in_place_write_to_a_weight_makes_the_memo_stale(kind):
    model, params = _model(kind)
    cache = model.init_cache(2, 16)
    frozen = _record(model, params, cache)
    with torch.no_grad(), frozen.serving():
        make_decode_step(model)(params, _batch(model, 1, 1), cache)
    assert not frozen.stale()
    with torch.no_grad():
        _a_cast_weight(params).mul_(0.5)
    assert frozen.stale()


def test_the_memo_keeps_no_weight_alive():
    """The copies live with the memo, the weights do not: once they are
    freed the memo reads stale, and serves a cast per call."""
    model, params = _model("dense")
    cache = model.init_cache(2, 16)
    frozen = _record(model, params, cache)
    nbytes = frozen.nbytes
    weight = weakref.ref(_a_cast_weight(params))
    del params
    gc.collect()
    assert weight() is None
    assert frozen.stale() and frozen.nbytes == nbytes


class _EagerGraph:
    """``DecodeGraph`` as the CPU can run it: the warm-up records the
    casts on a copy of the cache, and each replay is the eager step under
    the memo serving."""
    made = 0

    def __init__(self, model, params, cache, tokens, pos, rules=None):
        type(self).made += 1
        self.step = make_decode_step(model, rules)
        self.args = (params, {"tokens": tokens, "pos": pos}, cache)
        self.frozen = L.FrozenCasts()
        with torch.no_grad(), self.frozen.recording():
            self.step(params, self.args[1], _clone(cache))

    def stale(self):
        return self.frozen.stale()

    def replay(self):
        with torch.no_grad(), self.frozen.serving():
            return self.step(*self.args)[0]


class _Card:
    type = "cuda"


@pytest.mark.parametrize("kind", KINDS)
def test_serve_loop_freezes_again_after_a_weight_is_written(kind,
                                                            monkeypatch):
    """The loop's graph is kept while its weights stand; an in-place write
    to one makes the next step capture again, and serve the new weights:
    the per-call step's logits and cache, bit for bit."""
    monkeypatch.setattr(engine, "DecodeGraph", _EagerGraph)
    model, params = _model(kind)
    loop = ServeLoop(model, params, batch_slots=2, max_seq=16, device="cpu")
    loop.device = _Card()                 # take the captured path
    per_call = _clone(loop.cache)
    step = make_decode_step(model)
    made = _EagerGraph.made

    def both(pos):
        b = _batch(model, pos, 10 + pos)
        got = loop.decode(b["tokens"].numpy(), pos).clone()
        with torch.no_grad():
            want = step(params, b, per_call)[0]
        assert torch.equal(got, want), pos
        for c, w in zip(loop.cache, per_call):
            for k in c:
                assert torch.equal(c[k], w[k]), (pos, k)
    both(0)
    first = loop.graph
    both(1)
    assert loop.graph is first and _EagerGraph.made == made + 1
    with torch.no_grad():
        params.final_norm["scale"].mul_(0.5)    # read in f32, never cast
    both(2)
    assert loop.graph is first
    with torch.no_grad():
        _a_cast_weight(params).mul_(0.5)
    both(3)
    assert loop.graph is not first and _EagerGraph.made == made + 2
    both(4)
    assert _EagerGraph.made == made + 2


@pytest.mark.parametrize("kind", KINDS)
def test_the_captured_step_freezes_only_where_the_copies_fit(kind,
                                                             monkeypatch):
    """``DecodeGraph``'s rule: the free memory must hold every floating
    parameter not in the compute dtype, in it, with the warm-up's copy
    of the cache and the largest copy again to spare."""
    model, params = _model(kind)
    cache = model.init_cache(2, 16)
    total, largest = L.cast_bound(params, torch.bfloat16)
    warm = sum(v.numel() * v.element_size()
               for c in cache for v in c.values())
    assert 0 < largest < total
    need = total + warm + largest
    for free, fits in ((need, True), (need - 1, False), (0, False)):
        monkeypatch.setattr(torch.cuda, "mem_get_info",
                            lambda dev, free=free: (free, 80 << 30))
        memo = engine._freeze(params, torch.bfloat16, cache,
                              torch.device("cpu"))
        assert (memo is not None) is fits, free
    # nothing to freeze where the weights are in the compute dtype
    assert L.cast_bound(params, torch.float32) == (0, 0)
    assert engine._freeze(params, torch.float32, cache,
                          torch.device("cpu")) is None


@pytest.fixture
def cpu_host_mesh():
    """``make_host_mesh`` on the CPU (its own one-rank gloo group), torn
    down after the test."""
    assert not dist.is_initialized()
    try:
        yield M.make_host_mesh(device="cpu")
    finally:
        M.destroy_host_mesh()
    assert not dist.is_initialized()


@pytest.mark.parametrize("kv", ["bfloat16", "int8"])
def test_frozen_rules_steps_equal_the_per_call_rules_steps(cpu_host_mesh,
                                                           kv):
    """Under rules, on ``DTensor`` parameters and cache: the frozen steps
    leave the per-call steps' logits and every cache shard, bit for bit,
    and an in-place write to a ``DTensor`` weight makes the memo stale."""
    cfg = get_config("tiny-test")
    plan = cfg.plan if kv == "bfloat16" else optimized_plan("tiny-test",
                                                        "decode")
    model = Model(dataclasses.replace(cfg, plan=plan), plan, "cpu")
    rules = make_rules(model.cfg, cpu_host_mesh, plan)
    params = model.init(torch.Generator().manual_seed(0))
    params, _, cache = distribute(rules, params,
                                  cache=model.init_cache(2, 16))
    dparams = [p for p in params.parameters() if is_dtensor(p)]
    assert dparams
    frozen = _record(model, params, cache, rules, watch=dparams)
    assert frozen.nbytes > 0
    step = make_decode_step(model, rules)
    per_call = _clone(cache)
    with torch.no_grad():
        for pos in range(STEPS):
            b = _batch(model, pos, pos)
            want = step(params, b, per_call)[0]
            with frozen.serving():
                got = step(params, b, cache)[0]
            assert torch.equal(got.to_local(), want.to_local()), pos
            for c, w in zip(cache, per_call):
                for k in c:
                    assert torch.equal(c[k].to_local(), w[k].to_local()), \
                        (pos, k)
    assert not frozen.stale()
    p = _a_cast_weight(params)
    assert is_dtensor(p)
    with torch.no_grad():
        p.mul_(0.5)                       # moves the DTensor's counter
    assert frozen.stale()
    again = _record(model, params, cache, rules)      # no DTensor watched
    with torch.no_grad():
        _a_cast_weight(params).to_local().mul_(0.5)   # moves the local's
    assert again.stale()
