"""The captured decode step's frozen weight casts on the card
(``serve.engine.DecodeGraph`` with ``models.layers.FrozenCasts``).

A replay equals the eager step that casts at every call, bit for bit; its
capture recorded the weights' casts as frozen and no cast byte; where the
free memory cannot hold the copies the graph casts at every replay, and
still equals the eager step bit for bit; an in-place write to a frozen
weight makes the serve loop capture again.  The CPU counterparts are in
``tests/test_torch_frozen_casts.py``.

jax-free.  Every test takes the ``cuda`` fixture, which skips (with the
reason) when no CUDA device is visible; on the H100 run them with
``python -m pytest -m cuda tests/test_torch_frozen_casts_cuda.py``.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch import obs
from repro_torch.configs import get_config
from repro_torch.models.model import Model

pytestmark = pytest.mark.cuda

#: replays held to as many eager steps
STEPS = 4
#: the casts of qwen2-7b's decode step at 2 layers: 2 x (wq, wk, wv, bq,
#: bk, bv, wo, wi, wg, wo) + the head's lm_head
CASTS = 2 * 10 + 1


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; on the card run python -m pytest "
                    "-m cuda tests/test_torch_frozen_casts_cuda.py")
    obs.disable()
    try:
        yield torch.device("cuda")
    finally:
        obs.disable()


def _qwen2_two_layers(dev):
    """qwen2-7b at its published widths, 2 of its 28 layers, under the
    serve cell's plan (the swiglu decode kernel, bf16 compute and cache,
    f32 weights)."""
    cfg = get_config("qwen2-7b")
    cfg = dataclasses.replace(cfg, n_layers=2, plan=cfg.plan.replace(
        attn_impl="pallas", mlp_impl="pallas"))
    model = Model(cfg, device=dev)
    return model, model.init(torch.Generator(device=dev).manual_seed(0))


def _graph_against_eager(model, params, dev):
    """A ``DecodeGraph`` and STEPS replays of it against as many eager
    steps on a copy of the cache: logits and every cache tensor bit for
    bit.  Returns the graph."""
    from repro_torch.serve.engine import DecodeGraph, make_decode_step
    slots = 8
    cache = model.init_cache(slots, 64)
    eager = [{k: v.clone() for k, v in c.items()} for c in cache]
    tok = torch.zeros((slots, 1), dtype=torch.int32, device=dev)
    pos = torch.zeros((), dtype=torch.int32, device=dev)
    graph = DecodeGraph(model, params, cache, tok, pos)
    step = make_decode_step(model)
    rng = np.random.default_rng(3)
    for i in range(STEPS):
        tok.copy_(torch.from_numpy(rng.integers(
            2, model.cfg.vocab_size, (slots, 1)).astype(np.int32)))
        pos.fill_(i)
        got = graph.replay().clone()
        with torch.no_grad():
            want = step(params, {"tokens": tok, "pos": pos}, eager)[0]
        assert torch.equal(got, want), i
        for c, e in zip(cache, eager):
            for k in c:
                assert torch.equal(c[k], e[k]), (i, k)
    return graph


def test_a_frozen_replay_equals_the_per_call_step_bit_for_bit(cuda):
    model, params = _qwen2_two_layers(cuda)
    graph = _graph_against_eager(model, params, cuda)
    assert graph.frozen is not None and not graph.stale()
    # the bf16 copies of every cast weight: each f32 element in 2 bytes
    f32 = sum(p.numel() for n, p in params.named_parameters()
              if n != "embed" and "norm" not in n)
    assert graph.frozen_bytes == 2 * f32


def test_a_frozen_capture_records_no_cast_byte(cuda):
    _, mx = obs.enable()
    model, params = _qwen2_two_layers(cuda)
    before = mx.counter_values()
    graph = _graph_against_eager(model, params, cuda)
    counts = graph.recorded.counts
    assert counts.get("weights.casts", 0) == 0
    assert counts.get("weights.cast_bytes", 0) == 0
    assert counts["weights.frozen_casts"] == CASTS
    assert counts["weights.frozen_bytes"] == 2 * graph.frozen_bytes
    # the warm-up cast once, the eager steps at every call; the replays
    # added no cast
    got = {k: v - before.get(k, 0) for k, v in mx.counter_values().items()}
    assert got["weights.casts"] == (1 + STEPS) * CASTS
    assert got["weights.frozen_casts"] == STEPS * CASTS


def test_without_the_memory_for_the_copies_it_casts_at_every_replay(
        cuda, monkeypatch):
    _, mx = obs.enable()
    model, params = _qwen2_two_layers(cuda)
    total = torch.cuda.mem_get_info(cuda)[1]
    monkeypatch.setattr(torch.cuda, "mem_get_info",
                        lambda dev=None: (1 << 30, total))
    graph = _graph_against_eager(model, params, cuda)
    assert graph.frozen is None and graph.frozen_bytes == 0
    assert not graph.stale()
    counts = graph.recorded.counts
    assert counts["weights.casts"] == CASTS
    assert "weights.frozen_casts" not in counts


def test_a_written_weight_makes_the_loop_capture_again(cuda):
    from repro_torch.serve.engine import ServeLoop, make_decode_step
    model, params = _qwen2_two_layers(cuda)
    loop = ServeLoop(model, params, batch_slots=2, max_seq=16)
    eager = [{k: v.clone() for k, v in c.items()} for c in loop.cache]
    step = make_decode_step(model)
    toks = np.full((2, 1), 7, np.int32)

    def both(pos):
        got = loop.decode(toks, pos).clone()
        with torch.no_grad():
            want = step(params, {"tokens": torch.from_numpy(toks).cuda(),
                                 "pos": pos}, eager)[0]
        assert torch.equal(got, want), pos
    both(0)
    first = loop.graph
    assert first.frozen is not None
    both(1)
    assert loop.graph is first
    with torch.no_grad():
        params.layers[0].mixer["wq"].mul_(0.5)
    assert first.stale()
    both(2)
    assert loop.graph is not first and not loop.graph.stale()
