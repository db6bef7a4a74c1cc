"""The steps under rules as the port runs them, on the CPU's one-rank gloo
mesh (``launch.mesh.make_host_mesh(device="cpu")``, every placement
replicated).

The card captures these steps as CUDA graphs (``train.step.TrainGraph``,
``serve.engine.DecodeGraph``); on the CPU the same objects run the eager
step through the same buffers, so what is held here is what the graphs
must equal on the card (``tests/test_torch_cuda.py``):

* C13: the measured rung's train trial on a mesh runs
  ``TrainGraph(model, rules)`` on parameters and optimizer state laid out
  on that mesh (``DTensor``s), a ``use_tp`` plan's layers on the
  tensor-parallel regions, and its loss is ``make_train_step(model,
  rules)``'s from the same seed and batch;
* ``TrainGraph(model, rules)`` against ``make_train_step(model, rules)``
  over three steps, bit for bit (loss, gradient norm, every local shard
  of the parameters and the state), for AdamW and int8 Adam with and
  without int8 error feedback, the state keeping its storage and the
  placements it was given.  The eager step's state is laid back at its
  placements between steps (``train.step.pin_state``, the reference's
  ``out_shardings``), as the graph does: int8 Adam's comes back at others,
  on which the eager step cannot take a second step;
* ``donate`` refuses state that comes back at other placements;
* the measured rung's decode trial (``core.backends.DecodeTrial``: static
  token and 0-d position buffers) against the direct eager loop of
  ``Model.decode_step`` with an int position, logits bit for bit, with and
  without a mesh, for a bf16 and an int8 cache; and the trial on
  ``DTensor`` parameters and cache against the plain tensors'.
"""
import dataclasses

import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro_torch.configs import CARD_SHAPES, ShapeSpec, get_config
from repro_torch.configs.optimized import optimized_plan
from repro_torch.core import backends
from repro_torch.launch import mesh as M
from repro_torch.models.model import Model
from repro_torch.parallel.param_sharding import distribute
from repro_torch.parallel.sharding import is_dtensor, make_rules
from repro_torch.parallel.tp import record_routes
from repro_torch.telemetry.sampler import ConstantSource
from repro_torch.train import step as S

#: the layer kinds a ``use_tp`` plan runs on the tensor-parallel regions
TP_KINDS = {"embed", "attn", "mlp", "logits", "loss"}
STEPS = 3


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


def _rung(mesh, **kw):
    return backends.MeasuredBackend(device="cpu", mesh=mesh,
                                    source=ConstantSource(250.0),
                                    window_s=0.0, **kw)


def _local(t):
    return t.to_local() if is_dtensor(t) else t


def _whole(t):
    return t.full_tensor() if is_dtensor(t) else t


def _state_tensors(state, prefix=""):
    out = {}
    for k, v in state.items():
        if isinstance(v, dict):
            out.update(_state_tensors(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out


def test_c13_train_trial_runs_on_its_mesh(cpu_host_mesh, monkeypatch):
    """The measured rung given a mesh runs its train trial there: the
    step sees ``DTensor`` parameters on the mesh, the ``use_tp`` plan's
    layers take the tensor-parallel regions, and the last call's loss is
    ``make_train_step(model, rules)``'s after as many steps from the same
    seed and batch."""
    monkeypatch.setitem(CARD_SHAPES, "cpu_train",
                        ShapeSpec("cpu_train", 16, 2, "train"))
    cfg = get_config("tiny-test")
    plan = cfg.plan
    assert plan.use_tp
    seen = []

    class Spy(S.TrainGraph):
        def __call__(self, params, opt_state, batch):
            seen.append(params.embed)
            return super().__call__(params, opt_state, batch)
    monkeypatch.setattr(S, "TrainGraph", Spy)
    rung = _rung(cpu_host_mesh, min_calls=2)
    with record_routes() as routes:
        m = rung.measure(backends.MeasureContext(cfg, "cpu_train"), plan)
    assert m.ok and len(seen) == m.trace.meta["calls"] + 1
    assert all(is_dtensor(p) and p.device_mesh == cpu_host_mesh
               for p in seen)
    assert routes == dict.fromkeys(TP_KINDS, "tp")

    model = Model(dataclasses.replace(cfg, plan=plan), plan, "cpu")
    rules = make_rules(model.cfg, cpu_host_mesh, plan)
    params = model.init(torch.Generator().manual_seed(rung.seed))
    opt = S.make_opt_init(model)(params)
    params, opt, _ = distribute(rules, params, opt)
    toks = torch.from_numpy(np.random.default_rng(rung.seed).integers(
        0, cfg.vocab_size, (2, 17)).astype(np.int32))
    batch = {"tokens": toks[:, :-1], "targets": toks[:, 1:]}
    step = S.make_train_step(model, rules)
    for _ in seen:
        params, opt, met = step(params, opt, batch)
    want = met["loss"].full_tensor().reshape(1).float()
    assert torch.equal(rung.outputs[backends.plan_tag(plan)], want)


#: the optimizers held, with and without int8 error feedback
RULES_OPT_CASES = [(o, c) for o in ("adamw", "adam8")
                   for c in ("none", "int8_ef")]


def _rules_model(opt, compress, mesh):
    cfg = get_config("tiny-test")
    cfg = dataclasses.replace(cfg, optimizer=opt)
    cfg = dataclasses.replace(cfg, plan=cfg.plan.replace(
        grad_compress=compress))
    model = Model(cfg, device="cpu")
    return model, make_rules(cfg, mesh, cfg.plan)


def _rules_state(model, rules):
    params = model.init(torch.Generator().manual_seed(0))
    params, opt, _ = distribute(rules, params,
                                S.make_opt_init(model)(params))
    return params, opt


def _batches(cfg, seed=3):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(STEPS):
        t = torch.from_numpy(rng.integers(0, cfg.vocab_size, (4, 17))
                             .astype(np.int32))
        out.append({"tokens": t[:, :-1], "targets": t[:, 1:]})
    return out


@pytest.mark.parametrize("opt,compress", RULES_OPT_CASES)
def test_rules_train_graph_equals_the_rules_step_bit_for_bit(
        cpu_host_mesh, opt, compress):
    model, rules = _rules_model(opt, compress, cpu_host_mesh)
    params, state = _rules_state(model, rules)
    gparams, gstate = _rules_state(model, rules)
    given = _state_tensors(gstate)
    ptrs = {k: _local(t).data_ptr() for k, t in given.items()}
    layout = {k: (t.device_mesh, t.placements) for k, t in given.items()}
    step, graph = S.make_train_step(model, rules), S.TrainGraph(model, rules)
    with record_routes() as routes:
        for i, b in enumerate(_batches(model.cfg)):
            params, new, met = step(params, state, b)
            state = S.pin_state(new, state)
            out_p, out_s, gmet = graph(gparams, gstate, b)
            assert out_p is gparams and out_s is gstate
            for key in ("loss", "grad_norm"):
                assert torch.equal(_whole(gmet[key]), _whole(met[key])), \
                    (i, key)
            want, got = _state_tensors(state), _state_tensors(gstate)
            assert list(got) == list(want)
            for path, t in want.items():
                g = got[path]
                assert (g.device_mesh, g.placements) == layout[path], path
                assert torch.equal(g.to_local(), t.to_local()), (i, path)
            assert {k: _local(t).data_ptr() for k, t in got.items()} == ptrs
            for (n, p), q in zip(params.named_parameters(),
                                 gparams.parameters()):
                assert is_dtensor(q) and q.placements == p.placements, n
                assert torch.equal(q.to_local(), p.to_local()), (i, n)
    assert routes == dict.fromkeys(TP_KINDS, "tp")
    assert int(_whole(gstate["step"])) == STEPS
    assert graph.binds == 1 and graph.graph is None


def test_donate_refuses_state_at_other_placements(cpu_host_mesh):
    """A ``DTensor`` of the state is written shard into shard; one that
    comes back at other placements, or plain, raises and writes
    nothing."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    rep = [Replicate(), Replicate()]
    state = {"m": DTensor.from_local(torch.zeros(4), cpu_host_mesh, rep)}
    local = state["m"].to_local()
    S.donate(state, {"m": DTensor.from_local(torch.ones(4), cpu_host_mesh,
                                             rep)})
    assert state["m"].to_local().data_ptr() == local.data_ptr()
    assert local.tolist() == [1] * 4
    for bad in (DTensor.from_local(torch.full((4,), 2.0), cpu_host_mesh,
                                   [Shard(0), Replicate()]),
                torch.full((4,), 2.0)):
        with pytest.raises(ValueError, match="comes back as"):
            S.donate(state, {"m": bad})
        assert local.tolist() == [1] * 4
    with pytest.raises(ValueError, match="comes back as"):
        S.donate({"m": torch.zeros(4)}, {"m": state["m"]})


def _decode_cfg(kind):
    cfg = get_config("tiny-test")
    plan = cfg.plan if kind == "bfloat16" else optimized_plan("tiny-test",
                                                          "decode")
    assert plan.kv_cache_dtype == kind
    return cfg, plan


@pytest.mark.parametrize("kind", ["bfloat16", "int8"])
@pytest.mark.parametrize("on_mesh", [True, False])
def test_decode_trial_equals_the_direct_loop(request, monkeypatch, kind,
                                             on_mesh):
    """The rung's decode trial, through its static token and 0-d position
    buffers, leaves the logits of the direct loop of ``Model.decode_step``
    with an int position from the same seeded cache and tokens, after as
    many calls, bit for bit; on the CPU it captures nothing."""
    monkeypatch.setitem(CARD_SHAPES, "cpu_decode",
                        ShapeSpec("cpu_decode", 48, 2, "decode"))
    mesh = request.getfixturevalue("cpu_host_mesh") if on_mesh else None
    cfg, plan = _decode_cfg(kind)
    rung = _rung(mesh, min_calls=2, decode_steps=3)
    m = rung.measure(backends.MeasureContext(cfg, "cpu_decode"), plan)
    assert m.ok and m.trace.meta["graph"] is None

    model = Model(dataclasses.replace(cfg, plan=plan), plan, "cpu")
    rules = None if mesh is None else make_rules(model.cfg, mesh, plan)
    params = rung.params[cfg.name]
    n, s0 = 3, 45
    cache = model.init_cache(2, 48)
    backends._fill_cache(cache, s0, torch.Generator().manual_seed(0))
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, n)).astype(np.int32))
    for _ in range(m.trace.meta["calls"] + 1):
        for i in range(n):
            logits, _ = model.decode_step(
                params, {"tokens": toks[:, i:i + 1], "pos": s0 + i}, cache,
                rules)
    assert torch.equal(rung.outputs[backends.plan_tag(plan)],
                       logits.float())


@pytest.mark.parametrize("kind", ["bfloat16", "int8"])
def test_decode_trial_on_dtensors_equals_plain_tensors(cpu_host_mesh, kind):
    """``DecodeTrial`` under rules on parameters and a cache laid out on
    the mesh (``DTensor``s) against the trial on plain tensors: every
    call's logits and every cache tensor bit for bit, the cache written in
    place at its placements."""
    cfg, plan = _decode_cfg(kind)
    model = Model(dataclasses.replace(cfg, plan=plan), plan, "cpu")
    rules = make_rules(model.cfg, cpu_host_mesh, plan)
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (2, 3)).astype(np.int32))

    def trial(on_mesh):
        params = model.init(torch.Generator().manual_seed(0))
        cache = model.init_cache(2, 24)
        backends._fill_cache(cache, 21, torch.Generator().manual_seed(2))
        if on_mesh:
            params, _, cache = distribute(rules, params, cache=cache)
        return backends.DecodeTrial(model, params, cache, toks, 21,
                                    lambda: None, rules if on_mesh else None)
    plain, dist_trial = trial(False), trial(True)
    ptrs = [{k: v.to_local().data_ptr() for k, v in c.items()}
            for c in dist_trial.cache]
    for _ in range(2):
        want, got = plain(), dist_trial()
        assert torch.equal(_whole(got), want)
    for c, w, ptr in zip(dist_trial.cache, plain.cache, ptrs):
        for k, t in c.items():
            assert is_dtensor(t) and t.to_local().data_ptr() == ptr[k], k
            assert torch.equal(t.to_local(), w[k]), k
