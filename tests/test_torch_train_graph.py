"""``train.step.TrainGraph`` on the CPU: the port's counterpart of the
reference's ``jax.jit(make_train_step(model), donate_argnums=(0, 1))``.

On the CPU there is no capture, so a call is the eager step and the
write-back of the new optimizer state into the tensors it was given.
Held here:

* against ``make_train_step`` on the same seeded weights and batches, for
  each optimizer with and without int8 error feedback: three consecutive
  steps bit for bit (loss, gradient norm, every parameter and every state
  tensor), the state keeping its storage and its step counter reading 1,
  2, 3;
* against three steps of the reference's jitted step with donated
  buffers on tiny-test in f32 (AdamW and Adafactor), the state carried
  from step to step on both sides: at the tolerances of
  ``test_torch_train.py::test_two_train_steps_equal_the_reference`` (the
  loss and gradient norm rel 1e-5, ``_hold_params``, ``_hold_state``),
  each step against the reference's parameters before it and its
  gradients there.  The quantized paths (int8 Adam, int8 error feedback)
  are not carried against the reference: a value at an int8 rounding
  boundary takes the next code in one package (``QUANT_SHARE`` there),
  and once carried that code moves the next steps' loss beyond rel 1e-5
  (int8 Adam on tiny-test: 3.7e-4 at the third step).  Nor is the 8-unit
  config of that test at its learning rate of 1e-2: its first step moves
  one element whose gradient is rounding noise (2e-8) by 0.08 lr in one
  package, which that test allows, and the next step's gradient norm then
  differs at 5e-5.  Their donation is held bit for bit against
  ``make_train_step``, itself held step by step to the reference there;
* a batch of another shape raises, new state re-binds, the dry run's
  meta-device rules step runs eagerly (never captured), and the launch
  bookkeeping that the card's graphs share.  (Under rules on a real
  mesh: ``test_torch_rules_graph.py``.)

The card's side (capture, replays bit for bit against the eager step
under deterministic algorithms, launches a replay adds, a host sync in the
step) is in ``tests/test_torch_cuda.py``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_train import (OPT_CASES, _f32, _hold_params, _hold_state,
                              _leaf_paths, _stacked_cfgs, _state_to_port)

from repro.configs import get_config as jget
from repro.models.model import Model as JModel
from repro.train.step import make_opt_init as j_opt_init
from repro.train.step import make_train_step as j_train_step
from repro_torch.configs import get_config
from repro_torch.convert import params_from_jax
from repro_torch.kernels import swiglu as SG
from repro_torch.kernels._build import add_launches, recorded_launches
from repro_torch.models.model import Model
from repro_torch.train.step import (TrainGraph, donate, make_opt_init,
                                    make_train_step)

STEPS = 3


def _batches(cfg, n=STEPS, rows=4, seq=16, seed=3):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        t = rng.integers(0, cfg.vocab_size, (rows, seq + 1)).astype(np.int32)
        out.append({"tokens": t[:, :-1], "targets": t[:, 1:]})
    return out


def _torch(batch):
    return {k: torch.from_numpy(np.ascontiguousarray(v))
            for k, v in batch.items()}


def _state_tensors(state, prefix="") -> dict:
    """path -> tensor of every tensor of a nested state dict."""
    out = {}
    for k, v in state.items():
        if isinstance(v, dict):
            out.update(_state_tensors(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out


def _fresh(opt, compress):
    _, cfg = _stacked_cfgs(opt, compress)
    model = Model(cfg, device="cpu")
    params = model.init(torch.Generator().manual_seed(0))
    return model, params, make_opt_init(model)(params)


@pytest.mark.parametrize("opt,compress", OPT_CASES)
def test_train_graph_equals_the_eager_step_bit_for_bit(opt, compress):
    model, params, state = _fresh(opt, compress)
    _, gparams, gstate = _fresh(opt, compress)
    step, graph = make_train_step(model), TrainGraph(model)
    for b in _batches(model.cfg):
        params, state, met = step(params, state, _torch(b))
        gparams, gstate, gmet = graph(gparams, gstate, _torch(b))
        for key in ("loss", "grad_norm"):
            assert torch.equal(gmet[key], met[key]), key
        want = _state_tensors(state)
        got = _state_tensors(gstate)
        assert list(got) == list(want)
        for path, t in want.items():
            assert got[path].dtype == t.dtype and torch.equal(got[path], t), \
                path
        for (n, p), q in zip(params.named_parameters(), gparams.parameters()):
            assert torch.equal(q, p), n
    assert graph.binds == 1 and graph.graph is None


@pytest.mark.parametrize("opt,compress", OPT_CASES)
def test_train_graph_state_keeps_its_storage(opt, compress):
    """The donated state: every tensor of it (the step counter, int8 Adam's
    codes and scales, Adafactor's factors, the error buffers) is the same
    tensor with the same storage after each step, and the counter
    advances."""
    model, params, state = _fresh(opt, compress)
    tensors = _state_tensors(state)
    ptrs = {k: t.data_ptr() for k, t in tensors.items()}
    pptrs = [p.data_ptr() for p in params.parameters()]
    graph = TrainGraph(model)
    for i, b in enumerate(_batches(model.cfg)):
        out_params, out_state, _ = graph(params, state, _torch(b))
        assert out_params is params and out_state is state
        now = _state_tensors(state)
        assert all(now[k] is t for k, t in tensors.items())
        assert {k: t.data_ptr() for k, t in now.items()} == ptrs
        assert [p.data_ptr() for p in params.parameters()] == pptrs
        assert int(state["step"]) == i + 1
        assert not any(p.requires_grad for p in params.parameters())


#: the optimizers carried against the reference's donated step
DONATED_OPTS = ("adamw", "adafactor")


def _tiny_cfgs(opt):
    def mk(c):
        return _f32(dataclasses.replace(c, optimizer=opt))
    return mk(jget("tiny-test")), mk(get_config("tiny-test"))


@pytest.fixture(scope="module")
def donated_twins():
    """opt -> the reference's three steps under
    ``jax.jit(..., donate_argnums=(0, 1))`` from seeded weights, the state
    carried: its initial parameters and state, then for each step the
    batch, the metrics, the gradients at the parameters before it, the
    parameters before it and the parameters and state after it (numpy
    copies, taken before the next step donates the buffers)."""
    out = {}
    for opt in DONATED_OPTS:
        jcfg, _ = _tiny_cfgs(opt)
        jm = JModel(jcfg)
        step = jax.jit(j_train_step(jm), donate_argnums=(0, 1))
        grad = jax.jit(jax.grad(lambda p, b: jm.loss(p, b)[0]))
        params = jm.init(jax.random.PRNGKey(0))
        state = j_opt_init(jm)(params)
        init = (jax.tree.map(np.array, params), jax.tree.map(np.array, state))
        steps = []
        for batch in _batches(jcfg):
            jb = {k: jnp.asarray(v) for k, v in batch.items()}
            g = {k: np.asarray(v) for k, v in
                 _leaf_paths(grad(params, jb)).items()}
            before = jax.tree.map(np.array, params)
            params, state, met = step(params, state, jb)
            steps.append((batch, {k: float(v) for k, v in met.items()}, g,
                          before, jax.tree.map(np.array, params),
                          jax.tree.map(np.array, state)))
        out[opt] = (init, steps)
    return out


@pytest.mark.parametrize("opt", DONATED_OPTS)
def test_three_donated_steps_equal_the_reference(donated_twins, opt):
    """The port's ``TrainGraph`` and the reference's donated jitted step
    from the same weights, each carrying its own state over three steps:
    after each step the loss, the gradient norm, the parameters and the
    state within the reference step test's tolerances."""
    (jp0, js0), steps = donated_twins[opt]
    _, cfg = _tiny_cfgs(opt)
    model = Model(cfg, device="cpu")
    params = model.load(params_from_jax(cfg, jp0))
    state = _state_to_port(js0)
    graph = TrainGraph(model)
    for i, (batch, jmet, jgrads, jbefore, jafter, jstate) in \
            enumerate(steps):
        params, state, met = graph(params, state, _torch(batch))
        assert float(met["loss"]) == pytest.approx(jmet["loss"], rel=1e-5)
        assert float(met["grad_norm"]) == pytest.approx(jmet["grad_norm"],
                                                        rel=1e-5)
        _hold_params(cfg, params, jafter, jbefore, jgrads)
        _hold_state(cfg, state, jstate)
        assert int(state["step"]) == i + 1


def test_a_batch_of_another_shape_raises():
    model, params, state = _fresh("adamw", "none")
    graph = TrainGraph(model)
    b = _batches(model.cfg, n=1)[0]
    graph(params, state, _torch(b))
    short = {k: v[:, :8] for k, v in b.items()}
    with pytest.raises(ValueError, match="bound to batches"):
        graph(params, state, _torch(short))
    wide = {k: v.astype(np.int64) for k, v in b.items()}
    with pytest.raises(ValueError, match="bound to batches"):
        graph(params, state, _torch(wide))
    assert int(state["step"]) == 1


def test_new_opt_state_rebinds():
    """A call with another ``opt_state`` object (a checkpoint restore)
    binds the new pair, on the card a new capture: the step then runs on
    the new state, which may come with batches of another shape."""
    model, params, state = _fresh("adamw", "none")
    graph = TrainGraph(model)
    b = _batches(model.cfg, n=2)
    graph(params, state, _torch(b[0]))
    graph(params, state, _torch(b[1]))
    assert graph.binds == 1 and int(state["step"]) == 2
    restored = {k: (v.clone() if isinstance(v, torch.Tensor) else
                    {kk: vv.clone() for kk, vv in v.items()})
                for k, v in state.items()}
    _, out, _ = graph(params, restored, _torch(b[0]))
    assert graph.binds == 2 and out is restored
    assert int(restored["step"]) == 3 and int(state["step"]) == 2
    short = {k: v[:, :8] for k, v in b[1].items()}
    graph(params, make_opt_init(model)(params), _torch(short))
    assert graph.binds == 3


def test_rules_are_refused():
    """The dry run's rules step is never captured: its model lies on the
    CPU and its tensors on the meta device as ``DTensor``s over a fake
    256-rank group, and it calls ``make_train_step(model, rules)``; a
    ``TrainGraph(model, rules)`` given that state runs the eager step
    (nothing is captured), donates into the given state and keeps its
    placements.  (Rules on a real mesh: ``test_torch_rules_graph.py``.)"""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    from repro_torch.launch.dryrun import build_step
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.parallel.sharding import make_rules
    assert not dist.is_initialized()
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=256)
    try:
        mesh = make_production_mesh(device_type="cpu")
        fn, (params, opt, batch), cfg, _ = build_step("tiny-test",
                                                      "train_4k", mesh)
        assert fn.__qualname__ == "make_train_step.<locals>.train_step"
        model = Model(cfg, cfg.plan, "cpu")
        graph = TrainGraph(model, make_rules(cfg, mesh, cfg.plan))
        layout = {k: (t.placements, t.device.type)
                  for k, t in _state_tensors(opt).items()}
        out_p, out_o, met = graph(params, opt, batch)
        assert out_p is params and out_o is opt
        assert graph.graph is None and graph.capture_ms is None
        assert met["loss"].device.type == "meta"
        assert {k: (t.placements, t.device.type)
                for k, t in _state_tensors(opt).items()} == layout
    finally:
        dist.destroy_process_group()


def test_donate_writes_into_the_given_tensors():
    old = {"step": torch.zeros((), dtype=torch.int32),
           "m": {"a": torch.zeros(3)}, "v": {"b": {"q": torch.zeros(2)}}}
    keep = _state_tensors(old)
    new = {"step": torch.ones((), dtype=torch.int32), "m": old["m"],
           "v": {"b": {"q": torch.full((2,), 2.0)}}}
    assert donate(old, new) is old
    assert all(_state_tensors(old)[k] is t for k, t in keep.items())
    assert int(old["step"]) == 1 and old["v"]["b"]["q"].tolist() == [2, 2]


def test_recorded_launches_are_put_back_and_added_on_replay():
    """The bookkeeping a captured graph does: what a capture records is
    kept and taken off the counts, also when the capture raises; a replay
    adds it back."""
    n0 = SG.KERNEL.launches
    with recorded_launches() as rec:
        SG.KERNEL.launches += 3
    assert rec == {SG.KERNEL: 3} and SG.KERNEL.launches == n0
    add_launches(rec)
    add_launches(rec)
    assert SG.KERNEL.launches == n0 + 6
    with pytest.raises(RuntimeError):
        with recorded_launches() as rec2:
            SG.KERNEL.launches += 1
            raise RuntimeError("capture failed")
    assert rec2 == {SG.KERNEL: 1} and SG.KERNEL.launches == n0 + 6
    SG.KERNEL.launches = n0


def test_a_kernel_made_during_a_capture_is_recorded_from_zero():
    from repro_torch.kernels._build import KERNELS, CudaKernel
    with recorded_launches() as rec:
        k = CudaKernel("made_in_capture", [])
        k.launches += 2
    try:
        assert rec == {k: 2} and k.launches == 0
    finally:
        KERNELS.remove(k)
