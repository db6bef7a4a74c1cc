"""The port's training path against ``repro``'s: the kernels' autograd
Functions against the reference ops' ``custom_vjp``s, ``Model.loss`` and
its gradients for one reduced config of each family, the remat modes and
microbatching, the optimizers and the whole train step, and the GA over
the train genes followed by a train step under the plan it found.

The same numpy inputs (weights carried by ``convert.params_from_jax``) go
through both packages, in f32 compute.  Tolerances:

* the Functions' gradients, rel 1e-5 of each gradient's largest element
  (the reference differentiates its oracle, the port its plain version:
  the same arithmetic, summed in another order);
* ``Model.loss`` rel 1e-5, its gradients 1e-5 of each leaf's largest
  element (2e-5 where a loss sums 30k+ products of an f32 SSD or
  attention backward);
* the train step, one step at a time from the reference's parameters and
  state: the loss and gradient norm rel 1e-5.  A parameter whose gradient
  lies well above the gradients' tolerance (|g_ref| > 1e-3 of its leaf's
  largest) lands within 2e-3 lr + 2e-6 |p| of the reference's: Adam's and
  Adafactor's steps move by about the gradient's relative error.  Every
  parameter lands within 2 lr max(1, |u_ref|), u_ref the reference's own
  step in units of lr: at step 1 ``m / (sqrt(v) + eps)`` is sign(g)
  wherever |g| >> 1e-8, so an element whose gradient is rounding noise can
  flip sign between the packages, and int8 Adam's dequantized second
  moment can be 0, which scales such a step by 1 / |g|.  The state is held
  at rel 2e-5, its int8 codes equal.  On the quantized paths (int8 Adam,
  int8 error feedback) a value at a rounding boundary takes the next code
  in one package, and that moves the step of its element (and of its row
  and leaf, through Adafactor's factored moments and RMS clip): there
  ``QUANT_SHARE`` of the tight elements and codes may miss.  Given the
  same inputs, each optimizer's update and the compression agree exactly
  or at rel 1e-6 (``test_optimizer_update_on_the_same_gradients_...``,
  ``test_ef_compress_tree_equals_the_reference``).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget
from repro.kernels import ops as jops
from repro.models.model import Model as JModel
from repro.train import compress as JC
from repro.train import optimizer as JO
from repro.train.step import make_opt_init as j_opt_init
from repro.train.step import make_train_step as j_train_step
from repro_torch.configs import get_config
from repro_torch.convert import leaf_groups, params_from_jax
from repro_torch.core.ga import GAConfig, run_ga
from repro_torch.core.plan import PlanGenome
from repro_torch.core.verifier import Verifier
from repro_torch.kernels import ops
from repro_torch.kernels import ref as R
from repro_torch.models.model import Model, cross_entropy
from repro_torch.train import compress as C
from repro_torch.train import optimizer as O
from repro_torch.train.step import (global_norm, make_opt_init,
                                    make_train_step, param_leaves)

FN_REL = 1e-5
#: every compute site on its kernel (the Functions over the plain
#: versions on the CPU)
OFFLOAD = dict(attn_impl="pallas", mlp_impl="pallas", ssm_impl="pallas",
               rglru_impl="pallas")


def _np(rng, shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _rel_close(got, want, rel, what=""):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, what
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max()) / scale
    assert err <= rel, f"{what}: {err:.3e} of max|want| > {rel}"


def _f32(cfg, **kw):
    return dataclasses.replace(cfg, plan=cfg.plan.replace(
        compute_dtype="float32", **kw))


def _leaf_paths(tree, is_leaf=None) -> dict:
    return {"/".join(str(getattr(k, "key", k)) for k in path): leaf
            for path, leaf in jax.tree_util.tree_flatten_with_path(
                tree, is_leaf=is_leaf)[0]}


def _port_leaf(path, tensors):
    t = O.leaf_value(path, [x.detach() for x in tensors])
    return t.numpy()


# ---------------------------------------------------------------------------
# the four Functions against the reference's custom_vjp
# ---------------------------------------------------------------------------

def _vjp_twin(jfn, tfn, inputs, n_out=1, seed=5):
    """Forward and gradients of ``tfn`` (the port's Function) against
    ``jax.vjp`` of ``jfn`` (the reference op) on the same inputs and
    random cotangents."""
    rng = np.random.default_rng(seed)
    jin = [jnp.asarray(a) for a in inputs]
    jout, vjp = jax.vjp(jfn, *jin)
    jouts = jout if n_out > 1 else (jout,)
    cots = [_np(rng, np.shape(o)) for o in jouts]
    jg = vjp(tuple(jnp.asarray(c) for c in cots) if n_out > 1
             else jnp.asarray(cots[0]))
    tin = [torch.from_numpy(a).requires_grad_() for a in inputs]
    tout = tfn(*tin)
    touts = tout if n_out > 1 else (tout,)
    for k, (a, b) in enumerate(zip(touts, jouts)):
        _rel_close(a.detach(), b, FN_REL, f"output {k}")
    tg = torch.autograd.grad(touts, tin, [torch.from_numpy(c) for c in cots])
    for k, (a, b) in enumerate(zip(tg, jg)):
        _rel_close(a, b, FN_REL, f"gradient {k}")


@pytest.mark.parametrize("causal,window,hq,hkv", [(True, 0, 4, 2),
                                                  (True, 8, 4, 1),
                                                  (False, 0, 2, 2)])
def test_flash_function_gradients_equal_the_reference(causal, window, hq,
                                                      hkv):
    rng = np.random.default_rng(1)
    q = _np(rng, (2, 16, hq, 16))
    k, v = _np(rng, (2, 16, hkv, 16)), _np(rng, (2, 16, hkv, 16))
    _vjp_twin(lambda a, b, c: jops.flash_attention(a, b, c, causal, window),
              lambda a, b, c: ops.flash_attention(a, b, c, causal, window),
              [q, k, v])


@pytest.mark.parametrize("lead", [(24,), (2, 12)])
def test_swiglu_function_gradients_equal_the_reference(lead):
    """The backward works on the flattened (T, d) input, leading dims or
    not."""
    rng = np.random.default_rng(2)
    x = _np(rng, lead + (16,))
    wi, wg = _np(rng, (16, 40), 0.25), _np(rng, (16, 40), 0.25)
    wo = _np(rng, (40, 16), 0.15)
    _vjp_twin(jops.fused_swiglu, ops.fused_swiglu, [x, wi, wg, wo])


def test_rglru_function_gradients_equal_the_reference():
    rng = np.random.default_rng(3)
    log_a = -np.abs(_np(rng, (2, 32, 16), 0.3))
    b = _np(rng, (2, 32, 16))
    _vjp_twin(jops.rglru, ops.rglru, [log_a, b])


@pytest.mark.parametrize("s,chunk", [(32, 16), (24, 16)])
def test_ssd_function_gradients_equal_the_reference(s, chunk):
    """Both outputs (y and the final state) carry cotangents; the chunk is
    one at which the reference is finite (C1), dividing S or not."""
    rng = np.random.default_rng(4)
    x = _np(rng, (2, s, 4, 8))
    dt = np.log1p(np.exp(_np(rng, (2, s, 4)))).astype(np.float32)
    a = -np.exp(_np(rng, (4,), 0.3))
    bm, cm = _np(rng, (2, s, 8), 0.5), _np(rng, (2, s, 8), 0.5)
    _vjp_twin(lambda *t: jops.ssd(*t, chunk=chunk),
              lambda *t: ops.ssd(*t, chunk=chunk), [x, dt, a, bm, cm],
              n_out=2)


def test_ssd_function_takes_a_missing_state_cotangent_as_zeros():
    """A training forward uses y only: the final state's cotangent arrives
    as zeros, and the gradients are y's alone."""
    rng = np.random.default_rng(6)
    args = [_np(rng, (1, 16, 2, 4)),
            np.log1p(np.exp(_np(rng, (1, 16, 2)))).astype(np.float32),
            -np.exp(_np(rng, (2,), 0.3)), _np(rng, (1, 16, 4)),
            _np(rng, (1, 16, 4))]
    tin = [torch.from_numpy(a).requires_grad_() for a in args]
    y, _ = ops.ssd(*tin, chunk=8)
    g = torch.autograd.grad(y.sum(), tin)
    _, vjp = jax.vjp(lambda *t: jops.ssd(*t, chunk=8)[0],
                     *[jnp.asarray(a) for a in args])
    for a, b in zip(g, vjp(jnp.ones(y.shape, jnp.float32))):
        _rel_close(a, b, FN_REL)


def test_functions_backward_is_autograd_of_the_plain_version():
    """On any device the backward is autograd of ``kernels.ref``'s plain
    version on the saved inputs: on the CPU, bit for bit."""
    rng = np.random.default_rng(7)
    q, k, v = (torch.from_numpy(_np(rng, (1, 8, 2, 8))).requires_grad_()
               for _ in range(3))
    g = torch.from_numpy(_np(rng, (1, 8, 2, 8)))
    got = torch.autograd.grad(ops.flash_attention(q, k, v, True, 0), (q, k, v),
                              g)
    want = torch.autograd.grad(R.flash_attention_ref(q, k, v, True, 0),
                               (q, k, v), g)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# Model.loss and its gradients, one reduced config per family
# ---------------------------------------------------------------------------

#: arch -> (model twin's chunk override or None, batch maker); each arch a
#: family: dense, moe, ssm, hybrid, audio, vision
FAMILIES = {"tiny-test": "dense", "granite-moe-1b-a400m": "moe",
            "mamba2-1.3b": "ssm", "recurrentgemma-9b": "hybrid",
            "hubert-xlarge": "audio", "internvl2-76b": "vision"}
LOSS_REL = {"mamba2-1.3b": 2e-5, "recurrentgemma-9b": 2e-5}


def _batch(cfg, b=2, s=16, seed=1):
    rng = np.random.default_rng(seed)
    out = {"targets": rng.integers(0, cfg.vocab_size, (b, s))
           .astype(np.int32)}
    if cfg.frontend == "audio_frames":
        out["features"] = _np(rng, (b, s, cfg.d_model))
    else:
        out["tokens"] = rng.integers(0, cfg.vocab_size, (b, s)) \
            .astype(np.int32)
    if cfg.frontend == "vision_patches":
        out["patch_embeds"] = _np(rng, (b, cfg.n_patches, cfg.d_model))
    return out


@pytest.fixture(scope="module")
def loss_twins():
    """arch -> (port cfg, reference params as numpy, batch, reference loss,
    ce, aux, gradients by leaf path): each reference value_and_grad
    compiled once."""
    out = {}
    for arch in FAMILIES:
        jcfg, cfg = _f32(jget(arch, reduced=True)), \
            _f32(get_config(arch, reduced=True))
        jm = JModel(jcfg)
        jp = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(0)))
        batch = _batch(cfg)
        jb = {k: jnp.asarray(v) for k, v in batch.items()}
        (loss, met), grads = jax.jit(jax.value_and_grad(
            lambda p: jm.loss(p, jb), has_aux=True))(jp)
        out[arch] = (cfg, jp, batch, float(loss), float(met["ce"]),
                     float(met["aux"]),
                     {k: np.asarray(v) for k, v in _leaf_paths(grads).items()})
    return out


def _port_loss_grads(cfg, jp, batch, plan=None):
    model = Model(cfg, plan, device="cpu")
    params = model.load(params_from_jax(cfg, jp))
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    for p in params.parameters():
        p.requires_grad_(True)
    loss, met = model.loss(params, tb)
    loss.backward()
    named = dict(params.named_parameters())
    grads = {path: _port_leaf(path, [          # unread (audio: embed): 0
        torch.zeros_like(named[n]) if named[n].grad is None
        else named[n].grad for n in names]) for path, names in
        leaf_groups(cfg)}
    return (float(loss.detach()), float(met["ce"].detach()),
            float(met["aux"].detach()), grads)


@pytest.mark.parametrize("plan", ["config", "offload"])
@pytest.mark.parametrize("arch", list(FAMILIES))
def test_model_loss_and_gradients_equal_the_reference(loss_twins, arch,
                                                      plan):
    """The config's plan (stock sites) and the offload plan (every site
    through a Function) both give the reference's loss, its CE and aux
    parts, and its gradient for every leaf."""
    cfg, jp, batch, jloss, jce, jaux, jgrads = loss_twins[arch]
    p = cfg.plan.replace(**OFFLOAD) if plan == "offload" else None
    loss, ce, aux, grads = _port_loss_grads(cfg, jp, batch, p)
    rel = LOSS_REL.get(arch, FN_REL)
    assert loss == pytest.approx(jloss, rel=rel)
    assert ce == pytest.approx(jce, rel=rel)
    assert aux == pytest.approx(jaux, rel=rel, abs=1e-7)
    if FAMILIES[arch] == "moe":
        assert aux > 0
    else:
        assert aux == 0.0
    assert set(grads) == set(jgrads)
    for path, g in grads.items():
        _rel_close(g, jgrads[path], rel, path)


def test_cross_entropy_equals_the_reference_iota_compare():
    from repro.models.model import cross_entropy as j_ce
    rng = np.random.default_rng(8)
    logits, tg = _np(rng, (2, 5, 11), 3.0), rng.integers(0, 11, (2, 5))
    want = float(j_ce(jnp.asarray(logits), jnp.asarray(tg)))
    got = float(cross_entropy(torch.from_numpy(logits), torch.from_numpy(tg)))
    assert got == pytest.approx(want, rel=1e-6)


@pytest.mark.parametrize("arch", ["recurrentgemma-9b",
                                  "granite-moe-1b-a400m"])
def test_remat_modes_give_the_same_loss_and_gradients(arch):
    """none, dots and full keep or recompute activations; the values do
    not depend on which (a hybrid unit of three layers with its tail; a
    MoE with its aux loss), bit for bit on the CPU."""
    cfg = _f32(get_config(arch, reduced=True))
    jp = jax.tree.map(np.asarray, JModel(_f32(jget(arch, reduced=True)))
                      .init(jax.random.PRNGKey(0)))
    batch = _batch(cfg)
    runs = {r: _port_loss_grads(cfg, jp, batch,
                                cfg.plan.replace(remat=r, **OFFLOAD))
            for r in ("none", "dots", "full")}
    base = runs["none"]
    for r in ("dots", "full"):
        assert runs[r][:3] == base[:3], r
        for path in base[3]:
            np.testing.assert_array_equal(runs[r][3][path], base[3][path])


def test_remat_applies_only_under_autograd():
    """Serving (no grad) runs the units as they are: the same logits and
    no autograd graph."""
    cfg = get_config("tiny-test")
    model = Model(cfg, cfg.plan.replace(remat="full"), device="cpu")
    params = model.init(torch.Generator().manual_seed(0))
    toks = torch.randint(0, cfg.vocab_size, (2, 8),
                         generator=torch.Generator().manual_seed(1))
    a = model.forward(params, {"tokens": toks})
    b = model.with_plan(cfg.plan.replace(remat="none")).forward(
        params, {"tokens": toks})
    assert torch.equal(a, b) and a.grad_fn is None


# ---------------------------------------------------------------------------
# the train step
# ---------------------------------------------------------------------------

#: n_full = 8 units and leaves whose sizes are no multiple of 256 (d 24,
#: 4 heads of 6, f 40, vocab 50): a stacked norm scale (8, 24) is factored
#: by Adafactor, int8 Adam's blocks straddle layers, error feedback takes
#: one scale per stacked leaf
STACKED = dict(n_layers=8, d_model=24, n_heads=4, n_kv_heads=2, d_head=6,
               d_ff=40, vocab_size=50, learning_rate=1e-2)
OPT_CASES = [(o, c) for o in ("adamw", "adafactor", "adam8")
             for c in ("none", "int8_ef")]
_STATE_LEAF = lambda x: isinstance(x, dict) and set(x) in (  # noqa: E731
    {"vr", "vc"}, {"v"}, {"q", "scale"})


def _stacked_cfgs(opt, compress):
    def mk(c):
        c = dataclasses.replace(c, optimizer=opt, **STACKED)
        return _f32(c, grad_compress=compress)
    return mk(jget("tiny-test")), mk(get_config("tiny-test"))


def _state_to_port(state) -> dict:
    """The reference's optimizer state in the port's layout: each of its
    params-shaped trees as a leaf dict by reference path."""
    def conv(tree):
        return {k: jax.tree.map(lambda a: torch.from_numpy(np.array(a)), v)
                for k, v in _leaf_paths(tree, _STATE_LEAF).items()}
    return {k: torch.from_numpy(np.array(v)) if k == "step" else conv(v)
            for k, v in state.items()}


@pytest.fixture(scope="module")
def step_twins():
    """(opt, compress) -> the reference's two steps from seeded weights:
    [(params, state, batch, metrics, gradients)] before each step and
    the state after the last; each step function compiled once."""
    out = {}
    for opt, comp in OPT_CASES:
        jcfg, _ = _stacked_cfgs(opt, comp)
        jm = JModel(jcfg)
        step = jax.jit(j_train_step(jm))
        grad = jax.jit(jax.grad(lambda p, b: jm.loss(p, b)[0]))
        params = jm.init(jax.random.PRNGKey(0))
        state = j_opt_init(jm)(params)
        rng = np.random.default_rng(3)
        steps = []
        for _ in range(2):
            t = rng.integers(0, jcfg.vocab_size, (4, 17)).astype(np.int32)
            batch = {"tokens": t[:, :-1], "targets": t[:, 1:]}
            jb = {k: jnp.asarray(v) for k, v in batch.items()}
            g = grad(params, jb)
            before = (jax.tree.map(np.asarray, params),
                      jax.tree.map(np.asarray, state))
            params, state, met = step(params, state, jb)
            steps.append((*before, batch,
                          {k: float(v) for k, v in met.items()},
                          {k: np.asarray(v) for k, v in
                           _leaf_paths(g).items()}))
        out[(opt, comp)] = (steps, jax.tree.map(np.asarray, params),
                            jax.tree.map(np.asarray, state))
    return out


#: on the quantized paths (int8 Adam's state, int8 error feedback) a value
#: at an int8 rounding boundary takes the next code in one package: the
#: share of elements held tight (and of int8 codes held equal) that may
#: miss, counted over the whole model
QUANT_SHARE = 0.005


def _quantized(cfg) -> bool:
    return cfg.optimizer == "adam8" or cfg.plan.grad_compress == "int8_ef"


def _hold_params(cfg, params, jparams, jparams_before, jgrads):
    """The parameters after a step against the reference's (module
    docstring)."""
    lr = cfg.learning_rate
    named = dict(params.named_parameters())
    want_all = {k: np.asarray(v) for k, v in _leaf_paths(jparams).items()}
    before = {k: np.asarray(v) for k, v in
              _leaf_paths(jparams_before).items()}
    n_tight = n_missed = 0
    for path, names in leaf_groups(cfg):
        got = _port_leaf(path, [named[n] for n in names]).astype(np.float64)
        want = want_all[path].astype(np.float64)
        d = np.abs(got - want)
        u_ref = np.abs((before[path] - want) / lr)   # the step, wd included
        assert (d <= 2 * lr * np.maximum(1.0, u_ref) + 1e-7).all(), \
            (path, float(d.max()))
        g = np.abs(jgrads[path])
        tight = g > 1e-3 * g.max()
        n_tight += int(tight.sum())
        n_missed += int((d[tight] > 2e-3 * lr
                         + 2e-6 * np.abs(want[tight])).sum())
    share = QUANT_SHARE if _quantized(cfg) else 0.0
    assert n_missed <= share * n_tight, (n_missed, n_tight)


def _hold_state(cfg, state, jstate):
    """Leaves, shapes and dtypes equal; values at rel 2e-5 of each leaf's
    largest, int8 codes equal (on the quantized paths both but for
    QUANT_SHARE of the elements; the error buffers, which hold what each
    package's codes left over, are not compared there)."""
    got = _leaf_paths(jax.tree.map(lambda t: t.numpy(), state),
                      _STATE_LEAF)
    want = _leaf_paths(jax.tree.map(np.asarray, jstate), _STATE_LEAF)
    assert list(got) == list(want)
    share = QUANT_SHARE if _quantized(cfg) else 0.0
    n = missed = 0
    for key, leaf in want.items():
        parts = leaf if isinstance(leaf, dict) else {"": leaf}
        gparts = got[key] if isinstance(leaf, dict) else {"": got[key]}
        for part, w in parts.items():
            g = gparts[part]
            assert g.shape == w.shape and g.dtype == w.dtype, (key, part)
            if key.startswith("ef/"):
                continue
            if w.dtype == np.int8:
                off = g != w
            else:
                scale = max(float(np.abs(w).max()), 1e-30)
                off = np.abs(g.astype(np.float64) - w) > 2e-5 * scale
            n += off.size
            missed += int(off.sum())
    assert missed <= share * n, (missed, n)


@pytest.mark.parametrize("opt,compress", OPT_CASES)
def test_two_train_steps_equal_the_reference(step_twins, opt, compress):
    """Each of two steps from the reference's own parameters and state:
    the loss, the gradient norm, the parameters (module docstring) and
    the optimizer state, which has the reference's leaves, shapes and
    dtypes."""
    steps, _, jfinal = step_twins[(opt, compress)]
    _, cfg = _stacked_cfgs(opt, compress)
    model = Model(cfg, device="cpu")
    step = make_train_step(model)
    for i, (jp, jstate, batch, jmet, jgrads) in enumerate(steps):
        params = model.load(params_from_jax(cfg, jp))
        state = _state_to_port(jstate)
        params, state, met = step(params, state, {
            k: torch.from_numpy(v) for k, v in batch.items()})
        assert float(met["loss"]) == pytest.approx(jmet["loss"], rel=1e-5)
        assert float(met["grad_norm"]) == pytest.approx(jmet["grad_norm"],
                                                        rel=1e-5)
        jnext = steps[i + 1][:2] if i + 1 < len(steps) else \
            (step_twins[(opt, compress)][1], jfinal)
        _hold_params(cfg, params, jnext[0], jp, jgrads)
        _hold_state(cfg, state, jnext[1])
        assert int(state["step"]) == i + 1
        assert not any(p.requires_grad for p in params.parameters())


def test_opt_state_has_the_reference_layout():
    """Every optimizer's fresh state (and the error buffers) has the
    reference's leaves, shapes and dtypes, per reference leaf."""
    for opt, comp in OPT_CASES:
        jcfg, cfg = _stacked_cfgs(opt, comp)
        jm = JModel(jcfg)
        jstate = j_opt_init(jm)(jm.abstract_params())
        model = Model(cfg, device="cpu")
        state = make_opt_init(model)(model.init(
            torch.Generator().manual_seed(0)))
        got = _leaf_paths(jax.tree.map(lambda t: t.numpy(), state),
                          _STATE_LEAF)
        want = _leaf_paths(jstate, _STATE_LEAF)
        assert list(got) == list(want)
        for k in want:
            for a, b in zip(jax.tree.leaves(got[k]),
                            jax.tree.leaves(want[k])):
                assert (a.shape, str(a.dtype)) == (b.shape, str(b.dtype)), k


@pytest.mark.parametrize("opt", ["adamw", "adafactor", "adam8"])
def test_optimizer_update_on_the_same_gradients_equals_the_reference(opt):
    """Given the same parameters, gradients and state, one update of each
    optimizer equals the reference's (stacked leaves included) at rel
    1e-6, and int8 Adam's codes agree exactly."""
    rng = np.random.default_rng(11)
    shapes = {"scan/l0/w": (8, 12, 20), "scan/l0/s": (8, 24), "b": (30,),
              "m": (24, 50)}
    jparams = {"scan": {"l0": {"w": _np(rng, shapes["scan/l0/w"]),
                               "s": _np(rng, shapes["scan/l0/s"])}},
               "b": _np(rng, shapes["b"]), "m": _np(rng, shapes["m"])}
    jgrads = jax.tree.map(lambda a: _np(rng, a.shape, 1e-2), jparams)
    init, update = JO.OPTIMIZERS[opt]
    jstate = init(jax.tree.map(jnp.asarray, jparams))
    for _ in range(2):                   # two updates, state carried
        jnew, jstate2 = update(jax.tree.map(jnp.asarray, jparams),
                               jax.tree.map(jnp.asarray, jgrads), jstate,
                               lr=1e-2)
        port = {k: [torch.from_numpy(np.array(x)) for x in
                    (v if k.startswith("scan/") else v[None])]
                for k, v in _leaf_paths(jparams).items()}
        grads = {k: [torch.from_numpy(np.array(x)) for x in
                     (v if k.startswith("scan/") else v[None])]
                 for k, v in _leaf_paths(jgrads).items()}
        state = _state_to_port(jstate)
        state2 = O.OPTIMIZERS[opt][1](port, grads, state, lr=1e-2)
        for k, v in _leaf_paths(jnew).items():
            _rel_close(O.leaf_value(k, port[k]), v, 1e-6, k)
        got = jax.tree.leaves(jax.tree.map(lambda t: t.numpy(), state2))
        want = jax.tree.leaves(_state_to_port(jstate2))
        for a, b in zip(got, want):
            if b.dtype == torch.int8:
                assert np.array_equal(a, b.numpy())
            else:
                _rel_close(a, b.numpy(), 1e-6)
        jparams = jax.tree.map(np.asarray, jnew)
        jstate = jstate2


def test_ef_compress_tree_equals_the_reference():
    """One scale and one error buffer per stacked leaf: the same g_hat and
    error as the reference on the same gradients and errors."""
    rng = np.random.default_rng(12)
    jg = {"scan": {"l0": {"w": _np(rng, (8, 7, 9))}}, "b": _np(rng, (13,))}
    jerr = jax.tree.map(lambda a: _np(rng, a.shape, 1e-3), jg)
    jhat, jnew = JC.ef_compress_tree(jax.tree.map(jnp.asarray, jg),
                                     jax.tree.map(jnp.asarray, jerr))
    grads = {"scan/l0/w": [torch.from_numpy(x) for x in jg["scan"]["l0"]["w"]],
             "b": [torch.from_numpy(jg["b"])]}
    err = {k: torch.from_numpy(np.array(v))
           for k, v in _leaf_paths(jerr).items()}
    hat, new = C.ef_compress_tree(grads, err)
    for k, v in _leaf_paths(jhat).items():
        np.testing.assert_array_equal(O.leaf_value(k, hat[k]).numpy(), v)
    for k, v in _leaf_paths(jnew).items():
        np.testing.assert_array_equal(new[k].numpy(), v)


def test_global_norm_equals_the_reference():
    from repro.train.step import global_norm as j_global_norm
    rng = np.random.default_rng(13)
    tree = {"scan": {"l0": {"w": _np(rng, (8, 5, 7))}}, "b": _np(rng, (9,))}
    leaves = {"scan/l0/w": [torch.from_numpy(x) for x in
                            tree["scan"]["l0"]["w"]],
              "b": [torch.from_numpy(tree["b"])]}
    assert float(global_norm(leaves)) == pytest.approx(
        float(j_global_norm(tree)), rel=1e-6)


def test_microbatches_4_equal_1():
    """The reference's accumulation test on the port: 4 microbatches give
    the loss of 1 (rel 1e-4) and parameters within 5e-4 after a step."""
    cfg = get_config("tiny-test")
    model = Model(_f32(cfg), device="cpu")
    batch = {k: torch.from_numpy(v) for k, v in _batch(cfg, b=4).items()}
    out = {}
    for n in (1, 4):
        m = Model(_f32(cfg, microbatches=n), device="cpu")
        params = model.init(torch.Generator().manual_seed(0))
        state = make_opt_init(m)(params)
        params, _, met = make_train_step(m)(params, state, batch)
        out[n] = (params, float(met["loss"]))
    assert out[1][1] == pytest.approx(out[4][1], rel=1e-4)
    for a, b in zip(out[1][0].parameters(), out[4][0].parameters()):
        assert float((a - b).abs().max()) < 5e-4


def test_microbatched_step_equals_the_reference():
    """4 microbatches, accumulated in f32 in microbatch order: the
    reference's loss, gradient norm and parameters (tiny-test, AdamW)."""
    jcfg, cfg = _f32(jget("tiny-test"), microbatches=4), \
        _f32(get_config("tiny-test"), microbatches=4)
    jm = JModel(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    batch = _batch(cfg, b=4)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    jnew, _, jmet = jax.jit(j_train_step(jm))(jp, j_opt_init(jm)(jp), jb)
    model = Model(cfg, device="cpu")
    params = model.load(params_from_jax(cfg, jax.tree.map(np.asarray, jp)))
    params, _, met = make_train_step(model)(
        params, make_opt_init(model)(params),
        {k: torch.from_numpy(v) for k, v in batch.items()})
    assert float(met["loss"]) == pytest.approx(float(jmet["loss"]), rel=1e-5)
    assert float(met["grad_norm"]) == pytest.approx(float(jmet["grad_norm"]),
                                                    rel=1e-5)
    named = dict(params.named_parameters())
    want = {k: np.asarray(v) for k, v in _leaf_paths(jnew).items()}
    for path, names in leaf_groups(cfg):
        got = _port_leaf(path, [named[n] for n in names])
        assert np.abs(got - want[path]).max() <= 2 * cfg.learning_rate


def test_accumulator_dtype_is_the_plans():
    """bf16 parameters with an f32 accumulator: the microbatches' gradients
    are summed in f32 (not in the parameters' bf16)."""
    cfg = get_config("tiny-test")
    cfg = dataclasses.replace(cfg, plan=cfg.plan.replace(
        param_dtype="bfloat16", microbatches=2, accum_dtype="float32"))
    model = Model(cfg, device="cpu")
    params = model.init(torch.Generator().manual_seed(0))
    seen = []
    orig = O.adamw_update

    def spy(p, grads, state, **kw):
        seen.extend(g.dtype for ts in grads.values() for g in ts)
        return orig(p, grads, state, **kw)
    O.OPTIMIZERS["adamw"] = (O.adamw_init, spy)
    try:
        make_train_step(model)(params, make_opt_init(model)(params), {
            k: torch.from_numpy(v) for k, v in _batch(cfg, b=2).items()})
    finally:
        O.OPTIMIZERS["adamw"] = (O.adamw_init, orig)
    assert seen and set(seen) == {torch.float32}
    assert all(p.dtype == torch.bfloat16 for p in params.parameters())


def test_serving_after_training_builds_no_graph():
    """A train step turns gradients on for its own step only: afterwards
    the weights are frozen and prefill/decode build no autograd graph."""
    cfg = get_config("tiny-test")
    model = Model(cfg, device="cpu")
    params = model.init(torch.Generator().manual_seed(0))
    make_train_step(model)(params, make_opt_init(model)(params), {
        k: torch.from_numpy(v) for k, v in _batch(cfg).items()})
    assert not any(p.requires_grad for p in params.parameters())
    cache = model.init_cache(2, 8)
    toks = torch.zeros((2, 4), dtype=torch.int32)
    logits, cache = model.prefill(params, {"tokens": toks}, cache)
    assert logits.grad_fn is None and not logits.requires_grad


# ---------------------------------------------------------------------------
# the GA over the train genes, then a step under the plan it found
# ---------------------------------------------------------------------------

def test_ga_over_train_genes_then_a_train_step_under_the_found_plan():
    """The reference's end-to-end test on the port: GA-search a train plan
    at the published qwen2-7b (analytic rung), no worse than the config's
    plan, then run a real train step under it on the reduced config."""
    cfg_full = get_config("qwen2-7b")
    v = Verifier(cfg_full, "train_4k", n_chips=256, mode="analytic")
    incumbent = v.measure(PlanGenome.from_plan(cfg_full, "train",
                                               cfg_full.plan))
    res = run_ga(cfg_full, "train", v,
                 GAConfig(population=8, generations=4, seed=11))
    assert res.best_measurement.fitness() >= incumbent.fitness()
    assert {"remat", "microbatches", "fused_grad_reduce",
            "grad_compress"} <= set(res.best.alleles)
    plan = res.best.to_plan().replace(microbatches=1)
    cfg_small = dataclasses.replace(get_config("qwen2-7b", reduced=True),
                                    plan=plan)
    model = Model(cfg_small, device="cpu")
    params = model.init(torch.Generator().manual_seed(0))
    step = make_train_step(model)
    batch = {"tokens": torch.ones((2, 32), dtype=torch.int32),
             "targets": torch.ones((2, 32), dtype=torch.int32)}
    _, _, metrics = step(params, make_opt_init(model)(params), batch)
    assert np.isfinite(float(metrics["loss"]))
