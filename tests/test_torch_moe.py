"""The port's MoE layer against ``repro.models.layers.run_moe``.

Both packages route the same numpy inputs through the same weights (the
reduced granite-moe-1b-a400m and moonshot-v1-16b-a3b layers that
``params_from_jax`` carries).  In f32 ``y`` is held within 1e-5 and the
aux loss within 1e-6, at capacity factors where the capacity binds (0.5:
assignments certainly drop), at the published 1.25 and at 16 (nothing
drops); the kept assignments are the reference's, one for one.  In bf16
``y`` is held to 2^-6 of its largest value: the router's logits and the
experts' products round to bf16 in both, and the port sums each token's
k gated rows in f32 where XLA's scatter adds them in bf16 one by one.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from repro.configs import get_config as jget
from repro.models import layers as JL
from repro.models.model import Model as JModel
from repro_torch.configs import MoEConfig, get_config
from repro_torch.convert import params_from_jax
from repro_torch.models import layers as L

MOE_ARCHS = ["granite-moe-1b-a400m", "moonshot-v1-16b-a3b"]
#: capacity factors: drops certain, the published factor, no drops
FACTORS = [0.5, 1.25, 16.0]


def _cfgs(arch, factor=None, f32=True):
    out = []
    for c in (jget(arch, reduced=True), get_config(arch, reduced=True)):
        if f32:
            c = dataclasses.replace(c, plan=c.plan.replace(
                compute_dtype="float32"))
        if factor is not None:
            c = dataclasses.replace(c, moe=MoEConfig(
                c.moe.n_experts, c.moe.top_k, c.moe.d_ff_expert,
                capacity_factor=factor))
        out.append(c)
    return out


def _moe_params(jcfg, cfg, seed=0):
    """The first layer's MoE weights in both packages (numpy-carried)."""
    jp = jax.tree.map(np.asarray, JModel(jcfg).init(
        jax.random.PRNGKey(seed)))
    state = params_from_jax(cfg, jp)
    port = {k: state[f"layers.0.moe.{k}"]
            for k in ("router", "wi", "wg", "wo")}
    ref = {k: v[0] for k, v in jp["scan"]["l0"]["moe"].items()}
    return ref, port


def _x(cfg, b=2, s=40, seed=1, dtype=np.float32):
    return np.random.default_rng(seed).standard_normal(
        (b, s, cfg.d_model)).astype(dtype)


def _ref_kept(jcfg, jparams, x):
    """The reference's kept assignments (its lines in ``run_moe``: top k
    of the router's softmax, stable argsort by expert, position in the
    run < capacity), as a (t*k,) bool and the experts (t*k,)."""
    m = jcfg.moe
    t = x.shape[0] * x.shape[1]
    dt = JL.cdtype(jcfg.plan)
    xt = jnp.asarray(x).reshape(t, -1)
    logits = jnp.einsum("td,de->te", xt.astype(dt),
                        jparams["router"].astype(dt)).astype(jnp.float32)
    _, idx = lax.top_k(jax.nn.softmax(logits, axis=-1), m.top_k)
    eid = idx.reshape(-1)
    order = jnp.argsort(eid)
    sorted_eid = eid[order]
    run_start = jnp.searchsorted(sorted_eid, jnp.arange(m.n_experts),
                                 side="left")
    pos_sorted = jnp.arange(t * m.top_k) - run_start[sorted_eid]
    pos = jnp.zeros((t * m.top_k,), jnp.int32).at[order].set(
        pos_sorted.astype(jnp.int32))
    cap = JL.moe_capacity(jcfg, t)
    return np.asarray(pos < cap), np.asarray(eid)


@pytest.mark.parametrize("arch", MOE_ARCHS)
@pytest.mark.parametrize("factor", FACTORS)
def test_run_moe_matches_the_reference_f32(arch, factor):
    jcfg, cfg = _cfgs(arch, factor)
    jparams, params = _moe_params(jcfg, cfg)
    x = _x(cfg)
    jy, jaux = JL.run_moe(jparams, jnp.asarray(x), jcfg, jcfg.plan)
    y, aux = L.run_moe(params, torch.from_numpy(x), cfg, cfg.plan)
    assert y.shape == x.shape and y.dtype == torch.float32
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), atol=1e-5,
                               rtol=1e-5)
    assert abs(float(aux) - float(jaux)) <= 1e-6
    # the same kept assignments, one for one
    want_keep, want_eid = _ref_kept(jcfg, jparams, x)
    t = x.shape[0] * x.shape[1]
    _, _, idx = L.moe_route(params, torch.from_numpy(x).reshape(t, -1),
                            cfg, cfg.plan)
    _, keep = L.moe_slots(idx, cfg.moe.n_experts,
                          L.moe_capacity(cfg, t))
    np.testing.assert_array_equal(idx.reshape(-1).numpy(), want_eid)
    np.testing.assert_array_equal(keep.numpy(), want_keep)
    n_drop = int((~keep).sum())
    slots = cfg.moe.n_experts * L.moe_capacity(cfg, t)
    if factor == 0.5:   # the capacity binds: more assignments than slots
        assert n_drop >= t * cfg.moe.top_k - slots > 0
    if factor == 16.0:
        assert n_drop == 0


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_run_moe_matches_the_reference_bf16(arch):
    jcfg, cfg = _cfgs(arch, 0.5, f32=False)
    jparams, params = _moe_params(jcfg, cfg)
    x = _x(cfg)
    jy, jaux = JL.run_moe(jparams, jnp.asarray(x, jnp.bfloat16), jcfg,
                          jcfg.plan)
    y, aux = L.run_moe(params, torch.from_numpy(x).bfloat16(), cfg,
                       cfg.plan)
    want = np.asarray(jy, np.float32)
    assert y.dtype == torch.bfloat16
    np.testing.assert_allclose(y.float().numpy(), want,
                               atol=2.0 ** -6 * np.abs(want).max(), rtol=0)
    assert abs(float(aux) - float(jaux)) <= 1e-3 * float(jaux)


def test_moe_slots_keep_the_first_assignments_of_each_expert():
    """Token-major order decides: token 0's pick of expert 1 takes its
    slot 0, token 1's slot 1, and token 2's, past the capacity (2), drops
    to the overflow row e * cap (as does token 3's pick of expert 0)."""
    idx = torch.tensor([[1, 0], [1, 2], [1, 0], [0, 2]])
    slot, keep = L.moe_slots(idx, 3, 2)
    assert keep.tolist() == [True, True, True, True, False, True,
                             False, True]
    assert slot.tolist() == [2, 0, 3, 4, 6, 1, 6, 5]


def test_top_k_ties_go_to_the_lower_expert():
    """A zero router gives every expert the same probability: the top k
    are experts 0..k-1, as ``lax.top_k`` picks them."""
    jcfg, cfg = _cfgs("granite-moe-1b-a400m")
    e, k = cfg.moe.n_experts, cfg.moe.top_k
    params = {"router": torch.zeros((cfg.d_model, e))}
    x = torch.from_numpy(_x(cfg, 1, 5)[0])
    probs, gate, idx = L.moe_route(params, x, cfg, cfg.plan)
    _, jidx = lax.top_k(jnp.asarray(probs.numpy()), k)
    assert idx.tolist() == np.asarray(jidx).tolist() == [list(range(k))] * 5
    torch.testing.assert_close(gate, torch.full((5, k), 1.0 / k))
