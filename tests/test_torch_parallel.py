"""The port's sharding plan on a torch ``DeviceMesh`` against
``repro.parallel``.

The reference's side comes from one subprocess per test session that
forces 512 host devices before jax starts (as ``repro.launch.dryrun``
does) and dumps its specs as JSON: for every arch (``tiny-*`` included),
at the pod meshes ``(16, 16)`` and ``(2, 16, 16)``, under the arch's plan,
its three optimized plans and the plan with ``use_tp``, ``fsdp``,
``shard_moe_experts`` or ``seq_shard`` turned off, every parameter,
optimizer-state, cache and batch leaf's ``PartitionSpec``; and the slice
that each mesh coordinate holds of four leaves
(``NamedSharding.devices_indices_map``).

The port's side runs on ``DeviceMesh``es built by
``launch.mesh.make_production_mesh`` over torch's fake process group (512
ranks in this one process), its parameters, optimizer state and caches on
the meta device (shapes only).  A port parameter's spec is the reference
spec of the stacked leaf it came from without the stack axis; the port's
optimizer state is kept per reference leaf, so its specs are the
reference's as they are.  The fake group is process-global: the class
fixture destroys it, so no later test in the worker sees it.
"""
import contextlib
import dataclasses
import json
import math
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch
import torch.distributed as dist

from repro_torch.configs import SHAPES, get_config, list_archs
from repro_torch.configs.optimized import optimized_plan
from repro_torch.convert import leaf_groups
from repro_torch.launch import mesh as M
from repro_torch.models import transformer as T
from repro_torch.models.model import Model
from repro_torch.models.transformer import unit_structure
from repro_torch.parallel import param_sharding as PS
from repro_torch.parallel import sharding as S
from repro_torch.train.step import make_opt_init

ROOT = Path(__file__).resolve().parents[1]
ARCHS = list_archs()
MESHES = {"pod16x16": False, "pod2x16x16": True}
#: plan name -> the port's plan for an arch
PLANS = {
    "arch": lambda a: get_config(a).plan,
    "opt_train": lambda a: optimized_plan(a, "train"),
    "opt_prefill": lambda a: optimized_plan(a, "prefill"),
    "opt_decode": lambda a: optimized_plan(a, "decode"),
    "no_tp": lambda a: get_config(a).plan.replace(use_tp=False),
    "no_fsdp": lambda a: get_config(a).plan.replace(fsdp=False),
    "no_ep": lambda a: get_config(a).plan.replace(shard_moe_experts=False),
    "no_sp": lambda a: get_config(a).plan.replace(seq_shard=False),
}
OPTIMIZERS = ("adamw", "adafactor", "adam8")
#: the caches' (batch, seq_len): decode_32k's and long_500k's
CACHE_SHAPES = ((128, 32768), (1, 524288))
#: leaves whose per-coordinate slices are compared: (arch, kind, name)
SLICED = (("qwen2-7b", "param", "layers.0.mixer.wq"),
          ("qwen2-7b", "param", "layers.0.mixer.wo"),
          ("llama3-405b", "param", "embed"),
          ("qwen2-7b", "cache", "k"))

REFERENCE = r'''
import dataclasses, itertools, json, sys
from repro.launch.dryrun import setup_host_devices
setup_host_devices(512)
import jax
from jax.sharding import PartitionSpec as P
from jax.tree_util import DictKey, GetAttrKey, SequenceKey
from repro.configs import SHAPES, get_config, list_archs
from repro.configs.optimized import optimized_plan
from repro.launch.mesh import make_production_mesh
from repro.models.model import Model
from repro.parallel.param_sharding import (batch_shardings, cache_shardings,
                                           opt_shardings, param_spec_tree)
from repro.parallel.sharding import make_rules
from repro.train.step import make_opt_init

args = json.loads(sys.argv[1])


def spec(s):
    return [list(e) if isinstance(e, tuple) else e for e in tuple(s)]


def name(k):
    if isinstance(k, DictKey):
        return str(k.key)
    if isinstance(k, SequenceKey):
        return str(k.idx)
    return k.name


def flat(tree, leaf=lambda x: x):
    out = {}
    for path, x in jax.tree_util.tree_flatten_with_path(
            tree, is_leaf=lambda x: isinstance(x, (P, jax.sharding.Sharding)))[0]:
        out["/".join(name(k) for k in path)] = spec(leaf(x))
    return out


PLANS = {
    "arch": lambda a: get_config(a).plan,
    "opt_train": lambda a: optimized_plan(a, "train"),
    "opt_prefill": lambda a: optimized_plan(a, "prefill"),
    "opt_decode": lambda a: optimized_plan(a, "decode"),
    "no_tp": lambda a: get_config(a).plan.replace(use_tp=False),
    "no_fsdp": lambda a: get_config(a).plan.replace(fsdp=False),
    "no_ep": lambda a: get_config(a).plan.replace(shard_moe_experts=False),
    "no_sp": lambda a: get_config(a).plan.replace(seq_shard=False),
}
meshes = {m: make_production_mesh(multi_pod=mp)
          for m, mp in args["meshes"].items()}
memo = {}


def once(key, fn):
    if key not in memo:
        memo[key] = fn()
    return memo[key]


out = {"specs": {}, "slices": {}}
for arch in args["archs"]:
    base = get_config(arch)
    params = Model(base).abstract_params()
    for mname, mesh in meshes.items():
        for pname, mk in PLANS.items():
            plan = mk(arch)
            cfg = dataclasses.replace(base, plan=plan)
            model = Model(cfg)
            rules = make_rules(cfg, mesh, plan)
            rec = {"params": flat(param_spec_tree(params, rules))}
            opts = args["optimizers"] if pname == "arch" else [cfg.optimizer]
            for opt in opts:
                ocfg = dataclasses.replace(cfg, optimizer=opt)
                oplan = plan.replace(grad_compress="int8_ef") \
                    if pname == "arch" else plan
                state = once(("opt", arch, opt, oplan.grad_compress),
                             lambda: jax.eval_shape(
                                 make_opt_init(Model(ocfg, oplan)), params))
                rec["opt_" + opt] = flat(opt_shardings(state, params, rules),
                                         lambda s: s.spec)
            rec["cache"] = {}
            for b, s in args["cache_shapes"]:
                cache = once(("cache", arch, plan.kv_cache_dtype, b, s),
                             lambda: model.abstract_cache(b, s))
                rec["cache"][f"{b}x{s}"] = flat(
                    cache_shardings(cache, rules), lambda s: s.spec)
            rec["batch"] = {sh: {k: spec(v.spec) for k, v in
                                 batch_shardings(model, SHAPES[sh],
                                                 rules).items()}
                            for sh in SHAPES}
            out["specs"][f"{arch}|{mname}|{pname}"] = rec
for arch, kind, leaf in args["sliced"]:
    cfg = get_config(arch)
    model = Model(cfg)
    for mname, mesh in meshes.items():
        rules = make_rules(cfg, mesh, cfg.plan)
        if kind == "param":
            tree_in = model.abstract_params()
            tree = param_spec_tree(tree_in, rules)
            keys = args["ref_path"][f"{arch}|{leaf}"].split("/")
        else:
            tree_in = model.abstract_cache(*args["cache_shapes"][0])
            tree = cache_shardings(tree_in, rules)
            keys = ["scan", "l0", leaf]
        node, sds = tree, tree_in
        for k in keys:
            node, sds = node[k], sds[k]
        parts = tuple(node.spec if hasattr(node, "spec") else node)
        shape = tuple(sds.shape)
        if keys[0] == "scan":           # the port's leaf: one layer's
            parts, shape = parts[1:], shape[1:]
        s = P(*parts)
        imap = jax.sharding.NamedSharding(mesh, s).devices_indices_map(shape)
        rows = []
        for idx in itertools.product(*[range(n) for n in mesh.devices.shape]):
            sl = imap[mesh.devices[idx]]
            rows.append([[x.start or 0, shape[d] if x.stop is None
                          else x.stop] for d, x in enumerate(sl)])
        out["slices"][f"{arch}|{kind}|{leaf}|{mname}"] = {
            "shape": list(shape), "spec": spec(s), "rows": rows}
json.dump(out, sys.stdout)
'''


def _ref_path(cfg, name: str) -> str:
    """The reference leaf path a port parameter came from."""
    for path, names in leaf_groups(cfg):
        if name in names:
            return path
    raise KeyError(name)


@pytest.fixture(scope="session")
def ref():
    """The reference's specs and slices, from one 512-device subprocess."""
    ref_path = {f"{a}|{leaf}": _ref_path(get_config(a), leaf)
                for a, kind, leaf in SLICED if kind == "param"}
    args = dict(archs=ARCHS, meshes=MESHES, optimizers=OPTIMIZERS,
                cache_shapes=CACHE_SHAPES, sliced=SLICED, ref_path=ref_path)
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run([sys.executable, "-c", REFERENCE, json.dumps(args)],
                         capture_output=True, text=True, env=env, cwd=ROOT,
                         timeout=600)
    assert res.returncode == 0, res.stderr[-4000:]
    return json.loads(res.stdout)


def _tup(spec) -> tuple:
    return tuple(tuple(e) if isinstance(e, list) else e for e in spec)


def _flat(tree, prefix=()) -> dict:
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, prefix + (k,)))
        return out
    return {"/".join(prefix): tree}


@pytest.fixture(scope="class")
def port_meshes():
    """The two pod meshes over a 512-rank fake process group, destroyed
    with the class."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    assert not dist.is_initialized()
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=512)
    try:
        yield {m: M.make_production_mesh(multi_pod=mp, device_type="cpu")
               for m, mp in MESHES.items()}
    finally:
        dist.destroy_process_group()


_META = {}


def _meta_params(arch: str, plan) -> T.Transformer:
    key = (arch, plan.param_dtype)
    if key not in _META:
        cfg = dataclasses.replace(get_config(arch), plan=plan)
        _META[key] = T.Transformer(cfg, torch.device("meta"))
    return _META[key]


def _plan_cfg(arch: str, pname: str):
    plan = PLANS[pname](arch)
    return dataclasses.replace(get_config(arch), plan=plan), plan


CASES = [(a, m, p) for a in ARCHS for m in MESHES for p in PLANS]


@pytest.mark.usefixtures("port_meshes")
class TestSpecsEqualTheReference:

    @pytest.mark.parametrize("arch,mesh,pname", CASES)
    def test_param_specs(self, ref, port_meshes, arch, mesh, pname):
        cfg, plan = _plan_cfg(arch, pname)
        rules = S.make_rules(cfg, port_meshes[mesh], plan)
        want = ref["specs"][f"{arch}|{mesh}|{pname}"]["params"]
        got = PS.param_spec_tree(_meta_params(arch, plan), rules)
        groups = {n: path for path, names in leaf_groups(cfg)
                  for n in names}
        assert set(got) == set(groups)
        for name, spec in got.items():
            path = groups[name]
            w = _tup(want[path])
            assert spec == (w[1:] if path.startswith("scan/") else w), name

    @pytest.mark.parametrize("arch,mesh,pname", CASES)
    def test_opt_state_specs(self, ref, port_meshes, arch, mesh, pname):
        cfg, plan = _plan_cfg(arch, pname)
        rules = S.make_rules(cfg, port_meshes[mesh], plan)
        rec = ref["specs"][f"{arch}|{mesh}|{pname}"]
        params = _meta_params(arch, plan)
        opts = OPTIMIZERS if pname == "arch" else (cfg.optimizer,)
        for opt in opts:
            oplan = plan.replace(grad_compress="int8_ef") \
                if pname == "arch" else plan
            ocfg = dataclasses.replace(cfg, optimizer=opt, plan=oplan)
            state = make_opt_init(Model(ocfg, oplan, "cpu"))(params)
            got = _flat(PS.opt_shardings(state, params, rules, cfg=ocfg))
            want = {k: _tup(v) for k, v in rec["opt_" + opt].items()}
            assert got == want, opt

    @pytest.mark.parametrize("arch,mesh,pname", CASES)
    def test_cache_specs(self, ref, port_meshes, arch, mesh, pname):
        cfg, plan = _plan_cfg(arch, pname)
        rules = S.make_rules(cfg, port_meshes[mesh], plan)
        size, n_full = unit_structure(cfg)
        for b, s in CACHE_SHAPES:
            want = ref["specs"][f"{arch}|{mesh}|{pname}"]["cache"][f"{b}x{s}"]
            cache = T.init_cache(cfg, b, s, torch.device("meta"))
            got = PS.cache_shardings(cache, rules)
            seen = set()
            for i, layer in enumerate(got):
                stacked = i < n_full * size
                pre = f"scan/l{i % size}" if stacked \
                    else f"tail/t{i - n_full * size}"
                for k, spec in layer.items():
                    w = _tup(want[f"{pre}/{k}"])
                    assert spec == (w[1:] if stacked else w), (i, k)
                    seen.add(f"{pre}/{k}")
            assert seen == set(want)

    @pytest.mark.parametrize("arch,mesh,pname", CASES)
    def test_batch_specs(self, ref, port_meshes, arch, mesh, pname):
        cfg, plan = _plan_cfg(arch, pname)
        rules = S.make_rules(cfg, port_meshes[mesh], plan)
        model = Model(cfg, plan, "cpu")
        for sh, shape in SHAPES.items():
            want = ref["specs"][f"{arch}|{mesh}|{pname}"]["batch"][sh]
            got = PS.batch_shardings(model, shape, rules)
            assert got == {k: _tup(v) for k, v in want.items()}, sh

    @pytest.mark.parametrize("leaf", SLICED, ids="|".join)
    @pytest.mark.parametrize("mesh", MESHES)
    def test_placements_hold_the_references_slices(self, ref, port_meshes,
                                                   leaf, mesh):
        """By mesh coordinate: the slice ``placements()`` gives a
        coordinate equals the reference's slice at that coordinate."""
        from torch.distributed.tensor._utils import \
            _compute_local_shape_and_global_offset
        import itertools
        arch, kind, name = leaf
        cfg = get_config(arch)
        dm = port_meshes[mesh]
        rules = S.make_rules(cfg, dm, cfg.plan)
        if kind == "param":
            params = _meta_params(arch, cfg.plan)
            spec = PS.param_spec_tree(params, rules)[name]
            shape = tuple(dict(params.named_parameters())[name].shape)
        else:
            cache = T.init_cache(cfg, *CACHE_SHAPES[0], torch.device("meta"))
            spec = PS.cache_shardings(cache, rules)[0][name]
            shape = tuple(cache[0][name].shape)
        want = ref["slices"][f"{arch}|{kind}|{name}|{mesh}"]
        assert (list(shape), spec) == (want["shape"], _tup(want["spec"]))
        placements = S.to_placements(spec, dm)
        coords = list(itertools.product(*[range(n) for n in dm.shape]))
        assert len(coords) == len(want["rows"]) == dm.size()
        sharded = 0
        for coord, row in zip(coords, want["rows"]):
            size, off = _compute_local_shape_and_global_offset(
                shape, tuple(dm.shape), list(coord), placements)
            got = [[o, o + n] for o, n in zip(off, size)]
            assert got == row, coord
            sharded += math.prod(size) < math.prod(shape)
        assert sharded == len(coords)        # every leaf here is sharded


def test_no_group_outlives_its_fixture():
    assert not dist.is_initialized()


def test_reference_dump_covers_every_case(ref):
    assert set(ref["specs"]) == {f"{a}|{m}|{p}" for a, m, p in CASES}
    assert len(ref["slices"]) == len(SLICED) * len(MESHES)


# ---------------------------------------------------------------------------
# Meshes, placements, constrain, the rules plumbing and the measured rung
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def fake_world(n: int):
    """A fake process group of ``n`` ranks for a block."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    assert not dist.is_initialized()
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=n)
    try:
        yield
    finally:
        dist.destroy_process_group()


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


def test_production_mesh_needs_a_world_of_256_or_512():
    with pytest.raises(RuntimeError, match="initialised process group"):
        M.make_production_mesh(device_type="cpu")
    for world in (1, 4, 255, 257, 384, 1024):
        with fake_world(world):
            for multi_pod in (False, True):
                with pytest.raises(RuntimeError, match="never shrunk"):
                    M.make_production_mesh(multi_pod=multi_pod,
                                           device_type="cpu")
    with fake_world(256):
        with pytest.raises(RuntimeError, match="never shrunk"):
            M.make_production_mesh(multi_pod=True, device_type="cpu")
        dm = M.make_production_mesh(device_type="cpu")
        assert (tuple(dm.shape), dm.mesh_dim_names) == \
            ((16, 16), ("data", "model"))
    with fake_world(512):
        dm = M.make_production_mesh(multi_pod=True, device_type="cpu")
        assert (tuple(dm.shape), dm.mesh_dim_names) == \
            ((2, 16, 16), ("pod", "data", "model"))


def test_importing_the_mesh_module_touches_no_device_state():
    code = ("import torch.distributed as d, torch; "
            "import repro_torch.launch.mesh; "
            "assert not d.is_initialized(); "
            "assert not torch.cuda.is_initialized()")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=dict(os.environ,
                                             PYTHONPATH=str(ROOT / "src")))
    assert res.returncode == 0, res.stderr


def test_host_mesh_on_the_cpu_is_one_by_one_and_every_spec_replicated(
        cpu_host_mesh):
    dm = cpu_host_mesh
    assert (tuple(dm.shape), dm.mesh_dim_names) == ((1, 1),
                                                    ("data", "model"))
    assert dist.get_backend() == "gloo" and dist.get_world_size() == 1
    cfg = get_config("qwen2-7b")
    params = _meta_params("qwen2-7b", cfg.plan)
    for p in [cfg.plan] + [optimized_plan("qwen2-7b", k)
                           for k in ("train", "prefill", "decode")]:
        rules = S.make_rules(dataclasses.replace(cfg, plan=p), dm, p)
        specs = list(PS.param_spec_tree(params, rules).values())
        cache = T.init_cache(dataclasses.replace(cfg, plan=p), 8, 32768,
                             torch.device("meta"))
        specs += [s for layer in PS.cache_shardings(cache, rules)
                  for s in layer.values()]
        specs += list(PS.batch_shardings(Model(cfg, p, "cpu"),
                                         SHAPES["decode_32k"],
                                         rules).values())
        assert all(S.n_shards(s, dm) == 1 for s in specs)


def test_host_mesh_keeps_a_group_it_found():
    with fake_world(4):
        dm = M.make_host_mesh(model_axis=2, device="cpu")
        assert tuple(dm.shape) == (2, 2)
        with pytest.raises(ValueError, match="does not divide"):
            M.make_host_mesh(model_axis=3, device="cpu")
        M.destroy_host_mesh()
        assert dist.is_initialized()


def test_placements_order_split_dims_by_mesh_dim():
    from torch.distributed.tensor import Replicate, Shard
    with fake_world(512):
        dm = M.make_production_mesh(multi_pod=True, device_type="cpu")
        assert S.to_placements((None, ("pod", "data"), "model"), dm) == \
            (Shard(1), Shard(1), Shard(2))
        assert S.to_placements((), dm) == (Replicate(),) * 3
        with pytest.raises(ValueError, match="out of the mesh's order"):
            S.to_placements((("data", "pod"),), dm)
        with pytest.raises(ValueError, match="shards two dims"):
            S.to_placements(("model", "model"), dm)


def test_constrain_leaves_a_plain_tensor_and_redistributes_a_dtensor():
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    cfg = get_config("qwen2-7b")
    x = torch.randn(4, 6, 8)
    with fake_world(4):
        dm = M.make_host_mesh(model_axis=2, device="cpu")
        rules = S.make_rules(cfg, dm, cfg.plan)
        assert S.constrain(x, rules, "batch", "seq_sharded",
                           "act_embed") is x
        dx = distribute_tensor(x, dm, [Replicate(), Replicate()])
        y = S.constrain(dx, rules, "batch", "seq_sharded", "act_embed")
        assert y.placements == (Shard(0), Shard(1))
        # a dim the axis does not divide keeps it replicated
        dz = distribute_tensor(torch.randn(3, 5, 8), dm,
                               [Replicate(), Replicate()])
        z = S.constrain(dz, rules, "batch", "seq_sharded", "act_embed")
        assert z.placements == (Replicate(), Replicate())
        # a layout the mesh cannot express raises, it is not swallowed
        bad = S.ShardingRules(rules={"batch": ("model", "data")}, mesh=dm)
        with pytest.raises(ValueError, match="order"):
            S.constrain(dx, bad, "batch")
        M.destroy_host_mesh()


def test_rules_on_the_host_mesh_change_no_output_bit(cpu_host_mesh):
    """Forward, prefill and decode (and the serve engine's step makers)
    under rules on the ``(1, 1)`` mesh equal the runs without rules bit for
    bit."""
    from repro_torch.serve.engine import make_decode_step, make_prefill
    cfg = get_config("tiny-test")
    model = Model(cfg, device="cpu")
    params = model.init(torch.Generator().manual_seed(0))
    rules = S.make_rules(cfg, cpu_host_mesh, cfg.plan)
    toks = torch.randint(0, cfg.vocab_size, (2, 12),
                         generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        assert torch.equal(model.forward(params, {"tokens": toks}, rules),
                           model.forward(params, {"tokens": toks}))
        loss, _ = model.loss(params, {"tokens": toks[:, :-1],
                                      "targets": toks[:, 1:]}, rules)
        want, _ = model.loss(params, {"tokens": toks[:, :-1],
                                      "targets": toks[:, 1:]})
        assert torch.equal(loss, want)
        outs = []
        for r in (rules, None):
            cache = model.init_cache(2, 16)
            last, cache = make_prefill(model, r)(
                params, {"tokens": toks[:, :10]}, cache)
            step, cache = make_decode_step(model, r)(
                params, {"tokens": toks[:, 10:11], "pos": 10}, cache)
            outs.append((last, step))
        assert all(torch.equal(a, b) for a, b in zip(*outs))


def test_input_specs_equal_the_references():
    from repro.configs import get_config as jget
    from repro.models.model import Model as JModel
    for arch in ("qwen2-7b", "hubert-xlarge", "internvl2-76b"):
        model, jm = Model(get_config(arch), device="cpu"), JModel(jget(arch))
        for shape in SHAPES.values():
            got, want = model.input_specs(shape), jm.input_specs(shape)
            assert {k: (v.shape, str(v.dtype).split(".")[-1])
                    for k, v in got.items()} == \
                {k: (tuple(v.shape), str(v.dtype)) for k, v in want.items()}
            assert model.batch_spec_names(shape) == \
                jm.batch_spec_names(shape)


def test_measured_rung_refuses_a_context_larger_than_its_mesh(
        cpu_host_mesh, monkeypatch):
    """The measured rung runs on the mesh it is given: n_chips or tp above
    it raises before any trial; a one-card context on the ``(1, 1)`` mesh
    measures the same logits as the rung without a mesh."""
    from repro_torch.configs import CARD_SHAPES, ShapeSpec
    from repro_torch.core import backends
    from repro_torch.telemetry.sampler import ConstantSource
    monkeypatch.setitem(CARD_SHAPES, "cpu_decode",
                        ShapeSpec("cpu_decode", 48, 2, "decode"))
    cfg = get_config("tiny-test")
    plan = optimized_plan("tiny-test", "decode")
    outs = []
    for mesh in (cpu_host_mesh, None):
        rung = backends.MeasuredBackend(device="cpu", mesh=mesh,
                                        source=ConstantSource(250.0),
                                        window_s=0.02, decode_steps=3)
        for n, tp in ((256, 16), (2, 1), (1, 2)):
            with pytest.raises(ValueError, match="mesh holds 1 devices"):
                rung.measure(backends.MeasureContext(
                    cfg, "cpu_decode", n_chips=n, tp=tp), plan)
        assert not rung.outputs
        m = rung.measure(backends.MeasureContext(cfg, "cpu_decode"), plan)
        assert m.ok
        outs.append(rung.outputs[backends.plan_tag(plan)])
    assert torch.equal(*outs)


def test_no_group_is_left_behind():
    assert not dist.is_initialized()
