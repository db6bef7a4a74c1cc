"""Collectives on several ranks: ``compressed_psum``, restoring a
checkpoint onto a mesh, the rules train step and the kernels on
``DTensor``s, over gloo on the CPU.

Each group is real: processes, one a rank (``python -c WORKER``), meet over a
``FileStore`` in the test's temporary directory, run their part and write
one JSON file each; the tests read them.  The reference's side comes from
one jax subprocess with 4 host devices: its ``compressed_psum`` under
``shard_map`` on the same per-rank numpy inputs, and the slice
``NamedSharding.devices_indices_map`` gives each device of a ``(2, 2)``
``("data", "model")`` mesh for the specs the checkpoint is restored onto.

Tolerances:
  * ``compressed_psum`` equals the reference's bit for bit (the same f32
    and int32 arithmetic in the same order); on one rank it lies within
    half a quantization step of its input (``tests/test_substrates.py``).
  * A restored shard equals the reference's slice for that mesh
    coordinate, and its values the whole leaf's slice, bit for bit; a
    checkpoint written unsharded restores sharded and, saved again from
    the ``DTensor``s, restores unsharded bit for bit.
  * The kernels' wrappers on sharded ``DTensor`` inputs (forward, and the
    gradients of the inputs) equal their plain versions on the whole
    tensors bit for bit: every rank runs the plain version on the whole
    tensors that ``local_map`` hands it.
  * The rules train step on two ranks (``tiny-lm``) against the step
    without rules from the same weights and batch.  On a ``(1, 2)`` mesh
    the model axis splits every layer's products (``parallel.tp``), so
    each rank's part of a reduced product is a partial sum that rounds on
    its own: the case ``model_axis_bf16_int8_ef`` (int8 error feedback,
    ``fused_grad_reduce``) runs the f32 compute dtype, its loss and
    gradient norm within 1e-6 relative, and its gradients (max gap over
    the largest element) and parameters after the step (relative
    Frobenius norm) within twice the plain step's own distance from the
    same step in f64 (``own``: two f32 roundings of the same sums; an
    int8 block's rounding can land a step apart there, as it does between
    f32 and f64); ``model_axis_bf16_partial_sums`` runs the plan's bf16
    compute, its loss and gradient norm within 2^-8 relative (one bf16
    rounding of a reduced sum), its gradients and parameters within twice
    the plain bf16 step's distance from the f32 step.  On a ``(2, 1)`` mesh the
    batch is split and each rank's gradient is a partial sum: in bf16
    compute the two halves round separately (a 2^-8 difference, as any
    data-parallel sum), so this mesh runs the f32 compute dtype, two
    microbatches and ``fused_grad_reduce``; the gradients lie within 1e-6
    of their largest element, and the parameters after the AdamW step
    within 1e-6 in relative Frobenius norm (its first update is
    g/(|g| + 1e-8), which magnifies a last-bit difference of a gradient
    near zero in a single element).
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist

ROOT = Path(__file__).resolve().parents[1]
N_PSUM = 1000                   # not a multiple of the 512-element block
#: checkpoint leaves restored onto the (2, 2) mesh: name -> (shape, dtype,
#: spec)
LEAVES = {"w": ((8, 6), "float32", ["data", "model"]),
          "b": ((6,), "bfloat16", ["model"]),
          "e": ((8, 4, 2), "float32", [["data", "model"], None, None]),
          "s": ((3,), "float32", [])}


def _psum_input(rank: int) -> np.ndarray:
    return (np.random.default_rng(100 + rank).normal(size=(N_PSUM,)) * 5) \
        .astype(np.float32)


def _leaf(name: str) -> np.ndarray:
    shape, _, _ = LEAVES[name]
    return np.random.default_rng(sum(map(ord, name))).normal(size=shape) \
        .astype(np.float32)


REFERENCE = r'''
import json, sys
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import numpy as np
import jax, jax.numpy as jnp
from functools import partial
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from jax.experimental.shard_map import shard_map
from repro.train import compress as CP
args = json.loads(sys.argv[1])
xs = np.stack([np.asarray(x, np.float32) for x in args["inputs"]])
mesh1 = Mesh(np.asarray(jax.devices()[:4]), ("data",))

@partial(shard_map, mesh=mesh1, in_specs=P("data"), out_specs=P("data"))
def reduced(v):
    return CP.compressed_psum(v[0], "data")[None]

out = {"psum": np.asarray(reduced(jnp.asarray(xs))).tolist()}
mesh = Mesh(np.asarray(jax.devices()[:4]).reshape(2, 2), ("data", "model"))
out["slices"] = {}
for name, (shape, spec) in args["leaves"].items():
    s = P(*[tuple(e) if isinstance(e, list) else e for e in spec])
    imap = NamedSharding(mesh, s).devices_indices_map(tuple(shape))
    rows = []
    for dev in mesh.devices.reshape(-1):
        rows.append([[x.start or 0, shape[d] if x.stop is None else x.stop]
                     for d, x in enumerate(imap[dev])])
    out["slices"][name] = rows
json.dump(out, sys.stdout)
'''

WORKER = r'''
import json, sys, time
import numpy as np
import torch, torch.distributed as dist
rank, world, store, out_dir, job = (int(sys.argv[1]), int(sys.argv[2]),
                                    sys.argv[3], sys.argv[4], sys.argv[5])
args = json.loads(sys.argv[6])
dist.init_process_group("gloo", store=dist.FileStore(store, world),
                        rank=rank, world_size=world)
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import DTensor, Replicate, Shard
from repro_torch.parallel import sharding as S
res = {"rank": rank}


def spec(s):
    return tuple(tuple(e) if isinstance(e, list) else e for e in s)


def from_np(a, dtype):
    t = torch.from_numpy(np.asarray(a, np.float32))
    return t.to(getattr(torch, dtype))


if job == "four":
    from repro_torch.ckpt import checkpoint as ckpt
    from repro_torch.kernels import ops
    from repro_torch.kernels import ref as R
    from repro_torch.train import compress as C
    # compressed_psum of this rank's input over the world
    x = torch.from_numpy(np.asarray(args["inputs"][rank], np.float32))
    res["psum"] = C.compressed_psum(x).tolist()
    # a checkpoint written unsharded (by rank 0), restored onto (2, 2)
    dm = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
    tree = {"p": {k: from_np(v["value"], v["dtype"])
                  for k, v in args["leaves"].items()}}
    if rank == 0:
        ckpt.save(f"{out_dir}/plain", 1, tree)
    dist.barrier()
    shard = {"p": {k: (dm, S.to_placements(spec(v["spec"]), dm))
                   for k, v in args["leaves"].items()}}
    back, _ = ckpt.restore(f"{out_dir}/plain", 1, tree, shardings=shard)
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset
    res["shards"] = {}
    for k, t in back["p"].items():
        size, off = compute_local_shape_and_global_offset(
            t.shape, dm, t.placements)
        whole = tree["p"][k]
        part = whole[tuple(slice(o, o + n) for o, n in zip(off, size))]
        loc = t.to_local()
        res["shards"][k] = {
            "rows": [[o, o + n] for o, n in zip(off, size)],
            "equal": bool(torch.equal(loc, part)),
            "own": loc.untyped_storage().nbytes() == loc.numel()
            * loc.element_size(),
            "placements": str(t.placements)}
    # ... saved again from the DTensors, restored unsharded
    ckpt.save(f"{out_dir}/again", 2, back)
    again, _ = ckpt.restore(f"{out_dir}/again", 2, tree)
    res["round_trip"] = all(torch.equal(again["p"][k], tree["p"][k])
                            and again["p"][k].dtype == tree["p"][k].dtype
                            for k in tree["p"])
    # the kernels on sharded DTensor inputs against the plain versions
    g = torch.Generator().manual_seed(0)

    def rnd(*shape):
        return torch.randn(shape, generator=g)
    cases = {
        "flash_attention": (
            lambda q, k, v: ops.flash_attention(q, k, v, True, 0),
            lambda q, k, v: R.flash_attention_ref(q, k, v, True, 0),
            [rnd(4, 16, 4, 8), rnd(4, 16, 2, 8), rnd(4, 16, 2, 8)],
            [[Shard(0), Shard(2)], [Shard(0), Replicate()],
             [Replicate(), Shard(1)]]),
        "swiglu": (
            ops.fused_swiglu,
            lambda x, wi, wg, wo: R.swiglu_ref(
                x.reshape(-1, x.shape[-1]), wi, wg, wo).reshape(x.shape),
            [rnd(4, 8, 16), rnd(16, 32) / 4, rnd(16, 32) / 4,
             rnd(32, 16) / 6],
            [[Shard(0), Shard(1)], [Replicate(), Shard(1)],
             [Shard(1), Replicate()], [Shard(0), Shard(0)]]),
        "ssd": (
            lambda *a: ops.ssd(*a, chunk=8),
            lambda *a: R.ssd_ref(*a, 8),
            [rnd(2, 16, 2, 4), torch.rand((2, 16, 2), generator=g) * 0.1,
             -torch.rand((2,), generator=g) - 0.5, rnd(2, 16, 4),
             rnd(2, 16, 4)],
            [[Shard(0), Shard(2)], [Shard(0), Replicate()],
             [Replicate(), Replicate()], [Replicate(), Shard(1)],
             [Shard(0), Shard(2)]]),
        "rglru": (
            ops.rglru, R.rglru_ref,
            [-torch.rand((2, 16, 8), generator=g), rnd(2, 16, 8)],
            [[Shard(0), Shard(2)], [Replicate(), Shard(1)]]),
    }
    res["kernels"] = {}
    for name, (fn, plain, xs, pls) in cases.items():
        want_in = [x.clone().requires_grad_() for x in xs]
        want = plain(*want_in)
        want = want if isinstance(want, tuple) else (want,)
        cots = [torch.randn(w.shape, generator=g) for w in want]
        wgrads = torch.autograd.grad(want, want_in, cots)
        got_in = [DTensor.from_local(x, dm, [Replicate(), Replicate()])
                  .redistribute(dm, p).detach().requires_grad_()
                  for x, p in zip(xs, pls)]
        got = fn(*got_in)
        got = got if isinstance(got, tuple) else (got,)
        ggrads = torch.autograd.grad(
            got, got_in, [DTensor.from_local(c, dm, [Replicate()] * 2)
                          for c in cots])
        res["kernels"][name] = {
            "dtensor_out": all(isinstance(o, DTensor) for o in got),
            "forward": all(torch.equal(o.full_tensor(), w)
                           for o, w in zip(got, want)),
            "grads": all(torch.equal(a.full_tensor(), b)
                         for a, b in zip(ggrads, wgrads)),
            "grad_placements": [str(a.placements) == str(tuple(p))
                                for a, p in zip(ggrads, pls)]}
elif job == "train":
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.launch import mesh as M
    from repro_torch.models.model import Model
    from repro_torch.parallel.param_sharding import distribute
    from repro_torch.parallel.sharding import mixed_inputs
    from repro_torch.train.step import (make_grad_step, make_opt_init,
                                        make_train_step)
    res["cases"] = {}
    for case in args["cases"]:
        t_case = time.perf_counter()
        cfg = get_config(args["arch"])
        plan = cfg.plan.replace(**case["plan"])
        cfg = dataclasses.replace(cfg, plan=plan)
        model = Model(cfg, plan, "cpu")
        toks = torch.from_numpy(np.asarray(args["tokens"], np.int32))
        batch = {"tokens": toks[:, :-1], "targets": toks[:, 1:]}

        def weights():
            return model.init(torch.Generator().manual_seed(0))
        p0 = weights()
        g0, _ = make_grad_step(model)(p0, batch)
        o0 = make_opt_init(model)(p0)
        p0, _, m0 = make_train_step(model)(p0, o0, batch)
        dm = M.make_host_mesh(model_axis=case["model_axis"], device="cpu")
        rules = S.make_rules(cfg, dm, plan)
        p1 = weights()
        o1 = make_opt_init(model)(p1)
        p1, o1, _ = distribute(rules, p1, o1)
        with mixed_inputs(p1.embed):
            g1, _ = make_grad_step(model, rules)(p1, batch)
        pinned = all(g1[n].placements == p.placements
                     for n, p in p1.named_parameters())
        p1, o1, m1 = make_train_step(model, rules)(p1, o1, batch)
        named1 = dict(p1.named_parameters())
        out = {"loss": [float(m0["loss"]), float(m1["loss"].full_tensor())],
               "grad_norm": [float(m0["grad_norm"]),
                             float(m1["grad_norm"].full_tensor())],
               "pinned": pinned, "grad_max": 0.0,
               "param_fro": 0.0,
               "placements": sorted({str(p.placements)
                                     for p in named1.values()}),
               "state_dtensor": all(isinstance(v, DTensor)
                                    for v in o1["m"].values())}
        for n, a in p0.named_parameters():
            b = named1[n].full_tensor()
            scale = float(a.abs().max()) or 1.0
            out["param_fro"] = max(out["param_fro"], float(
                torch.linalg.vector_norm(a - b)
                / torch.linalg.vector_norm(a)))
            ga, gb = g0[n], g1[n].full_tensor()
            out["grad_max"] = max(out["grad_max"], float(
                (ga - gb).abs().max() / (ga.abs().max() + 1e-30)))
        if "truth" in case:
            # the plain step again with its products in a wider dtype: how
            # far the plain step's own rounding lies from it
            cfg_t = dataclasses.replace(cfg, plan=plan.replace(
                **case["truth"]))
            model_t = Model(cfg_t, cfg_t.plan, "cpu")
            pt = model_t.init(torch.Generator().manual_seed(0))
            gt, _ = make_grad_step(model_t)(pt, batch)
            pt, _, mt = make_train_step(model_t)(
                pt, make_opt_init(model_t)(pt), batch)
            named_t = dict(pt.named_parameters())
            own = {"loss": 0.0, "grad_norm": 0.0, "grad_max": 0.0,
                   "param_fro": 0.0}
            for what in ("loss", "grad_norm"):
                own[what] = abs(float(m0[what]) - float(mt[what])) \
                    / abs(float(mt[what]))
            for n, a in p0.named_parameters():
                b = named_t[n].to(a.dtype)
                own["param_fro"] = max(own["param_fro"], float(
                    torch.linalg.vector_norm(a - b)
                    / torch.linalg.vector_norm(b)))
                ga, gb = g0[n].double(), gt[n].double()
                own["grad_max"] = max(own["grad_max"], float(
                    (ga - gb).abs().max() / (gb.abs().max() + 1e-30)))
            out["own"] = own
        out["seconds"] = time.perf_counter() - t_case
        res["cases"][case["name"]] = out
with open(f"{out_dir}/rank{rank}.json", "w") as f:
    json.dump(res, f)
dist.destroy_process_group()
'''


def _run_group(job: str, world: int, args: dict, tmp: Path) -> list:
    """``world`` worker processes of ``job`` over a FileStore in ``tmp``;
    returns each rank's JSON."""
    tmp.mkdir(parents=True, exist_ok=True)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="2")
    env.pop("JAX_PLATFORMS", None)
    procs = [subprocess.Popen(
        [sys.executable, "-c", WORKER, str(r), str(world),
         str(tmp / "store"), str(tmp), job, json.dumps(args)],
        env=env, cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for r in range(world)]
    errs = []
    for p in procs:
        _, err = p.communicate(timeout=300)
        if p.returncode:
            errs.append(err[-3000:])
    assert not errs, errs[0]
    return [json.loads((tmp / f"rank{r}.json").read_text())
            for r in range(world)]


@pytest.fixture(scope="module")
def ref():
    args = {"inputs": [_psum_input(r).tolist() for r in range(4)],
            "leaves": {k: (list(s), spec) for k, (s, _, spec)
                       in LEAVES.items()}}
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run([sys.executable, "-c", REFERENCE, json.dumps(args)],
                         capture_output=True, text=True, env=env, cwd=ROOT,
                         timeout=300)
    assert res.returncode == 0, res.stderr[-4000:]
    return json.loads(res.stdout)


@pytest.fixture(scope="module")
def four(tmp_path_factory):
    args = {"inputs": [_psum_input(r).tolist() for r in range(4)],
            "leaves": {k: {"value": _leaf(k).tolist(), "dtype": dt,
                           "spec": spec}
                       for k, (_, dt, spec) in LEAVES.items()}}
    return _run_group("four", 4, args, tmp_path_factory.mktemp("four"))


TRAIN_CASES = [
    {"name": "model_axis_bf16_int8_ef", "model_axis": 2,
     "plan": {"fused_grad_reduce": True, "grad_compress": "int8_ef",
              "compute_dtype": "float32"},
     "truth": {"compute_dtype": "float64", "param_dtype": "float64",
               "accum_dtype": "float64"}},
    {"name": "model_axis_bf16_partial_sums", "model_axis": 2,
     "plan": {"fused_grad_reduce": True, "grad_compress": "int8_ef"},
     "truth": {"compute_dtype": "float32"}},
    {"name": "data_axis_f32_microbatches", "model_axis": 1,
     "plan": {"fused_grad_reduce": True, "compute_dtype": "float32",
              "microbatches": 2}},
]


@pytest.fixture(scope="module")
def train(tmp_path_factory):
    toks = np.random.default_rng(1).integers(0, 32000, (4, 17))
    args = {"arch": "tiny-lm", "cases": TRAIN_CASES,
            "tokens": toks.astype(np.int32).tolist()}
    return _run_group("train", 2, args, tmp_path_factory.mktemp("train"))


# ---------------------------------------------------------------------------
# compressed_psum
# ---------------------------------------------------------------------------

def test_compressed_psum_equals_the_references_bit_for_bit(ref, four):
    want = np.asarray(ref["psum"], np.float32)
    assert want.shape == (4, N_PSUM)
    for r in four:
        got = np.asarray(r["psum"], np.float32)
        assert np.array_equal(got, want[r["rank"]]), r["rank"]
        assert np.array_equal(got, want[0])     # the same on every rank


def test_compressed_psum_one_rank_bound():
    """On one rank: within one quantization step of its input (the
    reference's ``tests/test_substrates.py`` bound)."""
    from repro_torch.launch.mesh import host_mesh
    from repro_torch.train import compress as C
    x = torch.from_numpy((np.random.default_rng(1).normal(size=(256,))
                          * 5).astype(np.float32))
    with host_mesh(device="cpu"):
        y = C.compressed_psum(x)
    assert not dist.is_initialized()
    _, s = C.quantize(x)
    assert float((y - x).abs().max()) <= float(s.max()) * 0.5 + 1e-5
    assert y.dtype == x.dtype and y.shape == x.shape


# ---------------------------------------------------------------------------
# Restoring onto a mesh
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("leaf", sorted(LEAVES))
def test_restored_shards_are_the_references_slices(ref, four, leaf):
    want = ref["slices"][leaf]
    for r in four:
        got = r["shards"][leaf]
        assert got["rows"] == want[r["rank"]], (leaf, r["rank"])
        assert got["equal"] and got["own"], (leaf, r["rank"])
    if LEAVES[leaf][2]:
        # a sharded leaf: not every rank holds all of it
        assert len({json.dumps(r["shards"][leaf]["rows"])
                    for r in four}) > 1


def test_checkpoint_round_trip_through_the_mesh(four):
    assert all(r["round_trip"] for r in four)


# ---------------------------------------------------------------------------
# The kernels on DTensors
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kernel", ["flash_attention", "swiglu", "ssd",
                                    "rglru"])
def test_kernels_on_sharded_dtensors_equal_their_plain_versions(four,
                                                                kernel):
    for r in four:
        k = r["kernels"][kernel]
        assert k["dtensor_out"] and k["forward"], (kernel, r["rank"])
        assert k["grads"], (kernel, r["rank"])
        # each input's gradient comes back on the input's placements
        assert all(k["grad_placements"]), (kernel, r["rank"])


# ---------------------------------------------------------------------------
# The rules train step
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", [c["name"] for c in TRAIN_CASES])
def test_rules_train_step_equals_the_step_without_rules(train, case):
    bf16 = case == "model_axis_bf16_partial_sums"
    for r in train:
        c = r["cases"][case]
        own = c.get("own")
        for what in ("loss", "grad_norm"):
            plain, rules = c[what]
            # bf16: a reduced sum of two bf16-rounded halves, within one
            # bf16 rounding unit
            assert rules == pytest.approx(plain, rel=2.0 ** -8 if bf16
                                          else 1e-6), (what, r["rank"])
        assert c["pinned"] and c["state_dtensor"]
        if own is None:
            assert c["grad_max"] <= 1e-6, c["grad_max"]
            assert c["param_fro"] <= 1e-6, c["param_fro"]
        else:
            # the model axis splits products: within two roundings of the
            # plain step's own (its distance from the wider-dtype step)
            assert c["grad_max"] <= 2 * own["grad_max"], (c["grad_max"], own)
            assert c["param_fro"] <= 2 * own["param_fro"], \
                (c["param_fro"], own)
    # the weights really were laid out over the mesh
    shards = [p for p in train[0]["cases"][case]["placements"]
              if "Shard" in p]
    assert shards, train[0]["cases"][case]["placements"]


def test_no_group_left_behind():
    assert not dist.is_initialized()
