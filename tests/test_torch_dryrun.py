"""The port's pod dry run (``launch.dryrun``) and collective census
(``core.transfer``) against the reference's.

The reference's side comes from one subprocess per module that forces 512
host devices before jax starts and runs ``repro.launch.dryrun.run_cell``
(its JSON cache in a temporary directory) for a short list of cells —
tiny-test, qwen2-7b, mamba2-1.3b and granite-moe-1b-a400m at decode_32k
and prefill_32k on both pod meshes — and for tiny-test's train_4k cells,
counting every ``with_sharding_constraint`` call and every one that raised;
and for qwen2-7b's decode_32k cell on pod16x16 it dumps
``parse_collectives`` of its compiled HLO with its ``census`` and
``batching_report``.

What is held, and how closely:
  * ``memory.argument_size_in_bytes`` per rank equals the reference's to
    the byte, for every cell of the list: the port's build stage (the fake
    256/512-rank group, the meta ``DTensor``s) gives it, and it does not
    depend on the trace.  One exception, stated: where no layer attends
    (mamba2-1.3b) the reference's ``jax.jit`` prunes the arguments the
    step never reads (its ``keep_unused=False``) — a decode step's
    ``pos`` (4 bytes) and a prefill's whole cache, whose states the SSM
    prefill writes without reading — and the port counts them.
  * Cells run whole (build, trace, analyze) here, chosen for the suite's
    time (tiny-test's 16-position attention chunks make its 32k cells
    minutes long on the meta device): qwen2-7b decode_32k on pod16x16 and
    mamba2-1.3b decode_32k on pod2x16x16 end OK, with ``model_flops``
    equal to the reference's and the traced global FLOPs within a factor
    of 2 of ``estimate_program``'s (both count the same layers; the trace
    adds the attention over the whole 32k cache and the norms, the
    estimate its own site model); granite-moe-1b-a400m decode_32k ends
    FAIL naming the op that has no DTensor sharding strategy (the MoE
    dispatch's ``aten.searchsorted``); tiny-test train_4k ends OK.
  * C8: the reference's train cells FAIL with jax's "can only refer to
    Auto axes" (its ``jax.make_mesh`` builds Explicit axes), and its
    inference cells lower with every activation constraint dropped:
    each ``with_sharding_constraint`` call raises the same error inside
    ``parallel.sharding.constrain``, which swallows it.
  * ``census`` and ``batching_report`` equal the reference's on the same
    op list; ``CollectiveRecorder`` records DTensor's collectives with the
    reference's payload rule.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch
import torch.distributed as dist

from repro_torch.configs import SHAPES, get_config
from repro_torch.core import transfer as TR
from repro_torch.launch import dryrun as D

ROOT = Path(__file__).resolve().parents[1]
MESHES = {"pod16x16": False, "pod2x16x16": True}
ARCHS = ("tiny-test", "qwen2-7b", "mamba2-1.3b", "granite-moe-1b-a400m")
CELLS = [(a, s, m) for a in ARCHS for s in ("decode_32k", "prefill_32k")
         for m in MESHES]
TRAIN_CELLS = [("tiny-test", "train_4k", m) for m in MESHES]
CENSUS_CELL = ("qwen2-7b", "decode_32k", "pod16x16")
#: the traced FLOPs against estimate_program's, either way
FLOP_FACTOR = 2.0
C8 = "can only refer to Auto axes"

REFERENCE = r'''
import json, sys
from pathlib import Path
from repro.launch.dryrun import setup_host_devices
setup_host_devices(512)
import jax
import repro.launch.dryrun as D
from repro.core.transfer import batching_report, census, parse_collectives
args = json.loads(sys.argv[1])
D.ART = Path(args["art"])
calls = {}
orig = jax.lax.with_sharding_constraint


def counted(x, s):
    calls["n"] += 1
    try:
        return orig(x, s)
    except (ValueError, RuntimeError) as e:
        calls["raised"] += 1
        calls["errors"].add(str(e)[:120])
        raise


jax.lax.with_sharding_constraint = counted
out = {"cells": {}}
for a, s, m in args["cells"]:
    calls.update(n=0, raised=0, errors=set())
    rec = D.run_cell(a, s, m == "pod2x16x16", force=True)
    rec.pop("trace", None)
    rec["constraints"] = {"calls": calls["n"], "raised": calls["raised"],
                          "errors": sorted(calls["errors"])}
    out["cells"]["|".join((a, s, m))] = rec
a, s, m = args["census"]
from repro.launch.mesh import make_production_mesh
mesh = make_production_mesh(multi_pod=m == "pod2x16x16")
fn, fargs, in_sh, out_sh, donate, cfg, shape = D.build_step(a, s, mesh)
with mesh:
    hlo = jax.jit(fn, in_shardings=in_sh, out_shardings=out_sh,
                  donate_argnums=donate).lower(*fargs).compile().as_text()
rep = batching_report(hlo)
out["census"] = {
    "ops": [[o.kind, o.payload_bytes, o.shape_sig]
            for o in parse_collectives(hlo)],
    "census": census(hlo),
    "batching": {"groups": rep.groups, "fusible_ops": rep.fusible_ops,
                 "fusible_bytes": rep.fusible_bytes}}
json.dump(out, sys.stdout)
'''


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    args = {"cells": CELLS + TRAIN_CELLS, "census": CENSUS_CELL,
            "art": str(tmp_path_factory.mktemp("ref_dryrun"))}
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run([sys.executable, "-c", REFERENCE, json.dumps(args)],
                         capture_output=True, text=True, env=env, cwd=ROOT,
                         timeout=900)
    assert res.returncode == 0, res.stderr[-4000:]
    return json.loads(res.stdout)


def _key(arch, shape, mesh) -> str:
    return "|".join((arch, shape, mesh))


# ---------------------------------------------------------------------------
# The dry run against the reference's
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch,shape,mesh", CELLS)
def test_argument_bytes_equal_the_references(ref, arch, shape, mesh):
    want = ref["cells"][_key(arch, shape, mesh)]
    assert want["status"] == "OK", want.get("error")
    from repro_torch.launch.mesh import make_production_mesh
    with D.fake_world(D.WORLD[MESHES[mesh]]):
        dm = make_production_mesh(multi_pod=MESHES[mesh], device_type="cpu")
        _, args, cfg, sh = D.build_step(arch, shape, dm)
        got = D.local_bytes(args)
        pruned = _pruned(arch, shape, D.local_bytes(args[2]))
    assert not dist.is_initialized()
    assert got - want["memory"]["argument_size_in_bytes"] == pruned
    assert D.model_flops(cfg, sh) == want["model_flops"]


def _pruned(arch: str, shape: str, cache_bytes: int) -> int:
    """Bytes of the arguments the reference's ``jax.jit`` prunes as unused
    (its ``keep_unused=False``) and the port still holds, where no layer
    attends: a decode step's ``pos`` (an int32), and a prefill's whole
    cache (an SSM prefill writes its states without reading them)."""
    if "attn" in get_config(arch).layer_kinds():
        return 0
    return {"decode": 4, "prefill": cache_bytes}[SHAPES[shape].kind]


#: cells the port runs whole here: (arch, shape, mesh) -> its status
PORT_CELLS = {("qwen2-7b", "decode_32k", "pod16x16"): "OK",
              ("mamba2-1.3b", "decode_32k", "pod2x16x16"): "OK",
              ("granite-moe-1b-a400m", "decode_32k", "pod16x16"): "OK",
              ("tiny-test", "train_4k", "pod16x16"): "OK"}
#: a cell's layer kinds, as its record's ``execution`` names them
KINDS = {"qwen2-7b": "attn, embed, logits, mlp",
         "mamba2-1.3b": "embed, logits, ssm",
         "granite-moe-1b-a400m": "attn, embed, logits, moe",
         "tiny-test": "attn, embed, logits, loss, mlp"}


@pytest.fixture(scope="module")
def port(tmp_path_factory):
    art = tmp_path_factory.mktemp("port_dryrun")
    out = {}
    for (a, s, m), _ in PORT_CELLS.items():
        out[(a, s, m)] = D.run_cell(a, s, MESHES[m], art=art)
        assert not dist.is_initialized()        # the fake group is gone
    return out


@pytest.mark.parametrize("cell", list(PORT_CELLS), ids="|".join)
def test_port_cells(ref, port, cell):
    from repro_torch.core.intensity import estimate_program
    rec = port[cell]
    assert rec["status"] == PORT_CELLS[cell], rec.get("error")
    arch, shape, mesh = cell
    want = ref["cells"][_key(*cell)]
    from repro.configs import SHAPES as REF_SHAPES
    from repro.configs import get_config as ref_config
    from repro.launch.dryrun import model_flops as ref_model_flops
    assert rec["n_chips"] == (512 if MESHES[mesh] else 256)
    assert rec["model_flops"] == ref_model_flops(ref_config(arch),
                                                 REF_SHAPES[shape])
    cfg = get_config(arch)
    est = estimate_program(cfg, SHAPES[shape], cfg.plan, rec["n_chips"], 16)
    ratio = rec["flops"] / est.flops
    assert 1 / FLOP_FACTOR <= ratio <= FLOP_FACTOR, ratio
    assert rec["collectives"]["total_count"] > 0
    assert rec["collectives"]["total_bytes"] == sum(
        v["bytes"] for k, v in rec["collectives"].items()
        if isinstance(v, dict))
    assert set(rec["memory"]) >= {"argument_size_in_bytes", "how"}
    assert rec["execution"] == (
        "tp (products split over 'model', weights gathered over the batch "
        "axes only): " + KINDS[arch])
    if want["status"] == "OK":            # the port's cells: no prefill
        assert rec["memory"]["argument_size_in_bytes"] - \
            want["memory"]["argument_size_in_bytes"] == \
            _pruned(arch, shape, 0)
    else:                                   # C8: the reference's train cell
        assert C8 in want["error"]


def test_c9_port_census_is_tensor_parallel(ref, port):
    """C9 repaired: the port's layers split their products over the model
    axis, so its census has the reference's reductions and no gathered
    weight or cache.  Even with every collective of the reference's HLO
    charged once a layer (an upper bound on its loop body's trip count),
    the port's collectives move no more bytes; the batching groups that
    were the MLP weights gathered whole (``f32[3584,18944]``) and the
    seq-sharded cache gathered every layer (``bf16[128,2048,4,128]``) are
    gone.  The roofline row carries the record's ``execution``."""
    from repro_torch.core.roofline import analyze_record
    rec = port[CENSUS_CELL]
    assert rec["status"] == "OK", rec.get("error")
    want = ref["census"]["census"]
    got = rec["collectives"]
    layers = get_config(CENSUS_CELL[0]).n_layers
    assert want["all-reduce"]["count"] > 0
    assert got["all-reduce"]["count"] + got["reduce-scatter"]["count"] > 0
    assert got["total_bytes"] <= layers * want["total_bytes"]
    sigs = {g["sig"] for g in rec["batching"]["groups"]}
    assert not sigs & {"f32[3584,18944]", "bf16[128,2048,4,128]"}, sigs
    assert analyze_record(rec).note == rec["execution"]


@pytest.mark.parametrize("arch,shape,mesh", TRAIN_CELLS)
def test_c8_reference_train_cells_fail_on_explicit_axes(ref, arch, shape,
                                                        mesh):
    want = ref["cells"][_key(arch, shape, mesh)]
    assert want["status"] == "FAIL"
    assert want["error"].startswith("ValueError") and C8 in want["error"]


@pytest.mark.parametrize("arch,shape,mesh", CELLS)
def test_c8_reference_inference_cells_drop_their_constraints(ref, arch,
                                                             shape, mesh):
    """Confirmed: every activation constraint of an inference cell raises
    the Explicit-axes error inside the reference's ``constrain``, which
    swallows it, so the cell lowers with none of them."""
    c = ref["cells"][_key(arch, shape, mesh)]["constraints"]
    assert c["calls"] > 0 and c["raised"] == c["calls"]
    assert all(C8 in e for e in c["errors"])


def test_stage_sidecar_and_record(tmp_path):
    """A run writes its record and its three-stage sidecar; the CLI prints
    one line a cell; a SKIP writes no sidecar."""
    rec = D.run_cell("mamba2-1.3b", "decode_32k", False, art=tmp_path)
    key = "mamba2-1.3b__decode_32k__pod16x16"
    assert rec["status"] == "OK"
    assert json.loads((tmp_path / f"{key}.json").read_text()) == rec
    side = json.loads((tmp_path / f"{key}.stages.json").read_text())
    assert [s["name"] for s in side["stages"]] == ["build", "trace",
                                                   "analyze"]
    assert all(s["util_src"] == "process_time" and 0 <= s["util"] <= 1
               for s in side["stages"])
    skip = D.run_cell("tiny-test", "long_500k", False, art=tmp_path)
    assert skip["status"] == "SKIP"
    assert not (tmp_path / "tiny-test__long_500k__pod16x16.stages.json"
                ).exists()


def test_run_cell_cache_without_sidecar_runs_again(tmp_path, monkeypatch):
    """A cached OK record without its sidecar runs again (the compiled rung
    needs both); a cached SKIP/FAIL record is honoured."""
    monkeypatch.setattr(D, "ART", tmp_path)
    key = "mamba2-1.3b__decode_32k__pod16x16"
    (tmp_path / f"{key}.json").write_text(json.dumps({"status": "OK"}))
    rec = D.run_cell("mamba2-1.3b", "decode_32k", multi_pod=False)
    assert rec["status"] in ("OK", "FAIL") and "arch" in rec
    assert (tmp_path / f"{key}.stages.json").is_file()
    stub = {"status": "SKIP", "reason": "x"}
    (tmp_path / f"{key}.json").write_text(json.dumps(stub))
    assert D.run_cell("mamba2-1.3b", "decode_32k", multi_pod=False) == stub


def test_run_cell_malformed_cache_runs_again(tmp_path, monkeypatch):
    monkeypatch.setattr(D, "ART", tmp_path)
    key = "tiny-test__long_500k__pod16x16"
    (tmp_path / f"{key}.json").write_text("{truncated json...")
    rec = D.run_cell("tiny-test", "long_500k", multi_pod=False)
    assert rec["status"] == "SKIP"
    reread = json.loads((tmp_path / f"{key}.json").read_text())
    assert reread["status"] == rec["status"]


def test_a_cell_refuses_a_live_group(tmp_path):
    """The dry run lays its own fake group: inside another one the cell
    FAILs (recorded), and the caller's group stays."""
    from repro_torch.launch.mesh import host_mesh
    with host_mesh(device="cpu"):
        rec = D.run_cell("mamba2-1.3b", "decode_32k", False, art=tmp_path)
        assert dist.is_initialized()
    assert rec["status"] == "FAIL" and "already initialised" in rec["error"]


def test_cli(tmp_path, monkeypatch, capsys):
    monkeypatch.setattr(D, "ART", tmp_path)
    D.main(["--arch", "tiny-test", "--shape", "long_500k"])
    line = capsys.readouterr().out.strip()
    assert line.split()[:4] == ["tiny-test", "long_500k", "pod16x16", "SKIP"]
    D.main(["--arch", "tiny-test", "--shape", "long_500k", "--multi-pod",
            "--plan-json", json.dumps({"remat": "none"}), "--tag", "_x"])
    assert (tmp_path / "tiny-test__long_500k__pod2x16x16_x.json").is_file()


def test_clamp_microbatches_equals_the_references():
    from repro.launch.dryrun import _clamp_microbatches as ref_clamp
    from repro_torch.launch.mesh import make_production_mesh

    class RefMesh:                 # the reference reads names and shape
        def __init__(self, names, shape):
            import numpy as np
            self.axis_names = names
            self.devices = np.zeros(shape)
    for mp in (False, True):
        with D.fake_world(D.WORLD[mp]):
            dm = make_production_mesh(multi_pod=mp, device_type="cpu")
            rm = RefMesh(dm.mesh_dim_names, tuple(dm.shape))
            for arch in ("qwen2-7b", "llama3-405b", "mamba2-1.3b"):
                for plan in (get_config(arch).plan,
                             get_config(arch).plan.replace(use_tp=False)):
                    for s in SHAPES.values():
                        assert D._clamp_microbatches(plan, s, dm) == \
                            ref_clamp(plan, s, rm)


# ---------------------------------------------------------------------------
# The census
# ---------------------------------------------------------------------------

def test_census_and_batching_equal_the_references(ref):
    c = ref["census"]
    ops = [TR.CollectiveOp(k, b, s) for k, b, s in c["ops"]]
    assert ops                          # the cell has collectives
    assert TR.census(ops) == c["census"]
    rep = TR.batching_report(ops)
    assert rep.groups == c["batching"]["groups"]
    assert rep.fusible_ops == c["batching"]["fusible_ops"]
    assert rep.fusible_bytes == c["batching"]["fusible_bytes"]
    for n in (1, 2, 8):
        want = sorted(c["ops"], key=lambda o: (o[0], o[2]))
        assert TR.batching_report(ops, min_repeat=n).fusible_ops == \
            _fusible(want, n)


def _fusible(ops, n) -> int:
    groups: dict = {}
    for k, _, s in ops:
        groups[(k, s)] = groups.get((k, s), 0) + 1
    return sum(v - 1 for v in groups.values() if v >= n)


def test_shape_bytes_and_op_payloads():
    assert TR.shape_bytes("f32[8,4] bf16[3] s8[2,2] pred[5]") == \
        8 * 4 * 4 + 3 * 2 + 4 + 5
    x = torch.zeros((4, 8), dtype=torch.bfloat16)
    y = torch.zeros((16, 8), dtype=torch.bfloat16)
    assert TR.tensor_sig(y) == "bf16[16,8]"
    g = TR.collective_op("all-gather", [y], [x])
    assert (g.payload_bytes, g.shape_sig) == (16 * 8 * 2, "bf16[16,8]")
    r = TR.collective_op("all-reduce", [x], [x])
    assert r.payload_bytes == 2 * 4 * 8 * 2


def test_recorder_sees_dtensor_collectives():
    """On a fake 4-rank group: Shard -> Replicate is an all-gather,
    Partial -> Replicate an all-reduce (counted twice), Partial -> Shard a
    reduce-scatter, each with the reference's payload rule; a plain op
    records nothing; the FLOP counter beside it counts global shapes."""
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import (DTensor, Partial, Replicate,
                                          Shard, distribute_tensor)
    from torch.utils.flop_counter import FlopCounterMode
    with D.fake_world(4):
        dm = init_device_mesh("cpu", (4,))
        meta = torch.device("meta")
        x = distribute_tensor(torch.zeros((16, 8), device=meta), dm,
                              [Shard(0)], src_data_rank=None)
        p = DTensor.from_local(torch.zeros((16, 8), device=meta), dm,
                               [Partial()], run_check=False)
        w = distribute_tensor(torch.zeros((8, 32), device=meta), dm,
                              [Replicate()], src_data_rank=None)
        with TR.CollectiveRecorder() as rec, \
                FlopCounterMode(display=False) as fc:
            x.redistribute(dm, [Replicate()])
            p.redistribute(dm, [Replicate()])
            p.redistribute(dm, [Shard(0)])
            torch.zeros(3) + 1
            x @ w
        assert [(o.kind, o.payload_bytes, o.shape_sig) for o in rec.ops] == [
            ("all-gather", 16 * 8 * 4, "f32[16,8]"),
            ("all-reduce", 2 * 16 * 8 * 4, "f32[16,8]"),
            ("reduce-scatter", 16 * 8 * 4, "f32[4,8]")]
        assert fc.get_total_flops() == 2 * 16 * 8 * 32
    assert not dist.is_initialized()
