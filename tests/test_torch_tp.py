"""Tensor-parallel layers on the mesh (``parallel.tp``) over gloo on four
CPU ranks, against the same model without rules.

Each rank is a process (``python -c WORKER``) that meets the others over a
``FileStore`` in the test's temporary directory, as in
``tests/test_torch_pod.py``.  For each case — a ``tiny-test`` variant that
takes one head strategy at a 4-way model axis, or one layer kind — and for
each mesh, ``(1, 4)`` and ``(2, 2)`` over ``("data", "model")``, every rank
runs, in f32 compute:

  * a forward pass, a prefill and three decode steps, and one AdamW train
    step, with the weights, cache and optimizer state laid out by
    ``param_sharding.distribute`` under the plan's rules, the layers on
    their shards;
  * the same calls on the same weights and batch without rules, in this
    one process.

What is held:
  * logits, every decode step's logits and the train step's gradients lie
    within 1e-5 of the largest element of the run without rules (decode
    steps over an int8 cache within 2^-10: ``TOL_INT8``); the loss and the
    gradient norm within 1e-5 relative; the parameters after the AdamW
    step within 1e-5 in relative Frobenius norm (its first update is
    g/(|g| + 1e-8), which magnifies a last-bit difference of a gradient
    near zero in a single element, as ``tests/test_torch_pod.py`` states);
  * the MoE keeps and drops exactly the same assignments: each call of
    ``moe_slots`` over the whole batch's experts sees the same experts and
    returns the same keep mask with rules as without (the capacity binds:
    some assignments drop);
  * ``core.transfer.CollectiveRecorder`` sees all-reduces or
    reduce-scatters over the model axis, and no all-gather over it whose
    result is a parameter's or a cache entry's shard gathered whole over
    the axis;
  * every layer kind of the case ran on the tensor-parallel route.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch.distributed as dist

ROOT = Path(__file__).resolve().parents[1]
TOL = 1e-5
#: an int8 cache's decode: where an f32 key or value differs from the run
#: without rules in its last bit, its rounding to int8 can land one
#: quantization step (1/127 of its row's absmax) away
TOL_INT8 = 2.0 ** -10

#: case -> ``ArchConfig`` fields replaced in tiny-test, and its layer kinds
CASES = {
    # 4 kv heads: 'kv'; an int8 cache dequantised shard by shard
    "kv": ({"n_heads": 8, "n_kv_heads": 4, "d_head": 8},
           {"kv_cache_dtype": "int8"}),
    # 2 kv heads, 4 q a group: 'group'; the GELU MLP and LayerNorm; an
    # int8 cache split over its positions
    "group": ({"n_heads": 8, "n_kv_heads": 2, "d_head": 8, "act": "gelu",
               "norm": "layernorm"}, {"kv_cache_dtype": "int8"}),
    # 4 q heads on 4 ranks: 'flat', the q weights split on heads; no
    # fsdp and a 66-token vocab: the embedding and lm_head split d_model
    "flat_even": ({"n_heads": 4, "n_kv_heads": 2, "d_head": 8,
                   "vocab_size": 66}, {"fsdp": False}),
    # 6 q heads padded to 8: 'flat' with the d_head fallback, biases
    "flat_uneven": ({"n_heads": 6, "n_kv_heads": 2, "d_head": 8,
                     "qkv_bias": True}, {}),
    "moe": ({"family": "moe", "n_heads": 4, "n_kv_heads": 4, "d_head": 8,
             "moe": [8, 2, 16, 0.5]}, {}),
    # RG-LRU layers and local attention over a rolling 8-slot cache
    "rglru": ({"family": "hybrid", "n_layers": 3, "n_heads": 4,
               "n_kv_heads": 1, "d_head": 8, "act": "gelu",
               "layer_pattern": ["rec", "rec", "attn"], "lru_width": 32,
               "local_window": 8}, {}),
    # 6 heads of 6 and a 66-wide MLP: no dim divides by 4, so the stored
    # specs leave the attention and MLP weights whole over the model axis
    # and every model rank runs their whole products (nothing gathered)
    "whole": ({"n_heads": 6, "n_kv_heads": 6, "d_head": 6, "d_ff": 66},
              {}),
    # mamba2; a 66-token vocab the model axis cannot split: the tied
    # embedding stays whole over it, its d_model on the batch axes
    "mamba2": ({"family": "ssm", "n_heads": 0, "n_kv_heads": 0,
                "ssm_state": 8, "ssm_headdim": 8, "ssm_chunk": 8,
                "tie_embeddings": True, "vocab_size": 66}, {}),
}
KINDS = {"kv": ["attn", "mlp"], "group": ["attn", "mlp"],
         "flat_even": ["attn", "mlp"], "flat_uneven": ["attn", "mlp"],
         "whole": ["attn", "mlp"], "moe": ["attn", "moe"], "rglru": ["attn", "mlp", "rec"],
         "mamba2": ["ssm"]}
MESHES = {"1x4": (1, 4), "2x2": (2, 2)}
BATCH, PROMPT, CACHE, DECODE = 4, 16, 24, 3

WORKER = r'''
import dataclasses, json, sys, time
import numpy as np
import torch, torch.distributed as dist
rank, world, store, out_dir = (int(sys.argv[1]), int(sys.argv[2]),
                               sys.argv[3], sys.argv[4])
args = json.loads(sys.argv[5])
dist.init_process_group("gloo", store=dist.FileStore(store, world),
                        rank=rank, world_size=world)
torch.set_num_threads(1)
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import DTensor, Replicate
from torch.distributed.tensor._utils import \
    compute_local_shape_and_global_offset
from repro_torch.configs import MoEConfig, get_config
from repro_torch.core.transfer import CollectiveRecorder, tensor_sig
from repro_torch.models import layers as L
from repro_torch.models.model import Model
from repro_torch.parallel import tp
from repro_torch.parallel.param_sharding import distribute
from repro_torch.parallel.sharding import make_rules, mixed_inputs
from repro_torch.train.step import (make_grad_step, make_opt_init,
                                    make_train_step)

SLOTS = []
_slots = L.moe_slots


def moe_slots(idx, n_experts, cap):
    slot, keep = _slots(idx, n_experts, cap)
    if n_experts == SLOTS[0]:          # the whole batch's experts
        SLOTS[1].append([idx.reshape(-1).tolist(), keep.tolist()])
    return slot, keep


L.moe_slots = moe_slots


def err(a, b):
    a = a.full_tensor() if isinstance(a, DTensor) else a
    return float((a.float() - b.float()).abs().max()
                 / (b.float().abs().max() + 1e-30))


def build(name):
    fields, plan = args["cases"][name]
    fields = dict(fields)
    if "moe" in fields:
        fields["moe"] = MoEConfig(*fields["moe"])
    if "layer_pattern" in fields:
        fields["layer_pattern"] = tuple(fields["layer_pattern"])
    cfg = get_config("tiny-test")
    cfg = dataclasses.replace(cfg, **fields)
    plan = cfg.plan.replace(**{"compute_dtype": "float32",
                               "kv_cache_dtype": "float32", **plan})
    return dataclasses.replace(cfg, plan=plan)


def forbidden(params, cache, dm):
    """Result signatures of an all-gather over 'model' of a parameter's or
    a cache entry's shard (as stored, or gathered over 'data')."""
    mi = dm.mesh_dim_names.index("model")
    tpn = dm.size(mi)
    out = set()
    tensors = [p for _, p in params.named_parameters()]
    tensors += [t for layer in cache for t in layer.values()]
    for t in tensors:
        for pl in (t.placements, tuple(p if i == mi else Replicate()
                                       for i, p in enumerate(t.placements))):
            if t.ndim == 0 or not pl[mi].is_shard():
                continue
            shape, _ = compute_local_shape_and_global_offset(t.shape, dm, pl)
            shape = (shape[0] * tpn,) + tuple(shape[1:])
            out.add(tensor_sig(torch.empty(shape, dtype=t.dtype,
                                           device="meta")))
    return out


res = {}
toks = torch.from_numpy(np.asarray(args["tokens"], np.int64))
steps = torch.from_numpy(np.asarray(args["steps"], np.int64))
for name in args["cases"]:
    cfg = build(name)
    SLOTS[:] = [cfg.moe.n_experts if cfg.moe else -1, []]
    model = Model(cfg, cfg.plan, "cpu")
    tk = toks % cfg.vocab_size
    batch = {"tokens": tk[:, :-1], "targets": tk[:, 1:]}
    prompt = {"tokens": tk[:, :args["prompt"]]}

    def weights():
        return model.init(torch.Generator().manual_seed(0))

    def serve(p, cache, rules=None):
        out = [model.prefill(p, prompt, cache, rules)]
        for i in range(steps.shape[1]):
            out.append(model.decode_step(
                p, {"tokens": steps[:, i:i + 1] % cfg.vocab_size,
                    "pos": args["prompt"] + i}, cache, rules))
        return [o[0] for o in out]
    p0 = weights()
    want_fwd = model.forward(p0, batch)
    want_serve = serve(p0, model.init_cache(len(tk), args["cache"]))
    want_g, _ = make_grad_step(model)(p0, batch)
    o0 = make_opt_init(model)(p0)
    p0, _, m0 = make_train_step(model)(p0, o0, batch)
    want_slots = list(SLOTS[1])
    for mname, shape in args["meshes"].items():
        t0 = time.perf_counter()
        SLOTS[1] = []
        dm = init_device_mesh("cpu", tuple(shape),
                              mesh_dim_names=("data", "model"))
        rules = make_rules(cfg, dm, cfg.plan)
        p1 = weights()
        o1 = make_opt_init(model)(p1)
        cache = model.init_cache(len(tk), args["cache"])
        p1, o1, cache = distribute(rules, p1, o1, cache)
        bad = forbidden(p1, cache, dm)
        model_group = dm.get_group("model").group_name
        with tp.record_routes() as routes, CollectiveRecorder() as rec, \
                mixed_inputs(p1.embed):
            fwd = model.forward(p1, batch, rules)
            got_serve = serve(p1, cache, rules)
            g1, _ = make_grad_step(model, rules)(p1, batch)
        p1, o1, m1 = make_train_step(model, rules)(p1, o1, batch)
        named = dict(p1.named_parameters())
        over_model = [o for o in rec.ops if o.group == model_group]
        res[f"{name}|{mname}"] = {
            "forward": err(fwd, want_fwd),
            "serve": [err(a, b) for a, b in zip(got_serve, want_serve)],
            "grads": max(err(g1[n], want_g[n]) for n in want_g),
            "loss": [float(m0["loss"]), float(m1["loss"].full_tensor())],
            "grad_norm": [float(m0["grad_norm"]),
                          float(m1["grad_norm"].full_tensor())],
            "params": max(float(torch.linalg.vector_norm(
                named[n].full_tensor() - p) / torch.linalg.vector_norm(p))
                for n, p in p0.named_parameters()),
            "slots_equal": SLOTS[1] == want_slots,
            "n_slots": len(want_slots),
            "drops": sum(k.count(False) for _, k in want_slots),
            "reduces": sum(o.kind in ("all-reduce", "reduce-scatter")
                           for o in over_model),
            "model_gathers": sum(o.kind == "all-gather" for o in over_model),
            "bad_gathers": sorted({o.shape_sig for o in over_model
                                   if o.kind == "all-gather"
                                   and o.shape_sig in bad}),
            "routes": routes,
            "seconds": time.perf_counter() - t0}
with open(f"{out_dir}/rank{rank}.json", "w") as f:
    json.dump(res, f)
dist.destroy_process_group()
'''


def _run_group(world: int, args: dict, tmp: Path) -> list:
    tmp.mkdir(parents=True, exist_ok=True)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    env.pop("JAX_PLATFORMS", None)
    procs = [subprocess.Popen(
        [sys.executable, "-c", WORKER, str(r), str(world),
         str(tmp / "store"), str(tmp), json.dumps(args)],
        env=env, cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for r in range(world)]
    errs = []
    for p in procs:
        _, err = p.communicate(timeout=600)
        if p.returncode:
            errs.append(err[-3000:])
    assert not errs, errs[0]
    return [json.loads((tmp / f"rank{r}.json").read_text())
            for r in range(world)]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    rng = np.random.default_rng(3)
    args = {"cases": CASES, "meshes": MESHES, "prompt": PROMPT,
            "cache": CACHE,
            "tokens": rng.integers(0, 1 << 16, (BATCH, PROMPT + 1)).tolist(),
            "steps": rng.integers(0, 1 << 16, (BATCH, DECODE)).tolist()}
    return _run_group(4, args, tmp_path_factory.mktemp("tp"))


CELLS = [(c, m) for c in CASES for m in MESHES]


def _each(runs, case, mesh):
    return [r[f"{case}|{mesh}"] for r in runs]


@pytest.mark.parametrize("case,mesh", CELLS)
def test_forward_equals_the_step_without_rules(runs, case, mesh):
    for r in _each(runs, case, mesh):
        assert r["forward"] <= TOL, r["forward"]


@pytest.mark.parametrize("case,mesh", CELLS)
def test_prefill_and_decode_equal_the_steps_without_rules(runs, case, mesh):
    tol = TOL_INT8 if CASES[case][1].get("kv_cache_dtype") == "int8" \
        else TOL
    for r in _each(runs, case, mesh):
        assert len(r["serve"]) == 1 + DECODE
        assert r["serve"][0] <= TOL, r["serve"]         # the prefill
        assert max(r["serve"]) <= tol, r["serve"]


@pytest.mark.parametrize("case,mesh", CELLS)
def test_train_step_equals_the_step_without_rules(runs, case, mesh):
    for r in _each(runs, case, mesh):
        for what in ("loss", "grad_norm"):
            plain, rules = r[what]
            assert rules == pytest.approx(plain, rel=TOL), what
        assert r["grads"] <= TOL, r["grads"]
        assert r["params"] <= TOL, r["params"]


@pytest.mark.parametrize("case,mesh", CELLS)
def test_no_weight_or_cache_gathered_over_the_model_axis(runs, case, mesh):
    for r in _each(runs, case, mesh):
        assert r["reduces"] > 0
        assert r["bad_gathers"] == [], r["bad_gathers"]
        assert sorted(k for k, v in r["routes"].items() if v == "tp"
                      and k not in ("embed", "logits", "loss")) == \
            KINDS[case]
        assert set(r["routes"].values()) == {"tp"}


@pytest.mark.parametrize("mesh", MESHES)
def test_moe_keeps_and_drops_the_same_assignments(runs, mesh):
    for r in _each(runs, "moe", mesh):
        assert r["n_slots"] > 0 and r["drops"] > 0
        assert r["slots_equal"]


def test_no_group_left_behind():
    assert not dist.is_initialized()
