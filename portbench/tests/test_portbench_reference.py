"""The plain references against the port at its reduced configurations
on the CPU, in float32: the reference's decode step against its own
forward pass, its forward pass against the port's, and whole served and
trained cells of the port in float32 against the judges."""
import dataclasses
import json
import time

import pytest
import torch

from portbench import core, program, weights
from portbench.reference.common import Arith
from repro_torch.configs.base import get_config
from repro_torch.models.model import Model

F32 = {"attn_impl": "xla", "mlp_impl": "xla", "ssm_impl": "xla",
       "rglru_impl": "xla", "compute_dtype": "float32",
       "kv_cache_dtype": "float32"}
SMALL = {"prompt": {"kind": "uniform", "min": 2, "max": 9},
         "output": {"kind": "uniform", "min": 2, "max": 9}, "max_seq": 24}


def small_cell(name, plan=None, config=None, **mix):
    """The cell ``name`` at its arch's reduced configuration; with
    ``config``, that configuration of ``BENCHMARK.json`` in its own's
    place (the chat mix served by mamba2-1.3b, which no cell runs yet)."""
    cell = core.load_cell(name)
    if config:
        bench = json.loads((core.ROOT / "BENCHMARK.json").read_text())
        path = {c["name"]: c["file"] for c in bench["configs"]}[config]
        cell.config = json.loads((core.ROOT / path).read_text())
    arch = get_config(cell.config["arch"], reduced=True)
    ref = core.reference(cell.config["reference"])
    cfg = dict(cell.config, **ref.port_numbers(arch))
    if plan:
        cfg["plan"] = dict(cfg["plan"], **plan)
        # the port's caches take their dtype from the arch's own plan
        arch = dataclasses.replace(arch, plan=arch.plan.replace(**plan))
    cell.config = cfg
    cell.traffic = dict(cell.traffic, **mix)
    return cell, arch


@pytest.mark.parametrize("name", ["qwen2-7b", "mamba2-1.3b"])
def test_forward_matches_the_port(name):
    cell, arch = small_cell("qwen2-7b.serve_chat", F32, config=name)
    ref = core.reference(cell.config["reference"])
    p = weights.for_model(ref, cell.config, 3, "cpu")
    model, w = program.build(cell.config, arch, p, "cpu")
    tokens = torch.randint(2, arch.vocab_size, (2, 160),
                           generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        got = model.forward(w, {"tokens": tokens.int()})
        want = ref.forward(p, cell.config, Arith(), tokens)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("name", ["qwen2-7b", "mamba2-1.3b"])
def test_step_matches_forward(name):
    cell, arch = small_cell("qwen2-7b.serve_chat", config=name)
    cfg = cell.config
    ref = core.reference(cfg["reference"])
    p = weights.for_model(ref, cfg, 4, "cpu")
    tokens = torch.randint(2, arch.vocab_size, (3, 12),
                           generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        full = ref.forward(p, cfg, Arith(), tokens)
    state = ref.init_state(cfg, 3, 16, "cpu")
    for t in range(12):
        got = ref.step(p, cfg, Arith(), tokens[:, t], t, state)
        torch.testing.assert_close(got, full[:, t], rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("name", ["qwen2-7b", "mamba2-1.3b"])
def test_served_cell_in_f32_agrees_with_the_reference(name):
    cell, arch = small_cell("qwen2-7b.serve_chat", F32, config=name, **SMALL)
    out = core.driver("serve").run(cell, 2 ** 31 + 3, 0.3, False, "cpu",
                                   time.perf_counter(), arch=arch)
    gap = out["checks"]["widest_gap"]["value"]
    assert out["readings"]["gen_tokens"] > 0
    assert gap < 1e-3


def test_trained_cell_in_f32_agrees_with_the_reference():
    cell, arch = small_cell("mamba2-1.3b.train_4k", F32, seq_len=32)
    out = core.driver("train").run(cell, 17, 0.2, False, "cpu",
                                   time.perf_counter(), arch=arch)
    for k, v in out["gaps"].items():
        assert v < 1e-3, (k, out["gaps"])


def test_stream_matches_steps():
    cell, arch = small_cell("qwen2-7b.serve_chat", config="mamba2-1.3b")
    cfg = cell.config
    ref = core.reference("mamba2")
    p = weights.for_model(ref, cfg, 6, "cpu")
    tokens = torch.randint(2, arch.vocab_size, (3, 70),
                           generator=torch.Generator().manual_seed(2))
    state = ref.init_state(cfg, 3, 8, "cpu")
    steps = torch.stack([ref.step(p, cfg, Arith(), tokens[:, t], t, state)
                         for t in range(70)], dim=1)
    rows = torch.tensor([[0, 1, 2, 2], [0, 33, 64, 69]])
    got = ref.stream(p, cfg, Arith(), tokens, rows)
    torch.testing.assert_close(got, steps[rows[0], rows[1]], rtol=1e-4,
                               atol=1e-4)
