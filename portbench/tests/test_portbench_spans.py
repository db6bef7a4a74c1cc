"""The arithmetic of the program's own instruments in a cell
(``portbench/spans.py``) on synthetic readings, the split of idle time by
host span, and ``portbench/trace_program.py``'s serve and train runs at
the cells' reduced configurations on the CPU."""
import numpy as np
import pytest

from portbench import spans, trace_program
from repro_torch.obs import Span

from test_portbench_reference import SMALL, small_cell


def _span(name, t0, t1):
    return Span(name=name, t0=t0, t1=t1)


# ---------------------------------------------------------------------------
# Idle time split by the innermost open span
# ---------------------------------------------------------------------------


def test_idle_goes_to_the_innermost_open_span_or_the_harness():
    host = [_span("serve.step", 1.0, 5.0), _span("serve.launch", 2.0, 3.0),
            _span("serve.sync", 3.0, 5.0), _span("serve.step", 6.0, 7.0),
            _span("serve.fill", 6.0, 7.0)]
    busy = [[0, 1500], [2500, 3200], [4000, 4500], [6200, 6300]]

    def ms(t):
        return round(t * 1000)
    got = spans.split_idle(busy, 0, 8000, host, ms)
    # idle: 1500-2500 (step, launch), 3200-4000 and 4500-5000 (sync),
    # 5000-6000 (harness), 6000-6200 and 6300-7000 (the fill, innermost
    # of two spans opening together), 7000-8000 (harness)
    assert got == {"serve.step": 500, "serve.launch": 500,
                   "serve.sync": 1300, "serve.fill": 900, "harness": 2000}


def test_every_idle_nanosecond_is_booked_once():
    rng = np.random.default_rng(4)
    edges = np.sort(rng.choice(np.arange(1, 10_000), 40, replace=False))
    busy = [[int(a), int(b)] for a, b in edges.reshape(-1, 2)]
    host, t = [], 0.0
    for _ in range(30):             # nested pairs at random
        a = t + float(rng.uniform(0, 200))
        b = a + float(rng.uniform(1, 400))
        host.append(_span("serve.step", a, b))
        c = float(rng.uniform(a, b))
        host.append(_span("serve.launch", c, float(rng.uniform(c, b))))
        t = b
    got = spans.split_idle(busy, 0, 12_000, host, round)
    idle = 12_000 - sum(b - a for a, b in busy)
    assert sum(got.values()) == idle
    assert set(got) <= {"serve.step", "serve.launch", "harness"}


def test_busy_intervals_merge():
    assert spans.merge([(5, 7), (0, 2), (1, 3), (7, 9), (10, 11)]) == \
        [[0, 3], [5, 9], [10, 11]]


# ---------------------------------------------------------------------------
# The numbers, from synthetic readings
# ---------------------------------------------------------------------------


def _serve_readings():
    return {
        "counts": {"serve.fill_replays": 30.0, "serve.decode_replays": 10.0,
                   "serve.tokens_out": 60.0, "weights.casts": 40 * 281.0,
                   "weights.cast_bytes": 40 * 28_281_659_392.0},
        "forced_steps": 30, "decode_steps": 10,
        "ranges": {"decode.step": [4, 100.0, 1.0],
                   "weights.cast": [1124, 55.0, 55.0],
                   "decode.mlp": [112, 20.0, 20.0]},
        "idle_ns": {"serve.fill": 300, "serve.launch": 200, "serve.sync": 10,
                    "serve.step": 5, "harness": 85},
        "profile": {"start_ns": 1000, "end_ns": 3000, "busy_s": 2e-6,
                    "kernels": [["bfloat16_copy_kernel_cuda", 1.2e-6, 7],
                                ["gemv", 0.8e-6, 7]]},
    }


def test_serve_numbers():
    got = spans.serve_numbers(_serve_readings())
    assert got["weight_cast_range_share.serve"] == pytest.approx(55.0)
    assert got["weight_cast_gb_per_step.serve"] == pytest.approx(
        28.281659392)
    assert got["casts_per_step"] == 281
    assert got["fill_replay_share.serve"] == got["forced_step_share.serve"] \
        == 75.0
    assert got["tokens_per_decode_replay"] == 6.0
    # 515 ns of 2000 idle inside the loop's spans; the harness's apart
    assert got["idle_in_loop_share.serve"] == pytest.approx(25.75)
    assert got["weight_cast_share.serve"] == pytest.approx(60.0)


def test_serve_numbers_without_a_profile_or_replays():
    r = _serve_readings()
    r.pop("profile")
    r["counts"] = {}
    r["ranges"] = {}
    got = spans.serve_numbers(r)
    assert "idle_in_loop_share.serve" not in got
    assert got["weight_cast_range_share.serve"] is None
    assert got["weight_cast_gb_per_step.serve"] is None
    assert got["fill_replay_share.serve"] is None


def test_train_numbers_take_every_plain_backward():
    r = {"ranges": {"train.step": [2, 200.0, 1.0],
                    "train.backward": [8, 150.0, 20.0],
                    "ssd.backward": [96, 100.0, 100.0],
                    "flash.backward": [4, 30.0, 30.0],
                    "train.forward": [8, 40.0, 40.0]},
         "capture_s": 40.5, "eager_step_s": 24.6}
    got = spans.train_numbers(r)
    assert spans.backwards(r["ranges"]) == ["flash.backward", "ssd.backward"]
    assert got == {"plain_backward_share.train": 65.0,
                   "graph_capture_s.train": 40.5, "eager_step_s": 24.6}
    assert spans.train_numbers({"ranges": {}})[
        "plain_backward_share.train"] is None


def test_counter_growth():
    assert spans.delta({"a": 1.0, "b": 2.0}, {"a": 4.0, "b": 2.0, "c": 1.0}) \
        == {"a": 3.0, "c": 1.0}


# ---------------------------------------------------------------------------
# The runs, at the reduced configurations on the CPU
# ---------------------------------------------------------------------------


def _cast_bytes(w) -> int:
    """The f32 bytes of every weight a decode step casts: all of them but
    the norms' scales (used in f32) and the embedding table, whose rows
    are gathered before the cast."""
    return sum(p.numel() * 4 for n, p in w.named_parameters()
               if n != "embed" and not n.endswith(".scale"))


def test_the_serve_run_counts_what_the_loop_did():
    from portbench import core, program, weights
    cell, arch = small_cell("qwen2-7b.serve_chat", **SMALL)
    r = trace_program.serve(cell, 2 ** 31 + 9, 0.3, "cpu", arch=arch,
                            steps=3)
    got = spans.serve_numbers(r)
    c = r["counts"]
    assert c["serve.decode_replays"] == r["decode_steps"] > 0
    assert c["serve.fill_replays"] == r["forced_steps"] > 0
    # both count the window's fills, one inside the loop, one from the
    # prompt lengths
    assert got["fill_replay_share.serve"] == got["forced_step_share.serve"]
    ref = core.reference(cell.config["reference"])
    _, w = program.build(cell.config, arch,
                         weights.for_model(ref, cell.config, 1, "cpu"),
                         "cpu")
    want = _cast_bytes(w)
    assert got["weight_cast_gb_per_step.serve"] * 1e9 == pytest.approx(
        want, rel=1e-12)
    assert r["weight_bytes_f32"] > want
    names = {n for n, *_ in r["table"]}
    assert {"decode.step", "decode.attention", "decode.mlp", "decode.head",
            "weights.cast"} <= names
    assert 0 < got["weight_cast_range_share.serve"] < 100
    # three steps, each a decode replay and the fills of the slots it freed
    assert r["ranges"]["decode.step"][0] >= 3
    assert all(own >= 0 for _, _, _, own in r["table"])


def test_the_train_run_names_the_plain_backwards():
    cell, arch = small_cell("mamba2-1.3b.train_4k", seq_len=64)
    r = trace_program.train(cell, 23, "cpu", arch=arch, steps=2)
    got = spans.train_numbers(r)
    assert "ssd.backward" in r["ranges"]
    assert r["ranges"]["train.step"][0] == 2
    assert 0 < got["plain_backward_share.train"] < 100
    # no capture on the CPU: each call is the eager step
    assert got["graph_capture_s.train"] is None
    assert got["eager_step_s"] > 0
