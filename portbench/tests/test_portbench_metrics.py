"""Rates, tails, shares and the work formulas, against counts by hand;
a cell, a mix and a metric added as files alone."""
import json
from types import SimpleNamespace

import pytest

from portbench import core, work
from portbench.reference import mamba2, qwen2
from portbench.drivers.serve import Book
from portbench.stats import quantile

QWEN = {"hidden_size": 8, "num_hidden_layers": 2, "num_attention_heads": 2,
        "num_key_value_heads": 1, "intermediate_size": 16,
        "vocab_size": 10}
MAMBA = {"d_model": 4, "n_layer": 2, "vocab_size": 10, "d_state": 2,
         "expand": 2, "headdim": 4, "d_conv": 4, "chunk_size": 2}


def read(metric, readings):
    return core.reader(metric)(readings)


def req(rid, prompt_len, out, done=False):
    return SimpleNamespace(rid=rid, prompt=[0] * prompt_len, out=out,
                           done=done)


def test_book_counts_tokens_gaps_and_fills():
    book = Book()
    a, b = req(0, 5, [1]), req(1, 3, [])
    book.step([a, b], 0.5)            # set-up: seen, not counted
    book.open = 1.0
    b.out.append(7)                   # b filled in this step (2 forced)
    a.out.append(2)
    book.step([a, b], 1.2)            # a's gap straddles the open: dropped
    a.out.append(3)
    b.out.append(8)
    b.done = True
    done = book.step([a, b], 1.5)
    assert done == [b]
    assert book.tokens == 4
    assert book.gaps_ms == pytest.approx([300.0, 300.0])
    assert book.forced == 2
    # needed: b's 2 forced + 4 tokens; contexts: forced 1 + 2, then a's
    # tokens at 5+1, 5+2 and b's at 3+0, 3+1
    assert book.needed == 6
    assert book.ctx == 1 + 2 + 6 + 7 + 3 + 4


def test_rates_and_tail_by_hand():
    r = {"gen_tokens": 120, "window_s": 4.0,
         "gaps_ms": [10.0] * 19 + [1000.0], "energy_j": 800.0,
         "energy_s": 2.0}
    assert read("serve_tokens_per_s", r) == 30.0
    # 20 gaps: rank 0.95 x 19 = 18.05, between 10 and 1000
    assert read("itl_p95_ms", r) == pytest.approx(10 + 0.05 * 990)
    assert read("card_w", r) == 400.0
    assert read("ws_per_token", r) == pytest.approx(400.0 * 4.0 / 120)
    t = {"train_tokens": 16384 * 3, "window_s": 12.0, "energy_j": 10.0,
         "energy_s": 0.025}
    assert read("train_tokens_per_s", t) == pytest.approx(4096.0)
    assert read("ws_per_token", t) == pytest.approx(400 * 12.0 / 49152)


def test_a_stalled_window():
    # one fill of 1000 forced steps and one decode step in the window: one
    # token, no gap inside the window, almost every step forced
    r = {"gen_tokens": 1, "window_s": 30.0, "gaps_ms": [],
         "forced_steps": 1000, "decode_steps": 1, "replay_ms": [29.0] * 1001}
    assert read("serve_tokens_per_s", r) == pytest.approx(1 / 30.0)
    assert read("itl_p95_ms", r) is None
    assert read("forced_step_share.serve", r) == pytest.approx(
        100 * 1000 / 1001)
    assert read("idle_share.serve", r) == pytest.approx(
        100 * (30.0 - 29.029) / 30.0)
    assert read("decode_step_ms.serve", r) == 29.0
    assert quantile([5.0], 0.95) == 5.0


def test_shares_read_nothing_without_a_profile():
    for m in ("weight_cast_share.serve", "swiglu_decode_roofline",
              "ssd_roofline", "decode_step_ms.serve", "idle_share.serve",
              "idle_share.train", "mfu.train"):
        assert read(m, {"window_s": 1.0, "reference": "qwen2"}) is None


def test_work_formulas_by_hand():
    assert work.swiglu_work(8, 3584, 18944) == (
        6.0 * 8 * 3584 * 18944, (3 * 3584 * 18944 + 2 * 8 * 3584) * 2)
    # one chunk of 2 (3 pairs), b 1, h 1, p 1, n 1: scores 2*3*1, per head
    # 2*(3*1 + 2*1*1) and no carried state
    f, nb = work.ssd_work(1, 2, 1, 1, 1, 2, 2)
    assert f == 2 * 3 + 2 * (3 + 2)
    assert nb == (2 * 2 + 2 * 2) * 2 + (2 + 1) * 4 + 4
    # a second chunk adds the carried state's part
    f2, _ = work.ssd_work(1, 4, 1, 1, 1, 2, 2)
    assert f2 == 2 * f + 2 * 2
    assert work.bound(989e12, work.PEAK_BF16, 0) == pytest.approx(1.0)
    assert work.bound(0, work.PEAK_BF16, 3.35e12) == pytest.approx(1.0)


def test_model_flops_by_hand():
    # qwen2: per layer 8*2*4 + 2*8*1*4 + 2*4*8 + 3*8*16, head 8*10
    per = 64 + 64 + 64 + 384
    assert qwen2.matmul_params(QWEN) == 2 * per + 80
    assert qwen2.token_flops(QWEN, 3, 6) == \
        2.0 * (2 * per + 80) * 3 + 4 * 2 * 8 * 6
    # mamba2: di 8, h 2; per layer 4*(16+4+2) + 8*4, head 4*10
    assert mamba2.matmul_params(MAMBA) == 2 * (88 + 32) + 40
    assert mamba2.token_flops(MAMBA, 1, 0) == \
        2.0 * 280 + 2 * (6 * 8 * 2 + 2 * 4 * 12)
    f, _ = work.ssd_work(2, 8, 2, 4, 2, 2, 2)
    assert mamba2.train_step_flops(MAMBA, 2, 8) == \
        6.0 * 280 * 16 + 3.0 * f * 2


def test_mfu_and_roofline_readers_by_hand():
    r = {"needed_tokens": 3, "needed_ctx_sum": 6, "window_s": 2.0,
         "reference": "qwen2", "config": QWEN}
    ops = qwen2.token_flops(QWEN, 3, 6)
    assert read("mfu.serve", r) == pytest.approx(100 * ops / 2 / 989e12)
    t = {"train_steps": 2, "window_s": 3.0, "reference": "mamba2",
         "config": MAMBA, "batch": 2, "seq_len": 8}
    assert read("mfu.train", t) == pytest.approx(
        100 * 2 * mamba2.train_step_flops(MAMBA, 2, 8) / 3 / 989e12)
    prof = {"busy_s": 1.0, "kernels": [
        ["void gemm_kernel<Tile<32> >(x)", 0.02, 4],
        ["void wgmma_gemm_kernel<G, 0>(x)", 0.5, 1],
        ["void combine_kernel<true>(x)", 0.01, 4],
        ["void at::native::bfloat16_copy_kernel_cuda(x)", 0.25, 10]]}
    s = {"profile": prof, "launches": {"swiglu": 2}, "reference": "qwen2",
         "slots": 8, "config": QWEN}
    least = work.bound(*work.swiglu_work(8, 8, 16)[:1], work.PEAK_BF16,
                       work.swiglu_work(8, 8, 16)[1])
    assert read("swiglu_decode_roofline", s) == pytest.approx(
        100 * least / (0.03 / 2))
    assert read("weight_cast_share.serve", s) == pytest.approx(25.0)


def test_energy_window_brackets_two_counter_updates():
    from portbench.energy import Window
    t = [0.0]
    # a counter that moves by 40 J every 0.1 s of the fake clock
    read = lambda: 40.0 * int(t[0] / 0.1 + 1e-9)       # noqa: E731

    def sleep(s):
        t[0] += s
    w = Window(read, clock=lambda: t[0], sleep=sleep)
    t[0] = 0.05
    w.open()                  # waits for the update at 0.1 s
    t[0] = 1.23
    w.close()                 # and for the one at 1.3 s
    assert w.seconds == pytest.approx(1.2, abs=2e-3)
    assert w.joules == pytest.approx(480.0)


def test_a_cell_a_mix_and_a_metric_added_as_files_are_found(tmp_path):
    """A new configuration, traffic mix, limits and per-layer metric, each
    a file of its own beside entries in ``BENCHMARK.json``, make a cell
    that loads and reads by name, with no module of the harness edited."""
    base = tmp_path / "portbench"
    for d in ("configs", "traffic", "limits", "metrics"):
        (base / d).mkdir(parents=True)
    src = core.ROOT / "portbench"
    cfg = json.loads((src / "configs" / "qwen2-7b.json").read_text())
    cfg["num_hidden_layers"] = 2
    (base / "configs" / "qwen2-2l.json").write_text(json.dumps(cfg))
    mix = json.loads((src / "traffic" / "serve_chat.json").read_text())
    (base / "traffic" / "chat64.json").write_text(
        json.dumps(dict(mix, clients=64)))
    (base / "limits" / "qwen2-2l.chat64.json").write_text(
        '{"widest_gap": 0.4}')
    (base / "metrics" / "tokens_seen.py").write_text(
        "def read(r):\n    return r.get(\"gen_tokens\")\n")
    bench = json.loads((core.ROOT / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "qwen2-2l", "source": "x",
                             "file": "portbench/configs/qwen2-2l.json",
                             "reduced": ["num_hidden_layers"], "why": "x"})
    bench["workloads"].append({"name": "qwen2-2l.chat64",
                               "config": "qwen2-2l", "traffic": "chat64",
                               "chips": 1, "why": "x"})
    bench["per_layer"].append({"name": "tokens_seen", "unit": "tokens",
                               "better": "higher",
                               "source": "program_counter", "layer": "x",
                               "moves": "serve_tokens_per_s",
                               "workloads": ["qwen2-2l.chat64"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = core.load_cell("qwen2-2l.chat64", root=tmp_path)
    assert cell.config["num_hidden_layers"] == 2
    assert cell.traffic["clients"] == 64
    assert cell.limits == {"widest_gap": 0.4}
    assert core.driver(cell.traffic["driver"]).__name__.endswith("serve")
    assert core.metrics_line(cell, {"gen_tokens": 7}, trace=True) == {
        "tokens_seen": {"value": 7.0, "unit": "tokens"}}
    r = {"needed_tokens": 3, "needed_ctx_sum": 6, "window_s": 2.0,
         "reference": cell.config["reference"], "config": cell.config}
    assert read("mfu.serve", r) > 0
