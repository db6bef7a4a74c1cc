"""The traffic generator: stratified length blocks, one traffic a seed."""
import itertools
import json
from pathlib import Path

from portbench import mixes

TRAFFIC = Path(__file__).resolve().parents[1] / "traffic"
CHAT = json.loads((TRAFFIC / "serve_chat.json").read_text())


def take(mix, seed, n, vocab=1000):
    return list(itertools.islice(mixes.requests(mix, seed, vocab), n))


def test_quantile_midpoints_by_hand():
    assert mixes.quantiles({"kind": "uniform", "min": 4, "max": 12}, 4) \
        == [5, 7, 9, 11]
    # lognormal, median 48, sigma 0.5: the middle of 3 is the median, the
    # outer two exp(+-0.5 * 0.9674) * 48 = 29.7, 77.6
    assert mixes.quantiles({"kind": "lognormal", "median": 48,
                            "sigma": 0.5, "min": 16, "max": 128}, 3) \
        == [30, 48, 78]
    assert mixes.quantiles({"kind": "lognormal", "median": 48,
                            "sigma": 5.0, "min": 16, "max": 128}, 2) \
        == [16, 128]


def test_every_block_holds_the_same_lengths():
    mix = dict(CHAT, residual_slots=0)
    n = mix["block"]
    want_p = sorted(mixes.quantiles(mix["prompt"], n))
    want_o = sorted(mixes.quantiles(mix["output"], n))
    for seed in (1, 2 ** 31 + 11):
        reqs = take(mix, seed, 4 * n)
        for b in range(4):
            blk = reqs[b * n:(b + 1) * n]
            assert sorted(len(p) for p, _ in blk) == want_p
            assert sorted(o for _, o in blk) == want_o


def test_same_seed_same_traffic_other_seed_same_work():
    a, b = take(CHAT, 7, 40), take(CHAT, 7, 40)
    assert [(p.tolist(), o) for p, o in a] == [(p.tolist(), o) for p, o in b]
    c = take(CHAT, 2 ** 31 + 8, 40)
    assert [(len(p), o) for p, o in a] == [(len(p), o) for p, o in c]
    assert [p.tolist() for p, _ in a] != [p.tolist() for p, _ in c]
    assert all(2 <= t < 1000 for p, _ in a for t in p)


def test_block_order_spreads_over_both_distributions():
    assert [mixes.bitrev(j, 8) for j in range(8)] == [0, 4, 2, 6, 1, 5, 3, 7]
    mix = {"block": 4, "prompt": {"kind": "uniform", "min": 0, "max": 8},
           "output": {"kind": "uniform", "min": 0, "max": 8}}
    # quantiles 1, 3, 5, 7; prompts bitrev(0..3), outputs bitrev(2..5)
    assert mixes.lengths(mix) == [(1, 3), (5, 7), (3, 1), (7, 5)]


def test_residual_lengths_of_the_first_slots():
    mix = dict(CHAT, residual_slots=8)
    full = take(dict(mix, residual_slots=0), 3, 16)
    res = take(mix, 3, 16)
    for j in range(8):
        assert res[j][1] == max(1, -(-full[j][1] * (2 * j + 1) // 16))
    assert [o for _, o in res[8:]] == [o for _, o in full[8:]]


def test_train_batches_are_seeded_and_rows_differ():
    mix = {"seq_len": 64, "batch": 4, "mean_doc_len": 16}
    a = mixes.train_source(mix, 5, 500).batch(0)
    b = mixes.train_source(mix, 5, 500).batch(0)
    assert (a["tokens"] == b["tokens"]).all()
    assert (a["targets"][:, :-1] == a["tokens"][:, 1:]).all()
    rows = {tuple(r) for r in a["tokens"].tolist()}
    rows |= {tuple(r) for r in
             mixes.train_source(mix, 5, 500).batch(1)["tokens"].tolist()}
    assert len(rows) == 8
