"""The one generator of every traffic mix: ``portbench/traffic/<mix>.json``
holds a mix's parameters, and this module turns them and a seed into the
cell's requests or batches.

Served requests come in blocks of ``block`` (a power of two) requests.
Each block holds the same ``block`` prompt lengths and the same ``block``
output lengths, the quantile midpoints (i + 0.5) / block of the stated
distributions, in one fixed order: the j-th request of a block takes the
prompt quantile bitrev(j) and the output quantile bitrev(j + block / 2),
bitrev reversing the bits of the index, so that any run of requests
spreads over both distributions.  Token ids are drawn from the seed.  So
every seed serves the same work; a seed's own order would not do: a
30-second window of the chat mix holds about 27 requests, and shuffling
them by the seed moves the window's served tokens by 5-37 % from seed to
seed (a simulation of the loop's steps; the card's runs moved 22 %).

Distributions: ``{"kind": "lognormal", "median", "sigma", "min", "max"}``
(clipped to [min, max]) or ``{"kind": "uniform", "min", "max"}``; lengths
are rounded to whole tokens.

``residual_slots`` > 0 gives the first that many requests a share of their
drawn output length, (j + 0.5) / residual_slots for the j-th, so that the
batch they start begins with requests at every stage of their output and
the measured window opens on the steady mix.

Train batches are ``synthetic.SyntheticLM``'s, from the seed.
"""
from __future__ import annotations

import math
import statistics
from typing import Iterator

import numpy as np

from portbench.synthetic import DataConfig, SyntheticLM


def quantiles(dist: dict, n: int) -> list[int]:
    """The ``n`` quantile midpoints of ``dist``, as whole tokens."""
    out = []
    for i in range(n):
        q = (i + 0.5) / n
        if dist["kind"] == "lognormal":
            z = statistics.NormalDist().inv_cdf(q)
            v = dist["median"] * math.exp(dist["sigma"] * z)
        elif dist["kind"] == "uniform":
            v = dist["min"] + (dist["max"] - dist["min"]) * q
        else:
            raise ValueError(f"unknown distribution {dist['kind']!r}")
        out.append(int(min(max(round(v), dist["min"]), dist["max"])))
    return out


def bitrev(j: int, n: int) -> int:
    """j's bits reversed over log2(n) bits."""
    bits = n.bit_length() - 1
    return int(format(j % n, f"0{bits}b")[::-1], 2)


def lengths(mix: dict) -> list[tuple[int, int]]:
    """One block's (prompt, output) lengths, in submission order."""
    n = mix["block"]
    if n & (n - 1):
        raise ValueError(f"block {n} is not a power of two")
    plens = quantiles(mix["prompt"], n)
    olens = quantiles(mix["output"], n)
    return [(plens[bitrev(j, n)], olens[bitrev(j + n // 2, n)])
            for j in range(n)]


def requests(mix: dict, seed: int, vocab: int) -> Iterator[tuple]:
    """(prompt int32 array, output length) for ever, in submission
    order."""
    block = lengths(mix)
    res = mix.get("residual_slots", 0)
    k = 0
    b = 0
    while True:
        rng = np.random.default_rng([int(seed), b])
        for p, o in block:
            prompt = rng.integers(2, vocab, size=p).astype(np.int32)
            if k < res:
                o = max(1, math.ceil(o * (k + 0.5) / res))
            yield prompt, int(o)
            k += 1
        b += 1


def train_source(mix: dict, seed: int, vocab: int) -> SyntheticLM:
    """The batches of a training mix: ``source.batch(step)``."""
    return SyntheticLM(DataConfig(vocab_size=vocab, seq_len=mix["seq_len"],
                                  global_batch=mix["batch"], seed=int(seed),
                                  mean_doc_len=mix["mean_doc_len"]))
