"""A run with the timed path broken underneath comes out not correct:
every fault a cell can have on one chip, planted in the port at its
reduced size on the CPU, with the cells' own limits.  The sound run of
the same cell comes out correct."""
import time

import pytest
import torch

from portbench import core
from repro_torch.models.model import Model
from repro_torch.serve.engine import ServeLoop
from repro_torch.train import optimizer as O
from repro_torch.train.step import TrainGraph

from test_portbench_reference import SMALL, small_cell


def serve(config, seed=2 ** 31 + 5):
    cell, arch = small_cell("qwen2-7b.serve_chat", config=config, **SMALL)
    out = core.driver("serve").run(cell, seed, 0.3, False, "cpu",
                                   time.perf_counter(), arch=arch)
    return core.judge(out["checks"]), out["checks"]


def train(seed=23):
    cell, arch = small_cell("mamba2-1.3b.train_4k", seq_len=64)
    out = core.driver("train").run(cell, seed, 0.2, False, "cpu",
                                   time.perf_counter(), arch=arch)
    return core.judge(out["checks"]), out["checks"]


def over(checks, name):
    return checks[name]["value"] > checks[name]["limit"]


#: the served cell's configuration, and mamba2-1.3b under the same mix
#: and limits (no cell serves it yet; its reference is kept for one)
SERVED = ["qwen2-7b", "mamba2-1.3b"]


@pytest.mark.parametrize("name", SERVED)
def test_sound_serve_run_is_correct(name):
    ok, checks = serve(name)
    assert ok, checks


@pytest.mark.parametrize("name", SERVED)
def test_token_altered_where_produced(name, monkeypatch):
    decode = ServeLoop.decode

    def altered(self, toks, pos):
        logits = decode(self, toks, pos).clone()
        logits[:, 3] += 1e4          # every slot's next token becomes 3
        return logits
    monkeypatch.setattr(ServeLoop, "decode", altered)
    ok, checks = serve(name)
    assert not ok, checks


@pytest.mark.parametrize("name", SERVED)
def test_step_returns_its_state_unchanged(name, monkeypatch):
    step = Model.decode_step

    def stale(self, params, batch, cache, rules=None):
        copy = [{k: v.clone() for k, v in c.items()} for c in cache]
        return step(self, params, batch, copy, rules)
    monkeypatch.setattr(Model, "decode_step", stale)
    ok, checks = serve(name)
    assert not ok, checks


@pytest.mark.parametrize("seed", [1, 2, 23])
def test_sound_train_run_is_correct(seed):
    _, checks = train(seed)
    assert core.judge(checks), checks


def test_train_step_returns_its_state_unchanged(monkeypatch):
    init, _ = O.OPTIMIZERS["adamw"]

    def unchanged(params, grads, state, lr, **kw):
        return {"m": state["m"], "v": state["v"], "step": state["step"] + 1}
    monkeypatch.setitem(O.OPTIMIZERS, "adamw", (init, unchanged))
    ok, checks = train()
    assert not ok and over(checks, "delta_gap"), checks


def test_train_half_the_batch_left_out(monkeypatch):
    loss = Model.loss

    def half(self, params, batch, rules=None):
        rows = batch["tokens"].shape[1] // 2
        return loss(self, params, {k: v[:, :rows] for k, v in batch.items()},
                    rules)
    monkeypatch.setattr(Model, "loss", half)
    ok, checks = train()
    assert not ok and over(checks, "grad_median_gap"), checks


def test_train_replays_half_the_batch(monkeypatch):
    """Half of each batch left out from the second call on (on the card,
    the graph's replays) and not in the first: the second gradient's
    number catches it."""
    call, loss = TrainGraph.__call__, Model.loss
    calls = []

    def counted(self, *args):
        calls.append(1)
        return call(self, *args)

    def half(self, params, batch, rules=None):
        if len(calls) < 2:
            return loss(self, params, batch, rules)
        rows = batch["tokens"].shape[1] // 2
        return loss(self, params, {k: v[:, :rows] for k, v in batch.items()},
                    rules)
    monkeypatch.setattr(TrainGraph, "__call__", counted)
    monkeypatch.setattr(Model, "loss", half)
    ok, checks = train()
    assert not ok and over(checks, "grad2_median_gap"), checks
    assert not over(checks, "grad_median_gap"), checks
