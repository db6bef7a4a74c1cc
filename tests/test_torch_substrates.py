"""The port's data pipeline, checkpoints, fault-tolerant driver, gradient
compression, optimizers and train CLI (mirrors tests/test_substrates.py),
held against ``repro`` where the two compute the same thing: the batches
bit for bit, quantization bit for bit."""
import dataclasses
import json
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data.pipeline import DataConfig as JDataConfig
from repro.data.pipeline import SyntheticLM as JSyntheticLM
from repro.train import compress as JC
from repro_torch.ckpt import checkpoint as C
from repro_torch.configs import get_config
from repro_torch.data.pipeline import DataConfig, Prefetcher, SyntheticLM
from repro_torch.ft.driver import (FailureInjector, InjectedFailure,
                                   StragglerPolicy, TrainDriver)
from repro_torch.launch import train as launch_train
from repro_torch.models.model import Model
from repro_torch.train import compress as CP
from repro_torch.train import optimizer as O
from repro_torch.train.step import make_opt_init, make_train_step


# ---------------------------------------------------------------------------
# data pipeline
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("host_id,n_hosts", [(0, 1), (1, 2)])
def test_batches_are_the_references_bit_for_bit(host_id, n_hosts):
    kw = dict(vocab_size=97, seq_len=48, global_batch=4, seed=7,
              mean_doc_len=20, host_id=host_id, n_hosts=n_hosts)
    got, want = SyntheticLM(DataConfig(**kw)), JSyntheticLM(JDataConfig(**kw))
    for step in (0, 1, 13):
        a, b = got.batch(step), want.batch(step)
        assert set(a) == set(b) == {"tokens", "targets"}
        for k in a:
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k])


def test_data_deterministic_and_host_sharded():
    cfg = DataConfig(vocab_size=64, seq_len=32, global_batch=4)
    a = SyntheticLM(cfg).batch(7)
    b = SyntheticLM(cfg).batch(7)
    np.testing.assert_array_equal(a["tokens"], b["tokens"])
    h0 = SyntheticLM(dataclasses.replace(cfg, host_id=0, n_hosts=2)).batch(7)
    h1 = SyntheticLM(dataclasses.replace(cfg, host_id=1, n_hosts=2)).batch(7)
    np.testing.assert_array_equal(
        np.concatenate([h0["tokens"], h1["tokens"]]), a["tokens"])


def test_data_targets_shifted():
    b = SyntheticLM(DataConfig(vocab_size=64, seq_len=32,
                               global_batch=2)).batch(0)
    assert b["tokens"].shape == b["targets"].shape == (2, 32)
    np.testing.assert_array_equal(b["tokens"][:, 1:], b["targets"][:, :-1])


def test_prefetcher_orders_steps():
    pf = Prefetcher(SyntheticLM(DataConfig(vocab_size=64, seq_len=16,
                                           global_batch=2)), start_step=3)
    s0, _ = pf.next()
    s1, _ = pf.next()
    pf.close()
    assert (s0, s1) == (3, 4)
    assert not pf.thread.is_alive()


# ---------------------------------------------------------------------------
# checkpointing
# ---------------------------------------------------------------------------

def _tree(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {"w": torch.randn((8, 4), generator=g),
            "b": {"x": torch.randn((4,), generator=g),
                  "h": torch.randn((3, 2), generator=g).bfloat16(),
                  "q": torch.randint(-127, 128, (5,), generator=g,
                                     dtype=torch.int8),
                  "step": torch.tensor(3, dtype=torch.int32)}}


def _equal_trees(a, b):
    if isinstance(a, dict):
        assert set(a) == set(b)
        for k in a:
            _equal_trees(a[k], b[k])
    else:
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_checkpoint_roundtrip(tmp_path):
    t = _tree()
    C.save(tmp_path, 10, t, meta={"loss": 1.5})
    assert C.latest_step(tmp_path) == 10
    restored, meta = C.restore(tmp_path, 10, t, device="cpu")
    _equal_trees(t, restored)
    assert meta["loss"] == 1.5


def test_checkpoint_layout_is_the_references(tmp_path):
    """arrays.npz keyed by path, manifest.json with shape, dtype and
    sha256 per leaf, COMMITTED; a module's parameters under their dotted
    names."""
    model = Model(get_config("tiny-test"), device="cpu")
    params = model.init(torch.Generator().manual_seed(0))
    path = C.save(tmp_path, 4, {"p": params, "o": {"step": torch.tensor(4)}})
    assert path.name == "step_00000004"
    assert sorted(p.name for p in path.iterdir()) == [
        "COMMITTED", "arrays.npz", "manifest.json"]
    manifest = json.loads((path / "manifest.json").read_text())
    assert manifest["step"] == 4
    leaf = manifest["leaves"]["p/layers.1.mlp.wi"]
    assert leaf["shape"] == [32, 64] and leaf["dtype"] == "float32"
    assert len(leaf["sha256"]) == 64
    with np.load(path / "arrays.npz") as data:
        assert set(data.files) == set(manifest["leaves"])


def test_checkpoint_restores_a_model(tmp_path):
    model = Model(get_config("tiny-test"), device="cpu")
    params = model.init(torch.Generator().manual_seed(0))
    C.save(tmp_path, 1, {"p": params})
    other = model.init(torch.Generator().manual_seed(1))
    state, _ = C.restore(tmp_path, 1, {"p": other})
    other.load_state_dict(state["p"])
    for a, b in zip(params.parameters(), other.parameters()):
        assert torch.equal(a, b)


def test_checkpoint_integrity_detects_corruption(tmp_path):
    t = {"w": torch.from_numpy(np.random.default_rng(0).normal(
        size=(1024, 16)).astype(np.float32))}      # data dominates the file
    path = C.save(tmp_path, 1, t)
    npz = path / "arrays.npz"
    raw = bytearray(npz.read_bytes())
    for frac in (0.3, 0.5, 0.7):             # hit the array payload
        raw[int(len(raw) * frac)] ^= 0xFF
    npz.write_bytes(bytes(raw))
    with pytest.raises(Exception):
        C.restore(tmp_path, 1, t)


def test_checkpoint_hash_mismatch_raises(tmp_path):
    t = {"w": torch.ones(4)}
    path = C.save(tmp_path, 1, t)
    manifest = json.loads((path / "manifest.json").read_text())
    manifest["leaves"]["w"]["sha256"] = "0" * 64
    (path / "manifest.json").write_text(json.dumps(manifest))
    with pytest.raises(IOError, match="integrity check failed for w"):
        C.restore(tmp_path, 1, t)
    restored, _ = C.restore(tmp_path, 1, t, verify=False)
    assert torch.equal(restored["w"], t["w"])


def test_checkpoint_torn_write_ignored(tmp_path):
    C.save(tmp_path, 5, _tree())
    torn = tmp_path / "step_00000009"
    torn.mkdir()
    (torn / "manifest.json").write_text("{}")   # no COMMITTED marker
    assert C.latest_step(tmp_path) == 5
    with pytest.raises(FileNotFoundError):
        C.restore(tmp_path, 9, _tree())


def test_async_saver_snapshots_at_save(tmp_path, monkeypatch):
    """The saver copies the tree when ``save`` is called (CPU tensors
    too): an in-place update made while the file is being written does not
    reach it."""
    t = {"w": torch.zeros(64)}
    gate = threading.Event()
    write = C._write

    def slow_write(*a, **k):
        gate.wait(timeout=10)
        return write(*a, **k)
    monkeypatch.setattr(C, "_write", slow_write)
    saver = C.AsyncSaver()
    saver.save(tmp_path, 1, t)
    t["w"].add_(1.0)                   # the next optimizer step, in place
    gate.set()
    saver.wait()
    assert saver.last_path is not None
    restored, _ = C.restore(tmp_path, 1, t)
    assert torch.equal(restored["w"], torch.zeros(64))


def test_checkpoint_rejects_a_non_tensor_leaf(tmp_path):
    with pytest.raises(TypeError, match="must be a tensor"):
        C.save(tmp_path, 1, {"w": [1.0]})


# ---------------------------------------------------------------------------
# fault tolerance: failure injection + exact restart
# ---------------------------------------------------------------------------

def _driver(tmp_path, fail_at=None, steps_ckpt=5, opt="adamw"):
    cfg = dataclasses.replace(get_config("tiny-test"), optimizer=opt)
    model = Model(cfg, device="cpu")
    data = DataConfig(vocab_size=cfg.vocab_size, seq_len=16, global_batch=2)
    return TrainDriver(model=model, train_step=make_train_step(model),
                       opt_init=make_opt_init(model), data_cfg=data,
                       ckpt_dir=str(tmp_path), ckpt_every=steps_ckpt,
                       injector=FailureInjector(fail_at=fail_at or set()))


@pytest.mark.parametrize("opt", ["adamw", "adam8"])
def test_restart_resumes_exact_loss_curve(tmp_path, opt):
    """A crash at step 13 and a restart from the step-10 checkpoint: steps
    10-19 give the uninterrupted run's losses bit for bit (the CPU is
    deterministic; the state, int8 codes included, round-trips exactly)."""
    ref = _driver(tmp_path / "ref", opt=opt).run(20)
    d = _driver(tmp_path / "ft", fail_at={13}, opt=opt)
    with pytest.raises(InjectedFailure):
        d.run(20)
    out = _driver(tmp_path / "ft", opt=opt).run(20)
    ref_losses = {r["step"]: r["loss"] for r in ref["losses"]}
    assert [r["step"] for r in out["losses"]] == list(range(10, 20))
    for r in out["losses"]:
        assert r["loss"] == ref_losses[r["step"]], r["step"]


def test_straggler_deadline_detection():
    p = StragglerPolicy(deadline_factor=2.0, window=8)
    for i in range(8):
        assert not p.observe(i, 0.1)
    assert p.observe(8, 0.5)          # 5x the median -> straggler
    assert p.events and p.events[0]["step"] == 8


def test_driver_needs_a_card_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    args = launch_train.parser().parse_args(["--arch", "tiny-test"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        launch_train.run(args)


# ---------------------------------------------------------------------------
# gradient compression
# ---------------------------------------------------------------------------

def test_ef_compression_unbiased_over_steps():
    """Error feedback: accumulated quantization error stays bounded and the
    running sum of ghat tracks the running sum of g."""
    rng = np.random.default_rng(0)
    g_sum = np.zeros((64,), np.float32)
    ghat_sum = np.zeros((64,), np.float32)
    err = torch.zeros(64)
    for _ in range(50):
        g = torch.from_numpy(rng.normal(size=64).astype(np.float32))
        ghat, err = CP.ef_compress(g, err)
        g_sum += g.numpy()
        ghat_sum += ghat.numpy()
    assert np.max(np.abs(g_sum - ghat_sum)) <= float(err.abs().max()) + 1e-5


@pytest.mark.parametrize("seed,n", [(0, 16), (1, 100), (2, 512), (3, 700),
                                    (4, 1100)])
def test_quantize_equals_the_reference_and_its_error_bound(seed, n):
    x = (np.random.default_rng(seed).normal(size=n) * 10).astype(np.float32)
    q, s = CP.quantize(torch.from_numpy(x))
    jq, js = JC.quantize(jnp.asarray(x))
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    y = CP.dequantize(q, s, x.shape, x.size)
    np.testing.assert_array_equal(
        y.numpy(), np.asarray(JC.dequantize(jq, js, x.shape, x.size)))
    assert float((y - torch.from_numpy(x)).abs().max()) \
        <= float(s.max()) * 0.5 + 1e-6


def test_train_step_with_compression_converges_direction():
    cfg = get_config("tiny-test")
    cfg = dataclasses.replace(cfg,
                              plan=cfg.plan.replace(grad_compress="int8_ef"))
    model = Model(cfg, device="cpu")
    step = make_train_step(model)
    params = model.init(torch.Generator().manual_seed(0))
    opt = make_opt_init(model)(params)
    assert "ef" in opt
    data = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=16,
                                  global_batch=4))
    losses = []
    for i in range(15):
        b = {k: torch.from_numpy(v) for k, v in data.batch(i).items()}
        params, opt, m = step(params, opt, b)
        losses.append(float(m["loss"]))
    assert np.mean(losses[-5:]) < np.mean(losses[:5])


# ---------------------------------------------------------------------------
# optimizers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["adamw", "adafactor", "adam8"])
def test_optimizers_descend_quadratic(name):
    target = torch.from_numpy(np.random.default_rng(0).normal(
        size=(8, 8)).astype(np.float32))
    w = torch.zeros((8, 8))
    params = {"w": [w]}
    init, update = O.OPTIMIZERS[name]
    state = init(params)

    def loss(x):
        return torch.mean((x - target) ** 2)

    l0 = float(loss(w))
    for _ in range(60):
        x = w.clone().requires_grad_()
        (g,) = torch.autograd.grad(loss(x), x)
        state = update(params, {"w": [g]}, state, lr=0.05)
    assert float(loss(w)) < 0.2 * l0


def test_adafactor_memory_is_factored():
    st = O.adafactor_init({"w": [torch.zeros((64, 32))]})
    leaf = st["v"]["w"]
    assert leaf["vr"].shape == (64,) and leaf["vc"].shape == (32,)
    # a stacked leaf factors over its stacked shape: 8 norm scales of 24
    st = O.adafactor_init({"scan/l0/s": [torch.zeros(24)] * 8})
    assert st["v"]["scan/l0/s"]["vr"].shape == (8,)
    assert st["v"]["scan/l0/s"]["vc"].shape == (24,)


# ---------------------------------------------------------------------------
# the train CLI
# ---------------------------------------------------------------------------

def _cli(tmp_path, *extra):
    return launch_train.parser().parse_args(
        ["--device", "cpu", "--arch", "tiny-test", "--steps", "8",
         "--batch", "2", "--seq", "16", "--ckpt-every", "4",
         "--ckpt-dir", str(tmp_path / "ck"), *extra])


def test_train_cli_runs_on_the_cpu(tmp_path, capsys):
    out = launch_train.main(
        ["--device", "cpu", "--arch", "tiny-test", "--steps", "8",
         "--batch", "2", "--seq", "16", "--ckpt-dir", str(tmp_path / "ck"),
         "--ckpt-every", "4", "--log-every", "4"])
    assert [r["step"] for r in out["losses"]] == list(range(8))
    assert C.latest_step(tmp_path / "ck") == 8
    log = json.loads((tmp_path / "ck" / "train_log.json").read_text())
    assert log["final_step"] == 8 and len(log["losses"]) == 8
    text = capsys.readouterr().out
    assert "tiny-test: 8 steps in" in text and "step     4  loss" in text


def test_train_cli_resumes_after_an_injected_failure(tmp_path):
    """--fail-at stops the run at the failure; --resume continues from the
    last checkpoint and gives the uninterrupted run's losses."""
    ref = launch_train.run(launch_train.parser().parse_args(
        ["--device", "cpu", "--arch", "tiny-test", "--steps", "8",
         "--batch", "2", "--seq", "16", "--ckpt-every", "4",
         "--ckpt-dir", str(tmp_path / "ref")]))
    with pytest.raises(InjectedFailure):
        launch_train.run(_cli(tmp_path, "--fail-at", "6"))
    assert C.latest_step(tmp_path / "ck") == 4
    out = launch_train.run(_cli(tmp_path, "--resume"))
    want = {r["step"]: r["loss"] for r in ref["losses"]}
    assert [r["step"] for r in out["losses"]] == [4, 5, 6, 7]
    for r in out["losses"]:
        assert r["loss"] == want[r["step"]]


def test_train_cli_takes_the_callers_model(tmp_path):
    cfg = get_config("tiny-test")
    model = Model(cfg, cfg.plan.replace(microbatches=2), device="cpu")
    args = _cli(tmp_path)
    args.steps = 2
    out = launch_train.run(args, model=model)
    assert len(out["losses"]) == 2 and out["wall_s"] > 0
