"""ROADMAP C11: the port writes its records, caches and checkpoints under
its own root, ``artifacts/torch/`` (``repro_torch.artifacts``), apart from
the JAX package's directories under ``artifacts/``.

The two packages key their dry-run records alike
(``<arch>__<shape>__<mesh><tag>.json``) and lay out their checkpoints
alike, but the contents differ: when both wrote ``artifacts/dryrun/``, the
port's ``run_cell`` returned the reference's cached record and died in
``describe`` on its missing ``trace_s``, and its roofline rowed the
reference's HLO collectives as its own; when both trained into
``artifacts/train_ckpt``, the port's ``--resume`` read the reference's
checkpoint and died, and a run without ``--resume`` deleted it.

(a) every default directory of the port against each of the reference's,
read where they are defined (the reference's sweep scripts and its train
CLI as text: the scripts set ``XLA_FLAGS`` when imported, the CLI builds
its parser inside ``main``); (b) and (c) both packages' dry runs and
train CLIs with their default paths, each in a subprocess, on a copy of
``src/repro`` and ``src/repro_torch`` under ``tmp_path``, so that the
defaults resolve there.
"""
import json
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

import repro.core.backends as ref_backends
import repro.core.roofline as ref_roofline
import repro.launch.dryrun as ref_dryrun
from repro_torch import artifacts
from repro_torch.core import backends, roofline
from repro_torch.launch import dryrun, train
from repro_torch.scripts import hillclimb, optimize_all

ROOT = Path(__file__).resolve().parents[1]
CELL = ("tiny-test", "decode_32k")
KEY = "tiny-test__decode_32k__pod16x16"
TRAIN_ARGS = ["--arch", "tiny-test", "--steps", "2", "--ckpt-every", "1",
              "--seq", "64", "--batch", "2", "--log-every", "1"]


def _script_out(name: str) -> Path:
    """``OUT`` of the repo's ``scripts/<name>.py``, from its text."""
    path = ROOT / "scripts" / f"{name}.py"
    m = re.search(r'^OUT = Path\(__file__\)\.resolve\(\)\.parents\[(\d+)\]'
                  r'((?: / "[^"]+")+)$', path.read_text(), re.M)
    assert m, f"{path} no longer defines OUT as a path beside itself"
    return path.resolve().parents[int(m[1])].joinpath(
        *re.findall(r'"([^"]+)"', m[2]))


def _ref_ckpt_default() -> Path:
    """The reference train CLI's ``--ckpt-dir`` default, from its text,
    resolved against the repo root (its CLI runs from there)."""
    path = ROOT / "src" / "repro" / "launch" / "train.py"
    m = re.search(r'"--ckpt-dir", default="([^"]+)"', path.read_text())
    assert m, f"{path} no longer names a --ckpt-dir default"
    return ROOT / m[1]


REFERENCE_DEFAULTS = {
    "repro.launch.dryrun.ART": ref_dryrun.ART,
    "repro.core.roofline.ART": ref_roofline.ART,
    "repro.core.backends.ART_DRYRUN": ref_backends.ART_DRYRUN,
    "scripts/optimize_all.py OUT": _script_out("optimize_all"),
    "scripts/hillclimb.py OUT": _script_out("hillclimb"),
    "repro.launch.train --ckpt-dir": _ref_ckpt_default(),
}
PORT_DEFAULTS = {
    "launch.dryrun.ART": dryrun.ART,
    "core.roofline.ART": roofline.ART,
    "core.backends.CompiledBackend.art_dir":
        backends.CompiledBackend.art_dir,
    "core.backends.ReplayBackend.root": backends.ReplayBackend.root,
    "scripts.optimize_all.OUT": optimize_all.OUT,
    "scripts.hillclimb.OUT": hillclimb.OUT,
    "launch.train --ckpt-dir": Path(train.parser().get_default("ckpt_dir")),
}


def _overlap(a: Path, b: Path) -> bool:
    a, b = a.resolve(), b.resolve()
    return a == b or a in b.parents or b in a.parents


@pytest.mark.parametrize("name", PORT_DEFAULTS)
def test_port_default_is_disjoint_from_the_reference(name):
    """Under the port's one root, and neither equal to, inside, nor
    around any default directory of the reference."""
    path = PORT_DEFAULTS[name]
    assert path.is_absolute() and artifacts.ART_ROOT in path.parents, path
    shared = {ref: str(p) for ref, p in REFERENCE_DEFAULTS.items()
              if _overlap(path, p)}
    assert not shared, f"{name} = {path} overlaps the reference's {shared}"


@pytest.fixture
def both_packages(tmp_path):
    """A copy of both packages under ``tmp_path``: their defaults, which
    derive from where the modules lie, resolve under ``tmp_path``."""
    skip = shutil.ignore_patterns("__pycache__", "build")
    for pkg in ("repro", "repro_torch"):
        shutil.copytree(ROOT / "src" / pkg, tmp_path / "src" / pkg,
                        ignore=skip)
    env = dict(os.environ, PYTHONPATH=str(tmp_path / "src"),
               JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)

    def run(*argv):
        r = subprocess.run([sys.executable, *argv], cwd=tmp_path, env=env,
                           capture_output=True, text=True, timeout=300)
        assert r.returncode == 0, \
            f"{argv} exited {r.returncode}:\n{r.stdout}\n{r.stderr[-3000:]}"
        return r.stdout
    return tmp_path, run


def _snapshot(folder: Path) -> dict:
    return {p.relative_to(folder).as_posix(): p.read_bytes()
            for p in sorted(folder.rglob("*")) if p.is_file()}


def test_dryruns_of_both_packages_keep_their_own_records(both_packages):
    """The reference's dry run, then the port's on the same cell: the port
    runs the cell and describes its own record (``trace_s``; the
    reference's has ``compile_s``), its roofline rows only that record,
    and the reference's files are byte for byte what it wrote."""
    root, run = both_packages
    arch, shape = CELL
    run("-m", "repro.launch.dryrun", "--arch", arch, "--shape", shape)
    ref_dir = root / "artifacts" / "dryrun"
    ref_files = _snapshot(ref_dir)
    assert f"{KEY}.json" in ref_files
    ref_rec = json.loads(ref_files[f"{KEY}.json"])
    assert "compile_s" in ref_rec and "trace_s" not in ref_rec

    out = run("-m", "repro_torch.launch.dryrun", "--arch", arch,
              "--shape", shape)
    assert "trace=" in out and " OK " in out, out
    port_rec = json.loads(
        (root / "artifacts" / "torch" / "dryrun" / f"{KEY}.json")
        .read_text())
    assert "trace_s" in port_rec and "execution" in port_rec
    assert "compile_s" not in port_rec

    rows = json.loads(run("-c", (
        "import json\nfrom repro_torch.core.roofline import load_rows\n"
        "print(json.dumps([[r.arch, r.shape, r.status, "
        "r.raw['coll_bytes_raw_per_chip']] for r in load_rows()]))")))
    coll = port_rec["collectives"]["total_bytes"]
    assert coll != ref_rec["collectives"]["total_bytes"]
    assert rows == [[arch, shape, "OK", coll]]
    assert _snapshot(ref_dir) == ref_files


def test_train_clis_keep_their_own_checkpoints(both_packages):
    """The reference's train CLI, then the port's with ``--resume`` and
    again without it, all on their default ``--ckpt-dir`` from the same
    working directory: the port resumes from nothing (step 0), and the
    reference's ``step_*`` checkpoints survive both, byte for byte."""
    root, run = both_packages
    run("-m", "repro.launch.train", *TRAIN_ARGS)
    ref_dir = root / "artifacts" / "train_ckpt"
    steps = sorted(p.name for p in ref_dir.glob("step_*"))
    assert steps == ["step_00000001", "step_00000002"]
    ref_files = _snapshot(ref_dir)

    port_dir = root / "artifacts" / "torch" / "train_ckpt"
    for extra in (["--resume"], []):
        run("-m", "repro_torch.launch.train", *TRAIN_ARGS, *extra,
            "--device", "cpu")
        log = json.loads((port_dir / "train_log.json").read_text())
        assert [r["step"] for r in log["losses"]] == [0, 1], extra
        assert sorted(p.name for p in port_dir.glob("step_*")) == steps
        assert _snapshot(ref_dir) == ref_files, extra
