"""The port stands alone: it imports neither ``jax`` nor anything of
``repro``, and its entry points never fall back to the CPU quietly."""
import ast
from pathlib import Path

import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.device import resolve_device
from repro_torch.models.model import Model
from repro_torch.serve.engine import ServeLoop

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) \
    + [ROOT / "chip_smoke.py", ROOT / "scripts" / "kernel_ab.py"]
#: the user-facing entry points outside the package: each that imports
#: the reference has a module of the same name in the port
ENTRY_DIRS = ("examples", "scripts")


def _imported_modules(path: Path) -> list[str]:
    mods = []
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            mods.extend(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            mods.append(node.module or "")
    return mods


def _forbidden(mod: str) -> bool:
    top = mod.split(".")[0]
    return top in ("jax", "jaxlib", "repro")


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_no_jax_and_nothing_of_repro(path):
    bad = [m for m in _imported_modules(path) if _forbidden(m)]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_the_scan_sees_the_whole_port():
    names = {p.relative_to(ROOT).as_posix() for p in PORT_FILES}
    assert {"chip_smoke.py", "src/repro_torch/serve/engine.py",
            "src/repro_torch/kernels/ops.py",
            "src/repro_torch/train/step.py",
            "src/repro_torch/train/optimizer.py",
            "src/repro_torch/train/compress.py",
            "src/repro_torch/data/pipeline.py",
            "src/repro_torch/ckpt/checkpoint.py",
            "src/repro_torch/ft/driver.py",
            "src/repro_torch/launch/train.py",
            "src/repro_torch/fleet/vector.py",
            "src/repro_torch/fleet/segment.py",
            "src/repro_torch/fleet/shard.py",
            "src/repro_torch/fleet/torch_backend.py",
            "src/repro_torch/obs/flight.py",
            "src/repro_torch/launch/dryrun.py",
            "src/repro_torch/core/transfer.py",
            "src/repro_torch/core/roofline.py",
            "src/repro_torch/core/backends.py",
            "src/repro_torch/core/adapt.py",
            "src/repro_torch/examples/mriq_offload.py",
            "src/repro_torch/examples/adapt_flow.py",
            "src/repro_torch/scripts/power_report.py",
            "src/repro_torch/scripts/hillclimb.py",
            "scripts/kernel_ab.py"} <= names
    assert _forbidden("jax.numpy") and _forbidden("repro.models")
    assert not _forbidden("repro_torch.models")


@pytest.fixture
def no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_model_without_a_device_needs_a_card(no_card):
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Model(get_config("tiny-test"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device("cuda")
    assert Model(get_config("tiny-test"), device="cpu").device.type == "cpu"


def test_serve_loop_without_a_device_needs_a_card(no_card):
    model = Model(get_config("tiny-test"), device="cpu")
    params = model.init(torch.Generator().manual_seed(0))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ServeLoop(model, params, batch_slots=1, max_seq=8)
    loop = ServeLoop(model, params, batch_slots=1, max_seq=8, device="cpu")
    assert loop.device.type == "cpu"


#: reference modules whose counterpart has another name
RENAMED = {"fleet/jax_backend.py": "fleet/torch_backend.py"}


def test_every_reference_module_has_a_counterpart():
    """The port does everything the JAX package does: each module of
    ``src/repro`` has one in ``src/repro_torch`` (jax's booking plane as
    the torch one)."""
    ref = ROOT / "src" / "repro"
    port = ROOT / "src" / "repro_torch"
    missing = [p.relative_to(ref).as_posix() for p in sorted(ref.rglob("*.py"))
               if not (port / RENAMED.get(p.relative_to(ref).as_posix(),
                                          p.relative_to(ref).as_posix())
                       ).is_file()]
    assert not missing, missing


def _imports_the_reference(path: Path) -> bool:
    return any(m.split(".")[0] == "repro" for m in _imported_modules(path))


@pytest.mark.parametrize("folder", ENTRY_DIRS)
def test_every_reference_entry_point_has_a_counterpart(folder):
    """Each ``examples/*.py`` and ``scripts/*.py`` that imports ``repro``
    runs in the port as ``python -m repro_torch.<folder>.<name>``."""
    entry = sorted(p for p in (ROOT / folder).glob("*.py")
                   if _imports_the_reference(p))
    assert entry, f"no entry point of {folder}/ imports the reference"
    port = ROOT / "src" / "repro_torch" / folder
    missing = [p.name for p in entry if not (port / p.name).is_file()]
    assert not missing, missing


def test_the_entry_point_scan_reads_the_imports():
    assert _imports_the_reference(ROOT / "examples" / "mriq_offload.py")
    assert _imports_the_reference(ROOT / "scripts" / "hillclimb.py")
    assert not _imports_the_reference(ROOT / "scripts" / "kernel_ab.py")
    assert not _imports_the_reference(ROOT / "scripts" / "perf_gate.py")


def test_unsupported_devices_are_refused():
    with pytest.raises(ValueError, match="unsupported device"):
        resolve_device("meta")
