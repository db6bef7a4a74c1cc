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
    + [ROOT / "chip_smoke.py"]


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
            "src/repro_torch/kernels/ops.py"} <= names
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


def test_unsupported_devices_are_refused():
    with pytest.raises(ValueError, match="unsupported device"):
        resolve_device("meta")
