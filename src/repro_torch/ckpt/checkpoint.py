"""Atomic checkpointing with integrity hashes.

Counterpart of ``repro.ckpt.checkpoint``, with its on-disk layout:

    <dir>/step_<k>/
      arrays.npz          flattened tree leaves (key = path)
      manifest.json       shapes, dtypes, sha256 per leaf, meta
      COMMITTED           written last; absence = torn checkpoint

A tree is nested dicts whose leaves are tensors; a ``torch.nn.Module``
stands for its ``state_dict``.  Keys are the port's names joined by "/"
(a module's parameters keep their dotted names, e.g.
``p/layers.0.mlp.wi``).  A bf16 leaf is stored as its raw 16-bit pattern
(numpy has no bf16) under the manifest's dtype ``bfloat16``.

``restore(..., device=)`` places each leaf on the restoring job's device.
The reference's elastic re-sharding onto another mesh comes with the
train step's collectives (ROADMAP.md §A item 1).  ``AsyncSaver`` copies the tree to the host when ``save``
is called (a copy, also of CPU tensors, so a later in-place update cannot
reach the file) and writes it in a worker thread off the critical path.
"""
from __future__ import annotations

import hashlib
import json
import shutil
import threading
from pathlib import Path
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.device import DeviceLike


def _items(tree: Any, prefix: str = ""):
    """(key, tensor) for every leaf of ``tree``."""
    if isinstance(tree, torch.nn.Module):
        tree = tree.state_dict()
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _items(tree[k], f"{prefix}/{k}" if prefix else str(k))
    elif isinstance(tree, torch.Tensor):
        yield prefix, tree
    else:
        raise TypeError(f"{prefix}: a checkpoint leaf must be a tensor, "
                        f"not {type(tree).__name__}")


def _dtype_name(t: torch.Tensor) -> str:
    return str(t.dtype).removeprefix("torch.")


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    """A host copy of ``t`` as numpy (bf16 as its 16-bit pattern)."""
    t = t.detach().to("cpu", copy=True)
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
    return t.numpy()


def _flatten(tree: Any) -> tuple[dict, dict]:
    """(key -> numpy host copy, key -> torch dtype name)."""
    flat, dtypes = {}, {}
    for key, t in _items(tree):
        flat[key] = _to_numpy(t)
        dtypes[key] = _dtype_name(t)
    return flat, dtypes


def _write(ckpt_dir: str | Path, step: int, flat: dict, dtypes: dict,
           meta: Optional[dict]) -> Path:
    ckpt_dir = Path(ckpt_dir)
    final = ckpt_dir / f"step_{step:08d}"
    tmp = ckpt_dir / f".tmp_step_{step:08d}"
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir(parents=True)
    np.savez(tmp / "arrays.npz", **flat)
    manifest = {
        "step": step,
        "meta": meta or {},
        "leaves": {k: {"shape": list(v.shape), "dtype": dtypes[k],
                       "sha256": hashlib.sha256(v.tobytes()).hexdigest()}
                   for k, v in flat.items()},
    }
    (tmp / "manifest.json").write_text(json.dumps(manifest, indent=1))
    (tmp / "COMMITTED").write_text("ok")
    if final.exists():
        shutil.rmtree(final)
    tmp.rename(final)                      # atomic publish
    return final


def save(ckpt_dir: str | Path, step: int, tree: Any,
         meta: Optional[dict] = None) -> Path:
    flat, dtypes = _flatten(tree)
    return _write(ckpt_dir, step, flat, dtypes, meta)


class AsyncSaver:
    """Runs `save` off the training thread; at most one in flight."""

    def __init__(self):
        self._thread: Optional[threading.Thread] = None
        self.last_path: Optional[Path] = None

    def save(self, ckpt_dir, step, tree, meta=None):
        self.wait()
        flat, dtypes = _flatten(tree)           # snapshot now (host copies)

        def work():
            self.last_path = _write(ckpt_dir, step, flat, dtypes, meta)

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None


def latest_step(ckpt_dir: str | Path) -> Optional[int]:
    ckpt_dir = Path(ckpt_dir)
    if not ckpt_dir.exists():
        return None
    steps = []
    for p in ckpt_dir.glob("step_*"):
        if (p / "COMMITTED").exists():
            steps.append(int(p.name.split("_")[1]))
    return max(steps) if steps else None


def _unflatten(like: Any, leaf, prefix: str = "") -> Any:
    """``like``'s structure (a module as its state dict) with each leaf
    replaced by ``leaf(key)``."""
    if isinstance(like, torch.nn.Module):
        like = like.state_dict()
    if isinstance(like, dict):
        return {k: _unflatten(v, leaf, f"{prefix}/{k}" if prefix else str(k))
                for k, v in like.items()}
    return leaf(prefix)


def restore(ckpt_dir: str | Path, step: int, like: Any,
            device: DeviceLike = "cpu", verify: bool = True
            ) -> tuple[Any, dict]:
    """Restore into the structure of ``like`` (its leaf values are ignored;
    a module's entry comes back as a state dict), each leaf on
    ``device``.  Raises ``IOError`` when a leaf's hash does not match."""
    path = Path(ckpt_dir) / f"step_{step:08d}"
    if not (path / "COMMITTED").exists():
        raise FileNotFoundError(f"no committed checkpoint at {path}")
    manifest = json.loads((path / "manifest.json").read_text())
    leaves_meta = manifest["leaves"]
    dev = torch.device(device)
    with np.load(path / "arrays.npz") as data:
        def leaf(key: str) -> torch.Tensor:
            arr = data[key]
            if verify:
                digest = hashlib.sha256(arr.tobytes()).hexdigest()
                if digest != leaves_meta[key]["sha256"]:
                    raise IOError(f"integrity check failed for {key}")
            t = torch.from_numpy(np.array(arr))
            if leaves_meta[key]["dtype"] == "bfloat16":
                t = t.view(torch.bfloat16)
            return t.to(dev)
        tree = _unflatten(like, leaf)
    return tree, manifest["meta"]
