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

``restore(..., device=)`` places each leaf on the restoring job's device;
``restore(..., shardings=)`` lays each leaf onto a ``DeviceMesh`` as a
``DTensor`` holding only this rank's shard — the reference's elastic
re-sharding: a checkpoint written on one mesh (or none) restores onto
another.  ``save`` of a ``DTensor`` writes the full tensor: every rank
gathers it (a collective, so every rank calls ``save``), rank 0 writes,
and the ranks meet at a barrier before ``save`` returns.  ``AsyncSaver``
copies the tree to the host when ``save`` is called (a copy, also of CPU
tensors, so a later in-place update cannot reach the file) and writes it
in a worker thread off the critical path.
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
from repro_torch.parallel.sharding import is_dtensor


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
    """A host copy of ``t`` as numpy (bf16 as its 16-bit pattern); a
    ``DTensor`` is gathered whole first."""
    if is_dtensor(t):
        t = t.full_tensor()
    t = t.detach().to("cpu", copy=True)
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
    return t.numpy()


def _flatten(tree: Any) -> tuple[dict, dict, bool]:
    """(key -> numpy host copy, key -> torch dtype name, whether a leaf
    was a ``DTensor``)."""
    flat, dtypes, sharded = {}, {}, False
    for key, t in _items(tree):
        sharded = sharded or is_dtensor(t)
        flat[key] = _to_numpy(t)
        dtypes[key] = _dtype_name(t)
    return flat, dtypes, sharded


def _writer(sharded: bool) -> bool:
    """Whether this process writes: always, unless the tree held
    ``DTensor``s in a group of several ranks (then rank 0)."""
    import torch.distributed as dist
    return not (sharded and dist.is_initialized() and dist.get_rank() != 0)


def _meet(sharded: bool) -> None:
    """The ranks wait for rank 0's write of a sharded tree."""
    import torch.distributed as dist
    if sharded and dist.is_initialized() and dist.get_world_size() > 1:
        dist.barrier()


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
    flat, dtypes, sharded = _flatten(tree)
    final = Path(ckpt_dir) / f"step_{step:08d}"
    if _writer(sharded):
        final = _write(ckpt_dir, step, flat, dtypes, meta)
    _meet(sharded)
    return final


class AsyncSaver:
    """Runs `save` off the training thread; at most one in flight."""

    def __init__(self):
        self._thread: Optional[threading.Thread] = None
        self.last_path: Optional[Path] = None

    def save(self, ckpt_dir, step, tree, meta=None):
        self.wait()
        flat, dtypes, sharded = _flatten(tree)  # snapshot now (host copies)
        if sharded:
            raise ValueError("AsyncSaver writes from one thread: save a "
                             "DTensor tree with save()")

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


def _shard(arr: np.ndarray, dtype_name: str, dev: torch.device,
           sharding) -> torch.Tensor:
    """``arr`` (the whole leaf) as a ``DTensor`` on ``sharding = (mesh,
    placements)`` whose local tensor holds only this rank's slice."""
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset
    mesh, placements = sharding
    shape = tuple(arr.shape)
    size, off = compute_local_shape_and_global_offset(
        shape, mesh, tuple(placements))
    part = arr[tuple(slice(o, o + n) for o, n in zip(off, size))]
    local = _from_numpy(np.ascontiguousarray(part), dtype_name).to(dev)
    return DTensor.from_local(
        local, mesh, tuple(placements), run_check=False,
        shape=torch.Size(shape),
        stride=torch.empty(shape, device="meta").stride())


def _from_numpy(arr: np.ndarray, dtype_name: str) -> torch.Tensor:
    t = torch.from_numpy(np.array(arr))
    if dtype_name == "bfloat16":
        t = t.view(torch.bfloat16)
    return t


def restore(ckpt_dir: str | Path, step: int, like: Any,
            device: DeviceLike = "cpu", verify: bool = True,
            shardings: Any = None) -> tuple[Any, dict]:
    """Restore into the structure of ``like`` (its leaf values are ignored;
    a module's entry comes back as a state dict), each leaf on
    ``device``.  ``shardings`` (``like``'s structure, each leaf a
    ``(mesh, placements)`` pair, e.g. from
    ``parallel.param_sharding.shardings_of``) lays each leaf onto its mesh
    as a ``DTensor`` holding only this rank's shard, on ``mesh``'s device
    type.  Raises ``IOError`` when a leaf's hash does not match."""
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
            name = leaves_meta[key]["dtype"]
            sh = _lookup(shardings, key)
            if sh is not None:
                return _shard(arr, name, torch.device(sh[0].device_type),
                              sh)
            return _from_numpy(arr, name).to(dev)
        tree = _unflatten(like, leaf)
    return tree, manifest["meta"]


def _lookup(shardings: Any, key: str):
    """The ``(mesh, placements)`` of leaf ``key`` in ``shardings`` (nested
    dicts keyed as the checkpoint's "/"-joined paths), or None."""
    if shardings is None:
        return None
    node = shardings
    for k in key.split("/"):
        if not isinstance(node, dict) or k not in node:
            return None
        node = node[k]
    return node
