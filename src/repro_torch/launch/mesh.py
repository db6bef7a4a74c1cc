"""Mesh factories on torch ``DeviceMesh``.

Counterpart of ``repro.launch.mesh``.  Defined as FUNCTIONS (not
module-level constants) so importing this module touches no device and no
process group.

``make_production_mesh`` lays the reference's pod meshes over an existing
process group of 256 or 512 ranks (one card each); it never initialises
one and never shrinks a mesh to fit.  ``make_host_mesh`` is the mesh of
the devices this process group drives: on one card with no group it
creates a one-rank group of its own (NCCL on ``cuda``, gloo on the CPU,
over an in-process store: no rendezvous, no network) and lays a ``(1, 1)``
mesh over it, on which every sharding rule resolves to replicated.
``destroy_host_mesh`` tears down the group ``make_host_mesh`` created.
``init_communicators`` makes each of a mesh's groups' communicators
before a CUDA graph's capture, which cannot make one.
"""
from __future__ import annotations

import contextlib

from repro_torch.device import DeviceLike, resolve_device

#: the reference's pod mesh: 16x16 = 256 chips per pod; 2 pods = 512
POD_SHAPE = (16, 16)
POD_AXES = ("data", "model")
MULTI_POD_SHAPE = (2, 16, 16)
MULTI_POD_AXES = ("pod", "data", "model")
#: the world sizes a production mesh is laid over
PRODUCTION_WORLDS = (256, 512)

#: whether make_host_mesh created the current default group
_OWN_GROUP = {"created": False}


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda"):
    """The pod mesh, ``(16, 16)`` over ``("data", "model")`` or
    ``(2, 16, 16)`` over ``("pod", "data", "model")``: 'pod' composes with
    'data' for batch sharding, 'model' (TP/EP) stays inside a pod.

    Needs an initialised process group of 256 or 512 ranks (a single-pod
    mesh takes the first 256); raises otherwise."""
    import math

    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    shape = MULTI_POD_SHAPE if multi_pod else POD_SHAPE
    axes = MULTI_POD_AXES if multi_pod else POD_AXES
    if not dist.is_initialized():
        raise RuntimeError("make_production_mesh needs an initialised "
                           "process group of 256 or 512 ranks")
    world = dist.get_world_size()
    if world not in PRODUCTION_WORLDS or world < math.prod(shape):
        raise RuntimeError(f"a {shape} production mesh needs a world of "
                           f"{' or '.join(map(str, PRODUCTION_WORLDS))} "
                           f"ranks holding {math.prod(shape)}; this one has "
                           f"{world} (a mesh is never shrunk to fit)")
    return init_device_mesh(device_type, shape, mesh_dim_names=axes)


def make_host_mesh(model_axis: int = 1, device: DeviceLike = None):
    """``(n // model_axis, model_axis)`` over ``("data", "model")``, ``n``
    the ranks of the process group (one per device).  Without a group it
    creates a one-rank group on ``device`` (default ``cuda``; raises
    without a card) and ``n`` is 1."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    dev = resolve_device(device)
    if not dist.is_initialized():
        if dev.type == "cuda":
            import torch
            torch.cuda.set_device(torch.cuda.current_device()
                                  if dev.index is None else dev.index)
        backend = "nccl" if dev.type == "cuda" else "gloo"
        dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                                world_size=1)
        _OWN_GROUP["created"] = True
    n = dist.get_world_size()
    if model_axis < 1 or n % model_axis:
        raise ValueError(f"model axis {model_axis} does not divide the "
                         f"{n} devices of the group")
    return init_device_mesh(dev.type, (n // model_axis, model_axis),
                            mesh_dim_names=POD_AXES)


def destroy_host_mesh() -> None:
    """Destroy the process group ``make_host_mesh`` created (a group it
    found is the caller's and stays)."""
    import torch.distributed as dist
    if _OWN_GROUP["created"]:
        _OWN_GROUP["created"] = False
        if dist.is_initialized():
            dist.destroy_process_group()


def init_communicators(mesh) -> None:
    """One ``all_reduce`` of a 0-d tensor on each process group of
    ``mesh``, on the current stream, waited for: NCCL makes a group's
    communicator at its first collective, which must not fall inside a
    CUDA graph's capture."""
    import torch
    import torch.distributed as dist
    dev = torch.device(mesh.device_type)
    if dev.type == "cuda":
        dev = torch.device("cuda", torch.cuda.current_device())
    for group in mesh.get_all_groups():
        dist.all_reduce(torch.zeros((), device=dev), group=group)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


@contextlib.contextmanager
def host_mesh(model_axis: int = 1, device: DeviceLike = None):
    """``make_host_mesh`` for a block, its group destroyed on exit."""
    try:
        yield make_host_mesh(model_axis, device)
    finally:
        destroy_host_mesh()
