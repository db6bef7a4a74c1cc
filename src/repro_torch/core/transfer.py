"""Collective census + transfer-batching analysis (paper §3.1 analogue).

Counterpart of ``repro.core.transfer``.  The paper hoists CPU<->GPU
variable transfers to the outermost nest level and batches them.  The pod
analogue is collective traffic: this module counts every collective's
payload and flags *batching opportunities* — many small same-shape
collectives that could be fused (the per-layer vs once-a-step gradient
reduction the ``fused_grad_reduce`` gene controls).

The reference parses post-SPMD HLO text.  The port has no HLO: its input
is the collectives a step really issued, recorded by
``CollectiveRecorder`` — a ``TorchDispatchMode`` that sees each
``_c10d_functional`` collective that DTensor's redistributions (or any
other caller) launch, with its operand and result — and mapped onto the
reference's five kinds.  ``shape_bytes``, ``CollectiveOp``, ``census`` and
``batching_report`` keep the reference's fields and rules: the payload is
``max(result, operand)`` bytes, an all-reduce counts twice (reduce and
broadcast phases), a group needs ``min_repeat`` members.  The reference's
launch-latency estimate (``COLLECTIVE_LAUNCH_S``, a TPU interconnect
constant) has no measured NVLink/NCCL counterpart here and is left out.
"""
from __future__ import annotations

import re
from dataclasses import dataclass, field

import torch
from torch.utils._python_dispatch import TorchDispatchMode

COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
               "collective-permute")

_DTYPE_BYTES = {"f64": 8, "f32": 4, "bf16": 2, "f16": 2, "s64": 8, "u64": 8,
                "s32": 4, "u32": 4, "s16": 2, "u16": 2, "s8": 1, "u8": 1,
                "pred": 1, "f8e4m3fn": 1, "f8e5m2": 1}

_SHAPE_RE = re.compile(r"(f64|f32|bf16|f16|s64|u64|s32|u32|s16|u16|s8|u8|pred)"
                       r"\[([0-9,]*)\]")

#: torch dtype name -> the reference's (HLO) element type name
_TORCH_DTYPES = {"float64": "f64", "float32": "f32", "bfloat16": "bf16",
                 "float16": "f16", "int64": "s64", "uint64": "u64",
                 "int32": "s32", "uint32": "u32", "int16": "s16",
                 "uint16": "u16", "int8": "s8", "uint8": "u8", "bool": "pred",
                 "float8_e4m3fn": "f8e4m3fn", "float8_e5m2": "f8e5m2"}

#: ``_c10d_functional`` op name -> the reference's collective kind
TORCH_KINDS = {
    "all_reduce": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
}
#: ``_c10d_functional`` collectives with no reference kind
UNMAPPED = ("broadcast",)


def shape_bytes(text: str) -> int:
    total = 0
    for dt, dims in _SHAPE_RE.findall(text):
        n = 1
        for d in dims.split(","):
            if d:
                n *= int(d)
        total += n * _DTYPE_BYTES[dt]
    return total


@dataclass
class CollectiveOp:
    kind: str
    payload_bytes: int
    shape_sig: str
    group: str = ""             # the process group's name, where recorded


def tensor_sig(t) -> str:
    """A tensor's shape as the reference writes an HLO shape: ``f32[8,4]``."""
    name = str(t.dtype).removeprefix("torch.")
    return f"{_TORCH_DTYPES[name]}[{','.join(str(d) for d in t.shape)}]"


def collective_op(kind: str, results, operands,
                  group: str = "") -> CollectiveOp:
    """One collective from its result and operand tensors, by the
    reference's rule: the payload is the larger side's bytes, twice for an
    all-reduce; the signature is the result's shapes."""
    res = ",".join(tensor_sig(t) for t in results)
    ops = ",".join(tensor_sig(t) for t in operands)
    payload = max(shape_bytes(res), shape_bytes(ops))
    if kind == "all-reduce":
        payload *= 2                         # reduce + broadcast phases
    return CollectiveOp(kind, payload, res or "?", group)


def _tensors(x) -> list:
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, (list, tuple)):
        return [t for v in x for t in _tensors(v)]
    return []


class CollectiveRecorder(TorchDispatchMode):
    """Records each ``_c10d_functional`` collective issued inside its
    ``with`` block as a ``CollectiveOp`` (``ops``).

    A ``DTensor`` op is handed on (``NotImplemented``) so that DTensor's
    own dispatch runs and its redistributions come back here as the
    collectives they launch on local tensors.  A collective with no kind
    in the reference's five (a broadcast) raises: the census would drop
    it.  Each op keeps its process group's name (``group``), which says
    which mesh axis it ran over."""

    def __init__(self):
        super().__init__()
        self.ops: list[CollectiveOp] = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor
        kwargs = kwargs or {}
        if isinstance(func, torch._ops.HigherOrderOperator):
            return func(*args, **kwargs)
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        out = func(*args, **kwargs)
        self._see(func, args, out)
        return out

    def _see(self, func, args, out) -> None:
        ns = func.namespace
        if ns not in ("_c10d_functional", "c10d_functional"):
            return
        name = func._overloadpacket.__name__
        kind = TORCH_KINDS.get(name)
        if kind is None:
            if name not in UNMAPPED:
                return                  # wait_tensor and other plumbing
            raise NotImplementedError(
                f"collective {ns}.{name} has no kind in the census "
                f"{COLLECTIVES}")
        # the group's name is the op's last string argument
        group = next((a for a in reversed(args) if isinstance(a, str)), "")
        self.ops.append(collective_op(kind, _tensors(out),
                                      _tensors(args[0]), group))


def census(ops: list[CollectiveOp]) -> dict:
    out: dict = {k: {"count": 0, "bytes": 0} for k in COLLECTIVES}
    for op in ops:
        out[op.kind]["count"] += 1
        out[op.kind]["bytes"] += op.payload_bytes
    out["total_bytes"] = sum(v["bytes"] for v in out.values()
                             if isinstance(v, dict))
    out["total_count"] = sum(v["count"] for v in out.values()
                             if isinstance(v, dict))
    return out


@dataclass
class BatchingReport:
    """Same-shape collectives repeated many times -> fuse/batch candidates."""
    groups: list = field(default_factory=list)   # (kind, sig, count, bytes)
    fusible_ops: int = 0
    fusible_bytes: int = 0

    def summary(self) -> str:
        return (f"{self.fusible_ops} fusible collective ops in "
                f"{len(self.groups)} groups, {self.fusible_bytes/2**20:.1f} "
                f"MiB payload")


def batching_report(ops: list[CollectiveOp],
                    min_repeat: int = 4) -> BatchingReport:
    by_sig: dict[tuple, list[CollectiveOp]] = {}
    for op in ops:
        by_sig.setdefault((op.kind, op.shape_sig), []).append(op)
    rep = BatchingReport()
    for (kind, sig), group in sorted(by_sig.items(),
                                     key=lambda kv: -len(kv[1])):
        if len(group) >= min_repeat:
            b = sum(o.payload_bytes for o in group)
            rep.groups.append({"kind": kind, "sig": sig,
                               "count": len(group), "bytes": b})
            rep.fusible_ops += len(group) - 1
            rep.fusible_bytes += b
    return rep
