"""Cells, metric readers and the result line of the port's benchmark.

Everything a cell needs is found by name: ``BENCHMARK.json`` at the root of
the checkout names the cell's configuration and traffic mix;
``portbench/configs/<config>.json`` holds the configuration as it is run,
``portbench/traffic/<mix>.json`` the mix's parameters (its ``driver`` names
``portbench/drivers/<driver>.py``), ``portbench/limits/<cell>.json`` the
limits of the numbers ``correct`` compares, and
``portbench/metrics/<metric>.py`` each metric's reader.  A reader's
``read(readings)`` takes the raw readings a driver collected and returns a
number, or None where it finds nothing to read (the metric is then left
out of the line).
"""
from __future__ import annotations

import importlib
import importlib.util
import json
import sys
from dataclasses import dataclass
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
#: top-level module names that no process of the benchmark may hold: the
#: JAX stack and the JAX package the port was made from
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list
    per_layer: list
    root: Path = ROOT


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def _for_cell(metrics: list, cell: str) -> list:
    return [m for m in metrics if cell in m.get("workloads", [cell])]


def load_cell(name: str, root: Path = ROOT) -> Cell:
    """The cell ``name`` of ``root/BENCHMARK.json`` with its files under
    ``root/portbench``."""
    base = root / "portbench"
    bench = _json(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no cell {name!r}; have {sorted(cells)}")
    w = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = _json(root / configs[w["config"]]["file"])
    return Cell(name=name, chips=w["chips"], config=config,
                traffic=_json(base / "traffic" / f"{w['traffic']}.json"),
                limits=_json(base / "limits" / f"{name}.json"),
                end_to_end=_for_cell(bench["end_to_end"], name),
                per_layer=_for_cell(bench["per_layer"], name), root=root)


def driver(name: str):
    """``portbench/drivers/<name>.py`` as a module."""
    return importlib.import_module(f"portbench.drivers.{name}")


def reference(name: str):
    """``portbench/reference/<name>.py`` as a module."""
    return importlib.import_module(f"portbench.reference.{name}")


def reader(metric: str, root: Path = ROOT):
    """The ``read`` function of ``portbench/metrics/<metric>.py`` (metric
    names may hold dots, so the file is loaded by its path)."""
    path = root / "portbench" / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        f"portbench_metric_{metric.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def kernel_rule(name: str) -> list[str]:
    """The regular expressions of ``portbench/rules/<name>.txt`` (one a
    line; ``#`` starts a comment): which profiled kernel names belong to
    a group."""
    lines = (HERE / "rules" / f"{name}.txt").read_text().splitlines()
    return [ln.strip() for ln in lines if ln.strip()
            and not ln.strip().startswith("#")]


def metrics_line(cell: Cell, readings: dict, trace: bool) -> dict:
    """The cell's end-to-end metrics (``trace`` off) or per-layer ones
    (on), each as ``{"value", "unit"}``; a reader that returns None
    leaves its metric out."""
    out = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        v = reader(m["name"], cell.root)(readings)
        if v is not None:
            out[m["name"]] = {"value": float(v), "unit": m["unit"]}
    return out


def judge(checks: dict) -> bool:
    """``correct``: every compared number is finite and within its
    limit, and there is at least one."""
    return bool(checks) and all(
        c["value"] == c["value"] and c["value"] <= c["limit"]
        for c in checks.values())


def forbidden_modules() -> list[str]:
    """The modules of ``FORBIDDEN`` this process holds, by whole top-level
    name."""
    return sorted({m for m in sys.modules
                   if m.split(".")[0] in FORBIDDEN})


def result_line(correct: bool, attempted: int, failed: int, metrics: dict,
                device: dict, checks: dict, breakdown=None) -> str:
    """The last line of standard output; the compared numbers come last,
    under ``checks``."""
    line = {"correct": correct, "attempted": attempted, "failed": failed,
            "metrics": metrics, "device": device}
    if breakdown is not None:
        line["breakdown"] = breakdown
    line["checks"] = checks
    return json.dumps(line)


def checks_text(checks: dict) -> str:
    """The compared numbers, one a line, each beside its limit."""
    return "\n".join(f"check {k} {c['value']!r} limit {c['limit']!r}"
                     for k, c in checks.items())
