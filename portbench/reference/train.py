"""The plain reference of a training cell: the first train steps in
float32 (or, for the control, float8 products), and the numbers
``correct`` compares.

A step: the batch's rows cut in order into ``microbatches``; each one's
mean cross-entropy backpropagated, the gradients summed and divided by
their number, the loss averaged; the gradients clipped to a global norm
of ``clip``; AdamW (bias-corrected moments, decoupled weight decay on
every parameter).  ``readings`` gives each step's loss, each parameter's
gradient norm as the first and the second update take it (after the
clip), and each parameter's change after the last step.

``gaps`` compares two such readings, by the worst parameter (and, for
the first and second gradients, by the median one): the gap of two norms over the
reference's norm of that parameter or of the median parameter, whichever
is larger.  Parameters whose reference gradient is under a thousandth of
the median parameter's move under Adam by rounding alone, and are left
out of the change.
"""
from __future__ import annotations

import statistics

import torch

from portbench.reference.common import Arith, exact_f32


def readings(model, p0: dict, cfg: dict, opt: dict, batches: list,
             microbatches: int, lowp: bool = False) -> dict:
    """{"loss": [per step], "grad": {name: norm}, "grad2": {name: norm},
    "delta": {name: norm}} of ``len(batches)`` steps from the weights ``p0`` (left unchanged)."""
    ar = Arith(lowp)
    b1, b2, eps, lr, wd = (opt["b1"], opt["b2"], opt["eps"], opt["lr"],
                           opt["weight_decay"])
    p = {n: t.detach().clone().requires_grad_(True) for n, t in p0.items()}
    m = {n: torch.zeros_like(t) for n, t in p0.items()}
    v = {n: torch.zeros_like(t) for n, t in p0.items()}
    out = {"loss": [], "grad": {}, "grad2": {}, "delta": {}}
    with exact_f32():
        for k, batch in enumerate(batches, start=1):
            rows = batch["tokens"].shape[0]
            per = rows // microbatches
            lsum = 0.0
            for j in range(microbatches):
                sl = slice(j * per, (j + 1) * per)
                loss = model.loss(p, cfg, ar, batch["tokens"][sl],
                                  batch["targets"][sl])
                loss.backward()
                lsum += float(loss.detach())
            out["loss"].append(lsum / microbatches)
            with torch.no_grad():
                g = {n: t.grad / microbatches for n, t in p.items()}
                norm = torch.sqrt(sum(torch.sum(x * x) for x in g.values()))
                scale = torch.clamp(opt["clip"] / torch.clamp(norm, min=1e-9),
                                    max=1.0)
                c1, c2 = 1 - b1 ** k, 1 - b2 ** k
                for n, t in p.items():
                    gn = g[n] * scale
                    if k <= 2:
                        out["grad" if k == 1 else "grad2"][n] = float(
                            torch.linalg.vector_norm(gn))
                    m[n].mul_(b1).add_(gn, alpha=1 - b1)
                    v[n].mul_(b2).add_(gn * gn, alpha=1 - b2)
                    u = (m[n] / c1) / (torch.sqrt(v[n] / c2) + eps)
                    t.sub_(lr * (u + wd * t))
                    t.grad = None
    with torch.no_grad():
        for n, t in p.items():
            out["delta"][n] = float(torch.linalg.vector_norm(t - p0[n]))
    return out


def leaf_gaps(got: dict, want: dict, names) -> dict:
    """name -> |got - want| / max(want, the median want) over ``names``."""
    med = statistics.median(want[n] for n in names)
    return {n: abs(got[n] - want[n]) / max(want[n], med, 1e-30)
            for n in names}


def worst_leaf(got: dict, want: dict, names) -> float:
    return max(leaf_gaps(got, want, names).values())


def moving(ref_grad: dict) -> list:
    """The parameters whose reference gradient is at least a thousandth
    of the median parameter's."""
    med = statistics.median(ref_grad.values())
    return [n for n, g in ref_grad.items() if g >= 1e-3 * med]


def gaps(got: dict, want: dict) -> dict:
    """The readings: the first step's loss gap over the reference's loss;
    the first gradient's gap (the eager step's) by the worst parameter and
    by the median parameter, and the second's (the first replay's) by the
    median parameter too; the change's gap by the worst parameter.  (The later
    steps' losses are not read: from this init the loss climbs from ~11
    to 17-25 in three steps, and their gap swings with it from seed to
    seed, 4e-6 to 8e-3 at step 3, where the first step's stays under
    4e-5.)"""
    grad = leaf_gaps(got["grad"], want["grad"], want["grad"])
    return {"loss_gap": abs(got["loss"][0] - want["loss"][0])
            / abs(want["loss"][0]),
            "grad_gap": max(grad.values()),
            "grad_median_gap": statistics.median(grad.values()),
            "grad2_median_gap": statistics.median(leaf_gaps(
                got["grad2"], want["grad2"], want["grad2"]).values()),
            "delta_gap": worst_leaf(got["delta"], want["delta"],
                                    moving(want["grad"]))}
