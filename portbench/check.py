"""The comparisons that decide ``correct``, and their limits.

Training: the set-up's first steps and the step after the window, each
read as each step's loss, the first gradient as the optimizer got it, and
the parameters' change over the steps, each leaf's norm against the
reference's.  A leaf's gradient counts where the reference's is not nought,
and its change where the reference moves it.  At initialisation the
brightness decoder's zero output weights stop the gradient of the layers
before them at the first step, and on about half of the seeds the sky
NeRF's ReLU density is nought at every sample, so none of its leaves has a
gradient.  A leaf's gap is |norm(program) - norm(reference)| over the
larger of the reference's norm of that leaf and of the median counted
leaf; the number compared is the worst leaf's.  A leaf left out is one the
reference leaves unmoved; its reading is the program's change there over
that median.

Render: the rendered views' rgb, acc, depth and distance statistics against
the reference's, the widest absolute gap of each.  Depth is compared where
the reference's acc is not within ``ACC_EDGE`` of 0.6, the sky clamp's
threshold, where depth jumps to 300 on rounding.

Each cell's limits are in ``limits/<workload>.json``.
"""

from __future__ import annotations

import json
import os

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
ACC_EDGE = 1e-4
DISTANCES = ("distance_mean", "distance_median", "distance_percentile_5",
             "distance_percentile_95")


def limits(workload: str) -> dict:
    with open(os.path.join(_HERE, "limits", f"{workload}.json")) as f:
        return json.load(f)["limits"]


def _leaf_gap(prog: dict, ref: dict, counted):
    """(the worst leaf's gap, that leaf); inf where the readings are not
    finite or the reference's leaves read nought."""
    floor = float(np.median([ref[k] for k in counted])) if counted else 0.0
    if not np.isfinite(floor) or floor <= 0:
        return float("inf"), None
    worst, leaf = 0.0, None
    for k in counted:
        gap = abs(prog[k] - ref[k]) / max(ref[k], floor)
        if not np.isfinite(gap):
            return float("inf"), k
        if gap > worst or leaf is None:
            worst, leaf = gap, k
    return worst, leaf


def train_numbers(prog: dict, ref: dict, prefix: str = "") -> dict:
    """prog and ref: {"losses": [...], "grad": {leaf: norm} (the first
    step's), "update": {leaf: norm}}.  The numbers are named with
    `prefix`; "_leaves" holds the worst leaves and the counts, "_left_out"
    the program's change of each leaf that the reference leaves unmoved."""
    grad_leaves = [k for k, v in ref["grad"].items() if v > 0]
    update_leaves = [k for k, v in ref["update"].items() if v > 0]
    gaps = [abs(p - r) / abs(r) for p, r in zip(prog["losses"],
                                                 ref["losses"])]
    loss = max(gaps)
    if len(prog["losses"]) != len(ref["losses"]) or not np.all(
            np.isfinite(gaps)):
        loss = float("inf")
    grad, grad_leaf = _leaf_gap(prog["grad"], ref["grad"], grad_leaves)
    update, update_leaf = _leaf_gap(prog["update"], ref["update"],
                                    update_leaves)
    floor = (float(np.median([ref["update"][k] for k in update_leaves]))
             if update_leaves else 0.0)
    left_out = {k: prog["update"][k] / floor if floor > 0 else float("inf")
                for k in ref["update"] if k not in update_leaves}
    return {prefix + "loss_gap": loss, prefix + "grad_gap": grad,
            prefix + "update_gap": update,
            "_leaves": (grad_leaf, update_leaf, len(grad_leaves),
                        len(update_leaves), len(ref["grad"])),
            "_left_out": left_out}


def train_run_numbers(first: dict, ref_first: dict, late: dict,
                      ref_late: dict) -> dict:
    """The numbers of a training run: the first steps' and, named
    ``late_``, the late step's, with the leaves of each under "_leaves"
    and "_left_out"."""
    out = {"_leaves": {}, "_left_out": {}}
    for label, prog, ref, prefix in (("first steps", first, ref_first, ""),
                                     ("late step", late, ref_late, "late_")):
        n = train_numbers(prog, ref, prefix)
        out["_leaves"][label] = n.pop("_leaves")
        out["_left_out"][label] = n.pop("_left_out")
        out.update(n)
    return out


def render_numbers(prog: list, ref: list) -> dict:
    """prog and ref: one dict of flat arrays a view."""
    out = {"rgb_gap": 0.0, "acc_gap": 0.0, "depth_gap": 0.0,
           "distance_gap": 0.0}

    def widest(a, b, mask=None):
        d = np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64))
        if mask is not None:
            d = d[mask]
        d = np.where(np.isfinite(d), d, np.inf)
        return float(d.max()) if d.size else 0.0
    for p, r in zip(prog, ref):
        out["rgb_gap"] = max(out["rgb_gap"], widest(p["rgb"], r["rgb"]))
        out["acc_gap"] = max(out["acc_gap"], widest(p["acc"], r["acc"]))
        away = np.abs(np.asarray(r["acc"]) - 0.6) > ACC_EDGE
        out["depth_gap"] = max(out["depth_gap"],
                               widest(p["depth"], r["depth"], away))
        for k in DISTANCES:
            out["distance_gap"] = max(out["distance_gap"],
                                      widest(p[k], r[k]))
    if len(prog) != len(ref):
        out = {k: float("inf") for k in out}
    return out


def judge(numbers: dict, lim: dict):
    """(correct, {name: (value, limit)}) over the numbers with a limit."""
    checks = {k: (numbers[k], lim[k]) for k in lim}
    ok = all(np.isfinite(v) and v <= l for v, l in checks.values())
    return ok, checks
