"""The numbers that decide ``correct``, each against its limit
(``limits/<cell>.json``), and the guard that no JAX module was loaded.

Training cells compare the first three steps of the program's own train
state with the reference's: each step's loss, the first gradient as the
optimizer got it (worked out from Adam's first moment after one step), and
the change of the parameters over the three steps; by the worst leaf, as
the gap between the program's norm and the reference's, over the larger of
the reference's norm of that leaf and of the median leaf. Leaves whose
reference gradient is under a thousandth of the median leaf's move by
round-off alone and are left out of the change. A leaf the phase keeps
frozen has to keep its value to the bit. The first gradient is also
compared as a vector (``grad_diff``: the norm of the difference over the
reference's norm): both sides clip it to the same norm. And each
microbatch's gradient before clipping is compared so with the reference's
over the same rows (``micro_grad_diff``, the worst microbatch): a
microbatch whose rows run forward but whose gradient is lost, or counted
twice, reads about 1.

The serving cell compares served windows, a sample drawn from the seed:
the keypoints directly, the VRNN's outputs by following the served
choices, and how much farther from the detected keypoints each served
choice lies than the nearest sample (``choice_gap``;
``reference.model.Net.encode``). The dynamics cell compares the frozen
detector's keypoints directly too.
"""
from __future__ import annotations

import sys

import torch

FORBIDDEN = ("jax", "jaxlib", "flax", "neural_marionette_tpu")


def forbidden_modules(modules=None) -> list:
    """Loaded modules whose top-level name (before the first dot) is one of
    :data:`FORBIDDEN`, compared whole."""
    mods = sys.modules if modules is None else modules
    return sorted(m for m in mods if m.split(".", 1)[0] in FORBIDDEN)


def _leaf_norms(tensors: dict) -> dict:
    return {k: float(torch.linalg.vector_norm(v.double()))
            for k, v in tensors.items()}


def _median(values):
    v = sorted(values)
    return v[len(v) // 2] if v else 0.0


def leaf_gaps(cand: dict, ref: dict, keep=None) -> list:
    """Per leaf |cand - ref| / max(ref, median leaf of ref), sorted."""
    names = [k for k in ref if keep is None or k in keep]
    med = _median([ref[k] for k in names])
    return sorted(abs(cand[k] - ref[k]) / max(ref[k], med, 1e-30)
                  for k in names)


def worst_leaf(cand: dict, ref: dict, keep=None) -> float:
    """max over leaves of |cand - ref| / max(ref, median leaf of ref)."""
    return max(leaf_gaps(cand, ref, keep), default=0.0)


def diff_gaps(cand: dict, ref: dict) -> tuple[float, list]:
    """(the norm of ``cand - ref`` over the norm of ``ref``, every leaf
    taken together; per leaf the norm of its difference over the larger of
    its reference norm and the median leaf's, sorted)."""
    d = {k: float(torch.linalg.vector_norm((cand[k] - ref[k]).double()))
         for k in ref}
    n = _leaf_norms(ref)
    med = _median(n.values())
    whole = (sum(v * v for v in d.values())
             / max(sum(v * v for v in n.values()), 1e-60)) ** 0.5
    return whole, sorted(d[k] / max(n[k], med, 1e-30) for k in ref)


def train_readings(cand: dict, ref: dict) -> dict:
    """``cand`` and ``ref``: ``losses`` (per step), ``grad`` and ``change``
    (per trained leaf, norms), ``grad_vec`` (the first gradient per leaf),
    ``micro`` (per microbatch of the first step, its gradient per leaf),
    ``keypoints`` (per step); ``cand`` also ``frozen_moved``. Each gap by
    the worst leaf and by the median leaf; the loss over every step and
    over the steps after the first."""
    gaps = [abs(c - r) / max(abs(r), 1e-30)
            for c, r in zip(cand["losses"], ref["losses"])]
    med = _median(ref["grad"].values())
    moved = {k for k, v in ref["grad"].items() if v >= 1e-3 * med}
    grad = leaf_gaps(cand["grad"], ref["grad"])
    change = leaf_gaps(cand["change"], ref["change"], moved)
    whole, diff = diff_gaps(cand["grad_vec"], ref["grad_vec"])
    micro = max(diff_gaps(c, r)[0] for c, r in zip(cand["micro"],
                                                    ref["micro"]))
    out = {"loss_gap": max(gaps), "loss_gap_late": max(gaps[1:] or [0.0]),
           "grad_gap": grad[-1], "grad_gap_median": _median(grad),
           "change_gap": change[-1], "change_gap_median": _median(change),
           "grad_diff": whole, "grad_diff_median": _median(diff),
           "grad_diff_worst": diff[-1], "micro_grad_diff": micro,
           "frozen_moved": float(cand.get("frozen_moved", 0)),
           "rows_missing": float(rows_missing(cand["keypoints"],
                                              ref["keypoints"]))}
    return out


def rows_missing(cand: list, ref: list) -> int:
    """Batch rows, over the steps, whose keypoints ``ref`` has and
    ``cand`` (what the step's detector produced) does not."""
    return sum(max(r.shape[0] - c.shape[0], 0) for c, r in zip(cand, ref)) \
        + sum(r.shape[0] for r in ref[len(cand):])


def keypoints_gap(cand: list, ref: list, mean: bool = False) -> float:
    """The widest (or the mean) absolute gap between two lists of keypoint
    tensors, rows of ``cand`` against the same rows of ``ref``."""
    d = torch.cat([(c.float() - r[:c.shape[0]].float()).abs().flatten()
                   for c, r in zip(cand, ref)])
    return float(d.mean() if mean else d.max())


def norms_of_run(first_grad: dict, before: dict, after: dict) -> dict:
    """Per trained leaf: the first gradient's norm, the change's norm over
    the steps, and the first gradient itself (on the host)."""
    return {"grad": _leaf_norms(first_grad),
            "change": _leaf_norms({k: after[k] - before[k]
                                   for k in first_grad}),
            "grad_vec": {k: v.detach().float().cpu()
                         for k, v in first_grad.items()}}


def verdict(readings: dict, limits: dict) -> tuple[bool, dict]:
    """(every reading within its limit, ``{name: {value, limit}}``); a
    reading that is missing or not a number fails."""
    compared, ok = {}, True
    for name, limit in limits.items():
        v = readings.get(name)
        good = v is not None and v == v and v <= limit
        ok = ok and good
        compared[name] = {"value": v, "limit": limit}
    return ok, compared
