"""The numbers that decide ``correct`` for a training cell.

The program's first three steps (set-up drives them through the window's
own call, on three distinct batches) and the reference's three steps from
the same weights and batches (``kinds.train.first_steps``) each give:
every step's loss, every leaf's norm of the first step's gradient (the
program's worked out from its Adam state after one step and the raw global
norm it reports), and every leaf's norm of the change the three updates
made.  The numbers (the limits in ``benchmark/workloads/<cell>.json`` name
which of them a cell holds):

* ``loss1_gap``, ``loss2_gap``, ``loss3_gap``: each step's relative gap of
  its loss (the first is the forward's alone, the second sees the first
  update, the third the second update and so Adam's state after a step);
* ``grad_gap``, ``grad_med_gap``: the widest and the median over the leaves
  of a leaf's gap of its first gradient's norm, over the reference's norm
  of that leaf or of the median leaf, whichever is larger;
* ``change_gap``, ``change_med_gap``: the same for the change after the
  three steps, over the leaves whose reference gradient is at least a
  thousandth of the median leaf's (below that, as for a key's bias under
  the softmax, Adam moves a leaf by round-off alone).
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

NUMBERS = ("loss1_gap", "loss2_gap", "loss3_gap", "grad_gap", "grad_med_gap",
           "change_gap", "change_med_gap")
ROUND_OFF_LEAF = 1e-3


def _leaf_gaps(prog: np.ndarray, ref: np.ndarray,
               keep: np.ndarray) -> np.ndarray:
    """Each kept leaf's gap, over its reference norm or the median's."""
    prog, ref = prog[keep], ref[keep]
    gap = np.abs(prog - ref) / np.maximum(ref, np.median(ref))
    return np.where(np.isfinite(prog), gap, np.inf)


def gaps(prog: dict, ref: dict) -> Tuple[Dict[str, float], Dict[str, str]]:
    """-> ({number: value}, {number: where the worst reading lies})."""
    if prog["names"] != ref["names"]:
        raise ValueError("program and reference leaves differ")
    names = np.asarray(ref["names"])
    lp, lr = np.asarray(prog["loss"], float), np.asarray(ref["loss"], float)
    if lp.shape != lr.shape:
        raise ValueError("program and reference ran different steps")
    loss = np.nan_to_num(np.abs(lp - lr) / np.abs(lr), nan=np.inf)
    values = {f"loss{i + 1}_gap": float(x) for i, x in enumerate(loss)}
    where = {k: f"step {i + 1}'s loss" for i, k in enumerate(values)}
    gr = np.asarray(ref["grad_norm"], float)
    moved = gr >= ROUND_OFF_LEAF * np.median(gr)
    for key, kind, keep in (("grad", "grad_norm", np.ones(len(names), bool)),
                            ("change", "change_norm", moved)):
        gap = _leaf_gaps(np.asarray(prog[kind], float),
                         np.asarray(ref[kind], float), keep)
        i = int(np.argmax(gap))
        values[f"{key}_gap"] = float(gap[i])
        values[f"{key}_med_gap"] = (float(np.median(gap))
                                    if np.isfinite(gap).all() else np.inf)
        where[f"{key}_gap"] = where[f"{key}_med_gap"] = (
            f"widest {gap[i]:.3g} at {names[keep][i]}")
    return values, where


def verdict(values: Dict[str, float], limits: Dict[str, float]) -> bool:
    """Every number at or under its limit (a NaN or a missing number
    fails)."""
    return all(n in values and values[n] <= limits[n] for n in limits)
