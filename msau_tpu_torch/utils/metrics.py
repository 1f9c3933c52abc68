"""Evaluation metrics: micro P/R/accuracy and a per-class report (port of
``msau_tpu.utils.metrics``).

Semantics of the reference's evaluate():
  * pixels labelled 0 are dropped before scoring;
  * in testing mode a predicted 0 is remapped to the 'other' class;
  * micro precision == micro recall == accuracy over the pixels kept.

``confusion_matrix_device`` counts on the tensors' device (a one-hot
product), so an evaluation need not bring dense maps to the host.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np
import torch


def micro_metrics(
    labels: np.ndarray,
    preds: np.ndarray,
    drop_background: bool = True,
    remap_zero_pred_to: Optional[int] = None,
) -> Dict[str, float]:
    labels = np.asarray(labels).ravel()
    preds = np.asarray(preds).ravel()
    if drop_background:
        keep = labels != 0
        labels, preds = labels[keep], preds[keep]
    if remap_zero_pred_to is not None:
        preds = np.where(preds == 0, remap_zero_pred_to, preds)
    if labels.size == 0:
        return {"prec": 0.0, "recall": 0.0, "acc": 0.0}
    acc = float((labels == preds).mean())
    # micro-averaged P/R over multiclass == accuracy
    return {"prec": acc, "recall": acc, "acc": acc}


def confusion_matrix(labels: np.ndarray, preds: np.ndarray, n_class: int) -> np.ndarray:
    labels = np.asarray(labels).ravel()
    preds = np.asarray(preds).ravel()
    cm = np.zeros((n_class, n_class), np.int64)
    np.add.at(cm, (labels, preds), 1)
    return cm


def confusion_matrix_device(
    labels: torch.Tensor, preds: torch.Tensor, n_class: int,
    valid: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """[n_class, n_class] int32 confusion counts on the tensors' device, as
    one-hot^T @ one-hot (f32 sums, exact below 2^24 pixels a cell)."""
    lo = torch.nn.functional.one_hot(labels.reshape(-1).long(), n_class).float()
    po = torch.nn.functional.one_hot(preds.reshape(-1).long(), n_class).float()
    if valid is not None:
        lo = lo * valid.reshape(-1, 1).to(lo.dtype)
    return (lo.T @ po).to(torch.int32)


def report_from_confusion(cm: np.ndarray, target_names: Optional[Sequence[str]] = None):
    """Per-class precision / recall / f1 / support and the macro summary."""
    n = cm.shape[0]
    names = list(target_names) if target_names else [str(i) for i in range(n)]
    out = {}
    tp = np.diag(cm).astype(float)
    support = cm.sum(1).astype(float)
    pred_count = cm.sum(0).astype(float)
    prec = np.divide(tp, pred_count, out=np.zeros(n), where=pred_count > 0)
    rec = np.divide(tp, support, out=np.zeros(n), where=support > 0)
    f1 = np.divide(
        2 * prec * rec, prec + rec, out=np.zeros(n), where=(prec + rec) > 0
    )
    for i, name in enumerate(names[:n]):
        out[name] = {
            "precision": float(prec[i]),
            "recall": float(rec[i]),
            "f1": float(f1[i]),
            "support": int(support[i]),
        }
    total = support.sum()
    out["accuracy"] = float(tp.sum() / total) if total else 0.0
    mask = support > 0
    out["macro avg"] = {
        "precision": float(prec[mask].mean()) if mask.any() else 0.0,
        "recall": float(rec[mask].mean()) if mask.any() else 0.0,
        "f1": float(f1[mask].mean()) if mask.any() else 0.0,
        "support": int(total),
    }
    return out


def classification_report(
    labels: np.ndarray,
    preds: np.ndarray,
    target_names: Optional[Sequence[str]] = None,
    n_class: Optional[int] = None,
) -> str:
    """sklearn-style formatted report string."""
    labels = np.asarray(labels).ravel()
    preds = np.asarray(preds).ravel()
    n = n_class or int(max(labels.max(initial=0), preds.max(initial=0))) + 1
    rep = report_from_confusion(confusion_matrix(labels, preds, n), target_names)
    lines = [f"{'':>16} {'precision':>9} {'recall':>9} {'f1':>9} {'support':>9}"]
    for name, row in rep.items():
        if not isinstance(row, dict):
            continue
        lines.append(
            f"{name:>16} {row['precision']:9.3f} {row['recall']:9.3f} "
            f"{row['f1']:9.3f} {row['support']:9d}"
        )
    lines.append(f"{'accuracy':>16} {rep['accuracy']:9.3f}")
    return "\n".join(lines)
