"""Losses and on-device accuracy (port of ``msau_tpu.train.loss``).

* ``masked_cross_entropy``: entry-A semantics, mean CE over pixels whose
  integer label != 0, on the final and the auxiliary logits, summed
  unweighted.
* ``unet_loss``: entry-B semantics, mean CE over all (valid) pixels,
  optional class weights, (1 - w) * final + w * aux, plus non-background
  pixel accuracy.

``sum_ranks`` (data- and spatial-parallel training): a function that sums
a count over every rank that shares the global batch.  Each rank then
divides its own sums by the global counts, so its loss and metrics are its
share of the global ones and their sums over the ranks are the global
loss and metrics (JAX normalises over the global batch; dividing by each
rank's own count and averaging is wrong wherever the counts differ).

All math is f32 whatever the model's compute dtype.  Channel-major logits
[N, C, L] (``channel_axis=1``, rank 3) take the fused masked-CE op
(``ops.ce_loss``: a CUDA kernel pair on the card); any other layout takes
torch ops along ``channel_axis``.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch

from msau_tpu_torch.ops.ce_loss import fused_masked_ce_sum
from msau_tpu_torch.ops.precision import wide


def _per_pixel_ce(logits: torch.Tensor, labels: torch.Tensor,
                  channel_axis: int = -1) -> torch.Tensor:
    """Softmax cross-entropy per pixel along ``channel_axis``; labels int
    [N, ...] are clamped to [0, C-1], so a data bug gives a visible loss
    instead of a silent 0."""
    logp = torch.log_softmax(wide(logits), dim=channel_axis)
    nclass = logits.shape[channel_axis]
    idx = labels.clamp(0, nclass - 1).long().unsqueeze(channel_axis)
    return -logp.gather(channel_axis, idx).squeeze(channel_axis)


def nonzero_pixel_accuracy(
    logits: torch.Tensor, labels: torch.Tensor,
    valid: Optional[torch.Tensor] = None, channel_axis: int = -1,
    sum_ranks: Optional[Callable] = None,
) -> torch.Tensor:
    """sum(pred == label over label != 0) / sum(label != 0), pred the first
    argmax (model/training/cost.py:43-51)."""
    pred = torch.argmax(logits, dim=channel_axis)
    mask = labels != 0
    if valid is not None:
        mask = mask & valid
    correct = (mask & (pred == labels)).sum()
    return correct / _global(mask.sum(), sum_ranks).clamp(min=1)


def _global(count: torch.Tensor, sum_ranks: Optional[Callable]) -> torch.Tensor:
    return count if sum_ranks is None else sum_ranks(count)


def masked_cross_entropy(
    logits: torch.Tensor,
    aux_logits: torch.Tensor,
    labels: torch.Tensor,
    valid: Optional[torch.Tensor] = None,
    channel_axis: int = -1,
    sum_ranks: Optional[Callable] = None,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Entry-A loss: CE over label != 0 pixels, final + aux.

    labels int [N, ...] with 0 the background; ``valid`` (bool, same shape)
    further masks bucket padding.  Logits [N, C, L] with ``channel_axis=1``
    take the fused op, whose accuracy counts argmax ties as correct.
    """
    mask = labels != 0
    if valid is not None:
        mask = mask & valid
    denom = _global(mask.sum(), sum_ranks).clamp(min=1).float()
    if channel_axis == 1 and logits.ndim == 3:
        maskf = mask.float()
        lab32 = labels.to(torch.int32)
        s1, c1 = fused_masked_ce_sum(logits, lab32, maskf)
        s2, _ = fused_masked_ce_sum(aux_logits, lab32, maskf)
        ce, ce_aux = s1 / denom, s2 / denom
        loss = ce + ce_aux
        return loss, {"loss": loss, "loss_final": ce, "loss_aux": ce_aux,
                      "accuracy": c1 / denom}
    zero = torch.zeros((), device=logits.device)
    ce = torch.where(mask, _per_pixel_ce(logits, labels, channel_axis),
                     zero).sum() / denom
    ce_aux = torch.where(mask, _per_pixel_ce(aux_logits, labels, channel_axis),
                         zero).sum() / denom
    loss = ce + ce_aux
    return loss, {
        "loss": loss, "loss_final": ce, "loss_aux": ce_aux,
        "accuracy": nonzero_pixel_accuracy(logits, labels, valid, channel_axis,
                                           sum_ranks),
    }


def unet_loss(
    logits: torch.Tensor,
    labels: torch.Tensor,
    aux_logits: Optional[torch.Tensor] = None,
    aux_labels: Optional[torch.Tensor] = None,
    valid: Optional[torch.Tensor] = None,
    aux_weight: float = 0.5,
    class_weights: Optional[torch.Tensor] = None,
    channel_axis: int = -1,
    sum_ranks: Optional[Callable] = None,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Entry-B loss: mean CE over all (valid) pixels, optional per-class
    weights, aux mixed in by ``aux_weight`` (model/training/cost.py:52-61)."""
    zero = torch.zeros((), device=logits.device)
    ce = _per_pixel_ce(logits, labels, channel_axis)
    if class_weights is not None:
        w = class_weights[labels.long()]
        ce = ce * w
        denom = _global(w.sum() if valid is None
                        else torch.where(valid, w, zero).sum(), sum_ranks)
    elif valid is None:
        denom = _global(torch.tensor(float(ce.numel()), device=logits.device),
                        sum_ranks)
    else:
        denom = _global(valid.sum(), sum_ranks).clamp(min=1).float()
    if valid is not None:
        ce = torch.where(valid, ce, zero)
    final_loss = ce.sum() / denom

    if aux_logits is not None:
        if aux_labels is None:
            aux_labels = labels
        ce_a = _per_pixel_ce(aux_logits, aux_labels, channel_axis)
        if class_weights is not None:
            ce_a = ce_a * class_weights[aux_labels.long()]
        if valid is not None:
            ce_a = torch.where(valid, ce_a, zero)
        aux_loss = ce_a.sum() / denom
        loss = (1.0 - aux_weight) * final_loss + aux_weight * aux_loss
    else:
        aux_loss = zero
        loss = final_loss
    return loss, {
        "loss": loss, "loss_final": final_loss, "loss_aux": aux_loss,
        "accuracy": nonzero_pixel_accuracy(logits, labels, valid, channel_axis,
                                           sum_ranks),
    }
