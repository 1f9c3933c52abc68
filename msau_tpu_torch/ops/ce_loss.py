"""Fused masked cross-entropy over channel-major logits [N, C, L].

Port of ``msau_tpu/ops/ce_loss.py``.  The forward computes, in one read of
the logits,

    ce_sum  = sum_p mask_p * (logsumexp_c l[:, p] - l[label_p, p])
    correct = sum_p mask_p * (l[label_p, p] >= max_c l[:, p])

(argmax ties count as correct, as in the TPU kernel); the backward writes
dlogits = (softmax(l) - onehot(label)) * mask * g in one read and one write,
the softmax recomputed, nothing saved but the inputs.  Labels are clamped to
[0, C-1], as ``train.loss._per_pixel_ce`` does, so an out-of-range label
gives a visible loss.  The division by the mask count happens outside.

``fused_masked_ce_sum`` is the entry point, a ``torch.autograd.Function``
whose gradient flows to the logits only.  A CUDA tensor launches the
hand-written kernels (``csrc/ce_loss.cu``: the TPU kernels ``_ce_fwd_kernel``
and ``_ce_bwd_kernel``); a CPU tensor takes the ``_plain`` versions.
"""

from __future__ import annotations

from typing import Tuple

import torch

from msau_tpu_torch.ops import cuda_lib
from msau_tpu_torch.ops.precision import wide

_LOGIT_DTYPES = (torch.float32, torch.bfloat16)


def _clamped(labels: torch.Tensor, nclass: int) -> torch.Tensor:
    return labels.clamp(0, nclass - 1).long()


def masked_ce_fwd_plain(logits: torch.Tensor, labels: torch.Tensor,
                        maskf: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(ce_sum, correct) as f32 scalars, in f32 torch ops."""
    lf = wide(logits)
    m = lf.amax(dim=1)
    lse = m + torch.log(torch.exp(lf - m[:, None]).sum(dim=1))
    lsel = lf.gather(1, _clamped(labels, lf.shape[1])[:, None])[:, 0]
    ce_sum = ((lse - lsel) * maskf).sum()
    correct = torch.where(lsel >= m, maskf, torch.zeros_like(maskf)).sum()
    return ce_sum, correct


def masked_ce_bwd_plain(logits: torch.Tensor, labels: torch.Tensor,
                        maskf: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """dlogits = (softmax - onehot) * mask * g in the logits' dtype; ``g``
    is the f32 cotangent of ce_sum (a 0-d tensor)."""
    lf = wide(logits)
    p = torch.softmax(lf, dim=1)
    onehot = torch.zeros_like(p).scatter_(
        1, _clamped(labels, lf.shape[1])[:, None], 1.0)
    return ((p - onehot) * (maskf * g)[:, None]).to(logits.dtype)


def _check(name: str, logits, labels, maskf) -> Tuple[int, int, int]:
    cuda_lib.require_cuda(f"{name} logits", logits, _LOGIT_DTYPES, 3)
    cuda_lib.require_cuda(f"{name} labels", labels, torch.int32, 2)
    cuda_lib.require_cuda(f"{name} mask", maskf, torch.float32, 2)
    n, c, length = logits.shape
    if labels.shape != (n, length) or maskf.shape != (n, length):
        raise ValueError(f"{name}: labels {tuple(labels.shape)} / mask "
                         f"{tuple(maskf.shape)} must be [{n}, {length}]")
    if not (logits.device == labels.device == maskf.device):
        raise ValueError(f"{name}: tensors on different devices")
    return n, c, length


# pixels each forward block reduces into one partial (``kFwdPixels`` in
# csrc/ce_loss.cu)
FWD_BLOCK_PIXELS = 1024


def masked_ce_fwd_cuda(logits: torch.Tensor, labels: torch.Tensor,
                       maskf: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the forward kernel (block partials, fixed-order combine) ->
    (ce_sum, correct) 0-d f32 on the card.  ``.launches`` counts calls."""
    n, c, length = _check("masked_ce_fwd", logits, labels, maskf)
    blocks = max(1, -(-n * length // FWD_BLOCK_PIXELS))
    partial = torch.empty((2, blocks), dtype=torch.float32, device=logits.device)
    ce_sum = torch.empty((), dtype=torch.float32, device=logits.device)
    correct = torch.empty((), dtype=torch.float32, device=logits.device)
    code = cuda_lib.library().msau_masked_ce_fwd(
        logits.data_ptr(), labels.data_ptr(), maskf.data_ptr(),
        partial.data_ptr(), ce_sum.data_ptr(), correct.data_ptr(), blocks, n,
        c, length, int(logits.dtype == torch.bfloat16),
        cuda_lib.stream_ptr(logits.device))
    cuda_lib.check("msau_masked_ce_fwd", code)
    masked_ce_fwd_cuda.launches += 1
    return ce_sum, correct


masked_ce_fwd_cuda.launches = 0


def masked_ce_bwd_cuda(logits: torch.Tensor, labels: torch.Tensor,
                       maskf: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """Launch the backward kernel -> dlogits in the logits' dtype; ``g``
    (f32, one element) is read on the card, so nothing syncs with the
    host.  ``.launches`` counts calls."""
    _check("masked_ce_bwd", logits, labels, maskf)
    if g.device != logits.device or g.dtype != torch.float32 or g.numel() != 1:
        raise ValueError("masked_ce_bwd: g must be one f32 element on the "
                         "logits' device")
    g = g.contiguous()
    n, c, length = logits.shape
    dlogits = torch.empty_like(logits)
    code = cuda_lib.library().msau_masked_ce_bwd(
        logits.data_ptr(), labels.data_ptr(), maskf.data_ptr(), g.data_ptr(),
        dlogits.data_ptr(), n, c, length,
        int(logits.dtype == torch.bfloat16), cuda_lib.stream_ptr(logits.device))
    cuda_lib.check("msau_masked_ce_bwd", code)
    masked_ce_bwd_cuda.launches += 1
    return dlogits


masked_ce_bwd_cuda.launches = 0


def _on_cuda(t: torch.Tensor) -> bool:
    if t.device.type not in ("cuda", "cpu"):
        raise ValueError(f"fused_masked_ce_sum: unsupported device {t.device}")
    return t.device.type == "cuda"


class FusedMaskedCE(torch.autograd.Function):
    """(ce_sum, correct) with a gradient to the logits only: ``correct``
    is a metric, and labels / mask get none (``ce_loss.py:123-151``)."""

    @staticmethod
    def forward(ctx, logits, labels, maskf):
        logits, labels, maskf = (t.contiguous() for t in (logits, labels, maskf))
        ctx.save_for_backward(logits, labels, maskf)
        if _on_cuda(logits):
            ce_sum, correct = masked_ce_fwd_cuda(logits, labels, maskf)
        else:
            ce_sum, correct = masked_ce_fwd_plain(logits, labels, maskf)
        ctx.mark_non_differentiable(correct)
        return ce_sum, correct

    @staticmethod
    def backward(ctx, g_sum, _g_correct):
        logits, labels, maskf = ctx.saved_tensors
        g = wide(g_sum)
        if _on_cuda(logits):
            dlogits = masked_ce_bwd_cuda(logits, labels, maskf, g)
        else:
            dlogits = masked_ce_bwd_plain(logits, labels, maskf, g)
        return dlogits, None, None


def fused_masked_ce_sum(logits: torch.Tensor, labels: torch.Tensor,
                        maskf: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(ce_sum, correct) over logits [N, C, L] (f32 or bf16), labels
    [N, L] int32 and maskf [N, L] f32 0/1 (the label != 0 & valid mask)."""
    return FusedMaskedCE.apply(logits, labels, maskf)
