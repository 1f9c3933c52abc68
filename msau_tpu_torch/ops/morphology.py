"""Rectangular morphology on bit-packed masks (port of the part of
``msau_tpu.ops.morphology`` the KV decoder runs).

scipy geometry is kept exactly: the window for output i spans input
[i - size//2, i - size//2 + size) (origin=0, left-heavy for even sizes), and
borders behave like mode='constant', cval=0 — padded cells are 0 for both
the dilation (windowed OR) and the erosion (windowed AND), so the erosion
clears every bit at the border, as scipy's minimum_filter does.
"""

from __future__ import annotations

from typing import Tuple, Union

import torch
import torch.nn.functional as F

Size2 = Union[int, Tuple[int, int]]


def _window_reduce(x: torch.Tensor, size: Tuple[int, int], op) -> torch.Tensor:
    sh, sw = size
    h, w = x.shape[-2:]
    # F.pad order: (left, right, top, bottom) on the last two axes
    padded = F.pad(x, (sw // 2, sw - 1 - sw // 2, sh // 2, sh - 1 - sh // 2),
                   value=0)
    out = None
    for dy in range(sh):
        for dx in range(sw):
            win = padded[..., dy:dy + h, dx:dx + w]
            out = win if out is None else op(out, win)
    return out


def packed_closing(masks_bits: torch.Tensor, size: Size2) -> torch.Tensor:
    """Closing of up to 32 boolean masks packed as int32 bit planes: a
    windowed bitwise OR (dilation) then a windowed bitwise AND (erosion),
    both with cval=0 borders — every bit gets scipy's binary closing."""
    size = (size, size) if isinstance(size, int) else tuple(size)
    if masks_bits.dtype != torch.int32:
        raise ValueError(f"packed_closing needs int32 bit planes, got "
                         f"{masks_bits.dtype}")
    dilated = _window_reduce(masks_bits, size, torch.bitwise_or)
    return _window_reduce(dilated, size, torch.bitwise_and)
