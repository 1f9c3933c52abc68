"""Rectangular morphology, skeletonization and map upscaling (port of
``msau_tpu.ops.morphology``, which does them in XLA; torch ops here).

scipy geometry is kept exactly: the window for output i spans input
[i - size//2, i - size//2 + size) (origin=0, left-heavy for even sizes), and
borders behave like mode='constant', cval=0 — padded cells are 0 for both
the dilation (windowed max or OR) and the erosion (windowed min or AND), so
the erosion clears every bit at the border, as scipy's minimum_filter does.
All filters take [..., H, W] and apply to the last two axes.
"""

from __future__ import annotations

from typing import Tuple, Union

import torch
import torch.nn.functional as F

Size2 = Union[int, Tuple[int, int]]


def _normalize_size(size: Size2) -> Tuple[int, int]:
    return (size, size) if isinstance(size, int) else tuple(size)


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


def _filter(image: torch.Tensor, size: Size2, op) -> torch.Tensor:
    """A windowed ``op`` with cval=0 borders; bool maps go through f32, as
    the JAX filters take them."""
    size = _normalize_size(size)
    if image.dtype == torch.bool:
        return _window_reduce(image.to(torch.float32), size, op).to(torch.bool)
    return _window_reduce(image, size, op)


def r_dilation(image: torch.Tensor, size: Size2) -> torch.Tensor:
    """Dilation = rectangular maximum filter (cval=0 borders)."""
    return _filter(image, size, torch.maximum)


def r_erosion(image: torch.Tensor, size: Size2) -> torch.Tensor:
    """Erosion = rectangular minimum filter with cval=0 borders (scipy's
    minimum_filter default erodes the borders)."""
    return _filter(image, size, torch.minimum)


def r_opening(image: torch.Tensor, size: Size2) -> torch.Tensor:
    return r_dilation(r_erosion(image, size), size)


def r_closing(image: torch.Tensor, size: Size2) -> torch.Tensor:
    return r_erosion(r_dilation(image, size), size)


def packed_closing(masks_bits: torch.Tensor, size: Size2) -> torch.Tensor:
    """Closing of up to 32 boolean masks packed as int32 bit planes: a
    windowed bitwise OR (dilation) then a windowed bitwise AND (erosion),
    both with cval=0 borders — every bit gets scipy's binary closing."""
    size = _normalize_size(size)
    if masks_bits.dtype != torch.int32:
        raise ValueError(f"packed_closing needs int32 bit planes, got "
                         f"{masks_bits.dtype}")
    dilated = _window_reduce(masks_bits, size, torch.bitwise_or)
    return _window_reduce(dilated, size, torch.bitwise_and)


# ---------------------------------------------------------------------------
# Skeletonization and map upscaling
# ---------------------------------------------------------------------------
def _shift(x: torch.Tensor, dy: int, dx: int) -> torch.Tensor:
    """Zero-padded 2-D shift: out[y, x] = x[y - dy, x - dx]."""
    h, w = x.shape
    padded = F.pad(x, (1, 1, 1, 1))
    return padded[1 - dy:1 - dy + h, 1 - dx:1 - dx + w]


def _zhang_suen_pass(p: torch.Tensor, phase: int) -> torch.Tensor:
    # P2..P9 clockwise from north
    p2, p3, p4, p5, p6, p7, p8, p9 = (
        _shift(p, 1, 0), _shift(p, 1, -1), _shift(p, 0, -1),
        _shift(p, -1, -1), _shift(p, -1, 0), _shift(p, -1, 1),
        _shift(p, 0, 1), _shift(p, 1, 1))
    ring = [p2, p3, p4, p5, p6, p7, p8, p9, p2]
    b = sum(ring[:-1])
    a = sum(((ring[i] < 0.5) & (ring[i + 1] > 0.5)).to(torch.float32)
            for i in range(8))
    cond_b = (b >= 2) & (b <= 6)
    cond_a = a == 1
    if phase == 0:
        c1 = p2 * p4 * p6 == 0
        c2 = p4 * p6 * p8 == 0
    else:
        c1 = p2 * p4 * p8 == 0
        c2 = p2 * p6 * p8 == 0
    remove = (p > 0.5) & cond_a & cond_b & c1 & c2
    return torch.where(remove, torch.zeros_like(p), p)


def skeletonize(mask: torch.Tensor, max_iters: int = 64) -> torch.Tensor:
    """Zhang-Suen thinning of a boolean [H, W] mask, both sub-iterations per
    round, until a round changes nothing or after ``max_iters`` rounds."""
    p = mask.to(torch.float32)
    for _ in range(max_iters):
        new = _zhang_suen_pass(_zhang_suen_pass(p, 0), 1)
        if torch.equal(new, p):
            break
        p = new
    return p > 0.5


def skelet(image: torch.Tensor, thres: float = 150, expand: bool = False,
           expand_horizontal: bool = True, iters: int = 1,
           max_thin_iters: int = 64) -> torch.Tensor:
    """threshold -> skeletonize -> dilate (and optionally widen)."""
    sk = skeletonize(image > thres, max_iters=max_thin_iters)
    out = r_dilation(sk, (1 + 2 * iters, 1 + 2 * iters))
    if expand:
        out = r_dilation(out, (1, 5) if expand_horizontal else (5, 1))
    return out


def resize_bilinear(image: torch.Tensor, shape: Tuple[int, int]) -> torch.Tensor:
    """f32 [H, W] -> ``shape`` as ``jax.image.resize(..., "bilinear")``:
    separable, half-pixel centres, and a triangle kernel widened by the
    scale (antialiasing) along an axis that shrinks.  One axis at a time,
    each with ``antialias`` on only where it shrinks: torch's antialiased
    path differs from plain bilinear where an axis grows."""
    x = image.to(torch.float32)[None, None]
    for axis, new in enumerate(shape):
        old = x.shape[2 + axis]
        if new == old:
            continue
        size = (new, x.shape[3]) if axis == 0 else (x.shape[2], new)
        x = F.interpolate(x, size=size, mode="bilinear", align_corners=False,
                          antialias=new < old)
    return x[0, 0]


def threshold_and_upscale_map(img_shape: Tuple[int, int], gt: torch.Tensor,
                              skeletonize_map: bool = False,
                              threshold: float = 150,
                              expand: bool = False) -> torch.Tensor:
    """Resize a map to the image's shape, then threshold it (or skeletonize
    it with ``skelet``)."""
    resized = resize_bilinear(gt, tuple(img_shape[:2]))
    if skeletonize_map:
        return skelet(resized, thres=threshold, expand=expand)
    return resized > threshold
