"""Seeded inputs that exercise the kernels' edge cases, shared by the tests
and ``chip_smoke.py`` (numpy only, so both frameworks get the same data)."""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np


def paint_program(rng: np.random.Generator, n: int, h: int, w: int,
                  pad_to: Optional[int] = None) -> Tuple[np.ndarray, np.ndarray]:
    """(boxes [B, 4] int32 (y1, y2, x1, x2), values [B] int32): overlapping
    boxes, boxes crossing tiles, empty boxes (y2 == y1 or x2 <= x1) and,
    with ``pad_to``, zero-padded records at the end."""
    y1 = rng.integers(0, h, n)
    x1 = rng.integers(0, w, n)
    y2 = np.minimum(y1 + rng.integers(0, max(h // 2, 1), n), h)
    x2 = np.minimum(x1 + rng.integers(-2, max(w // 3, 1), n), w)
    boxes = np.stack([y1, y2, x1, x2], 1).astype(np.int32)
    values = rng.integers(1, 100, n).astype(np.int32)
    if pad_to:
        boxes = np.concatenate([boxes, np.zeros((pad_to - n, 4), np.int32)])
        values = np.concatenate([values, np.zeros(pad_to - n, np.int32)])
    return boxes, values


def attention_inputs(rng: np.random.Generator, n: int, t: int, cb: int, c: int,
                     scale: float = 1.0):
    """f, g [N, T, Cb] and h [N, T, C] float32; ``scale`` raises the
    logits' range."""
    f = (rng.normal(size=(n, t, cb)) * scale).astype(np.float32)
    g = (rng.normal(size=(n, t, cb)) * scale).astype(np.float32)
    h = rng.normal(size=(n, t, c)).astype(np.float32)
    return f, g, h


def ce_inputs(rng: np.random.Generator, n: int, c: int, length: int,
              scale: float = 3.0, out_of_range: bool = False):
    """Masked-CE operands: logits [N, C, L] f32 (``scale`` sets their
    range), labels [N, L] int32 with about a quarter label 0 (background)
    and, with ``out_of_range``, some below 0 or above C-1, and maskf [N, L]
    f32 = (label != 0) and not in a bucket-padding band (the last eighth of
    each image's pixels)."""
    logits = (rng.normal(size=(n, c, length)) * scale).astype(np.float32)
    labels = rng.integers(1, c, (n, length)).astype(np.int32)
    labels[rng.random((n, length)) < 0.25] = 0
    if out_of_range:
        odd = rng.random((n, length))
        labels[odd < 0.05] = -1
        labels[odd > 0.95] = c + 2
    valid = np.ones((n, length), bool)
    valid[:, length - length // 8:] = False
    maskf = ((labels != 0) & valid).astype(np.float32)
    return logits, labels, maskf


def ccl_map(kind: str, h: int, w: int, rng: np.random.Generator) -> np.ndarray:
    """int32 [H, W] class maps: 'blobby' (upsampled random classes),
    'noisy' (independent 3-class pixels, many tiny components) or 'maze'
    (serpentine class-1 corridors in class-2 walls with class-3 noise:
    long geodesic paths)."""
    if kind == "blobby":
        coarse = rng.integers(0, 4, (-(-h // 16), -(-w // 16)))
        return np.repeat(np.repeat(coarse, 16, 0), 16, 1)[:h, :w].astype(np.int32)
    if kind == "noisy":
        return rng.integers(0, 3, (h, w)).astype(np.int32)
    if kind == "maze":
        cls = np.full((h, w), 2, np.int32)
        cls[::2, :] = 1
        for r in range(1, h, 2):
            cls[r, (w - 1) if (r // 2) % 2 == 0 else 0] = 1
        cls[rng.random((h, w)) < 0.02] = 3
        return cls
    raise ValueError(f"unknown map kind {kind!r}")
