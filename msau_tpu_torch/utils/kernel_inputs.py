"""Seeded inputs that exercise the kernels' edge cases, shared by the tests
and ``chip_smoke.py`` (numpy arrays, so both frameworks get the same data)."""

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


def planes_program(rng: np.random.Generator, n: int, h: int, w: int,
                   num_planes: int):
    """(boxes [B, 4], values [B], plane_ids [B]) int32 for ``paint_planes``:
    overlapping boxes, boxes overhanging every edge (rows below 0 and past
    H, which must not spill into a neighbouring plane), empty boxes, and
    plane ids out of range (-1 and ``num_planes``: painted nowhere)."""
    y1 = rng.integers(-h // 4, h, n)
    x1 = rng.integers(-w // 4, w, n)
    y2 = y1 + rng.integers(-1, max(h // 2, 2), n)
    x2 = x1 + rng.integers(-1, max(w // 2, 2), n)
    boxes = np.stack([y1, y2, x1, x2], 1).astype(np.int32)
    values = rng.integers(1, 100, n).astype(np.int32)
    plane_ids = rng.integers(-1, num_planes + 1, n).astype(np.int32)
    return boxes, values, plane_ids


# edge programs of paint_edge_program, each exact on every implementation
PAINT_EDGE_CASES = ("value_0_overwrites", "overhanging", "page_under_small",
                    "one_box", "no_boxes")


def paint_edge_program(name: str, h: int, w: int) -> Tuple[np.ndarray, np.ndarray]:
    """(boxes [B, 4], values [B]) int32 of one ``PAINT_EDGE_CASES`` entry:
    later boxes of value 0 over earlier ones; boxes overhanging every edge
    (negative corners, coordinates far outside, boxes wholly outside, empty
    and reversed ones) after a first box far larger than the grid; one
    page-sized box under many small ones; a single box; no box."""
    if name == "value_0_overwrites":
        boxes = [[h // 8, h // 2, w // 8, w // 2], [h // 4, h // 3, w // 4, w // 3],
                 [0, h, w // 3, w // 3 + 1], [h // 5, h // 5 + 2, 0, w],
                 [h // 5, h // 5 + 1, w // 6, w // 5]]
        values = [7, 0, 0, 5, 0]
    elif name == "overhanging":
        big = 1 << 20
        boxes = [[-big, big, -big, big], [-5, 3, -7, w // 4],
                 [h - 2, h + 9, w - 3, w + 50], [-10, h + 10, w // 2, w // 2 + 1],
                 [h // 2, h // 2 + 1, -100, w + 100], [-3, -1, 2, 9],
                 [h + 1, h + 4, 0, 10], [5, 9, w, w + 3], [5, 9, -9, 0],
                 [4, 4, 0, 10], [9, 3, 0, 10], [1, 2, 7, 3]]
        values = list(range(15, 3, -1))
    elif name == "page_under_small":
        small, vals = paint_program(np.random.default_rng(7), max(h * w // 90, 1),
                                    h, w)
        boxes = np.concatenate([[[0, h, 0, w]], small])
        values = np.concatenate([[1], vals])
    elif name == "one_box":
        boxes, values = [[h // 3, h // 2, w // 5, w // 2]], [42]
    elif name == "no_boxes":
        boxes, values = np.zeros((0, 4)), []
    else:
        raise ValueError(f"unknown paint case {name!r}")
    return (np.asarray(boxes, np.int32).reshape(-1, 4),
            np.asarray(values, np.int32))


def page_programs(n_cols: int):
    """The serve path's three box programs of the synthetic page
    ``make_page(default_rng(3), n_cols, 2 n_cols)`` with the bench charset at
    the serve scale, padded as ``KVModel`` pads them (n_cols 5: the 512^2
    bench page; 10: a page in the 1024 bucket) -> ({"char" | "line_id" |
    "char_id": (boxes [B, 4], values [B]) int32}, (hb, wb))."""
    from msau_tpu_torch.config import InferConfig
    from msau_tpu_torch.data.charset import Charset
    from msau_tpu_torch.data.pages import page_from_label_dict
    from msau_tpu_torch.data.synth import BENCH_CHARSET, make_page
    from msau_tpu_torch.infer.kv_model import prepare_host

    page = page_from_label_dict(make_page(np.random.default_rng(3),
                                          n_cols=n_cols,
                                          rows_per_col=2 * n_cols))
    _, _, arrays, hb, wb = prepare_host(page, Charset(chars=" $" + BENCH_CHARSET),
                                        InferConfig().scale)
    names = ("char", "line_id", "char_id")
    return ({name: arrays[2 * i:2 * i + 2] for i, name in enumerate(names)},
            (hb, wb))


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
    'noisy' (independent 3-class pixels, many tiny components), 'maze'
    (serpentine class-1 corridors in class-2 walls with class-3 noise:
    long geodesic paths), 'one_class' (every pixel class 1: one component)
    or 'checker' (classes 1 and 2 alternating: every pixel its own
    component)."""
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
    if kind == "one_class":
        return np.ones((h, w), np.int32)
    if kind == "checker":
        return (np.indices((h, w)).sum(0) % 2 + 1).astype(np.int32)
    raise ValueError(f"unknown map kind {kind!r}")
