"""Per-character box records of the rasterizer and of the word grid.

``char_records`` and ``wordgrid_records`` run the C core
(``msau_tpu_torch.native``, built at first use) where it is available and
their numpy versions (``*_plain``) otherwise, as the JAX package's
``msau_tpu.native`` does; the numpy versions are the port's copies of
that package's numpy paths and the C core's oracle in the tests
(``tests/test_torch_host_copies.py``, ``tests/test_torch_native.py``).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from msau_tpu_torch import native


def char_records_plain(line_boxes: np.ndarray, text_offsets: np.ndarray,
                       char_ids: np.ndarray, cap_factor: float
                       ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """line_boxes [L, 4] int32 scaled (x1, y1, x2, y2), text_offsets [L+1],
    char_ids [total] -> (records [N, 5] (y1, y2, sx, ex, id), line_idx [N]
    1-based, char_pos [N] 1-based)."""
    line_boxes = np.ascontiguousarray(line_boxes, np.int32)
    text_offsets = np.ascontiguousarray(text_offsets, np.int32)
    char_ids = np.ascontiguousarray(char_ids, np.int32)
    lens = np.diff(text_offsets)
    if not (lens > 0).any():
        e = np.zeros((0,), np.int32)
        return np.zeros((0, 5), np.int32), e, e
    x1, y1, x2, y2 = (line_boxes[:, 0], line_boxes[:, 1], line_boxes[:, 2],
                      line_boxes[:, 3])
    lens_f = np.maximum(lens, 1).astype(np.float64)
    cfw = np.maximum((x2 - x1) / lens_f, 1.0)
    cw = np.maximum(0.9 * cfw, 1.0)
    cw = np.minimum(cw, ((y2 - y1) * cap_factor).astype(np.int64).astype(
        np.float64))
    line_of = np.repeat(np.arange(len(lens)), lens)
    pos = np.arange(len(char_ids)) - np.repeat(text_offsets[:-1], lens)
    offset = x1[line_of] + pos * cfw[line_of]
    sx = offset.astype(np.int32)
    ex = (offset + cw[line_of]).astype(np.int32)
    rec = np.stack([y1[line_of], y2[line_of], sx, ex, char_ids],
                   axis=1).astype(np.int32)
    return rec, (line_of + 1).astype(np.int32), (pos + 1).astype(np.int32)


def wordgrid_records_plain(word_boxes: np.ndarray,
                           text_offsets: np.ndarray, char_ids: np.ndarray,
                           min_x: float, min_y: float, min_scale: float,
                           min_h: float) -> np.ndarray:
    """word_boxes [W, 4] float64 (x, y, w, h), text_offsets [W+1], char_ids
    [total] -> records [total, 5] (y1, y2, x1, x2, id) in cell units: each
    word's chars side by side, ``max(nw // len, 1)`` cells wide."""
    word_boxes = np.ascontiguousarray(word_boxes, np.float64)
    text_offsets = np.ascontiguousarray(text_offsets, np.int32)
    char_ids = np.ascontiguousarray(char_ids, np.int32)
    lens = np.diff(text_offsets)
    x, y, w, h = word_boxes.T
    nx = ((x - min_x) / min_scale).astype(np.int64)
    ny = ((y - min_y) / min_h).astype(np.int64)
    nw = np.maximum((w / min_scale).astype(np.int64), 1)
    nh = np.maximum((h / min_h).astype(np.int64), 1)
    pcw = np.maximum(nw // np.maximum(lens, 1), 1)
    word_of = np.repeat(np.arange(len(lens)), lens)
    pos = np.arange(len(char_ids)) - np.repeat(text_offsets[:-1], lens)
    sx = nx[word_of] + pcw[word_of] * pos
    return np.stack(
        [ny[word_of], ny[word_of] + nh[word_of], sx, sx + pcw[word_of],
         char_ids], axis=1).astype(np.int32)


def char_records(line_boxes: np.ndarray, text_offsets: np.ndarray,
                 char_ids: np.ndarray, cap_factor: float
                 ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """``char_records_plain``'s records, from the C core where it is
    available."""
    if native.native_available():
        return native.char_records(line_boxes, text_offsets, char_ids,
                                   cap_factor)
    return char_records_plain(line_boxes, text_offsets, char_ids, cap_factor)


def wordgrid_records(word_boxes: np.ndarray, text_offsets: np.ndarray,
                     char_ids: np.ndarray, min_x: float, min_y: float,
                     min_scale: float, min_h: float) -> np.ndarray:
    """``wordgrid_records_plain``'s records, from the C core where it is
    available."""
    args = (word_boxes, text_offsets, char_ids, min_x, min_y, min_scale,
            min_h)
    if native.native_available():
        return native.wordgrid_records(*args)
    return wordgrid_records_plain(*args)
