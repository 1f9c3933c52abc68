"""Corner/center heatmaps + linking targets for box-relation training.

The reference's corner-target generator
(data_generator/data_generator_funsd.py:177-290) imports
``gaussian_radius``/``draw_gaussian`` that don't exist in the repo — the
module cannot run as committed (SURVEY.md §2.12).  This implements the
intended CornerNet-style targets (Law & Deng 2018) vectorized:

  * ``gaussian_radius``: the max radius keeping IoU >= ``min_iou`` for the
    three corner-displacement cases;
  * ``draw_gaussians``: max-blended 2-D gaussian bumps on a heatmap;
  * ``corner_targets``: per-class top-left / bottom-right / center
    heatmaps + flattened-position tags, offsets and masks for the
    linking edges (reference :248-290 semantics, minus its dead code).

Host copy of ``msau_tpu.data.corners`` (that package's ``__init__`` imports
JAX); tests/test_torch_host_copies.py pins it to the original.
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence, Tuple

import numpy as np


def gaussian_radius(det_size: Tuple[float, float], min_iou: float = 0.7) -> float:
    h, w = det_size
    a1 = 1.0
    b1 = h + w
    c1 = w * h * (1 - min_iou) / (1 + min_iou)
    sq1 = math.sqrt(max(b1 ** 2 - 4 * a1 * c1, 0))
    r1 = (b1 + sq1) / 2

    a2 = 4.0
    b2 = 2 * (h + w)
    c2 = (1 - min_iou) * w * h
    sq2 = math.sqrt(max(b2 ** 2 - 4 * a2 * c2, 0))
    r2 = (b2 + sq2) / 2

    a3 = 4 * min_iou
    b3 = -2 * min_iou * (h + w)
    c3 = (min_iou - 1) * w * h
    sq3 = math.sqrt(max(b3 ** 2 - 4 * a3 * c3, 0))
    r3 = (b3 + sq3) / 2
    return min(r1, r2, r3)


def gaussian_2d(radius: int, sigma: float) -> np.ndarray:
    m = n = radius
    y, x = np.ogrid[-m : m + 1, -n : n + 1]
    g = np.exp(-(x * x + y * y) / (2 * sigma * sigma))
    g[g < np.finfo(g.dtype).eps * g.max()] = 0
    return g


def draw_gaussian(heatmap: np.ndarray, center: Sequence[int], radius: int) -> None:
    """Max-blend a gaussian bump at (x, y) = center in place."""
    radius = max(int(radius), 0)
    g = gaussian_2d(radius, sigma=(2 * radius + 1) / 6.0)
    x, y = int(center[0]), int(center[1])
    h, w = heatmap.shape
    if x < 0 or y < 0 or x >= w or y >= h:
        return
    left, right = min(x, radius), min(w - x, radius + 1)
    top, bottom = min(y, radius), min(h - y, radius + 1)
    roi = heatmap[y - top : y + bottom, x - left : x + right]
    groi = g[radius - top : radius + bottom, radius - left : radius + right]
    np.maximum(roi, groi, out=roi)


def corner_targets(
    boxes: Dict[int, Tuple[Sequence[float], int, str, object, list]],
    origin_shape: Tuple[int, int],
    output_shape: Tuple[int, int],
    n_box_class: int = 3,
    max_tag_len: int = 256,
    use_gaussian_bump: bool = True,
    gaussian_rad: int = 1,
    gaussian_iou: float = 0.7,
) -> Dict[str, np.ndarray]:
    """boxes: id -> (box (x1,y1,x2,y2), category, text, feats, linking)."""
    oh, ow = output_shape
    heat_tl = np.zeros((oh, ow, n_box_class), np.float32)
    heat_br = np.zeros((oh, ow, n_box_class), np.float32)
    heat_ct = np.zeros((oh, ow, n_box_class), np.float32)
    tags_tl = np.zeros((max_tag_len,), np.int64)
    tags_br = np.zeros((max_tag_len,), np.int64)
    offsets_tl = np.zeros((max_tag_len, 2), np.float32)
    offsets_br = np.zeros((max_tag_len, 2), np.float32)
    tags_mask = np.zeros((max_tag_len,), np.float32)

    wr = ow / max(origin_shape[1], 1)
    hr = oh / max(origin_shape[0], 1)

    converted = {}
    for bid, item in boxes.items():
        box, category = item[0], item[1]
        x1, y1, x2, y2 = box
        xtl, ytl = int(x1 * wr), int(y1 * hr)
        xbr, ybr = int(x2 * wr), int(y2 * hr)
        xc, yc = (xtl + xbr) // 2, (ytl + ybr) // 2
        converted[bid] = (xtl, ytl, xbr, ybr)
        if category <= 0:
            continue
        cat = min(category - 1, n_box_class - 1)
        if use_gaussian_bump:
            bw = math.ceil((x2 - x1) * wr)
            bh = math.ceil((y2 - y1) * hr)
            radius = (
                max(0, int(gaussian_radius((bh, bw), gaussian_iou)))
                if gaussian_rad == -1
                else gaussian_rad
            )
            draw_gaussian(heat_tl[:, :, cat], (xtl, ytl), radius)
            draw_gaussian(heat_br[:, :, cat], (xbr, ybr), radius)
            draw_gaussian(heat_ct[:, :, cat], (xc, yc), radius)
        else:
            if 0 <= ytl < oh and 0 <= xtl < ow:
                heat_tl[ytl, xtl, cat] = 1
            if 0 <= ybr < oh and 0 <= xbr < ow:
                heat_br[ybr, xbr, cat] = 1
            if 0 <= yc < oh and 0 <= xc < ow:
                heat_ct[yc, xc, cat] = 1

    # linking edges -> position tags + corner offsets (reference :248-290)
    tag_len = 0
    max_pos = oh * ow - 1
    for bid, item in boxes.items():
        linking = item[-1]
        for edge in linking:
            if len(edge) != 2:
                continue
            target_id = edge[1]
            if target_id == bid or target_id not in converted:
                continue
            if tag_len >= max_tag_len:
                break
            sx, sy = converted[bid][:2]
            tx, ty = converted[target_id][:2]
            shift = (sx - tx, sy - ty)
            if shift[0] > shift[1]:
                offsets_tl[tag_len] = shift
            else:
                offsets_br[tag_len] = shift
            tags_tl[tag_len] = min(ty * ow + tx, max_pos)
            tags_br[tag_len] = min(ty * ow + tx, max_pos)
            tag_len += 1
    tags_mask[:tag_len] = 1.0

    return {
        "heat_tl": heat_tl,
        "heat_br": heat_br,
        "heat_center": heat_ct,
        "tags_tl": tags_tl,
        "tags_br": tags_br,
        "offsets_tl": offsets_tl,
        "offsets_br": offsets_br,
        "tags_mask": tags_mask,
        "tag_len": np.int32(tag_len),
    }
