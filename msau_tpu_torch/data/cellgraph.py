"""Cell-graph construction: vectorized spatial-relation adjacency.

Reference: utils/graph_building_utils.py builds left/right, top/bottom and
containment edges between OCR cells with per-pair Python predicates and an
O(N^3) blocker scan (``is_left_of``/``is_top_of`` reject a neighbor when a
third cell lies between).  Here the same heuristics are evaluated as
boolean [N, N] matrices with a chunked einsum-style blocker reduction —
hundreds of times faster on host and trivially testable against a direct
translation.

Output matches ``get_adj_mat`` (graph_building_utils.py:431-444):
[N, N, 6] with planes (lefts, rights, tops, bottoms, parents, children);
``adj[i, j, 1] == 1`` means j is a direct right neighbor of i.

Host copy of ``msau_tpu.data.cellgraph`` (that package's ``__init__`` imports
JAX); tests/test_torch_host_copies.py pins it to the original.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Sequence

import numpy as np


@dataclass
class Cell:
    """API-parity cell record (CellNode equivalent, bbox is xywh)."""

    x: float
    y: float
    w: float
    h: float
    ocr_value: str = ""
    index: int = -1

    def get_bbox(self):
        return (self.x, self.y, self.w, self.h)

    @property
    def aspect_ratio(self):
        return self.w / self.h if self.h else np.inf


def get_list_cells(list_bboxs: Sequence[Sequence[float]], ocr_values: Sequence[str]) -> List[Cell]:
    return [
        Cell(b[0], b[1], b[2], b[3], ocr_values[i], index=i)
        for i, b in enumerate(list_bboxs)
    ]


def _proj_overlap(lo: np.ndarray, size: np.ndarray) -> np.ndarray:
    """[N, N] pairwise 1-D projection overlap length (bbox_operations.py:44-54)."""
    a1 = lo[:, None]
    a2 = (lo + size)[:, None]
    b1 = lo[None, :]
    b2 = (lo + size)[None, :]
    return np.maximum(np.minimum(a2, b2) - np.maximum(a1, b1), 0.0)


def build_adjacency(boxes: np.ndarray, chunk: int = 64) -> np.ndarray:
    """boxes: [N, 4] xywh → adjacency [N, N, 6] uint8."""
    boxes = np.asarray(boxes, np.float64)
    n = len(boxes)
    adj = np.zeros((n, n, 6), np.uint8)
    if n == 0:
        return adj
    x, y, w, h = boxes.T
    x2, y2 = x + w, y + h

    h_ov = _proj_overlap(y, h)   # horizontal-projection overlap (heights)
    v_ov = _proj_overlap(x, w)   # vertical-projection overlap (widths)
    min_h = np.minimum(h[:, None], h[None, :])
    min_w = np.minimum(w[:, None], w[None, :])
    not_self = ~np.eye(n, dtype=bool)

    # ---------------- left-right edges (build_left_right_edges :133-156)
    collide = (x[None, :] >= x[:, None]) & (h_ov > 0) & not_self
    collide &= h_ov > 0.3 * min_h
    # is_left_of(i, j) short-circuit: big overlap + nearly same left edge
    short = (h_ov > 0.9 * min_h) & ((x[None, :] - x[:, None]) < 0.1 * min_w)
    # blocker k for pair (i, j): k must itself be in i's collide set, lie
    # clearly right of i and end before j (is_left_of steps 1-3)
    base_k = (
        collide
        & (x[None, :] >= (x + 0.8 * w)[:, None])
        & (h_ov > min_h / 5)
    )
    rights = np.zeros((n, n), dtype=bool)
    for i0 in range(0, n, chunk):
        i1 = min(i0 + chunk, n)
        # axes: [I, K, J] — does k block pair (i, j)?
        k_ok = base_k[i0:i1, :, None]                                    # i-k terms
        k_before_j = (x2[None, :, None] < (x + 0.1 * w)[None, None, :])  # k ends before j
        wide = h_ov[None, :, :] > (h / 2)[None, None, :]                 # overlap(k, j) > hj/2
        tall = h_ov[i0:i1, :, None] > 0.8 * min_h[i0:i1, :, None]        # overlap(i, k) > .8 min
        blocked = (k_ok & k_before_j & (wide | tall)).any(axis=1)        # [I, J]
        rights[i0:i1] = collide[i0:i1] & (short[i0:i1] | ~blocked)
    adj[:, :, 1] = rights
    adj[:, :, 0] = rights.T

    # ---------------- top-down edges (build_top_down_edges :159-174)
    collide_v = (y[None, :] > y2[:, None]) & (v_ov > 0) & not_self
    ok_v = v_ov >= min_w / 5
    base_kv = (
        collide_v
        & (y[None, :] >= (y + 0.8 * h)[:, None])
        & (v_ov > min_w / 5)
    )
    bottoms = np.zeros((n, n), dtype=bool)
    for i0 in range(0, n, chunk):
        i1 = min(i0 + chunk, n)
        k_ok = base_kv[i0:i1, :, None]
        k_before_j = (y2[None, :, None] < (y + 0.1 * h)[None, None, :])
        wide = v_ov[None, :, :] > (w / 2)[None, None, :]
        tall = v_ov[i0:i1, :, None] > 0.8 * min_w[i0:i1, :, None]
        blocked = (k_ok & k_before_j & (wide | tall)).any(axis=1)
        bottoms[i0:i1] = collide_v[i0:i1] & ok_v[i0:i1] & ~blocked
    adj[:, :, 3] = bottoms
    adj[:, :, 2] = bottoms.T

    # ---------------- containment edges (build_containing_edges :178-192)
    area = w * h
    bigger = area[None, :] >= area[:, None]
    # contains(big=j, small=i): check_bbox_contains_each_other semantics
    contains = (
        (y[:, None] >= (y - 0.1 * h)[None, :])
        & (x2[None, :] > x2[:, None])
        & (y2[None, :] > y2[:, None])
    )
    almost = (
        (y[:, None] >= (y - 0.2 * h)[None, :])
        & (v_ov.T * h_ov.T > 0.8 * (w * h)[:, None])
    )
    parents = bigger & not_self & (contains | almost)
    adj[:, :, 4] = parents
    adj[:, :, 5] = parents.T
    return adj


def neighbor_lists(adj: np.ndarray):
    """Convert adjacency planes to neighbor index lists (CellNode fields)."""
    keys = ("lefts", "rights", "tops", "bottoms", "parents", "children")
    return [
        {k: np.nonzero(adj[i, :, p])[0].tolist() for p, k in enumerate(keys)}
        for i in range(adj.shape[0])
    ]
