"""Plain bbox predicates (xywh) — API parity with utils/bbox_operations.py.

The vectorized forms live in msau_tpu_torch/data/cellgraph.py; these scalar
helpers serve code that works box-by-box (tests, tooling, user code
migrating from the reference).

Host copy of ``msau_tpu.data.bbox`` (that package's ``__init__`` imports
JAX); tests/test_torch_host_copies.py pins it to the original.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

Box = Sequence[float]  # (x, y, w, h)


class BBox:
    def __init__(self, bbox: Box):
        self.x, self.y, self.w, self.h = bbox

    def get_bbox(self) -> List[float]:
        return [self.x, self.y, self.w, self.h]

    def __getitem__(self, key):
        return self.get_bbox()[key]


def check_intersect_range(x1, l1, x2, l2) -> bool:
    if x1 > x2:
        x1, x2 = x2, x1
        l1, l2 = l2, l1
    return (x1 + l1) > x2


def check_intersect_vertical_proj(b1: Box, b2: Box) -> bool:
    return check_intersect_range(b1[0], b1[2], b2[0], b2[2])


def check_intersect_horizontal_proj(b1: Box, b2: Box) -> bool:
    return check_intersect_range(b1[1], b1[3], b2[1], b2[3])


def check_intersect_bbox(b1: Box, b2: Box) -> bool:
    return check_intersect_horizontal_proj(b1, b2) and check_intersect_vertical_proj(b1, b2)


def get_intersect_range(x1, l1, x2, l2) -> float:
    if x1 > x2:
        x1, x2 = x2, x1
        l1, l2 = l2, l1
    if not check_intersect_range(x1, l1, x2, l2):
        return 0
    return l2 if (x1 + l1) > (x2 + l2) else x1 + l1 - x2


def get_intersect_range_horizontal_proj(b1: Box, b2: Box) -> float:
    return get_intersect_range(b1[1], b1[3], b2[1], b2[3])


def get_intersect_range_vertical_proj(b1: Box, b2: Box) -> float:
    return get_intersect_range(b1[0], b1[2], b2[0], b2[2])


def check_bbox_contains_each_other(b1: Box, b2: Box) -> bool:
    if b1[2] * b1[3] < b2[2] * b2[3]:
        b1, b2 = b2, b1
    if b2[1] < b1[1] - b1[3] * 0.1:
        return False
    return (b1[0] + b1[2] > b2[0] + b2[2]) and (b1[1] + b1[3] > b2[1] + b2[3])


def check_bbox_almost_contains_each_other(b1: Box, b2: Box) -> bool:
    if b1[2] * b1[3] < b2[2] * b2[3]:
        b1, b2 = b2, b1
    if b2[1] < b1[1] - b1[3] * 0.2:
        return False
    return (
        get_intersect_range_vertical_proj(b1, b2)
        * get_intersect_range_horizontal_proj(b1, b2)
        > 0.8 * b2[2] * b2[3]
    )


def get_min_bbox_contains_all(boxes: Sequence[Box]) -> Optional[Tuple]:
    if not boxes:
        return None
    x1 = min(b[0] for b in boxes)
    y1 = min(b[1] for b in boxes)
    x2 = max(b[0] + b[2] for b in boxes)
    y2 = max(b[1] + b[3] for b in boxes)
    return (x1, y1, x2 - x1, y2 - y1)


# ---------------------------------------------------------------------------
# overlap filters on corner boxes (inference/morph_util.py:106-157)
# ---------------------------------------------------------------------------
def filter_overlap_boxes(boxes, return_indices: bool = False):
    """Drop boxes fully contained in a wider box (morph_util.py:106-129)."""
    n = len(boxes)
    if n < 2:
        return [False] * n if return_indices else list(boxes)
    overlap = [False] * n
    for i in range(n):
        x1, y1, x2, y2 = boxes[i]
        for j in range(n):
            if i == j:
                continue
            x3, y3, x4, y4 = boxes[j]
            if (
                not overlap[j]
                and abs(x1 - x2) <= abs(x3 - x4)
                and x1 >= x3 and x2 <= x4 and y1 >= y3 and y2 <= y4
            ):
                overlap[i] = True
                break
    if return_indices:
        return overlap
    return [boxes[i] for i in range(n) if not overlap[i]]


def filter_overlap_boxes_bigger(
    boxes, intersect_thres: float = 0.9, min_area: float = 0,
    return_indices: bool = False,
):
    """Drop the smaller of heavily-overlapping pairs (morph_util.py:131-157)."""
    from msau_tpu_torch.infer.evaluate import intersect_area, rect_area

    n = len(boxes)
    if n < 2:
        return [False] * n if return_indices else list(boxes)
    overlap = [False] * n
    for i in range(n):
        for j in range(n):
            if i == j:
                continue
            inter = intersect_area(boxes[i], boxes[j], min_thresh=0)
            ai, aj = rect_area(boxes[i]), rect_area(boxes[j])
            if (
                not overlap[i]
                and ai <= aj
                and inter > intersect_thres * min(ai, aj)
                and min(ai, aj) > min_area
            ):
                overlap[i] = True
                break
    if return_indices:
        return overlap
    return [boxes[i] for i in range(n) if not overlap[i]]
