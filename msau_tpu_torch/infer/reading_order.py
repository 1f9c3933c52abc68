"""Geometric reading-order sort (top-left first).

Reproduces the selection heuristic of the reference
(inference/generic_util.py:51-92): repeatedly scan for the current
"top-left" box — a candidate displaces the incumbent if its center is more
than half a line height above, or if its center lies left of and above the
incumbent's bottom-right corner.

Host copy of ``msau_tpu.infer.reading_order`` (that package's ``__init__`` imports JAX);
tests/test_torch_host_copies.py pins it to the original.
"""

from __future__ import annotations

from typing import Callable, List, Sequence, TypeVar

T = TypeVar("T")


def _default_box(item):
    if isinstance(item, dict):
        return item["box"]
    return item.box


def sort_box_reading_order(items: Sequence[T], box_fn: Callable = _default_box) -> List[T]:
    boxes = list(items)
    if len(boxes) == 0:
        return boxes
    # geometry cached once: the selection scan below evaluates O(n^2)
    # comparisons, and box_fn per comparison dominated dense pages
    geo = [box_fn(b) for b in boxes]
    cxy = [((g[0] + g[2]) / 2, (g[1] + g[3]) / 2) for g in geo]
    idxs = list(range(len(boxes)))
    out: List[T] = []
    while len(idxs) > 1:
        ti = idxs[0]
        for ci in idxs[1:]:
            tcy = cxy[ti][1]
            tx2, ty2 = geo[ti][2], geo[ti][3]
            cx, cy = cxy[ci]
            cell_h = geo[ci][3] - geo[ci][1]
            if cy <= tcy - cell_h / 2:
                ti = ci
                continue
            if cx < tx2 and cy < ty2:
                ti = ci
                continue
        out.append(boxes[ti])
        idxs.remove(ti)
    out.append(boxes[idxs[0]])
    return out
