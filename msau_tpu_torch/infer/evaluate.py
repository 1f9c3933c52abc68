"""Field-level evaluation: GT reading + IoU > 0.7 box matching.

Every predicted field box counts as num_pred; a prediction is correct when
IoU (intersection over *predicted* area) with the GT merged box exceeds the
threshold.

Host copy of ``msau_tpu.infer.evaluate`` (that package's ``__init__`` imports
JAX); tests/test_torch_host_copies.py pins it to the original.
"""

from __future__ import annotations

import json
from typing import Dict, List, Sequence, Tuple

import numpy as np

from msau_tpu_torch.infer.reading_order import sort_box_reading_order


def rect_area(rect) -> float:
    x1, y1, x2, y2 = rect
    return (x2 - x1) * (y2 - y1)


def intersect_area(a, b, min_thresh: float = 2) -> float:
    x1, y1, x2, y2 = a
    x3, y3, x4, y4 = b
    left, right = max(x1, x3), min(x2, x4)
    top, bottom = max(y1, y3), min(y2, y4)
    if left <= right - min_thresh and top <= bottom - min_thresh:
        return 1.0 * (right - left + 1) * (bottom - top + 1)
    return 0.0


def iou_pred(a, b) -> float:
    """Intersection over the *first* box's area (reference IoU definition)."""
    area_a = rect_area(a)
    if area_a <= 0:
        return 0.0
    return intersect_area(a, b, min_thresh=0) / area_a


def read_json_gt(
    json_path: str, scale: float = 1.0, offset: Tuple[float, float] = (0, 0)
) -> Dict[int, Tuple[List[List[int]], str]]:
    """GT value boxes grouped by value class, merged in reading order."""
    with open(json_path, encoding="utf-8") as f:
        doc = json.load(f)
    ox, oy = offset
    value_boxes: Dict[int, List[dict]] = {}
    for line in doc["lines"]:
        x1, y1, x2, y2 = line["box"]
        box = [
            int((x1 - ox) * scale),
            int((y1 - oy) * scale),
            int((x2 - ox) * scale),
            int((y2 - oy) * scale),
        ]
        rec = {"box": box, "text": line.get("text", "")}
        value_idx = int(line.get("value", 0))
        type_idx = int(line.get("type", 0))
        if value_idx > 0 and type_idx > 0:
            value_boxes.setdefault(value_idx + 1, []).append(rec)

    correct: Dict[int, Tuple[List[List[int]], str]] = {}
    for value_id, recs in value_boxes.items():
        recs = sort_box_reading_order(recs)
        boxes = [r["box"] for r in recs]
        arr = np.asarray(boxes)
        merged = [
            int(arr[:, 0].min()),
            int(arr[:, 1].min()),
            int(arr[:, 2].max()),
            int(arr[:, 3].max()),
        ]
        text = "".join(r["text"] for r in recs)
        if value_id not in (1,):
            correct[value_id] = ([merged] + boxes, text)
    return correct


def accumulate_field_eval(
    values: Sequence,
    correct_answers: Dict[int, Tuple[List[List[int]], str]],
    eval_results: List[Dict[str, int]],
    iou_threshold: float = 0.7,
) -> None:
    """Update per-class num_pred / num_correct / num_label counters."""
    for value_id in correct_answers:
        if value_id < len(eval_results):
            eval_results[value_id]["num_label"] += 1
    for value_id, v in enumerate(values):
        boxes = v[1]
        if boxes is None:
            continue
        for box in boxes:
            if value_id < len(eval_results):
                eval_results[value_id]["num_pred"] += 1
            gt_boxes = (
                correct_answers[value_id][0][:1]
                if value_id in correct_answers
                else []
            )
            for gt in gt_boxes:
                if iou_pred(box, gt) > iou_threshold:
                    if value_id < len(eval_results):
                        eval_results[value_id]["num_correct"] += 1
                    break
