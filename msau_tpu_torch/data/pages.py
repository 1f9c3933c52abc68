"""Canonical page records + loaders for the two reference input formats.

* FUNSD ``form`` JSON (text lines with word sub-boxes, labels, linking) —
  consumed by the training generators (data_generator/data_generator_funsd.py:307-364,
  funsd_preprocessing_word_level.py:60-101).
* Labeling-tool JSON ``{'img_shape', 'lines': [{box, text, type, value}]}`` —
  produced by scripts/extract_training_data.py:194-195 and consumed by the
  generic generator (data_generator/data_generator_text.py:212-231) and
  KV inference (inference/kv_model.py:60-87).

Boxes are (x1, y1, x2, y2) pixel coordinates throughout.

Host copy of ``msau_tpu.data.pages`` (that package's ``__init__`` imports JAX);
tests/test_torch_host_copies.py pins it to the original.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

# FUNSD entity label ids (data_generator_funsd.py:106-112)
FUNSD_LABEL_TO_ID = {"other": 0, "question": 1, "answer": 2, "header": 3}


@dataclass
class Word:
    box: Tuple[int, int, int, int]
    text: str


@dataclass
class Line:
    box: Tuple[float, float, float, float]
    text: str
    label: int = 0                   # semantic class id
    value: int = 0                   # value-class id (labeling-tool format)
    id: int = -1
    linking: List[Tuple[int, int]] = field(default_factory=list)
    words: List[Word] = field(default_factory=list)


@dataclass
class Page:
    lines: List[Line]
    img_shape: Optional[Tuple[int, int]] = None
    path: Optional[str] = None

    @property
    def texts(self) -> List[str]:
        return [l.text for l in self.lines]


def load_funsd_page(path: str, label_to_id: Dict[str, int] = FUNSD_LABEL_TO_ID) -> Page:
    with open(path, encoding="utf-8") as f:
        doc = json.load(f)
    lines: List[Line] = []
    for item in doc["form"]:
        words = [Word(box=tuple(w["box"]), text=w["text"]) for w in item.get("words", [])]
        lines.append(
            Line(
                box=tuple(item["box"]),
                text=item["text"],
                label=label_to_id.get(item.get("label", "other"), 0),
                id=item.get("id", -1),
                linking=[tuple(l) for l in item.get("linking", [])],
                words=words,
            )
        )
    return Page(lines=lines, path=path)


def page_from_label_dict(doc: Dict, path: Optional[str] = None) -> Page:
    """Labeling-tool dict -> Page (lines carry integer 'type'/'value' ids)."""
    lines = [
        Line(
            box=tuple(l["box"]),
            text=l.get("text", ""),
            label=int(l.get("value", 0)),
            value=int(l.get("value", 0)),
        )
        for l in doc["lines"]
    ]
    shape = tuple(doc["img_shape"][:2]) if "img_shape" in doc else None
    return Page(lines=lines, img_shape=shape, path=path)


def load_label_json_page(path: str) -> Page:
    """Labeling-tool format: lines carry integer 'type' and 'value' ids."""
    with open(path, encoding="utf-8") as f:
        doc = json.load(f)
    return page_from_label_dict(doc, path=path)



def save_label_json(path: str, img_shape: Sequence[int], lines: Sequence[Line]) -> None:
    """Writer matching scripts/data_util.py:33-39."""
    doc = {
        "img_shape": list(img_shape),
        "lines": [
            {"box": list(l.box), "text": l.text, "type": l.label, "value": l.value}
            for l in lines
        ],
    }
    with open(path, "w", encoding="utf-8") as f:
        json.dump(doc, f, ensure_ascii=False)
