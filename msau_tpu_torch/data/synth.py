"""Synthetic form pages for the serve benchmark and smoke runs, and the
bench's structured training batch.

Host copy of ``make_page``, ``write_corpus``, ``make_structured_batch`` and
``BENCH_CHARSET`` from ``msau_tpu.data.synth`` (that package's ``__init__`` imports JAX);
tests/test_torch_host_copies.py pins each to the original.  Each page is a randomized bank-transfer-style form
in the labeling-tool JSON dict format (``{'img_shape', 'lines': [{box, text,
type, value}]}``) over the default 17-class schema.
"""

from __future__ import annotations

import json
import os
import string
from typing import List, Tuple

import numpy as np

FIELDS = [
    # (key text, value generator); value id = index + 1, pixel class = id + 1
    ("Bank Name", "words"),
    ("Branch", "words"),
    ("Account No", "digits"),
    ("Amount", "amount"),       # value 4 -> class 5: multi-line capable
    ("Holder", "name"),
    ("Kana", "words"),
    ("Branch Code", "digits"),
    ("Institution", "words"),
]

WORDS = [
    "First", "National", "Central", "Pacific", "Union", "Metro", "Trust",
    "Sakura", "Mizuho", "Plaza", "Harbor", "Summit", "Valley", "River",
]
NAMES = ["Alexandra", "Tanaka", "Suzuki", "Jordan", "Morgan", "Casey", "Robin"]


def gen_value(kind: str, rng: np.random.Generator) -> str:
    if kind == "digits":
        return "".join(rng.choice(list(string.digits), rng.integers(5, 9)))
    if kind == "amount":
        return "%s,%03d" % (
            "".join(rng.choice(list("123456789"), 1)), rng.integers(0, 1000)
        )
    if kind == "name":
        return " ".join(rng.choice(NAMES, 2))
    return " ".join(rng.choice(WORDS, rng.integers(1, 3)))


def make_page(rng: np.random.Generator, *, n_cols: int = 1,
              rows_per_col: int = 1, dropout: float = 0.15,
              multiline_p: float = 0.5) -> dict:
    """One randomized form in labeling-tool JSON dict format.

    ``n_cols``/``rows_per_col`` scale the page up (each column cycles
    through FIELDS ``rows_per_col`` times), which raises the page-extent /
    line-height ratio and therefore the rasterized resolution: the 1-col
    default lands in the 256 bucket; 5 columns x 10 rows is the 512² bench
    page.
    """
    col_w = 700
    lines: List[dict] = []
    y_max = 0
    for col in range(n_cols):
        x0 = col * col_w
        y = int(rng.integers(30, 60))
        for rep in range(rows_per_col):
            order = rng.permutation(len(FIELDS))
            for fi in order:
                key, kind = FIELDS[fi]
                if rng.random() < dropout:      # field dropout
                    continue
                vtext = gen_value(kind, rng)
                xk = x0 + int(rng.integers(20, 60))
                kw_ = 14 * len(key)
                lines.append({"box": [xk, y, xk + kw_, y + 24], "text": key,
                              "type": 1, "value": 0})
                xv = xk + kw_ + int(rng.integers(20, 60))
                lines.append({"box": [xv, y, xv + 14 * len(vtext), y + 24],
                              "text": vtext, "type": 2, "value": int(fi) + 1})
                y += int(rng.integers(34, 56))
                # multi-line continuation for the Amount field (class 5)
                if kind == "amount" and rng.random() < multiline_p:
                    cont = gen_value("digits", rng)
                    lines.append(
                        {"box": [xv, y, xv + 14 * len(cont), y + 24],
                         "text": cont, "type": 2, "value": int(fi) + 1})
                    y += int(rng.integers(34, 56))
        y_max = max(y_max, y)
    return {"img_shape": [y_max + 30, n_cols * col_w], "lines": lines}


def write_corpus(out_dir: str, n_train: int, n_test: int,
                 rng: np.random.Generator, **page_kwargs
                 ) -> Tuple[List[str], List[str], str]:
    """Dump a page corpus + charset file; returns (train, test, charset)."""
    os.makedirs(out_dir, exist_ok=True)
    train_paths: List[str] = []
    test_paths: List[str] = []
    corpus: List[str] = []
    for i in range(n_train + n_test):
        doc = make_page(rng, **page_kwargs)
        p = os.path.join(out_dir, f"page{i:03d}.json")
        with open(p, "w") as f:
            json.dump(doc, f)
        (train_paths if i < n_train else test_paths).append(p)
        corpus.extend(l["text"] for l in doc["lines"])
    charset_path = os.path.join(out_dir, "charset.txt")
    with open(charset_path, "w") as f:
        f.write("".join(sorted(set("".join(corpus)))))
    return train_paths, test_paths, charset_path


def make_structured_batch(
    rng: np.random.Generator, bs: int, hw: int, n_class: int,
    channels: int, n_rects: int = 24,
) -> Tuple[np.ndarray, np.ndarray]:
    """Rectangle-structured (input, label) pair for benchmark training.

    Each image holds ``n_rects`` random class-c rectangles; the input adds
    +1 on channel ``c % channels`` inside each rectangle over background
    noise, so the labels are linearly recoverable from the input and the
    masked CE converges instead of chasing uniform noise.
    """
    x = rng.normal(0.0, 0.1, (bs, hw, hw, channels)).astype(np.float32)
    label = np.zeros((bs, hw, hw), np.int32)
    for b in range(bs):
        for _ in range(n_rects):
            c = int(rng.integers(1, n_class))
            rh = int(rng.integers(max(hw // 16, 2), max(hw // 4, 3)))
            rw = int(rng.integers(max(hw // 16, 2), max(hw // 4, 3)))
            yy = int(rng.integers(0, hw - rh))
            xx = int(rng.integers(0, hw - rw))
            label[b, yy:yy + rh, xx:xx + rw] = c
            x[b, yy:yy + rh, xx:xx + rw, c % channels] += 1.0
    return x, label


BENCH_CHARSET = string.ascii_letters + string.digits  # 62 chars + 2 specials
