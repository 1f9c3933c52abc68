"""Character-set handling for chargrid rasterization.

Reference behavior (data_generator/data_generator_funsd.py:95-104,
inference/kv_model.py:44-53): a charset file is prefixed with two special
tokens (pad/background at index 0, blank/unknown at index 1); characters map
to one-hot channel indices; unknown characters fall back to the blank index;
inference optionally normalizes all digits to '0' (kv_model.py:126).

Host copy of ``msau_tpu.data.charset`` (that package's ``__init__`` imports JAX);
tests/test_torch_host_copies.py pins it to the original.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Iterable

import numpy as np

# Default specials match the training generator ('◫' background, '⎅' blank).
DEFAULT_SPECIALS = ("◫", "⎅")
BLANK_IDX = 1


@dataclass
class Charset:
    chars: str                       # full token string incl. specials
    blank_idx: int = BLANK_IDX
    tok_to_id: Dict[str, int] = field(default_factory=dict)

    def __post_init__(self):
        if not self.tok_to_id:
            self.tok_to_id = {tok: idx for idx, tok in enumerate(self.chars)}
        self.id_to_tok = {idx: tok for tok, idx in self.tok_to_id.items()}

    @property
    def n_token(self) -> int:
        return len(self.tok_to_id)

    # ------------------------------------------------------------------
    @classmethod
    def from_corpus(cls, corpus: Iterable[str], specials=DEFAULT_SPECIALS) -> "Charset":
        """Build a sorted charset from raw text (whitespace stripped),
        mirroring DataGenerator.generate_charset (data_generator_funsd.py:146-158)."""
        text = "".join(corpus)
        chars = sorted(set("".join(text.split())))
        return cls(chars="".join(specials) + "".join(chars))

    @classmethod
    def from_file(cls, path: str, specials=DEFAULT_SPECIALS) -> "Charset":
        with open(path, encoding="utf-8") as f:
            body = f.read()
        return cls(chars="".join(specials) + body)

    def save(self, path: str) -> None:
        """Write the raw charset body (without specials)."""
        with open(path, "w", encoding="utf-8") as f:
            f.write(self.chars[len(DEFAULT_SPECIALS):])

    # ------------------------------------------------------------------
    def encode(self, text: str, normalize_digits: bool = False) -> np.ndarray:
        """Map text to token ids; unknown chars -> blank_idx."""
        if normalize_digits:
            text = "".join("0" if c.isdigit() else c for c in text)
        return np.array(
            [self.tok_to_id.get(c, self.blank_idx) for c in text], dtype=np.int32
        )

    def one_hot_matrix(self, text: str) -> np.ndarray:
        """[len(text), n_token] one-hot rows (unknown chars -> all-zero row),
        mirroring transform_from_charset (funsd_preprocessing_word_level.py:50-57)."""
        mat = np.zeros((len(text), self.n_token), dtype=np.float32)
        for i, c in enumerate(text):
            idx = self.tok_to_id.get(c)
            if idx is not None:
                mat[i, idx] = 1.0
        return mat
