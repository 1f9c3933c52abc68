"""Word-level chargrid of the FUNSD path: preprocessing and word-grid
rasterization (port of ``msau_tpu.data.wordgrid``).

  * ``preprocess_funsd_dir``: FUNSD ``form`` JSON -> text-line cells, word
    cells and labels, pickled per split with a shared charset
    (``save_preprocessed`` / ``load_preprocessed``);
  * ``wordgrid_programs`` / ``rasterize_wordgrid``: the grid is in cell
    units (x in the least per-char width, y in the least cell height);
    each word paints its per-char ids, each text line its label + 1.  The
    host builds the box programs; ``ops.paint`` paints them on the device
    of the caller's choice (the paint kernel on a card);
  * ``bow_features``, ``char_ngram_features`` and
    ``sentence_embedding_features``: per-cell feature vectors for the
    feature grid (``data.featgrid``).  The sentence embedding tries a local
    transformers model and falls back to the deterministic char-ngram
    projection of the same width.

Pickles that the JAX package wrote name
``msau_tpu.data.wordgrid.WordGridExample``; ``load_preprocessed`` maps that
name onto this module's class, so ``msau_tpu`` is never imported.
"""

from __future__ import annotations

import glob
import os
import pickle
import zlib
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from msau_tpu_torch.data.charset import Charset
from msau_tpu_torch.data.pages import FUNSD_LABEL_TO_ID, load_funsd_page
from msau_tpu_torch.data.rasterize import BoxProgram, round_up
from msau_tpu_torch.ops.paint import paint_boxes


@dataclass
class WordGridExample:
    """One page in word-grid form (cells in xywh like the reference)."""

    path: str
    line_boxes: np.ndarray    # [L, 4] (x, y, w, h)
    line_texts: List[str]
    labels: np.ndarray        # [L] int label ids
    word_boxes: np.ndarray    # [Nw, 4] (x, y, w, h)
    word_texts: List[str]
    word_to_line: np.ndarray  # [Nw]
    linking: List[List[Tuple[int, int]]]
    ids: List[int]


def preprocess_funsd_dir(
    annotations_dir: str,
    label_to_id: Dict[str, int] = FUNSD_LABEL_TO_ID,
) -> Tuple[List[WordGridExample], str]:
    """FUNSD annotations dir -> examples + corpus text (for the charset)."""
    examples = []
    corpus = []
    for path in sorted(glob.glob(os.path.join(annotations_dir, "*.json"))):
        try:
            page = load_funsd_page(path, label_to_id)
        except (KeyError, ValueError):
            continue  # not a FUNSD 'form' JSON
        lb, lt, lab, wb, wt, w2l, linking, ids = [], [], [], [], [], [], [], []
        for li, line in enumerate(page.lines):
            x1, y1, x2, y2 = line.box
            lb.append([x1, y1, x2 - x1 + 1, y2 - y1 + 1])
            lt.append(line.text)
            lab.append(line.label)
            linking.append(line.linking)
            ids.append(line.id)
            for wrd in line.words:
                wx1, wy1, wx2, wy2 = wrd.box
                wb.append([wx1, wy1, wx2 - wx1 + 1, wy2 - wy1 + 1])
                wt.append(wrd.text)
                w2l.append(li)
        corpus.extend(lt)
        examples.append(
            WordGridExample(
                path=path,
                line_boxes=np.asarray(lb, np.float64),
                line_texts=lt,
                labels=np.asarray(lab, np.int32),
                word_boxes=np.asarray(wb, np.float64) if wb else np.zeros((0, 4)),
                word_texts=wt,
                word_to_line=np.asarray(w2l, np.int32),
                linking=linking,
                ids=ids,
            )
        )
    return examples, " ".join(corpus)


def save_preprocessed(path: str, examples: List[WordGridExample], charset: Charset):
    with open(path, "wb") as f:
        pickle.dump({"examples": examples, "charset": charset.chars}, f)


class _Unpickler(pickle.Unpickler):
    """Reads this module's pickles and the JAX package's: the example class
    by either module name, numpy arrays, and nothing else."""

    _EXAMPLE_MODULES = ("msau_tpu.data.wordgrid", __name__)

    def find_class(self, module, name):
        if name == "WordGridExample" and module in self._EXAMPLE_MODULES:
            return WordGridExample
        if module == "numpy" or module.startswith("numpy."):
            return super().find_class(module, name)
        raise pickle.UnpicklingError(
            f"preprocessed pickle names {module}.{name}, not an example or a "
            "numpy array")


def load_preprocessed(path: str) -> Tuple[List[WordGridExample], Charset]:
    with open(path, "rb") as f:
        blob = _Unpickler(f).load()
    return blob["examples"], Charset(chars=blob["charset"])


# ---------------------------------------------------------------------------
# word-grid rasterization (get_box_mask_box_label_word semantics)
# ---------------------------------------------------------------------------
def wordgrid_programs(ex: WordGridExample, charset: Charset):
    """Char and label box programs in cell-unit grid coordinates ->
    (height, width, char program, label program).

    x-unit = the least positive per-char width over word cells (zero-length
    words take the mean ratio), y-unit = the least cell height; grid size =
    page extent in those units + 1.
    """
    wb = ex.word_boxes
    lb = ex.line_boxes
    if not len(wb):
        raise ValueError(f"{ex.path}: page has no word cells")
    all_b = np.concatenate([wb, lb], 0) if len(lb) else wb
    min_x = float(all_b[:, 0].min())
    min_y = float(all_b[:, 1].min())
    max_x = float((wb[:, 0] + wb[:, 2]).max())
    max_y = float((wb[:, 1] + wb[:, 3]).max())
    min_w = float(wb[:, 2].min())
    min_h = float(wb[:, 3].min())

    ratios = np.array(
        [w / len(t) if len(t) else 0.0 for w, t in zip(wb[:, 2], ex.word_texts)]
    )
    mean_ratio = ratios.mean() if len(ratios) else 1.0
    ratios = np.where(ratios == 0.0, mean_ratio, ratios)
    min_scale = float(ratios.min())

    width = int((max_x - min_x) / min_w) + 1
    height = int((max_y - min_y) / min_h) + 1
    # chars live on the min_scale x-grid, which can exceed the min_w grid
    char_width = int((max_x - min_x) / min_scale) + 1
    grid_w = max(width, char_width)

    char_b, char_v = [], []
    for (x, y, w, h), text in zip(wb, ex.word_texts):
        nx = int((x - min_x) / min_scale)
        ny = int((y - min_y) / min_h)
        nw = max(int(w / min_scale), 1)
        nh = max(int(h / min_h), 1)
        ocr_len = len(text) if len(text) else nw
        pcw = max(int(nw / ocr_len), 1)
        # unknown chars map to 0, the zeroed feature channel
        ids = [charset.tok_to_id.get(c, 0) for c in text]
        for j, cid in enumerate(ids):
            char_b.append((ny, ny + nh, nx + pcw * j, nx + pcw * (j + 1)))
            char_v.append(int(cid))

    lab_b, lab_v = [], []
    for (x, y, w, h), label in zip(lb, ex.labels):
        nx = int((x - min_x) / min_w)
        ny = int((y - min_y) / min_h)
        nw = max(int(w / min_w), 1)
        nh = max(int(h / min_h), 1)
        lab_b.append((ny, ny + nh, nx, nx + nw))
        lab_v.append(int(label) + 1)

    char = BoxProgram.from_lists(char_b, char_v).clipped(height, grid_w)
    lab = BoxProgram.from_lists(lab_b, lab_v).clipped(height, grid_w)
    return height, grid_w, char, lab


def _paint(program: BoxProgram, capacity: int, height: int, width: int,
           device) -> torch.Tensor:
    prog = program.padded(capacity)
    return paint_boxes(torch.from_numpy(prog.boxes).to(device),
                       torch.from_numpy(prog.values).to(device), height, width)


def rasterize_wordgrid(
    ex: WordGridExample,
    charset: Charset,
    pad_multiple: int = 8,
    *,
    device,
) -> Dict[str, np.ndarray]:
    """Paint the word grid on ``device`` -> {"input": [H, W, n_token]
    one-hot (channel 0, background and unknown chars, zeroed), "label":
    [H, W] int32, "valid": [H, W] bool}, numpy; H and W padded to a
    multiple of ``pad_multiple``."""
    h, w, char, lab = wordgrid_programs(ex, charset)
    hb = round_up(h, pad_multiple)
    wb = round_up(w, pad_multiple)
    ids = _paint(char, round_up(max(len(char.values), 1), 512), hb, wb, device)
    label = _paint(lab, round_up(max(len(lab.values), 1), 128), hb, wb, device)
    onehot = torch.nn.functional.one_hot(ids.long(), charset.n_token).float()
    onehot[..., 0] = 0.0
    rows = np.arange(hb)[:, None]
    cols = np.arange(wb)[None, :]
    return {
        "input": onehot.cpu().numpy(),
        "label": label.cpu().numpy(),
        "valid": (rows < h) & (cols < w),
    }


# ---------------------------------------------------------------------------
# per-cell features (BERT / BOW loaders)
# ---------------------------------------------------------------------------
def bow_features(texts: Sequence[str], vocab: Optional[Dict[str, int]] = None):
    """Bag-of-words per text -> ([len(texts), |vocab|] counts, vocab)."""
    if vocab is None:
        vocab = {}
        for t in texts:
            for tok in t.lower().split():
                vocab.setdefault(tok, len(vocab))
    mat = np.zeros((len(texts), max(len(vocab), 1)), np.float32)
    for i, t in enumerate(texts):
        for tok in t.lower().split():
            j = vocab.get(tok)
            if j is not None:
                mat[i, j] += 1.0
    return mat, vocab


def char_ngram_features(
    texts: Sequence[str],
    dim: int = 768,
    n_buckets: int = 4096,
    ngram_sizes: Tuple[int, ...] = (1, 2, 3),
) -> np.ndarray:
    """Deterministic character-ngram embedding: crc32-bucketed char 1/2/3-
    gram counts projected to ``dim`` by a fixed Gaussian matrix (``rng
    777``) and L2-normalised (crc32, unlike ``hash``, is the same in every
    process)."""
    counts = np.zeros((len(texts), n_buckets), np.float32)
    for i, t in enumerate(texts):
        s = f"\x02{t}\x03"  # boundary markers
        for n in ngram_sizes:
            for j in range(len(s) - n + 1):
                b = zlib.crc32(s[j : j + n].encode("utf-8")) % n_buckets
                counts[i, b] += 1.0
    proj = np.random.default_rng(777).standard_normal(
        (n_buckets, dim)
    ).astype(np.float32) / np.sqrt(n_buckets)
    feats = counts @ proj
    norm = np.linalg.norm(feats, axis=1, keepdims=True)
    return feats / np.maximum(norm, 1e-8)


def sentence_embedding_features(
    texts: Sequence[str],
    model_name: str = "bert-base-nli-mean-tokens",
    dim: int = 768,
    return_backend: bool = False,
):
    """Sentence-embedding features: a local transformers model's mean token
    state when one is on disk (``local_files_only``), else
    :func:`char_ngram_features` of the same width.  ``return_backend=True``
    also returns which of the two made them."""
    try:  # pragma: no cover - depends on a local model
        from transformers import AutoModel, AutoTokenizer

        tok = AutoTokenizer.from_pretrained(model_name, local_files_only=True)
        mdl = AutoModel.from_pretrained(model_name, local_files_only=True)
        with torch.no_grad():
            enc = tok(list(texts), padding=True, truncation=True, return_tensors="pt")
            out = mdl(**enc).last_hidden_state.mean(1)
        feats, backend = out.numpy(), model_name
    except Exception:
        # no local model (or no transformers): the documented fallback
        feats, backend = char_ngram_features(texts, dim=dim), "char-ngram"
    return (feats, backend) if return_backend else feats
