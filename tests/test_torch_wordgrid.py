"""The port's word-grid data side (msau_tpu_torch.data.wordgrid) against
the JAX package's on the CPU: ``preprocess_funsd_dir`` on the FUNSD fixture
and on seeded synthetic FUNSD pages, ``wordgrid_programs`` box for box, the
rasterized input / label / valid grids exactly, the per-cell features
(``bow_features`` exactly, ``char_ngram_features`` and the sentence
embedding's fallback within 1e-6), and the pickles: the port's round trip
and a pickle the JAX package wrote.
"""

import collections
import dataclasses
import json
import os
import pickle

import numpy as np
import pytest

from msau_tpu.data import wordgrid as owg
from msau_tpu.data.charset import Charset as OCharset
from msau_tpu_torch.data import wordgrid as wg
from msau_tpu_torch.data.charset import Charset

FIX = os.path.join(os.path.dirname(__file__), "fixtures")
LABELS = ("question", "answer", "header", "other")


def write_funsd_pages(dirname, seed, n_pages=2, n_lines=9):
    """Seeded synthetic FUNSD ``form`` pages: lines of 1-4 words (some with
    an empty text), random labels and links."""
    rng = np.random.default_rng(seed)
    for p in range(n_pages):
        form = []
        for i in range(n_lines):
            x, y = int(rng.integers(20, 500)), int(rng.integers(20, 700))
            h = int(rng.integers(9, 30))
            words, wx = [], x
            for _ in range(int(rng.integers(1, 5))):
                n = int(rng.integers(0, 8))
                text = "".join(rng.choice(list("abcXYZ019:$-"), n))
                ww = max(4, n * int(rng.integers(5, 12)))
                words.append({"box": [wx, y, wx + ww, y + h], "text": text})
                wx += ww + int(rng.integers(3, 12))
            form.append({"id": i, "box": [x, y, wx, y + h],
                         "text": " ".join(w["text"] for w in words),
                         "label": LABELS[int(rng.integers(0, 4))],
                         "linking": [[i, int(rng.integers(0, n_lines))]],
                         "words": words})
        with open(os.path.join(dirname, f"page_{seed}_{p}.json"), "w") as f:
            json.dump({"form": form}, f)


@pytest.fixture(scope="module", params=["fixture", "synthetic"])
def pages(request, tmp_path_factory):
    """(port examples, port charset, JAX examples, JAX charset)."""
    d = FIX
    if request.param == "synthetic":
        d = str(tmp_path_factory.mktemp("funsd"))
        write_funsd_pages(d, seed=5)
    exs, corpus = wg.preprocess_funsd_dir(d)
    oexs, ocorpus = owg.preprocess_funsd_dir(d)
    assert corpus == ocorpus
    return exs, Charset.from_corpus(corpus), oexs, OCharset.from_corpus(ocorpus)


def _example_dict(ex):
    return {k: (v.tolist() if isinstance(v, np.ndarray) else v)
            for k, v in dataclasses.asdict(ex).items()}


def test_preprocess_matches_jax(pages):
    exs, cs, oexs, ocs = pages
    assert len(exs) == len(oexs) >= 1
    assert cs.chars == ocs.chars
    for a, b in zip(exs, oexs):
        assert _example_dict(a) == _example_dict(b)
        for f in ("line_boxes", "labels", "word_boxes", "word_to_line"):
            assert getattr(a, f).dtype == getattr(b, f).dtype, f


def test_wordgrid_programs_match_jax(pages):
    exs, cs, oexs, ocs = pages
    for a, b in zip(exs, oexs):
        h, w, char, lab = wg.wordgrid_programs(a, cs)
        oh, ow, ochar, olab = owg.wordgrid_programs(b, ocs)
        assert (h, w) == (oh, ow)
        for got, want in ((char, ochar), (lab, olab)):
            np.testing.assert_array_equal(got.boxes, want.boxes)
            np.testing.assert_array_equal(got.values, want.values)


def test_rasterize_wordgrid_matches_jax(pages):
    exs, cs, oexs, ocs = pages
    for a, b in zip(exs, oexs):
        got = wg.rasterize_wordgrid(a, cs, device="cpu")
        want = owg.rasterize_wordgrid(b, ocs)
        assert got.keys() == want.keys()
        for k in want:
            assert got[k].shape == want[k].shape, k
            assert got[k].dtype == want[k].dtype, k
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        assert got["input"].shape[0] % 8 == 0 and got["input"][..., 0].max() == 0


def test_features_match_jax(pages):
    exs, _, _, _ = pages
    texts = [t for ex in exs for t in ex.line_texts] + ["", "Date: 12/03"]
    got, vocab = wg.bow_features(texts)
    want, ovocab = owg.bow_features(texts)
    assert vocab == ovocab
    np.testing.assert_array_equal(got, want)
    np.testing.assert_allclose(wg.char_ngram_features(texts),
                               owg.char_ngram_features(texts), atol=1e-6)
    feats, backend = wg.sentence_embedding_features(texts[:5],
                                                    return_backend=True)
    ofeats, obackend = owg.sentence_embedding_features(texts[:5],
                                                       return_backend=True)
    assert backend == obackend == "char-ngram"
    assert feats.shape == (5, 768)
    np.testing.assert_allclose(feats, ofeats, atol=1e-6)


def test_pickle_round_trip_and_jax_pickle(pages, tmp_path):
    exs, cs, oexs, ocs = pages
    mine = tmp_path / "port.pkl"
    wg.save_preprocessed(str(mine), exs, cs)
    back, bcs = wg.load_preprocessed(str(mine))
    assert bcs.chars == cs.chars
    assert [_example_dict(e) for e in back] == [_example_dict(e) for e in exs]
    theirs = tmp_path / "jax.pkl"
    owg.save_preprocessed(str(theirs), oexs, ocs)
    assert b"msau_tpu.data.wordgrid" in theirs.read_bytes()
    back, bcs = wg.load_preprocessed(str(theirs))
    assert all(type(e) is wg.WordGridExample for e in back)
    assert bcs.chars == ocs.chars
    assert [_example_dict(e) for e in back] == [_example_dict(e) for e in oexs]


def test_load_preprocessed_refuses_other_classes(tmp_path):
    p = tmp_path / "bad.pkl"
    with open(p, "wb") as f:
        pickle.dump({"examples": [collections.OrderedDict()],
                     "charset": "ab"}, f)
    with pytest.raises(pickle.UnpicklingError):
        wg.load_preprocessed(str(p))
