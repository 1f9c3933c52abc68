"""The port's feature-grid data side (msau_tpu_torch.data.featgrid) against
the JAX package's on the CPU: ``cell_unit_layout``, ``cell_index_programs``
box for box in the three loader styles, ``gather_features``, and
``rasterize_feature_example`` on the FUNSD fixture and on seeded synthetic
FUNSD pages in all three styles, with char-ngram and bag-of-words
features: label and valid grids exact, the feature grid exact (a gather of
the same f32 rows).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_wordgrid import FIX, write_funsd_pages

from msau_tpu.data import featgrid as ofg
from msau_tpu_torch.data import featgrid as fg
from msau_tpu_torch.data import wordgrid as wg

STYLES = ("box", "box_mask_px_label", "px")


@pytest.fixture(scope="module", params=["fixture", "synthetic"])
def examples(request, tmp_path_factory):
    d = FIX
    if request.param == "synthetic":
        d = str(tmp_path_factory.mktemp("funsd"))
        write_funsd_pages(d, seed=9)
    return wg.preprocess_funsd_dir(d)[0]


@pytest.mark.parametrize("style", STYLES)
def test_cell_index_programs_match_jax(examples, style):
    for ex in examples:
        assert fg.cell_unit_layout(ex.line_boxes) == \
            ofg.cell_unit_layout(ex.line_boxes)
        for labels in (ex.labels, None):
            got = fg.cell_index_programs(ex.line_boxes, labels, style=style)
            want = ofg.cell_index_programs(ex.line_boxes, labels, style=style)
            assert got[:2] == want[:2]
            for a, b in zip(got[2:], want[2:]):
                np.testing.assert_array_equal(a.boxes, b.boxes)
                np.testing.assert_array_equal(a.values, b.values)


def test_gather_features_matches_jax():
    rng = np.random.default_rng(0)
    idx = rng.integers(0, 6, (7, 9)).astype(np.int32)
    feats = rng.standard_normal((5, 4)).astype(np.float32)
    got = fg.gather_features(torch.from_numpy(idx), torch.from_numpy(feats))
    want = ofg.gather_features(jnp.asarray(idx), jnp.asarray(feats))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("features", ["char_ngram", "bow"])
@pytest.mark.parametrize("style", STYLES)
def test_rasterize_feature_example_matches_jax(examples, style, features):
    for ex in examples:
        if features == "bow":
            feats = wg.bow_features(ex.line_texts)[0]
        else:
            feats = wg.char_ngram_features(ex.line_texts, dim=32)
        got = fg.rasterize_feature_example(ex, feats, style=style, device="cpu")
        want = ofg.rasterize_feature_example(ex, feats, style=style)
        assert got.keys() == want.keys()
        for k in want:
            assert got[k].shape == want[k].shape and got[k].dtype == want[k].dtype
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_rasterize_feature_example_checks_counts(examples):
    ex = examples[0]
    with pytest.raises(ValueError, match="feature vectors"):
        fg.rasterize_feature_example(
            ex, np.zeros((len(ex.line_boxes) + 1, 3), np.float32), device="cpu")
