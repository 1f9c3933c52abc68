"""The port's morphology (ops/morphology.py) against the JAX package's
(XLA) functions on the same seeded maps: the rectangular filters at odd and
even window sizes (scipy's origin-0, left-heavy geometry with cval=0
borders) on float, int and bool maps, Zhang-Suen skeletonization, ``skelet``
and ``threshold_and_upscale_map``.  Filters, skeletons and masks: exact.
The bilinear resize: within 1e-3 on values up to 255 (f32 sums in another
order; torch's antialiased path, taken where an axis shrinks, weights the
taps in its own order), and the thresholded map exact wherever the resized
value lies at least 1e-3 from the threshold."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from msau_tpu.ops import morphology as jm
from msau_tpu_torch.ops import morphology as tm
from msau_tpu_torch.ops import r_closing, r_dilation, r_erosion, r_opening

SIZES = [3, 2, 4, (1, 3), (2, 5), (4, 1)]
RESIZE_TOL = 1e-3


def _maps(seed):
    rng = np.random.default_rng(seed)
    return {
        "float": rng.normal(0, 1, (2, 23, 31)).astype(np.float32),
        "int": rng.integers(-5, 9, (23, 31)).astype(np.int32),
        "bool": rng.random((23, 31)) < 0.4,
    }


@pytest.mark.parametrize("size", SIZES)
@pytest.mark.parametrize("op", ["r_dilation", "r_erosion", "r_opening",
                                "r_closing"])
def test_rect_filters_match_jax(op, size):
    ours = {"r_dilation": r_dilation, "r_erosion": r_erosion,
            "r_opening": r_opening, "r_closing": r_closing}[op]
    for name, x in _maps(0).items():
        want = np.asarray(getattr(jm, op)(jnp.asarray(x), size))
        got = ours(torch.from_numpy(x), size)
        assert got.numpy().dtype == want.dtype, name
        np.testing.assert_array_equal(got.numpy(), want, err_msg=name)


def _blobs(seed, h=40, w=52):
    rng = np.random.default_rng(seed)
    m = np.zeros((h, w), bool)
    for _ in range(6):
        y, x = rng.integers(0, h - 6), rng.integers(0, w - 6)
        m[y:y + rng.integers(3, 14), x:x + rng.integers(3, 20)] = True
    return m


@pytest.mark.parametrize("seed,max_iters", [(0, 64), (1, 64), (2, 1)])
def test_skeletonize_matches_jax(seed, max_iters):
    m = _blobs(seed)
    want = np.asarray(jm.skeletonize(jnp.asarray(m), max_iters=max_iters))
    got = tm.skeletonize(torch.from_numpy(m), max_iters=max_iters)
    assert got.dtype == torch.bool
    np.testing.assert_array_equal(got.numpy(), want)
    assert not (want & ~m).any() and want.sum() < m.sum()


@pytest.mark.parametrize("expand,horizontal,iters", [(False, True, 1),
                                                     (True, True, 1),
                                                     (True, False, 2)])
def test_skelet_matches_jax(expand, horizontal, iters):
    img = _blobs(3).astype(np.float32) * 200 + np.random.default_rng(3).normal(
        0, 20, (40, 52)).astype(np.float32)
    want = np.asarray(jm.skelet(jnp.asarray(img), thres=150, expand=expand,
                                expand_horizontal=horizontal, iters=iters))
    got = tm.skelet(torch.from_numpy(img), thres=150, expand=expand,
                    expand_horizontal=horizontal, iters=iters)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("src,dst", [((64, 64), (30, 45)),    # shrinks
                                     ((40, 40), (97, 130)),   # grows
                                     ((64, 40), (30, 97)),    # each way
                                     ((33, 50), (33, 50))])   # unchanged
def test_threshold_and_upscale_matches_jax(src, dst):
    gt = np.random.default_rng(5).uniform(0, 255, src).astype(np.float32)
    want = np.asarray(jax.image.resize(jnp.asarray(gt), dst, "bilinear"))
    got = tm.resize_bilinear(torch.from_numpy(gt), dst)
    assert got.shape == dst
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=RESIZE_TOL)
    mask = tm.threshold_and_upscale_map(dst, torch.from_numpy(gt),
                                        threshold=150).numpy()
    wmask = np.asarray(jm.threshold_and_upscale_map(dst, jnp.asarray(gt),
                                                    threshold=150))
    clear = np.abs(want - 150) >= 1e-3
    assert clear.mean() > 0.99
    np.testing.assert_array_equal(mask[clear], wmask[clear])
    sk = tm.threshold_and_upscale_map(dst, torch.from_numpy(gt),
                                      skeletonize_map=True, threshold=150)
    assert sk.shape == dst and sk.dtype == torch.bool
