"""Multiclass CCL parity: the port's labelling against the TPU kernel
(connected_components_multiclass_pallas, interpret mode on the CPU) on the
maps of tests/test_ops.py, after asserting that the JAX output is a
converged fixpoint (the port has no sweep cap; the TPU kernel does).  A
maze map is held against scipy.  Integer labels: exact equality."""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.ndimage as ndi
import torch

from msau_tpu.ops.ccl import _sweep_multiclass, connected_components_multiclass_pallas
from msau_tpu_torch.ops.ccl import (
    connected_components_multiclass,
    connected_components_multiclass_cuda,
    connected_components_multiclass_plain,
)
from msau_tpu_torch.utils.kernel_inputs import ccl_map


def _test_ops_maps():
    """The blobby and noisy maps of test_ops.py::test_ccl_multiclass_pallas_matches_xla."""
    rng = np.random.default_rng(0)
    maps = []
    for h, w in ((64, 128), (32, 256)):
        coarse = rng.integers(0, 4, (h // 8, w // 8))
        maps.append((np.repeat(np.repeat(coarse, 8, 0), 8, 1).astype(np.int32), 64))
        maps.append((rng.integers(0, 3, (h, w)).astype(np.int32), 128))
    return maps


def _scipy_labels(cls):
    """Per-class 4-connected scipy labels in the root convention:
    (linear index of the component's raster-first pixel) + 1."""
    out = np.zeros(cls.shape, np.int64)
    for c in np.unique(cls[cls > 0]):
        lab, n = ndi.label(cls == c)
        for i in range(1, n + 1):
            m = lab == i
            out[m] = np.flatnonzero(m)[0] + 1
    return out


@pytest.mark.parametrize("case", range(4))
def test_ccl_matches_pallas_fixpoint(case):
    cls, iters = _test_ops_maps()[case]
    want = np.asarray(connected_components_multiclass_pallas(
        jnp.asarray(cls), max_iters=iters))
    # the reference output must be converged for the comparison to hold
    again = np.asarray(_sweep_multiclass(jnp.asarray(want), jnp.asarray(cls)))
    np.testing.assert_array_equal(again, want)
    got = connected_components_multiclass(torch.from_numpy(cls))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_maze_matches_scipy():
    cls = ccl_map("maze", 48, 40, np.random.default_rng(1))
    got = connected_components_multiclass_plain(torch.from_numpy(cls))
    np.testing.assert_array_equal(got.numpy(), _scipy_labels(cls))


def test_background_and_negative_classes_are_zero():
    cls = np.array([[0, 1, 1], [-1, -1, 1], [2, 0, 1]], np.int32)
    got = connected_components_multiclass(torch.from_numpy(cls)).numpy()
    np.testing.assert_array_equal(got, [[0, 2, 2], [0, 0, 2], [7, 0, 2]])


def test_cuda_wrapper_rejects_cpu_tensor():
    with pytest.raises(ValueError, match="CUDA"):
        connected_components_multiclass_cuda(torch.zeros((4, 4), dtype=torch.int32))


@pytest.mark.parametrize("kind,h,w", [("noisy", 1, 300), ("noisy", 300, 1),
                                      ("checker", 40, 56),
                                      ("one_class", 48, 40)])
def test_plain_matches_scipy_on_edge_maps(kind, h, w):
    """One row and one column (no tile of the card kernel is full), every
    pixel its own component, and one component over the whole map."""
    cls = ccl_map(kind, h, w, np.random.default_rng(2))
    got = connected_components_multiclass_plain(torch.from_numpy(cls))
    np.testing.assert_array_equal(got.numpy(), _scipy_labels(cls))


@pytest.mark.parametrize("kinds,h,w", [(("blobby", "noisy", "maze"), 40, 56),
                                       (("noisy", "maze"), 33, 17),
                                       (("one_class",), 9, 70)])
def test_batched_plain_matches_each_page(kinds, h, w):
    """A [B, H, W] stack labels each page on its own: page-local labels,
    the same as the page's [H, W] call and scipy's."""
    rng = np.random.default_rng(3)
    stack = np.stack([ccl_map(k, h, w, rng) for k in kinds])
    got = connected_components_multiclass(torch.from_numpy(stack))
    assert got.shape == stack.shape and got.dtype == torch.int32
    for i, cls in enumerate(stack):
        one = connected_components_multiclass_plain(torch.from_numpy(cls))
        assert torch.equal(got[i], one)
        np.testing.assert_array_equal(got[i].numpy(), _scipy_labels(cls))


def _mask_with_ties():
    """Blobs of a boolean mask, two pairs with equal bbox areas."""
    m = np.zeros((24, 40), bool)
    m[1:4, 1:5] = True        # area 12
    m[6:9, 10:14] = True      # area 12, a tie with the first
    m[12:20, 3:6] = True      # area 24
    m[2:8, 20:24] = True      # area 24, a tie
    m[15, 30:39] = True       # area 9
    m[20:23, 30:31] = True    # area 3
    return m


@pytest.mark.parametrize("case", ["ties", "random"])
def test_single_map_functions_match_jax(case):
    """connected_components_jax, component_stats and top_k_components
    against the JAX package's (XLA) functions, with equal-area ties going to
    the lower root as lax.top_k breaks them."""
    from msau_tpu.ops.ccl import component_stats as jax_stats
    from msau_tpu.ops.ccl import connected_components_jax as jax_ccl
    from msau_tpu.ops.ccl import top_k_components as jax_top_k
    from msau_tpu_torch.ops.ccl import (
        component_stats,
        connected_components_jax,
        top_k_components,
    )

    mask = (_mask_with_ties() if case == "ties"
            else np.random.default_rng(4).random((30, 50)) < 0.45)
    want = np.asarray(jax_ccl(jnp.asarray(mask), max_iters=256))
    got = connected_components_jax(torch.from_numpy(mask))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(want, _scipy_labels(mask.astype(np.int32)))
    wstats = jax_stats(jnp.asarray(want))
    gstats = component_stats(got)
    assert set(gstats) == set(wstats)
    for key in wstats:
        assert gstats[key].dtype == torch.int32, key
        np.testing.assert_array_equal(gstats[key].numpy(),
                                      np.asarray(wstats[key]), err_msg=key)
    for k in (4, 8):
        wtop = jax_top_k(wstats, k=k)
        gtop = top_k_components(gstats, k=k)
        assert set(gtop) == set(wtop)
        for key in wtop:
            np.testing.assert_array_equal(gtop[key].numpy(),
                                          np.asarray(wtop[key]), err_msg=key)
    if case == "ties":
        top = top_k_components(gstats, k=8)
        assert top["bbox_area"].tolist()[:4] == [24, 24, 12, 12]
        assert top["root"].tolist()[:4] == sorted(top["root"].tolist()[:2]) \
            + sorted(top["root"].tolist()[2:4])
        assert not top["valid"][6:].any()
