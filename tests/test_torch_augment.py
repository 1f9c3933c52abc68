"""The port's device augmentation (msau_tpu_torch.data.augment) against the
JAX package's on the CPU, from the same numpy inputs and Generator seeds.

* ``apply_affine``: exact at ``order`` 0; at ``order`` 1 within one f32
  eps of the largest |value| (the JAX package's compiled CPU program fuses
  each tap's multiply into the sum; the port sums the taps in f32 as
  separate products and sums, so that every device gives the same
  values), on its own canvas and with ``out_shape`` (off-canvas taps).
  A 90° rotation of an even-sized stack is exact at both orders.  The
  source coordinates are JAX's to the bit: the port fuses their
  multiply-adds as the compiled program does.
* ``apply_elastic``: exact at ``order`` 0; at ``order`` 1 within one f32
  ulp of each source coordinate (two ulps of the largest coordinate times
  the largest value in all: the bilinear weights move by at most the
  coordinate's change), and equal at most pixels.  The coordinates move
  because the upsampled fields differ from JAX's in the last bits (the
  compiled CPU program computes its cubic weights with fused
  multiply-adds the port does not reproduce).  The cubic upsampling of
  the coarse fields is ``jax.image.resize``'s (Keys a = -0.5,
  renormalised at the borders) to 2e-6, with coarse grids that do not
  divide the page.
* ``rebinarize_one_hot``: exact.
* ``augment_example`` with each flag alone and all together, and
  ``augment_stack``: ids exact; labels, valid and the binarised planes
  exact except at pixels whose JAX value before the threshold lies within
  the window of 0.25 (0.5 for valid): 1e-6 without the elastic warp, and
  with it the elastic bound above, two ulps of the largest coordinate
  (the soft planes lie in [0, 1]); each case prints how many it excused.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from msau_tpu.data import augment as ja
from msau_tpu_torch.data import augment as ta

N_TOKEN, N_ID, N_CLASSES = 6, 2, 4
NEAR = 1e-6


def _near(shape, elastic):
    """The near-threshold window: 1e-6, or the elastic warp's bound on a
    soft value's change, two ulps of the largest coordinate."""
    return (2 * float(np.spacing(np.float32(max(shape)))) if elastic
            else NEAR)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread for this file: its CPU runs stay fast when the
    suite's other workers load every core (OpenMP's barriers spin)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _example(seed, h=64, w=80):
    """One-hot token planes (rectangles of random ids), two id planes
    (ids 0-8), a class label of rectangles and a valid page region."""
    rng = np.random.default_rng(seed)
    ids = np.zeros((h, w), np.int32)
    label = np.zeros((h, w), np.int32)
    lines = np.zeros((h, w), np.float32)
    for _ in range(12):
        y, x = rng.integers(0, h - 4), rng.integers(0, w - 6)
        rh, rw = rng.integers(2, 9), rng.integers(3, 20)
        ids[y:y + rh, x:x + rw] = rng.integers(1, N_TOKEN)
        label[y:y + rh, x:x + rw] = rng.integers(1, N_CLASSES)
        lines[min(y + rh, h) - 1, x:x + rw] = rng.integers(1, 9)
    sep = np.where(ids > 0, (np.arange(w)[None, :] % 3 == 0) * ids, 0)
    onehot = (ids[..., None] == np.arange(N_TOKEN)).astype(np.float32)
    inp = np.concatenate([onehot, lines[..., None], sep[..., None]
                          .astype(np.float32)], -1)
    valid = np.zeros((h, w), bool)
    valid[:h - 5, :w - 7] = True
    return inp, label, valid


def _jax_soft(inp, label, valid, seed, *, affine=False, elastic=False,
              rotate_angle=None, rot90_k=0, page_hw=None, out_hw=None,
              **kw):
    """The JAX augment_example's stacks before thresholding (its steps, in
    its order, with JAX's own functions and a Generator of ``seed``)."""
    rng = np.random.default_rng(seed)
    n_soft = inp.shape[-1] - N_ID
    soft = jnp.concatenate([jnp.asarray(inp[..., :n_soft]),
                            jax.nn.one_hot(label, N_CLASSES, dtype=jnp.float32),
                            jnp.asarray(valid, jnp.float32)[..., None]], -1)
    h, w = soft.shape[:2]
    if affine:
        m = jnp.asarray(ja.random_affine_matrix((h, w), kw.get(
            "affine_value", 0.025), rng))
        soft = ja.apply_affine(soft, m, order=1)
    if elastic:
        ex, ey = kw.get("elastic_value_x", 2e-4), kw.get("elastic_value_y", 2e-4)
        cdx, cdy = ja.elastic_fields((h, w), ex, ey, rng)
        soft = ja.apply_elastic(soft, jnp.asarray(cdx), jnp.asarray(cdy),
                                jnp.float32(ex * min(h, w)),
                                jnp.float32(ey * min(h, w)), order=1)
    if rotate_angle is not None:
        rot_hw = ja.rotated_canvas(*page_hw, rotate_angle)
        m = jnp.asarray(ja.rotation_matrix(page_hw, rot_hw, rotate_angle))
        soft = ja.apply_affine(soft, m, order=1, out_shape=out_hw)
    if rot90_k:
        soft = jnp.rot90(soft, rot90_k, axes=(0, 1))
    return np.asarray(soft), n_soft


def _compare(got, want, soft, n_soft, label, near=NEAR):
    """Ids exact; the rest exact outside the pixels within ``near`` of
    the threshold -> the number of excused values."""
    gi, gl, gv = (t.numpy() for t in got)
    wi, wl, wv = (np.asarray(t) for t in want)
    assert gi.dtype == wi.dtype and gl.dtype == wl.dtype and gv.dtype == wv.dtype
    # the replica of the JAX steps gives the JAX outputs
    np.testing.assert_array_equal(wi[..., :n_soft], soft[..., :n_soft] > 0.25)
    np.testing.assert_array_equal(wv, soft[..., -1] > 0.5)
    np.testing.assert_array_equal(gi[..., n_soft:], wi[..., n_soft:])
    near_tok = np.abs(soft[..., :n_soft] - 0.25) <= near
    near_lab = (np.abs(soft[..., n_soft:n_soft + N_CLASSES] - 0.25)
                <= near).any(-1)
    near_val = np.abs(soft[..., -1] - 0.5) <= near
    np.testing.assert_array_equal(gi[..., :n_soft][~near_tok],
                                  wi[..., :n_soft][~near_tok])
    np.testing.assert_array_equal(gl[~near_lab], wl[~near_lab])
    np.testing.assert_array_equal(gv[~near_val], wv[~near_val])
    excused = int(near_tok.sum() + near_lab.sum() + near_val.sum())
    print(f"{label}: {excused} values within {near:.3g} of the threshold "
          "excused")
    return excused


def _assert_warp(got, want, order, inp):
    """Nearest: exact; bilinear: within one f32 eps of max |inp|."""
    if order == 0:
        np.testing.assert_array_equal(got, want)
        return
    eps = float(np.finfo(np.float32).eps)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=eps * np.abs(inp).max())


@pytest.mark.parametrize("order", [0, 1])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_apply_affine_matches_jax(order, seed):
    inp, _, _ = _example(seed)
    m = ja.random_affine_matrix((64, 80), 0.05, np.random.default_rng(seed))
    for out_shape in (None, (96, 72)):
        want = np.asarray(ja.apply_affine(jnp.asarray(inp), jnp.asarray(m),
                                          order=order, out_shape=out_shape))
        got = ta.apply_affine(torch.from_numpy(inp), m, order=order,
                              out_shape=out_shape).numpy()
        _assert_warp(got, want, order, inp)
    # a shift that puts the taps of the last rows and first columns off
    # the canvas
    shift = np.float32([[1, 0, 30.5], [0, 1, -25.25]])
    want = np.asarray(ja.apply_affine(jnp.asarray(inp), jnp.asarray(shift),
                                      order=order))
    got = ta.apply_affine(torch.from_numpy(inp), shift, order=order).numpy()
    _assert_warp(got, want, order, inp)
    assert (want[34:] == 0).all() and (want[:, :25] == 0).all()


@pytest.mark.parametrize("order", [0, 1])
@pytest.mark.parametrize("angle", [90.0, -90.0, 180.0])
def test_apply_affine_right_angles_exact(order, angle):
    """An even-sized stack rotated by right angles: exactly JAX's."""
    inp, _, _ = _example(3)
    rot = ja.rotated_canvas(64, 80, angle)
    m = ja.rotation_matrix((64, 80), rot, angle)
    want = np.asarray(ja.apply_affine(jnp.asarray(inp), jnp.asarray(m),
                                      order=order, out_shape=rot))
    got = ta.apply_affine(torch.from_numpy(inp), m, order=order,
                          out_shape=rot).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("shape,coarse", [((64, 80), (2, 3)),
                                          ((100, 75), (4, 3)),
                                          ((128, 128), (5, 5)),
                                          ((40, 56), (5, 7))])
def test_resize_cubic_matches_jax(shape, coarse):
    field = np.random.default_rng(sum(shape)).uniform(
        -1, 1, coarse).astype(np.float32)
    want = np.asarray(jax.image.resize(jnp.asarray(field), shape,
                                       method="cubic"))
    got = ta.resize_cubic(torch.from_numpy(field), shape).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-6)
    if coarse == (5, 7):   # torch's bicubic is another function
        other = torch.nn.functional.interpolate(
            torch.from_numpy(field)[None, None], size=shape, mode="bicubic",
            align_corners=False)[0, 0].numpy()
        assert np.abs(other - want).max() > 1e-2


@pytest.mark.parametrize("order", [0, 1])
@pytest.mark.parametrize("shape,value", [((64, 80), 2e-4), ((64, 80), 0.02),
                                         ((100, 75), 0.01)])
def test_apply_elastic_matches_jax(order, shape, value):
    inp, _, _ = _example(5, *shape)
    cdx, cdy = ja.elastic_fields(shape, value, value,
                                 np.random.default_rng(7))
    alpha = np.float32(value * min(shape))
    want = np.asarray(ja.apply_elastic(
        jnp.asarray(inp), jnp.asarray(cdx), jnp.asarray(cdy),
        jnp.float32(alpha), jnp.float32(alpha), order=order))
    got = ta.apply_elastic(torch.from_numpy(inp), cdx, cdy, alpha, alpha,
                           order=order).numpy()
    if order == 0:
        np.testing.assert_array_equal(got, want)
        return
    ulp = float(np.spacing(np.float32(max(shape))))
    diff = np.abs(got - want)
    print(f"elastic {shape} {value}: max |diff| {diff.max():.3e}, "
          f"{(diff > 0).mean():.4f} of values differ")
    assert diff.max() <= 2 * ulp * np.abs(inp).max()
    assert (diff > 0).mean() < 0.05


@pytest.mark.parametrize("seed", [0, 1])
def test_rebinarize_one_hot_matches_jax(seed):
    rng = np.random.default_rng(seed)
    tgt = rng.random((40, 50, 5)).astype(np.float32) * 0.6
    tgt[rng.random((40, 50)) < 0.1] = 0.25
    for dom in (1, 3):
        want = np.asarray(ja.rebinarize_one_hot(jnp.asarray(tgt),
                                                dominating_channel=dom))
        got = ta.rebinarize_one_hot(torch.from_numpy(tgt),
                                    dominating_channel=dom).numpy()
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


CASES = {
    "affine": dict(affine=True, affine_value=0.05),
    "elastic": dict(elastic=True, elastic_value_x=0.02,
                    elastic_value_y=0.015),
    "rotate": dict(rotate_angle=13.0),
    "rot90": dict(rot90_k=3),
    "all": dict(affine=True, elastic=True, rotate_angle=-17.5, rot90_k=1),
    "right_angle": dict(rotate_angle=90.0),
}


@pytest.mark.parametrize("case", list(CASES))
def test_augment_example_matches_jax(case):
    kw = dict(CASES[case])
    inp, label, valid = _example(11)
    if "rotate_angle" in kw:
        kw.update(page_hw=(59, 73), out_hw=(96, 112) if
                  kw["rotate_angle"] % 90 else (80, 64))
    seed = 20260816
    want = ja.augment_example(jnp.asarray(inp), jnp.asarray(label),
                              jnp.asarray(valid), N_CLASSES,
                              np.random.default_rng(seed), **kw)
    got = ta.augment_example(torch.from_numpy(inp), torch.from_numpy(label),
                             torch.from_numpy(valid), N_CLASSES,
                             np.random.default_rng(seed), **kw)
    soft, n_soft = _jax_soft(inp, label, valid, seed, **kw)
    excused = _compare(got, want, soft, n_soft, case,
                       _near(inp.shape[:2], kw.get("elastic", False)))
    if case == "right_angle":
        assert excused == 0
        rot = np.rot90(label[:59, :73])
        assert got[1].shape == (80, 64)
        np.testing.assert_array_equal(got[1].numpy()[:73, :59], rot)


def test_augment_stack_matches_jax():
    inp, _, _ = _example(4)
    stack = inp[..., :N_TOKEN]
    h, w = stack.shape[:2]
    for kw in (dict(affine=True), dict(elastic=True, elastic_value_x=0.01,
                                       elastic_value_y=0.01),
               dict(affine=True, elastic=True), dict()):
        want = np.asarray(ja.augment_stack(jnp.asarray(stack),
                                           np.random.default_rng(9), **kw))
        got = ta.augment_stack(torch.from_numpy(stack),
                               np.random.default_rng(9), **kw).numpy()
        # the JAX steps before the threshold, from the same draws
        rng, soft = np.random.default_rng(9), jnp.asarray(stack)
        if kw.get("affine"):
            soft = ja.apply_affine(soft, jnp.asarray(
                ja.random_affine_matrix((h, w), 0.025, rng)))
        if kw.get("elastic"):
            ex, ey = kw.get("elastic_value_x", 2e-4), kw.get(
                "elastic_value_y", 2e-4)
            cdx, cdy = ja.elastic_fields((h, w), ex, ey, rng)
            soft = ja.apply_elastic(soft, jnp.asarray(cdx), jnp.asarray(cdy),
                                    jnp.float32(ex * min(h, w)),
                                    jnp.float32(ey * min(h, w)))
        soft = np.asarray(soft)
        if not kw:
            np.testing.assert_array_equal(got, want)
            continue
        np.testing.assert_array_equal(want, soft > 0.25)
        near = np.abs(soft - 0.25) <= _near((h, w), kw.get("elastic", False))
        np.testing.assert_array_equal(got[~near], want[~near])
        print(f"augment_stack {sorted(kw)}: {int(near.sum())} values "
              "excused")
