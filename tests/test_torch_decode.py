"""Decode parity: the port's decode_fields_device against the JAX one on the
same probabilities, line-id and char-id maps.  Integer and boolean tables:
exact equality.  The scenes are rectangles, which the JAX labelling
converges on in a few sweeps, far inside its cap (the port's has none)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from msau_tpu.infer.decode import decode_fields_device as jax_decode
from msau_tpu.infer.decode import pack_decode_out as jax_pack
from msau_tpu_torch.infer.decode import (
    decode_fields_device,
    pack_decode_out,
    unpack_decode_out,
)
from msau_tpu_torch.ops.ccl import top_k_lower_index

N_CLASS = 9
MULTILINE = (5,)


def scene(h, w, seed):
    """Rectangles of classes 2..8 on background, as noisy probabilities,
    plus line-id / char-id planes.  Class 5 (multi-line) gets three
    equal-size blocks, class 3 two: equal-area ties for top_k / argmax."""
    rng = np.random.default_rng(seed)
    cls = np.zeros((h, w), np.int64)
    line_id = np.zeros((h, w), np.int32)
    char_id = np.zeros((h, w), np.int32)
    rects = [(5, 4, 4), (5, 20, 40), (5, 36, 10), (3, 4, 60), (3, 30, 70)]
    rects += [(int(rng.integers(2, N_CLASS)), int(rng.integers(0, h - 8)),
               int(rng.integers(0, w - 20))) for _ in range(6)]
    for i, (c, y, x) in enumerate(rects):
        cls[y:y + 6, x:x + 16] = c
        line_id[y:y + 6, x:x + 18] = i + 1
        char_id[y:y + 6, x:x + 18] = np.arange(1, 19)[None, :]
    pred = np.eye(N_CLASS, dtype=np.float32)[cls] + rng.normal(
        0, 0.05, (h, w, N_CLASS)).astype(np.float32)
    return pred, line_id, char_id


@pytest.mark.parametrize("h,w,seed", [(48, 100, 0), (64, 128, 1)])
def test_decode_tables_match_jax(h, w, seed):
    pred, line_id, char_id = scene(h, w, seed)
    num_lines = 128
    want = jax_decode(jnp.asarray(pred), jnp.asarray(line_id),
                      jnp.asarray(char_id), MULTILINE, n_class=N_CLASS,
                      num_lines=num_lines, k=8, min_area=5, max_iters=64)
    got = decode_fields_device(torch.from_numpy(pred),
                               torch.from_numpy(line_id),
                               torch.from_numpy(char_id), MULTILINE,
                               n_class=N_CLASS, num_lines=num_lines, k=8,
                               min_area=5)
    assert set(got) == set(want)
    # the scene really has alt components (the top_k path ran)
    assert np.asarray(want["alt_valid"])[5].sum() >= 2
    for key in want:
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]),
                                      err_msg=key)
    packed = pack_decode_out(got)
    np.testing.assert_array_equal(packed.numpy(), np.asarray(jax_pack(want)))
    host = unpack_decode_out(packed.numpy(), N_CLASS, 8, num_lines)
    np.testing.assert_array_equal(host["main_bbox"], np.asarray(want["main_bbox"]))


def test_top_k_ties_go_to_lower_index():
    vals = torch.tensor([[3, 7, 5, 7, 0, 5, 7]], dtype=torch.int32)
    v, i = top_k_lower_index(vals, 5)
    assert v.tolist() == [[7, 7, 7, 5, 5]]
    assert i.tolist() == [[1, 3, 6, 2, 5]]


def test_owner_is_lowest_class_where_closings_overlap():
    """Class 2 at pixels 1-2 and 4-5, class 3 at pixel 3: class 2's (1, 3)
    closing fills pixel 3, which class 3 also owns; the lower class wins,
    as in the JAX decoder."""
    pc = np.array([0, 2, 2, 3, 2, 2, 0, 0, 0])
    pred = np.eye(4, dtype=np.float32)[pc][None]
    ones = np.ones((1, 9), np.int32)
    kw = dict(n_class=4, num_lines=1, k=2, min_area=1)
    out = decode_fields_device(torch.from_numpy(pred), torch.from_numpy(ones),
                               torch.from_numpy(ones), **kw)
    want = jax_decode(jnp.asarray(pred), jnp.asarray(ones), jnp.asarray(ones),
                      **kw)
    assert out["chosen_class"][0].tolist() == [0, 2, 2, 2, 2, 2, 0, 0, 0]
    for key in want:
        np.testing.assert_array_equal(out[key].numpy(), np.asarray(want[key]),
                                      err_msg=key)


def page_stack(b, h, w, seed):
    """``b`` pages of rectangles (rows of at most h // 2 pixels, so the
    8-row maps hold them too) with equal-area pairs in classes 5 and 3."""
    rng = np.random.default_rng(seed)
    rh = min(6, h // 2)
    preds, lids, cids = [], [], []
    for _ in range(b):
        cls = np.zeros((h, w), np.int64)
        line_id = np.zeros((h, w), np.int32)
        char_id = np.zeros((h, w), np.int32)
        rects = [(c, int(rng.integers(0, h - rh + 1)),
                  int(rng.integers(0, w - 20)))
                 for c in [5, 5, 3, 3] + list(rng.integers(2, N_CLASS, 5))]
        for i, (c, y, x) in enumerate(rects):
            cls[y:y + rh, x:x + 16] = c
            line_id[y:y + rh, x:x + 18] = i + 1
            char_id[y:y + rh, x:x + 18] = np.arange(1, 19)[None, :]
        preds.append(np.eye(N_CLASS, dtype=np.float32)[cls] + rng.normal(
            0, 0.05, (h, w, N_CLASS)).astype(np.float32))
        lids.append(line_id)
        cids.append(char_id)
    return np.stack(preds), np.stack(lids), np.stack(cids)


@pytest.mark.parametrize("b,h,w,pallas", [(3, 64, 64, False),
                                          (2, 8, 128, True)])
def test_batched_decode_matches_jax_vmap(monkeypatch, b, h, w, pallas):
    """A page axis through the decoder against ``jax.vmap`` of the JAX
    decoder; at 8 x 128 the JAX labelling is the Pallas kernel (interpret
    mode), at 64 x 64 its XLA sweeps.  Each page's tables also equal the
    unbatched call's."""
    import jax
    from jax.experimental import pallas as pl

    seen = []
    real = pl.pallas_call

    def spy(kernel, *args, **kwargs):
        seen.append(getattr(kernel, "func", kernel).__name__)
        return real(kernel, *args, **kwargs)

    monkeypatch.setattr(pl, "pallas_call", spy)
    pred, line_id, char_id = page_stack(b, h, w, seed=b)
    kw = dict(n_class=N_CLASS, num_lines=16, k=4, min_area=2)
    want = jax.vmap(lambda p, l, c: jax_decode(p, l, c, MULTILINE, **kw,
                                               max_iters=64))(
        jnp.asarray(pred), jnp.asarray(line_id), jnp.asarray(char_id))
    assert seen == (["_ccl_mc_kernel"] if pallas else [])
    got = decode_fields_device(torch.from_numpy(pred),
                               torch.from_numpy(line_id),
                               torch.from_numpy(char_id), MULTILINE, **kw)
    assert set(got) == set(want)
    assert np.asarray(want["active"]).sum() >= b   # something was decoded
    assert np.asarray(want["alt_valid"])[:, 5].sum() >= 1   # top_k ran
    for key in want:
        assert got[key].shape[0] == b
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]),
                                      err_msg=key)
    packed = pack_decode_out(got)
    assert packed.shape[0] == b
    np.testing.assert_array_equal(packed.numpy(),
                                  np.asarray(jax.vmap(jax_pack)(want)))
    for i in range(b):
        one = decode_fields_device(torch.from_numpy(pred[i]),
                                   torch.from_numpy(line_id[i]),
                                   torch.from_numpy(char_id[i]), MULTILINE,
                                   **kw)
        assert torch.equal(pack_decode_out(one), packed[i])
        assert torch.equal(one["chosen_class"], got["chosen_class"][i])
