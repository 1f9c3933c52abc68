"""The train pipeline's rasterization (``assemble_chargrid_input`` and
``rasterize_train_example``) against the JAX package's on the CPU, on
``synth.make_page`` pages: the same input planes, labels and valid mask,
exactly (the port paints through ``ops.paint.paint_boxes``, whose plain
version runs on a CPU tensor; the JAX package's ``paint_boxes_fast`` takes
its XLA loop on the CPU)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from msau_tpu.data import charset as o_charset
from msau_tpu.data import pages as o_pages
from msau_tpu.data import rasterize as o_rast
from msau_tpu.data import synth as o_synth
from msau_tpu_torch.data import charset, pages, rasterize, synth

BUCKETS = (64, 128)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread for this file: its CPU runs stay fast when the
    suite's other workers load every core (OpenMP's barriers spin)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _charsets():
    return (charset.Charset(chars="◫⎅" + synth.BENCH_CHARSET),
            o_charset.Charset(chars="◫⎅" + o_synth.BENCH_CHARSET))


@pytest.mark.parametrize("seed,n_cols", [(0, 1), (1, 1), (2, 2)])
def test_assemble_chargrid_input_matches_jax(seed, n_cols):
    cs, ocs = _charsets()
    doc = synth.make_page(np.random.default_rng(seed), n_cols=n_cols)
    progs = rasterize.build_chargrid_programs(
        pages.page_from_label_dict(doc), cs, scale_min=2.0, scale_max=2.0,
        label_style="underline")
    hb, wb = rasterize.pad_to_bucket(progs.height, progs.width, BUCKETS)
    cap = rasterize.round_up(len(progs.char.values), 512)
    lcap = rasterize.round_up(len(progs.line_mask.values), 128)
    arrays = [progs.char.padded(cap), progs.char_sep.padded(cap),
              progs.line_mask.padded(lcap)]
    want = np.asarray(o_rast.assemble_chargrid_input(
        *[jnp.asarray(a) for p in arrays for a in (p.boxes, p.values)],
        hb, wb, cs.n_token))
    tensors = rasterize.upload_programs(arrays, "cpu")
    got = rasterize.assemble_chargrid_input(*tensors, hb, wb, cs.n_token)
    assert got.dtype == torch.float32
    assert got.shape == (hb, wb, cs.n_token + 2)
    np.testing.assert_array_equal(got.numpy(), want)
    # every plane painted: tokens, the line mask and the separators
    assert want[..., 2:cs.n_token].sum() > 0
    assert want[..., -2].sum() > 0 and want[..., -1].sum() > 0


@pytest.mark.parametrize("seed", [0, 3])
@pytest.mark.parametrize("scale", [(2.0, 2.0), (1.0, 2.5)])
def test_rasterize_train_example_matches_jax(seed, scale):
    cs, ocs = _charsets()
    doc = synth.make_page(np.random.default_rng(seed), n_cols=2)
    kw = dict(buckets=BUCKETS, scale_min=scale[0], scale_max=scale[1],
              text_err=0.1)
    got = rasterize.rasterize_train_example(
        pages.page_from_label_dict(doc), cs, 17,
        rng=np.random.default_rng(seed), device="cpu", **kw)
    want = o_rast.rasterize_train_example(
        o_pages.page_from_label_dict(doc), ocs, 17,
        rng=np.random.default_rng(seed), **kw)
    for key, dtype in (("input", torch.float32), ("label", torch.int32),
                       ("valid", torch.bool)):
        assert got[key].dtype == dtype, key
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]),
                                      err_msg=key)
    label = got["label"].numpy()
    assert label.max() > 0 and (label[~got["valid"].numpy()] == 0).all()
    assert got["valid"].numpy().mean() < 1.0
