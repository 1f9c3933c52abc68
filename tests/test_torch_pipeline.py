"""The port's input pipeline (msau_tpu_torch.data.pipeline) on the CPU.

* ``_prepare`` + ``_assemble`` against the JAX provider's on the same
  pages, the same worker Generator and the same augmentation Generator:
  the same box programs, then the same numpy batch exactly (input planes,
  labels, valid), with affine + elastic + rotation, with ``rotate_mod90``
  on a non-square page, and unaugmented for the val split.
* The lifecycle: worker threads serve train and val batches, a malformed
  page is skipped, and no worker thread is left alive after ``stop_all``
  or leaving the ``with`` block.
* ``BatchingProvider``: same-shape grouping, the partial group dropped
  when the stream ends, ``size_val // batch_size``.
"""

import threading

import numpy as np
import pytest
import torch

from msau_tpu.config import DataConfig as ODataConfig
from msau_tpu.data import charset as o_charset
from msau_tpu.data import pipeline as o_pipeline
from msau_tpu_torch.config import DataConfig
from msau_tpu_torch.data import charset, pipeline, synth

AUG = {
    "affine_elastic_rotate": dict(affine=True, elastic=True, rotate=True),
    "rotate_mod90": dict(rotate_mod90=True),
    "val": dict(affine=True, rotate=True),
}


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread for this file: its CPU runs stay fast when the
    suite's other workers load every core (OpenMP's barriers spin)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("corpus")
    train, test, cs_path = synth.write_corpus(str(root), 4, 2,
                                              np.random.default_rng(5))
    return train, test, cs_path


def _providers(cs_path, **flags):
    kw = dict(n_classes=17, buckets=(64, 128), scale_min=1.5, scale_max=2.5,
              text_err=0.05, **flags)
    ours = pipeline.ChargridProvider(
        None, None, charset.Charset.from_file(cs_path), DataConfig(**kw),
        device="cpu")
    theirs = o_pipeline.ChargridProvider(
        None, None, o_charset.Charset.from_file(cs_path), ODataConfig(**kw))
    return ours, theirs


@pytest.mark.parametrize("case", list(AUG))
@pytest.mark.parametrize("page", [0, 2])
def test_prepare_and_assemble_match_jax(corpus, case, page):
    train, _, cs_path = corpus
    ours, theirs = _providers(cs_path, **AUG[case])
    is_train = case != "val"
    a = ours._prepare(train[page], np.random.default_rng(page), is_train)
    b = theirs._prepare(train[page], np.random.default_rng(page), is_train)
    assert a[0] == b[0] == "ok"
    for f in ("char", "char_sep", "line_mask", "label"):
        np.testing.assert_array_equal(getattr(a[1], f).boxes,
                                      getattr(b[1], f).boxes)
        np.testing.assert_array_equal(getattr(a[1], f).values,
                                      getattr(b[1], f).values)
    if case == "rotate_mod90":
        assert a[1].height != a[1].width
    ours._aug_rng = np.random.default_rng(31 + page)
    theirs._aug_rng = np.random.default_rng(31 + page)
    for _ in range(2):    # two examples from one augmentation stream
        got = ours._assemble(a[1], train=is_train)
        want = theirs._assemble(b[1], train=is_train)
        assert set(got) == set(want) == {"input", "label", "valid"}
        for key in want:
            assert got[key].dtype == want[key].dtype, key
            assert got[key].shape[0] == 1
            np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    assert len(ours.timings) == 2
    assert set(ours.timings[-1]) == {"assemble_ms", "fetch_ms"}


def _workers():
    return [t for t in threading.enumerate()
            if t.name.startswith("chargrid-") and t.is_alive()]


def test_provider_lifecycle(corpus, tmp_path):
    train, test, cs_path = corpus
    bad = tmp_path / "bad.json"
    bad.write_text('{"lines": [{"text": "no box"}]}')
    cs = charset.Charset.from_file(cs_path)
    cfg = DataConfig(n_classes=17, buckets=(64, 128), num_workers=2,
                     prefetch=1, rotate=True)
    before = len(_workers())
    with pipeline.ChargridProvider([str(bad)] + train, test, cs, cfg,
                                   device="cpu") as prov:
        assert (prov.size_train, prov.size_val) == (5, 2)
        assert len(_workers()) == before + 3   # 2 train, 1 val
        for _ in range(6):       # the malformed page is skipped
            batch = prov.next_data("train")
            assert batch["input"].shape[-1] == cs.n_token + 2
            assert batch["input"].shape[0] == 1
        val = prov.next_data("val")
        assert val["input"].shape[1:3] in ((64, 64), (64, 128), (128, 64),
                                           (128, 128))
        assert all(t["host_ms"] >= 0 for t in prov.timings)
    assert len(_workers()) == before
    prov = pipeline.ChargridProvider(train, None, cs, cfg, device="cpu")
    assert prov.next_data("val") is None
    prov.next_data("train")
    prov.stop_all()
    assert len(_workers()) == before


class _Stream:
    """An inner provider yielding single examples of the given sides, then
    None."""

    def __init__(self, sides, size_val=7):
        self.sides = list(sides)
        self.size_val = size_val
        self.size_train = len(self.sides)
        self.stopped = False

    def next_data(self, split="train"):
        if not self.sides:
            return None
        s = self.sides.pop(0)
        return {"input": np.full((1, s, s, 3), s, np.float32),
                "label": np.full((1, s, s), s, np.int32),
                "valid": np.ones((1, s, s), bool)}

    def stop_all(self):
        self.stopped = True


def test_batching_provider_groups_by_shape():
    inner = _Stream([64, 128, 64, 128, 128, 64, 128])
    with pipeline.BatchingProvider(inner, 2) as prov:
        assert prov.size_val == 3 and prov.size_train == 3
        sides = []
        while (batch := prov.next_data("train")) is not None:
            assert batch["input"].shape[0] == 2
            s = batch["input"].shape[1]
            assert (batch["input"] == s).all() and (batch["label"] == s).all()
            sides.append(s)
        # the groups complete in this order; the last 64 has no partner
        assert sides == [64, 128, 128]
    assert inner.stopped
    single = pipeline.BatchingProvider(_Stream([64]), 1)
    assert single.next_data()["input"].shape == (1, 64, 64, 3)
    with pytest.raises(ValueError):
        pipeline.BatchingProvider(_Stream([]), 0)

