"""The serve slice end to end: the port's KVModel (predict, rasterize,
predict_batch, field evaluation, run_test) against the JAX KVModel on
tests/fixtures/kv_sample.json, with the tiny config of tests/test_kv_model.py
and the same (bridged) weights.

Probabilities: atol 1e-5 (f32 on both sides).  The argmax maps are asserted
equal first — a flipped argmax would change the decode legitimately — and
then the decode tables, the extracted values and the result dict must be
equal.  Chargrids, eval counters and batched results: exact.
"""

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from msau_tpu.config import InferConfig, ModelConfig
from msau_tpu.data.pages import page_from_label_dict as jax_page_from_label_dict
from msau_tpu.infer.kv_model import KVModel as JaxKVModel
from msau_tpu.infer.schema import FieldSchema as JaxFieldSchema
from msau_tpu.models.msau import build_model as jax_build_model
from msau_tpu_torch.data.pages import page_from_label_dict
from msau_tpu_torch.data.synth import make_page
from msau_tpu_torch.infer.kv_model import INFER_SPECIALS, KVModel
from msau_tpu_torch.infer.schema import FieldSchema
from msau_tpu_torch.ops import launch_counts

FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures", "kv_sample.json")
N_CLASS = 9
NAMES = tuple(["NUL"] + [f"{p}_f{i}" for i in range(1, 5) for p in ("k", "v")])


@pytest.fixture(scope="module")
def charset_file(tmp_path_factory):
    p = tmp_path_factory.mktemp("cs") / "charset.txt"
    chars = sorted(set("Bank NameFirst National Account 0123456789 Alexandra Example Savings"))
    p.write_text("".join(chars))
    return str(p)


@pytest.fixture(scope="module")
def pair(charset_file):
    """(jax KVModel, port KVModel) with identical weights and config."""
    jkv = JaxKVModel(infer_config=InferConfig(n_class=N_CLASS),
                     schema=JaxFieldSchema(class_names=NAMES,
                                           multiple_lines_fields=(5,)))
    jkv.load(charset=charset_file, n_class=N_CLASS)
    mc = ModelConfig(img_channels=jkv.charset.n_token, n_class=N_CLASS,
                     scale_space_num=2, res_depth=1, feat_root=4, num_blocks=1)
    jkv.model_config = mc
    jkv.model = jax_build_model(mc)
    jkv.params = jkv.model.init(jax.random.PRNGKey(0),
                                jnp.zeros((1, 64, 64, mc.img_channels)))
    tkv = KVModel(model_config=mc, infer_config=InferConfig(n_class=N_CLASS),
                  schema=FieldSchema(class_names=NAMES,
                                     multiple_lines_fields=(5,)),
                  device="cpu")
    tkv.load(charset=charset_file, n_class=N_CLASS,
             params=jax.tree_util.tree_map(np.asarray, jkv.params))
    return jkv, tkv


def test_predict_matches_jax(pair):
    jkv, tkv = pair
    jres, jex = jkv.predict(FIXTURE)
    timings = {}
    tres, tex = tkv.predict(FIXTURE, timings=timings)
    jp, tp = np.asarray(jex["pred"]), tex["pred"].numpy()
    assert tp.shape == jp.shape
    np.testing.assert_array_equal(tp.argmax(-1), jp.argmax(-1))
    np.testing.assert_allclose(tp, jp, atol=1e-5)
    np.testing.assert_array_equal(tex["chosen_class"].numpy(),
                                  np.asarray(jex["chosen_class"]))
    assert [tuple(v) for v in tex["values"]] == [tuple(v) for v in jex["values"]]
    assert tres == jres
    assert set(timings) == {"prep", "device", "strings"}


def test_serving_protocol_omits_maps_and_launches_nothing_on_cpu(pair):
    _, tkv = pair
    before = launch_counts()
    res, extras = tkv.predict(FIXTURE, return_maps=False)
    assert "pred" not in extras and "chosen_class" not in extras
    assert launch_counts() == before
    assert set(res) == {f"f{i}" for i in range(1, 5)}


def test_charset_specials(charset_file):
    kv = KVModel(device="cpu").load(charset=charset_file, n_class=5)
    assert kv.charset.chars[:2] == "".join(INFER_SPECIALS)
    assert kv.model is None  # no weights and no generator: nothing built
    assert kv.schema.n_class == 5


def test_init_from_generator_is_seeded(charset_file):
    mc = ModelConfig(img_channels=10, n_class=4, scale_space_num=2,
                     res_depth=1, feat_root=4, num_blocks=1)
    a = KVModel(model_config=mc, device="cpu").load(
        charset=charset_file, n_class=4, generator=torch.Generator().manual_seed(7))
    b = KVModel(model_config=mc, device="cpu").load(
        charset=charset_file, n_class=4, generator=torch.Generator().manual_seed(7))
    for (ka, va), (kb, vb) in zip(a.model.state_dict().items(),
                                  b.model.state_dict().items()):
        assert ka == kb and torch.equal(va, vb)


# small buckets keep the chargrids at most 128^2: the fixture lands in 64 x
# 64, the synthetic page (25 lines) in 128 x 128
SMALL_BUCKETS = (64, 128)


def _values(values):
    return [tuple(v) for v in values]


def test_rasterize_matches_jax(pair):
    jkv, tkv = pair
    page = page_from_label_dict(make_page(np.random.default_rng(0),
                                          rows_per_col=2))
    jpage = jax_page_from_label_dict(make_page(np.random.default_rng(0),
                                               rows_per_col=2))
    got = tkv.rasterize(page, SMALL_BUCKETS)
    want = jkv.rasterize(jpage, SMALL_BUCKETS)
    assert got[0].shape == (128, 128, tkv.charset.n_token)
    assert got[0].dtype == torch.float32
    for a, b in zip(got[:3], want[:3]):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert [(l.box, l.text, l.id) for l in got[3]] == \
        [(l.box, l.text, l.id) for l in want[3]]
    assert (got[4].height, got[4].width, got[4].scale) == \
        (want[4].height, want[4].width, want[4].scale)


def test_predict_batch_matches_jax_predict(pair):
    """[fixture, a page of the 128 bucket, fixture]: one group of two pages
    and one of one; each page's results and values equal the JAX predict's
    on that page alone (and the JAX predict_batch's), in input order."""
    jkv, tkv = pair
    doc = make_page(np.random.default_rng(0), rows_per_col=2)
    pages = [FIXTURE, page_from_label_dict(doc), FIXTURE]
    jpages = [FIXTURE, jax_page_from_label_dict(doc), FIXTURE]
    before = launch_counts()
    got = tkv.predict_batch(pages, SMALL_BUCKETS)
    assert launch_counts() == before    # the plain versions on the CPU
    # the JAX predict takes its buckets from _prepare_host's default
    jkv._prepare_host = functools.partial(JaxKVModel._prepare_host, jkv,
                                          buckets=SMALL_BUCKETS)
    try:
        want = [jkv.predict(p) for p in jpages]
    finally:
        del jkv._prepare_host
    want_batch = jkv.predict_batch(jpages, SMALL_BUCKETS)
    assert len(got) == 3
    for (res, values), (wres, wex), (bres, bvalues) in zip(got, want,
                                                           want_batch):
        assert _values(values) == _values(wex["values"]) == _values(bvalues)
        assert res == wres == bres
    assert got[0] == got[2]
    assert _values(got[1][1]) != _values(got[0][1])


def test_predict_field_eval_matches_jax(pair):
    jkv, tkv = pair
    got = [{"num_pred": 0, "num_correct": 0, "num_label": 0}
           for _ in range(N_CLASS)]
    want = [dict(c) for c in got]
    tres, _ = tkv.predict(FIXTURE, label_path=FIXTURE, eval_results=got)
    jres, _ = jkv.predict(FIXTURE, label_path=FIXTURE, eval_results=want)
    assert tres == jres
    assert got == want
    assert sum(c["num_label"] for c in got) == 3   # values 1-3 of the page
    # a label file that cannot be read counts nothing
    missing = [dict(c) for c in got]
    tkv.predict(FIXTURE, label_path=FIXTURE + ".missing",
                eval_results=missing)
    assert missing == got


def test_run_test_matches_jax(pair):
    jkv, tkv = pair
    label_dir = os.path.dirname(FIXTURE)
    got = tkv.run_test([FIXTURE], label_dir=label_dir)
    want = jkv.run_test([FIXTURE], label_dir=label_dir)
    assert got == want
    assert got[2] is not None and set(got[2]) == {"precision", "recall", "f1"}
    assert tkv.run_test([FIXTURE])[2] is None


def test_predict_at_flat_scales_2_gives_the_decode_tables_of_0(charset_file):
    """The flat-layout ops (plain versions on the CPU) serve the same
    decode tables as flat_scales 0, from the same seeded weights."""
    out = {}
    for fs in (0, 2):
        mc = ModelConfig(img_channels=36, n_class=N_CLASS, scale_space_num=3,
                         res_depth=2, feat_root=4, num_blocks=1, flat_scales=fs)
        kv = KVModel(model_config=mc, infer_config=InferConfig(n_class=N_CLASS),
                     schema=FieldSchema(class_names=NAMES,
                                        multiple_lines_fields=(5,)),
                     device="cpu")
        kv.load(charset=charset_file, n_class=N_CLASS,
                generator=torch.Generator().manual_seed(4))
        assert kv.charset.n_token == mc.img_channels
        out[fs] = kv.predict(FIXTURE)
    (res0, ex0), (res2, ex2) = out[0], out[2]
    np.testing.assert_allclose(ex2["pred"].numpy(), ex0["pred"].numpy(),
                               atol=1e-5)
    assert torch.equal(ex2["chosen_class"], ex0["chosen_class"])
    assert [tuple(v) for v in ex2["values"]] == [tuple(v) for v in ex0["values"]]
    assert res2 == res0


def test_model_weight_reads_a_trainer_checkpoint(charset_file, tmp_path):
    """Trainer.save -> KVModel.load(model_weight=) -> predict: the directory
    and its train_state.pt both give the predictions of the trainer's own
    parameters."""
    from msau_tpu_torch.config import InferConfig, ModelConfig, TrainConfig
    from msau_tpu_torch.data.synth import make_structured_batch
    from msau_tpu_torch.train.trainer import Trainer

    def kv_model(mc):
        return KVModel(model_config=mc,
                       infer_config=InferConfig(n_class=N_CLASS),
                       schema=FieldSchema(class_names=NAMES,
                                          multiple_lines_fields=(5,)),
                       device="cpu")

    n_token = kv_model(None).load(charset=charset_file).charset.n_token
    mc = ModelConfig(img_channels=n_token, n_class=N_CLASS, scale_space_num=2,
                     res_depth=1, feat_root=4, num_blocks=2)
    x, y = make_structured_batch(np.random.default_rng(2), 2, 64, N_CLASS,
                                 n_token)
    tr = Trainer(mc, TrainConfig(learning_rate=1e-3,
                                 lr_decay_staircase=False), device="cpu")
    tr.init_state(x, seed=0)
    batch = tr.put_batch({"input": x, "label": y,
                          "valid": np.ones(y.shape, bool)})
    for _ in range(2):
        tr.state, _ = tr.train_step(tr.state, batch)
    assert tr.state.step == 2
    tr.save(str(tmp_path / "ckpt"))

    own = kv_model(mc).load(charset=charset_file, n_class=N_CLASS,
                            params={k: v.detach().clone()
                                    for k, v in tr.state.params.items()})
    want_res, want = own.predict(FIXTURE)
    for path in (tmp_path / "ckpt", tmp_path / "ckpt" / "train_state.pt"):
        kv = kv_model(mc).load(model_weight=str(path), charset=charset_file,
                               n_class=N_CLASS)
        res, got = kv.predict(FIXTURE)
        assert torch.equal(got["pred"], want["pred"])
        assert torch.equal(got["chosen_class"], want["chosen_class"])
        assert res == want_res
