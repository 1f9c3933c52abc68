"""The port's FUNSD entry (msau_tpu_torch.tools.preprocess_funsd and
train_funsd) and the helpers it uses (utils.metrics, utils.io) on the CPU:
the metrics and io functions give the JAX package's results on seeded
inputs (counts and strings exactly, the device confusion matrix too), and
the two tools run end to end on the FUNSD fixture, ``--device cpu``, for
each ``--features`` and for a ``model_kwargs.json`` that names
``msau_box``, leaving checkpoints under the ``gen_prefix`` directory as
the JAX package's CLI does (tests/test_cli_smoke.py).
"""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from msau_tpu.utils import io as oio
from msau_tpu.utils import metrics as om
from msau_tpu_torch.tools import preprocess_funsd, train_funsd
from msau_tpu_torch.utils import io, metrics

FIX = os.path.join(os.path.dirname(__file__), "fixtures")


@pytest.mark.parametrize("seed", [0, 1])
def test_metrics_match_jax(seed):
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, 5, (13, 17))
    preds = rng.integers(0, 5, (13, 17))
    valid = rng.random((13, 17)) < 0.7
    for kw in (dict(), dict(drop_background=False),
               dict(remap_zero_pred_to=4)):
        assert metrics.micro_metrics(labels, preds, **kw) == \
            om.micro_metrics(labels, preds, **kw)
    assert metrics.micro_metrics(np.zeros(4), np.ones(4)) == \
        om.micro_metrics(np.zeros(4), np.ones(4))
    cm = metrics.confusion_matrix(labels, preds, 5)
    np.testing.assert_array_equal(cm, om.confusion_matrix(labels, preds, 5))
    for v in (None, valid):
        got = metrics.confusion_matrix_device(
            torch.from_numpy(labels), torch.from_numpy(preds), 5,
            None if v is None else torch.from_numpy(v))
        want = om.confusion_matrix_device(
            jnp.asarray(labels), jnp.asarray(preds), 5,
            None if v is None else jnp.asarray(v))
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    names = ["bg", "q", "a", "h", "o"]
    assert metrics.report_from_confusion(cm, names) == \
        om.report_from_confusion(cm, names)
    assert metrics.classification_report(labels, preds, names, 5) == \
        om.classification_report(labels, preds, names, 5)
    assert metrics.classification_report(labels, preds) == \
        om.classification_report(labels, preds)


def test_io_matches_jax(tmp_path):
    for args in (("funsd", "msau", 8, 5), ("funsd", "msau", 8, 5, "run")):
        assert io.gen_prefix(*args) == oio.gen_prefix(*args)
    for epoch in (None, 3):
        got = io.create_filename(str(tmp_path / "a"), "p", epoch)
        want = oio.create_filename(str(tmp_path / "a"), "p", epoch)
        assert got == want and os.path.isdir(os.path.dirname(got))
    lst = tmp_path / "list.txt"
    lst.write_text("x/1.png\n\n  y/2.png  \n")
    for prefix in (None, "/data"):
        assert io.read_image_list(str(lst), prefix) == \
            oio.read_image_list(str(lst), prefix)
    for rel in ("d1/a.json", "d1/b.json", "d2/a.json", "d2/c.txt"):
        os.makedirs(tmp_path / "tree" / os.path.dirname(rel), exist_ok=True)
        (tmp_path / "tree" / rel).write_text("{}")
    for use_dirname in (False, True):
        got = io.glob_folder(str(tmp_path / "tree"), ".json", use_dirname)
        want = oio.glob_folder(str(tmp_path / "tree"), ".json", use_dirname)
        assert got == want
    files = ["/p/one.json", "/p/two.json"]
    results = [{"date": "1/2", "total": "$3"}, {"name": "A, B"}]
    for name in ("write_csv_report_by_row", "write_csv_report_by_field"):
        getattr(io, name)(str(tmp_path / "got.csv"), files, results)
        getattr(oio, name)(str(tmp_path / "want.csv"), files, results)
        assert (tmp_path / "got.csv").read_bytes() == \
            (tmp_path / "want.csv").read_bytes()


@pytest.fixture(scope="module")
def preprocessed(tmp_path_factory):
    out = tmp_path_factory.mktemp("pp")
    preprocess_funsd.main(["--train_dir", FIX, "--out_dir", str(out)])
    assert (out / "funsd_preprocess_train_word.pkl").exists()
    assert (out / "charset.txt").exists()
    return out


MODEL_KWARGS = dict(model="msau", final_act="softmax", featRoot=4,
                    scale_space_num=2, res_depth=1, n_class=5,
                    img_channels=33)


@pytest.mark.parametrize("case", ["chargrid", "bert", "bow", "msau_box"])
def test_preprocess_then_train(preprocessed, tmp_path, capsys, case):
    kwargs = dict(MODEL_KWARGS)
    features = case
    if case == "msau_box":
        kwargs.update(model="msau_box", num_box_convs=1,
                      num_box_per_channels=2, max_box_sizes=5)
        features = "chargrid"
    mk = tmp_path / "model_kwargs.json"
    mk.write_text(json.dumps(kwargs))
    ckpt = tmp_path / "ckpt"
    train_funsd.main([
        "--data_dir", str(preprocessed), "--ckptdir", str(ckpt),
        "--epochs", "1", "--train_ratio", "1.0",
        "--model_kwargs_path", str(mk), "--features", features,
        "--eval_every", "1", "--checkpoint_every", "1", "--device", "cpu",
    ])
    out = capsys.readouterr().out
    assert "Train acc:" in out and out.rstrip().endswith("Finished")
    subdirs = sorted(ckpt.glob("funsd_msau_*/*"))
    assert [p.name for p in subdirs] == ["0", "1"]
    state = torch.load(subdirs[-1] / "train_state.pt", weights_only=True)
    assert state["step"] == 1
    keys = state["params"]
    assert any(k.startswith("net.bmsau.") for k in keys) == (case == "msau_box")
    entry = keys["net.block_0.down.dil_conv_0.Conv_0.weight"
                 if case != "msau_box" else
                 "net.bmsau.block_0.down.dil_conv_0.Conv_0.weight"]
    # the features set the input width: 33 chars, 768 char-ngram dims, or
    # the page's bag-of-words vocabulary
    if case == "bert":
        assert entry.shape[1] == 768
    elif case == "bow":
        assert entry.shape[1] not in (33, 768)
    else:
        assert entry.shape[1] == 33


def test_train_funsd_refuses_devices(preprocessed):
    with pytest.raises(NotImplementedError, match="Queue 1 item 13"):
        train_funsd.main(["--data_dir", str(preprocessed), "--devices", "2",
                          "--device", "cpu"])
