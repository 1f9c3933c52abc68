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
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from msau_tpu.utils import io as oio
from msau_tpu.utils import metrics as om
from msau_tpu_torch.tools import preprocess_funsd, train_funsd
from msau_tpu_torch.utils import io, metrics

FIX = os.path.join(os.path.dirname(__file__), "fixtures")


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread for this file: its CPU runs stay fast when the
    suite's other workers load every core (OpenMP's barriers spin)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


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
    """--devices beyond the CUDA devices there are, or a --batch_size that
    does not split over them, is refused (ValueError; the JAX CLI
    asserts)."""
    with pytest.raises(ValueError, match="CUDA devices"):
        train_funsd.main(["--data_dir", str(preprocessed), "--devices",
                          str(torch.cuda.device_count() + 1), "--batch_size",
                          str(torch.cuda.device_count() + 1)])
    with pytest.raises(ValueError, match="multiple of --devices"):
        train_funsd.main(["--data_dir", str(preprocessed), "--devices", "2",
                          "--device", "cpu"])


# ------------------------------------------------------------ entry B
@pytest.fixture(scope="module")
def corpus_b(tmp_path_factory):
    """A 3-page labelled corpus (write_corpus, rng 5) and its charset."""
    from msau_tpu_torch.data.synth import write_corpus

    root = tmp_path_factory.mktemp("entry_b")
    train, _, cs_path = write_corpus(str(root / "pages"), 3, 0,
                                     np.random.default_rng(5))
    return root, train, cs_path


@pytest.fixture(scope="module")
def trained_b(corpus_b):
    """train_generic --device cpu on the corpus (val on the same pages),
    then the ModelConfig it trained, as model_kwargs.json."""
    from msau_tpu_torch.data.charset import Charset
    from msau_tpu_torch.tools import train_generic

    root, _, cs_path = corpus_b
    # TensorBoard events are optional; importing their writer loads
    # TensorFlow where it is installed
    mp = pytest.MonkeyPatch()
    mp.setitem(sys.modules, "torch.utils.tensorboard", None)
    argv = ["--train_dir", str(root / "pages"), "--val_dir",
            str(root / "pages"), "--charset", cs_path, "--n_classes", "17",
            "--output_path", str(root / "out"), "--feat_root", "2",
            "--scale_space_num", "3", "--res_depth", "1", "--epochs", "1",
            "--batch_steps_per_epoch", "1", "--affine", "--rotate",
            "--device", "cpu"]
    args = train_generic.build_parser().parse_args(argv)
    try:
        trainer, history = train_generic.train(args,
                                               log_dir=str(root / "logs"))
    finally:
        mp.undo()
    mc = train_generic.configs(args, Charset.from_file(cs_path))[1]
    (root / "model_kwargs.json").write_text(json.dumps(mc.to_model_kwargs()))
    return root, trainer, history, mc


def test_train_generic_entry_b(trained_b):
    root, trainer, history, mc = trained_b
    assert trainer.cfg.optimizer == "rmsprop" and not trainer.cfg.masked_loss
    assert trainer.cfg.lr_decay_staircase and trainer.state.step == 1
    assert len(history["train_loss"]) == len(history["val_loss"]) == 1
    assert np.isfinite(history["train_loss"] + history["val_loss"]).all()
    state = torch.load(root / "out" / "model1" / "train_state.pt",
                       weights_only=True)
    assert state["step"] == 1
    entry = state["params"]["net.block_0.down.dil_conv_0.Conv_0.weight"]
    assert entry.shape[1] == mc.img_channels
    rows = [json.loads(l) for l in
            (root / "logs" / "metrics.jsonl").read_text().splitlines()]
    assert [sorted(r) for r in rows] == [
        ["epoch", "step", "train/accuracy", "train/loss"],
        ["step", "val/accuracy", "val/loss"]]


def test_train_generic_main_and_devices(corpus_b, tmp_path):
    from msau_tpu_torch.tools import train_generic

    root, _, cs_path = corpus_b
    base = ["--train_dir", str(root / "pages"), "--charset", cs_path,
            "--n_classes", "17", "--device", "cpu"]
    with pytest.raises(ValueError, match="CUDA devices"):
        train_generic.main(base[:-1] + [
            "cuda", "--devices", str(torch.cuda.device_count() + 1)])
    train_generic.main(base + [
        "--output_path", str(tmp_path), "--feat_root", "2",
        "--scale_space_num", "3", "--res_depth", "1", "--epochs", "1",
        "--batch_steps_per_epoch", "1", "--rotate_mod90", "--val_dir",
        str(root / "pages")])
    assert (tmp_path / "model1" / "train_state.pt").exists()


def test_run_kv_test_on_entry_b_checkpoint(trained_b, corpus_b, tmp_path,
                                           capsys):
    from msau_tpu_torch.tools import run_kv_test

    root, _, _, _ = trained_b
    _, train, cs_path = corpus_b
    results, eval_results, summary = run_kv_test.main([
        "--input_dir", str(root / "pages"), "--charset", cs_path,
        "--n_class", "17", "--model_weight", str(root / "out" / "model1"),
        "--model_kwargs", str(root / "model_kwargs.json"),
        "--out_dir", str(tmp_path), "--label_dir", str(root / "pages"),
        "--device", "cpu"])
    assert len(results) == len(train)
    assert all(0.0 <= v <= 1.0 for v in summary.values())
    assert sum(c["num_label"] for c in eval_results) > 0
    assert (tmp_path / "kv_results.csv").exists()
    assert "F1-score" in capsys.readouterr().out


def test_kv_model_serves_entry_b_input(trained_b, corpus_b, monkeypatch):
    """A model of entry B's width is served entry B's input: the training
    charset's one-hot, then the line-mask and char-sep planes, painted by
    the training rule (equal to assemble_chargrid_input's on the serve
    programs, 5 paint calls); any other channel count raises."""
    import dataclasses

    from msau_tpu_torch.data import rasterize
    from msau_tpu_torch.data.pages import load_label_json_page
    from msau_tpu_torch.infer import kv_model
    from msau_tpu_torch.infer.kv_model import KVModel

    root, _, _, mc = trained_b
    _, train, cs_path = corpus_b
    kv = KVModel(device="cpu").load(
        model_weight=str(root / "out" / "model1"), charset=cs_path,
        n_class=17, model_kwargs_path=str(root / "model_kwargs.json"))
    n = kv.train_charset.n_token
    assert kv.model_config.img_channels == n + 2 != kv.charset.n_token
    page = load_label_json_page(train[0])
    paints, real = [], rasterize.paint_boxes

    def spy(*args):
        paints.append(args[2:])
        return real(*args)

    for module in (rasterize, kv_model):
        monkeypatch.setattr(module, "paint_boxes", spy)
    x, _, _, _, progs = kv.rasterize(page)
    assert len(paints) == 5
    cap = len(progs.char.values)
    hb, wb = x.shape[:2]
    want = rasterize.assemble_chargrid_input(
        *rasterize.upload_programs(
            [progs.char.padded(rasterize.round_up(cap, 512)),
             progs.char_sep.padded(rasterize.round_up(cap, 512)),
             progs.line_mask.padded(512)], "cpu"), hb, wb, n)
    assert x.shape == (hb, wb, n + 2)
    torch.testing.assert_close(x, want, rtol=0, atol=0)
    assert x[..., -2].sum() > 0 and x[..., -1].sum() > 0
    # the served planes follow the training rule: a 1-px mask under each
    # line with text, each char's last column valued by its token id
    assert set(np.unique(x[..., -2].numpy())) == {0.0, 1.0}
    assert x[..., -1].max() < n
    kv.predict(page)
    wrong = KVModel(dataclasses.replace(mc, img_channels=n + 1),
                    device="cpu").load(charset=cs_path, n_class=17,
                                       generator=torch.Generator())
    with pytest.raises(ValueError, match="input channels"):
        wrong.predict(page)


def test_entry_b_step_matches_jax(corpus_b):
    """One entry-B step (unet_loss, RMSprop, staircase) on the same
    _assemble'd batch from the JAX Trainer's init carried over by
    utils/transplant.py: loss rel 1e-5, the updated parameters within 1e-5
    of JAX's."""
    import dataclasses

    import jax

    from msau_tpu import config as oconfig
    from msau_tpu.train.trainer import Trainer as OTrainer
    from msau_tpu_torch.data.charset import Charset
    from msau_tpu_torch.data.pipeline import ChargridProvider
    from msau_tpu_torch.tools import train_generic
    from msau_tpu_torch.train.trainer import Trainer
    from msau_tpu_torch.utils.transplant import flax_to_torch

    root, train, cs_path = corpus_b
    args = train_generic.build_parser().parse_args([
        "--train_dir", "-", "--charset", cs_path, "--n_classes", "17",
        "--feat_root", "2", "--scale_space_num", "3", "--res_depth", "1",
        "--affine", "--elastic", "--rotate", "--device", "cpu"])
    cs = Charset.from_file(cs_path)
    dcfg, mc, tc = train_generic.configs(args, cs)
    prov = ChargridProvider(None, None, cs, dataclasses.replace(
        dcfg, buckets=(64, 128)), device="cpu")
    _, progs = prov._prepare(train[1], np.random.default_rng(0), True)
    batch = prov._assemble(progs)
    assert batch["input"].shape[-1] == mc.img_channels == cs.n_token + 2

    jt = OTrainer(oconfig.ModelConfig(**dataclasses.asdict(mc)),
                  oconfig.TrainConfig(**dataclasses.asdict(tc)))
    jt.init_state(batch["input"])
    init = jax.tree_util.tree_map(np.asarray, jt.state.params)
    jstate, jm = jt.train_step(jt.state, jt.put_batch(batch))
    want = flax_to_torch(jax.tree_util.tree_map(np.asarray, jstate.params))

    tr = Trainer(mc, tc, device="cpu")
    tr.init_state(batch["input"])
    tr.model.load_state_dict(flax_to_torch(init))
    tr.state, m = tr.train_step(tr.state, tr.put_batch(batch))
    assert abs(float(m["loss"]) - float(jm["loss"])) <= 1e-5 * abs(float(jm["loss"]))
    moved = 0
    for name, p in tr.state.params.items():
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(),
                                   rtol=0, atol=1e-5, err_msg=name)
        moved += not np.array_equal(want[name].numpy(),
                                    flax_to_torch(init)[name].numpy())
    assert moved > 10


def test_random_split_and_extract_match_jax(tmp_path):
    from msau_tpu.tools import extract_training_data as o_extract
    from msau_tpu.tools import random_split as o_split
    from msau_tpu_torch.tools import extract_training_data, random_split

    for i in range(10):
        (tmp_path / f"f{i}.json").write_text("{}")
    for seed in (1, 2):
        assert random_split.random_split(str(tmp_path), 0.7, "p/", seed) == \
            o_split.random_split(str(tmp_path), 0.7, "p/", seed)
    random_split.main(["--data_dir", str(tmp_path), "--seed", "3"])
    ours = [(tmp_path / n).read_text() for n in ("train.lst", "val.lst")]
    o_split.main(["--data_dir", str(tmp_path), "--seed", "3"])
    assert ours == [(tmp_path / n).read_text() for n in ("train.lst", "val.lst")]

    via = {"img1.jpg": {"height": 120, "width": 300, "regions": [
        {"shape_attributes": {"name": "rect", "x": 10, "y": 10, "width": 50,
                              "height": 20},
         "region_attributes": {"label": "Account 123", "type": "key",
                               "formal_key": "account_number"}},
        {"shape_attributes": {"name": "polygon",
                              "all_points_x": [70, 120, 120, 70],
                              "all_points_y": [10, 10, 30, 30]},
         "region_attributes": {"label": "98765", "type": "value",
                               "formal_key": "account_number"}},
        {"shape_attributes": {"name": "rect", "x": 10, "y": 50, "width": 40,
                              "height": 15},
         "region_attributes": {"label": "note é", "type": "other"}},
        {"shape_attributes": {"name": "circle"}, "region_attributes": {}}]}}
    src = tmp_path / "labels"
    src.mkdir()
    (src / "img1.json").write_text(json.dumps(via))
    (src / "img2.json").write_text(json.dumps({"_via_img_metadata": via}))
    for module, out in ((extract_training_data, "ours"), (o_extract, "jax")):
        module.main(["--label_dir", str(src), "--save_dir", str(tmp_path / out),
                     "--classes", "account_number", "bank_name"])
    names = sorted(p.name for p in (tmp_path / "ours").iterdir())
    assert names == ["charset.txt", "img1.json", "img2.json"]
    assert names == sorted(p.name for p in (tmp_path / "jax").iterdir())
    for n in names:
        assert (tmp_path / "ours" / n).read_bytes() == \
            (tmp_path / "jax" / n).read_bytes(), n
