"""The port's held-out accuracy protocol (msau_tpu_torch.tools.corpus_eval
and accuracy_matrix) against scripts/synthetic_corpus_eval.py and
scripts/run_accuracy_matrix.py, on the CPU at small sizes.

Tolerances (f32 on both sides):
  * training examples and batch grouping: exact;
  * the script's step at flat_scales 0 against the JAX step from a
    transplanted init: each of 3 losses rel 1e-5; step 1's gradients within
    1e-4 of each leaf's largest |gradient| plus 1e-6 of the model's (the
    rule of tests/test_torch_train.py);
  * the step at flat_scales 1 against flat_scales 0, same parameters: loss
    rel 1e-5, each gradient within 1e-5 of its leaf's largest |gradient|
    plus 1e-7 of the model's (the same function summed in other orders);
  * the --box_lr update against optax's chain(clip, multi_transform):
    parameters after 3 updates rtol 1e-6, atol 1e-7 (the optimizer rule
    of tests/test_torch_train.py), on gradients whose norm exceeds the clip;
  * box drift and pixel precision / recall: 1e-6.
"""

import contextlib
import io
import json
import os
import re
import subprocess
import sys

import flax
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from msau_tpu.config import InferConfig as JaxInferConfig
from msau_tpu.config import ModelConfig as JaxModelConfig
from msau_tpu.data.pages import load_label_json_page as jax_load_page
from msau_tpu.data.rasterize import paint_boxes as jax_paint_boxes
from msau_tpu.data.rasterize import round_up as jax_round_up
from msau_tpu.infer.kv_model import KVModel as JaxKVModel
from msau_tpu.infer.schema import FieldSchema as JaxFieldSchema
from msau_tpu.models.msau import build_model as jax_build_model
from msau_tpu.train.loss import unet_loss as jax_unet_loss
from msau_tpu_torch.config import InferConfig, ModelConfig
from msau_tpu_torch.data.synth import make_structured_batch, write_corpus
from msau_tpu_torch.infer.kv_model import KVModel
from msau_tpu_torch.infer.schema import FieldSchema
from msau_tpu_torch.models.msau import build_model
from msau_tpu_torch.tools import accuracy_matrix
from msau_tpu_torch.tools import corpus_eval as ce
from msau_tpu_torch.utils.transplant import flax_to_torch, torch_to_flax

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPT = os.path.join(ROOT, "scripts", "synthetic_corpus_eval.py")
# the summary keys the script appends to its result literal
SUMMARY_KEYS = {"precision", "recall", "f1"}


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread for this file: its CPU runs stay fast when the
    suite's other workers load every core (OpenMP's barriers spin)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rel(a, b):
    return abs(float(a) - float(b)) / max(abs(float(b)), 1e-12)


def _relabel_jax(page):
    import dataclasses

    return dataclasses.replace(page, lines=[
        dataclasses.replace(l, label=(l.value + 1 if l.value > 0 else 0))
        for l in page.lines])


def _jax_training_example(jkv, path):
    """synthetic_corpus_eval.py:122-137, with the JAX package."""
    x, _, _, _, progs = jkv.rasterize(_relabel_jax(jax_load_page(path)))
    hb, wb = x.shape[:2]
    lab = progs.label.padded(
        jax_round_up(max(len(progs.label.values), 1), 128))
    label = jax_paint_boxes(jnp.asarray(lab.boxes), jnp.asarray(lab.values),
                            hb, wb)
    return np.asarray(x), np.asarray(label)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("corpus"))
    train, test, charset = write_corpus(d, 2, 1, np.random.default_rng(7))
    jkv = JaxKVModel(infer_config=JaxInferConfig(n_class=17),
                     schema=JaxFieldSchema())
    jkv.load(charset=charset, n_class=17)
    tkv = KVModel(infer_config=InferConfig(n_class=17), schema=FieldSchema(),
                  device="cpu")
    tkv.load(charset=charset, n_class=17)
    return d, train + test, charset, jkv, tkv


def test_training_examples_equal_jax(corpus):
    """Two rng-7 corpus pages: the same bucket, the same bits."""
    _, paths, _, jkv, tkv = corpus
    for path in paths[:2]:
        x, label = ce.training_example(tkv, path)
        jx, jlabel = _jax_training_example(jkv, path)
        assert x.dtype == torch.float32 and label.dtype == torch.int32
        assert tuple(x.shape) == jx.shape and tuple(label.shape) == jlabel.shape
        np.testing.assert_array_equal(x.numpy(), jx)
        np.testing.assert_array_equal(label.numpy(), jlabel)
        assert int((label > 0).sum()) > 0


def _jax_batches(examples, bs):
    """synthetic_corpus_eval.py:138-155's grouping."""
    import collections

    by_shape = collections.defaultdict(list)
    for x, y in examples:
        by_shape[x.shape].append((x, y))
    batches = []
    for _, items in by_shape.items():
        for i in range(0, len(items), bs):
            chunk = items[i:i + bs]
            batches.append((np.stack([c[0] for c in chunk]),
                            np.stack([c[1] for c in chunk])))
    return batches


@pytest.mark.parametrize("bs", [2, 4])
def test_make_batches_matches_the_script(bs):
    """A mixed list of 256^2 and 512^2 examples (and a 256 x 512 one):
    the same batches in the same order."""
    rng = np.random.default_rng(bs)
    shapes = [(256, 256), (512, 512), (256, 256), (256, 512), (512, 512),
              (256, 256), (256, 256), (512, 512), (256, 256)]
    examples = [(rng.normal(size=s + (3,)).astype(np.float32),
                 rng.integers(0, 17, s).astype(np.int32)) for s in shapes]
    got = ce.make_batches([(torch.from_numpy(x), torch.from_numpy(y))
                           for x, y in examples], bs)
    want = _jax_batches(examples, bs)
    assert len(got) == len(want)
    for (gx, gy), (wx, wy) in zip(got, want):
        np.testing.assert_array_equal(gx.numpy(), wx)
        np.testing.assert_array_equal(gy.numpy(), wy)


# ----------------------------------------------------------------- step
TINY = dict(img_channels=8, n_class=17, scale_space_num=2, feat_root=4,
            num_blocks=1, res_depth=1)


def _batch(seed=0):
    x, y = make_structured_batch(np.random.default_rng(seed), 2, 64, 17, 8,
                                 n_rects=10)
    return x, y


def _grad_rule(got, want, rel, floor):
    """Each leaf within ``rel`` of its largest |gradient| plus ``floor`` of
    the model's largest."""
    assert set(got) == set(want)
    scale = max(float(w.abs().max()) for w in want.values())
    for name, g in got.items():
        w = want[name].numpy()
        np.testing.assert_allclose(
            g.numpy(), w, rtol=0,
            atol=rel * np.abs(w).max() + floor * scale, err_msg=name)


def test_step_matches_jax_at_fs0():
    """Three steps of the script's step from the JAX init (transplanted)
    against the JAX step of synthetic_corpus_eval.py:169, :192-208."""
    x, y = _batch()
    jmc = JaxModelConfig(**TINY)
    jm = jax_build_model(jmc)
    params = jm.init(jax.random.PRNGKey(3), jnp.asarray(x[:1]))
    cw = jnp.asarray([0.02] + [1.0] * 16)
    tx = optax.chain(optax.clip_by_global_norm(1.0), optax.adam(2e-3))
    opt_state = tx.init(params)
    xb, yb = jnp.asarray(x), jnp.asarray(y)

    @jax.jit
    def jstep(params, opt_state):
        def loss_fn(p):
            _, logits, aux = jm.apply(p, xb, train=True, logits_layout="NHWC")
            return jax_unet_loss(logits, yb, aux_logits=aux, class_weights=cw,
                                 channel_axis=-1)

        (loss, m), grads = jax.value_and_grad(loss_fn, has_aux=True)(params)
        updates, opt_state2 = tx.update(grads, opt_state, params)
        return (optax.apply_updates(params, updates), opt_state2, loss,
                grads)

    model = build_model(ModelConfig(**TINY), torch.Generator().manual_seed(0))
    model.load_state_dict(flax_to_torch(
        jax.tree_util.tree_map(np.asarray, params)))
    tx_, ty_ = torch.from_numpy(x), torch.from_numpy(y)
    _, _, grads = ce.loss_and_grads(model, tx_, ty_, ce.class_weights(17, "cpu"))
    step = ce.make_step(model, ce.make_optimizer(2e-3))
    for i in range(3):
        params, opt_state, jloss, jgrads = jstep(params, opt_state)
        loss, _ = step(tx_, ty_)
        assert _rel(loss, jloss) <= 1e-5, (i, float(loss), float(jloss))
        if i == 0:
            _grad_rule(grads, flax_to_torch(jax.tree_util.tree_map(
                np.asarray, jgrads)), 1e-4, 1e-6)


def test_step_at_fs1_matches_fs0():
    """The NCHW logits and channel_axis=1 of a flat model: the same loss
    and gradients as the unflattened model with the same parameters."""
    x, y = _batch(1)
    m0 = build_model(ModelConfig(**TINY), torch.Generator().manual_seed(4))
    m1 = build_model(ModelConfig(**TINY, flat_scales=1),
                     torch.Generator().manual_seed(5))
    m1.load_state_dict(m0.state_dict())
    cw = ce.class_weights(17, "cpu")
    tx_, ty_ = torch.from_numpy(x), torch.from_numpy(y)
    l0, met0, g0 = ce.loss_and_grads(m0, tx_, ty_, cw)
    l1, met1, g1 = ce.loss_and_grads(m1, tx_, ty_, cw)
    assert _rel(l1, l0) <= 1e-5
    assert _rel(met1["accuracy"], met0["accuracy"]) <= 1e-5
    _grad_rule(g1, g0, 1e-5, 1e-7)


# ------------------------------------------------------------ --box_lr
def test_box_lr_update_matches_optax():
    """One clip over all leaves, then Adam(box_lr) on ybox / xbox and
    Adam(lr) on the rest, as optax's chain(clip_by_global_norm,
    multi_transform); the gradients' global norm exceeds the clip, and
    each group's own norm differs from it, so a clip per group would
    scale them otherwise."""
    mc = ModelConfig(model="msau_box", img_channels=5, n_class=4,
                     scale_space_num=2, feat_root=4, num_blocks=1)
    model = build_model(mc, torch.Generator().manual_seed(0))
    params = {k: v.detach().clone() for k, v in model.named_parameters()}
    rng = np.random.default_rng(0)
    grads = [{k: torch.from_numpy((rng.normal(size=v.shape) * s).astype(
        np.float32)) for k, v in params.items()} for s in (0.5, 0.02, 0.3)]
    lr, box_lr = 2e-3, 0.5
    opt = ce.make_optimizer(lr, box_lr)
    assert isinstance(opt, ce.BoxLrOptimizer)
    boxes = [k for k in params if opt.group(k) == "box"]
    assert boxes and len(boxes) < len(params)

    def label_fn(tree):
        flat = flax.traverse_util.flatten_dict(tree)
        return flax.traverse_util.unflatten_dict(
            {k: ("box" if k[-1] in ("ybox", "xbox") else "rest")
             for k in flat})

    tx = optax.chain(optax.clip_by_global_norm(1.0), optax.multi_transform(
        {"box": optax.adam(box_lr), "rest": optax.adam(lr)}, label_fn))
    jp = jax.tree_util.tree_map(jnp.asarray, torch_to_flax(params))
    jst = tx.init(jp)
    state = opt.init(params)
    for g in grads:
        norm = float(optax.global_norm(torch_to_flax(g)))
        box_norm = float(np.sqrt(sum(float((g[k] ** 2).sum())
                                     for k in boxes)))
        if g is grads[0]:
            assert norm > 1.0 and abs(box_norm - norm) > 0.1
        upd, jst = tx.update(jax.tree_util.tree_map(
            jnp.asarray, torch_to_flax(g)), jst, jp)
        jp = optax.apply_updates(jp, upd)
        got_norm = opt.update({k: v.clone() for k, v in g.items()}, state,
                              params)
        assert _rel(got_norm, norm) <= 1e-6
        want = flax_to_torch(jax.tree_util.tree_map(np.asarray, jp))
        for k, v in params.items():
            np.testing.assert_allclose(v.numpy(), want[k].numpy(), rtol=1e-6,
                                       atol=1e-7, err_msg=k)
    assert state["box"]["count"] == state["rest"]["count"] == 3


# ------------------------------------------------- box drift, pixel P/R
def test_box_drift_matches_the_script():
    """synthetic_corpus_eval.py:229-247's formula on the flax trees."""
    mc = ModelConfig(model="msau_box", img_channels=5, n_class=4,
                     scale_space_num=2, feat_root=4, num_blocks=1)
    p0 = build_model(mc, torch.Generator().manual_seed(0)).state_dict()
    rng = np.random.default_rng(1)
    p1 = {k: v + torch.from_numpy(rng.normal(
        size=v.shape).astype(np.float32)) * 0.1 for k, v in p0.items()}
    got, n = ce.box_drift(p0, p1)
    f0 = flax.traverse_util.flatten_dict(torch_to_flax(p0))
    f1 = flax.traverse_util.flatten_dict(torch_to_flax(p1))
    drifts = [float(jnp.sqrt(jnp.mean((jnp.asarray(f1[k], jnp.float32)
                                       - jnp.asarray(v, jnp.float32)) ** 2)))
              for k, v in f0.items()
              if any("box" in str(part).lower() for part in k)]
    assert n == len(drifts) == 18
    assert abs(got - float(np.mean(drifts))) <= 1e-6


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_pixel_precision_recall_match_the_script(seed):
    """synthetic_corpus_eval.py:261-290's counts on seeded maps."""
    rng = np.random.default_rng(seed)
    tp = fp = fn = 0
    counts = torch.zeros(3, dtype=torch.int64)
    for _ in range(3):
        label = rng.integers(0, 5, (37, 41)) * (rng.random((37, 41)) < 0.4)
        pred = np.where(rng.random((37, 41)) < 0.7, label,
                        rng.integers(0, 5, (37, 41)))
        nz = label != 0
        tp += int(((pred == label) & nz).sum())
        fn += int(((pred != label) & nz).sum())
        fp += int(((pred != label) & (pred != 0)).sum())
        counts += ce.pixel_counts(torch.from_numpy(pred),
                                  torch.from_numpy(label))
    assert counts.tolist() == [tp, fn, fp]
    p, r = ce.pixel_precision_recall(tp, fn, fp)
    assert abs(p - tp / max(tp + fp, 1)) <= 1e-6
    assert abs(r - tp / max(tp + fn, 1)) <= 1e-6
    assert ce.pixel_precision_recall(0, 0, 0) == (0.0, 0.0)


# ----------------------------------------------------------------- smoke
def _script_result_keys():
    """The keys of the JAX script's result literal."""
    src = open(SCRIPT).read()
    body = src[src.index("result = {"):src.index("print(json.dumps(result))")]
    return set(re.findall(r'"(\w+)":', body))


def _last_json(text):
    lines = [l for l in text.splitlines() if l.startswith("{")]
    return json.loads(lines[-1])


def test_smoke_runs_with_the_scripts_keys():
    """--smoke on the CPU end to end; the last line has exactly the JAX
    script's keys (box_drift only for msau_box)."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        f1 = ce.main(["--smoke", "--device", "cpu"])
    out = buf.getvalue()
    assert out.splitlines()[-1].startswith("{")
    result = _last_json(out)
    assert set(result) == (_script_result_keys() - {"box_drift"}) | SUMMARY_KEYS
    assert result["metric"] == "held-out synthetic corpus field F1"
    assert (result["train_pages"], result["test_pages"], result["epochs"]) \
        == (2, 1, 2)
    assert 0.0 <= f1 <= 1.0 and result["f1"] == round(f1, 4)
    for k in ("pixel_precision", "pixel_recall", "precision", "recall"):
        assert 0.0 <= result[k] <= 1.0
    assert "epoch 0: loss" in out and "pixel micro precision" in out


def test_smoke_bmsau_box_lr_reports_box_drift():
    """The BMSAU with --box_lr: box_drift in the line, and positive."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        run = ce.run(["--smoke", "--device", "cpu", "--model", "msau_box",
                      "--box_lr", "0.05", "--epochs", "1"])
    result = _last_json(buf.getvalue())
    assert set(result) == _script_result_keys() | SUMMARY_KEYS
    assert result["box_drift"] > 0 and result["model"] == "msau_box"
    assert len(run.epoch_losses) == 1 and np.isfinite(run.epoch_losses[0])
    assert run.kv.model_config.flat_scales == 0
    assert os.path.isdir(run.out_dir)


def test_corpus_eval_keeps_the_scripts_flags():
    """The JAX script's flags, with --cpu replaced by --device (default
    cuda)."""
    src = open(SCRIPT).read()
    jax_flags = set(re.findall(r'add_argument\("(--\w+)"', src))
    ours = {a for act in ce.build_parser()._actions
            for a in act.option_strings if a.startswith("--")} - {"--help"}
    assert ours == (jax_flags - {"--cpu"}) | {"--device"}
    assert ce.build_parser().parse_args([]).device == "cuda"


# ---------------------------------------------------------- the matrix
def test_accuracy_matrix_records(tmp_path):
    """A stub in place of the per-run process: 4 x 5 records with the JAX
    runner's keys, --only filters, --device passes through, and
    scripts/summarize_accuracy_matrix.py reads the file."""
    canned = {"metric": "held-out synthetic corpus field F1",
              "train_pages": 40, "test_pages": 50, "dtype": "f32",
              "flat_scales": 0, "epochs": 60, "seed": 0, "model": "msau",
              "pixel_precision": 0.5, "pixel_recall": 0.6,
              "precision": 0.7, "recall": 0.7, "f1": 0.7}
    cmds = []

    def runner(cmd):
        cmds.append(cmd)
        seed = int(cmd[cmd.index("--seed") + 1])
        line = dict(canned, seed=seed, f1=0.6 + 0.05 * seed)
        return 0, "epoch 0: loss 1.0\n" + json.dumps(line) + "\n"

    out = tmp_path / "m.jsonl"
    with contextlib.redirect_stdout(io.StringIO()):
        recs = accuracy_matrix.main([str(out), "--device", "cpu"],
                                    runner=runner)
    rows = [json.loads(l) for l in out.read_text().splitlines()]
    assert rows == recs and len(rows) == 20
    assert [(r["config"], r["seed"]) for r in rows] == [
        (c, s) for c, _ in accuracy_matrix.CONFIGS for s in range(5)]
    for r in rows:
        assert set(r) == {"config", "seed", "wall_s"} | set(canned)
    for cmd, (name, extra) in zip(cmds[::5], accuracy_matrix.CONFIGS):
        assert cmd[1:3] == ["-m", "msau_tpu_torch.tools.corpus_eval"]
        assert cmd[cmd.index("--test_pages") + 1] == "50"
        assert cmd[cmd.index("--device") + 1] == "cpu"
        assert cmd[-len(extra):] == extra
    proc = subprocess.run(
        [sys.executable, os.path.join(ROOT, "scripts",
                                      "summarize_accuracy_matrix.py"),
         str(out)], capture_output=True, text=True, timeout=60)
    assert proc.returncode == 0, proc.stderr
    assert [l.split()[0] for l in proc.stdout.splitlines()] == [
        c for c, _ in accuracy_matrix.CONFIGS]
    assert "F1 0.700 +- 0.079" in proc.stdout

    only = tmp_path / "only.jsonl"
    with contextlib.redirect_stdout(io.StringIO()):
        recs = accuracy_matrix.main(["--only", "flat3_bf16,bmsau_f32",
                                     str(only)], runner=runner)
    assert [r["config"] for r in recs] == ["bmsau_f32"] * 5 + \
        ["flat3_bf16"] * 5
    assert cmds[-1][cmds[-1].index("--device") + 1] == "cuda"

    with contextlib.redirect_stdout(io.StringIO()):
        recs = accuracy_matrix.main(["--only", "nhwc_f32",
                                     str(tmp_path / "err.jsonl")],
                                    runner=lambda cmd: (1, "Traceback\n"))
    assert all(r["error"] == "Traceback\n" and "f1" not in r for r in recs)
