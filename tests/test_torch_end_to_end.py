"""The port's end-to-end demo (examples/end_to_end_kv_torch.py) against
examples/end_to_end_kv.py on the CPU, and the configuration classes that
the port's package exports.

The demo's training input (the fixture page's chargrid and its painted
labels) equals the JAX demo's bit for bit; a 2-step run goes through
training, serving and the field evaluation; the full 120 steps (~6 min on
one CPU thread) reach the JAX demo's F1 > 0.9 and are marked slow.
"""

import dataclasses
import importlib.util
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import msau_tpu
import msau_tpu_torch
from msau_tpu.config import InferConfig as JaxInferConfig
from msau_tpu.data.pages import load_label_json_page as jax_load_page
from msau_tpu.data.rasterize import paint_boxes as jax_paint_boxes
from msau_tpu.data.rasterize import round_up as jax_round_up
from msau_tpu.infer.kv_model import KVModel as JaxKVModel
from msau_tpu.infer.schema import FieldSchema as JaxFieldSchema
from msau_tpu_torch import config as tconfig

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLE = os.path.join(ROOT, "examples", "end_to_end_kv_torch.py")
JAX_EXAMPLE = os.path.join(ROOT, "examples", "end_to_end_kv.py")
CONFIGS = ("Config", "DataConfig", "InferConfig", "ModelConfig",
           "TrainConfig")


def _load_example():
    spec = importlib.util.spec_from_file_location("end_to_end_kv_torch",
                                                  EXAMPLE)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def example():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield _load_example()
    torch.set_num_threads(n)


def _jax_training_input(charset_path, n_class):
    """examples/end_to_end_kv.py's charset, schema and training input."""
    schema = JaxFieldSchema(
        class_names=tuple(
            ["NUL"] + [f"{p}_f{i}" for i in range(1, 5) for p in ("k", "v")]
        )[:n_class],
        multiple_lines_fields=(),
    )
    page = jax_load_page(os.path.join(ROOT, "tests", "fixtures",
                                      "kv_sample.json"))
    page = dataclasses.replace(page, lines=[
        dataclasses.replace(l, label=(l.value + 1 if l.value > 0 else 0))
        for l in page.lines])
    kv = JaxKVModel(infer_config=JaxInferConfig(n_class=n_class),
                    schema=schema)
    kv.load(charset=charset_path, n_class=n_class)
    x, _, _, _, progs = kv.rasterize(page)
    hb, wb = x.shape[:2]
    lab = progs.label.padded(
        jax_round_up(max(len(progs.label.values), 1), 128))
    label = jax_paint_boxes(jnp.asarray(lab.boxes), jnp.asarray(lab.values),
                            hb, wb)
    return kv, np.asarray(x), np.asarray(label)


def test_training_input_equals_the_jax_demo(example, tmp_path):
    """The same charset (the JAX demo's string), schema, chargrid and
    labels, bit for bit."""
    text = "Bank NameFirst National Account 0123456789Alexandra Example Savings"
    assert f'"{text}"' in open(JAX_EXAMPLE).read()
    assert example.CHARS == "".join(sorted(set(text)))
    kv, x, label = example.setup("cpu", str(tmp_path))
    assert open(tmp_path / "charset.txt").read() == example.CHARS
    jkv, jx, jlabel = _jax_training_input(str(tmp_path / "charset.txt"),
                                          example.N_CLASS)
    assert kv.schema.class_names == jkv.schema.class_names
    assert kv.schema.multiple_lines_fields == ()
    assert tuple(x.shape) == jx.shape and x.dtype == torch.float32
    np.testing.assert_array_equal(x.numpy(), jx)
    np.testing.assert_array_equal(label.numpy(), jlabel)
    assert sorted(np.unique(jlabel)) == [0, 2, 3, 4]


def test_demo_model_is_the_jax_demos(example, tmp_path):
    kv, _, _ = example.setup("cpu", str(tmp_path))
    mc, model, _ = example.build(kv)
    assert (mc.scale_space_num, mc.res_depth, mc.feat_root, mc.num_blocks,
            mc.n_class, mc.img_channels) == (3, 1, 8, 2, 9, kv.charset.n_token)
    assert next(model.parameters()).device.type == "cpu"


def test_demo_runs_two_steps(example, capsys):
    """main("cpu", steps=2): trains, serves the page and scores it; the
    charset lands in a temporary directory, not in a fixed path."""
    timings = {}
    f1 = example.main("cpu", steps=2, timings=timings)
    out = capsys.readouterr().out
    assert 0.0 <= f1 <= 1.0
    assert "step 0: loss" in out and "field eval: P=" in out
    assert timings["train_ms_per_step"] > 0


@pytest.mark.slow
def test_demo_reaches_the_jax_demos_f1(example):
    """The full 120 steps on the CPU (~6 min on one thread): F1 > 0.9, as
    the JAX demo asserts."""
    assert example.main("cpu") > 0.9


@pytest.mark.parametrize("name", CONFIGS)
def test_package_exports_its_own_configs(name):
    """msau_tpu_torch re-exports the port's config classes (not the JAX
    package's), as msau_tpu exports its own."""
    ours = getattr(msau_tpu_torch, name)
    assert ours is getattr(tconfig, name)
    assert ours is not getattr(msau_tpu, name)
    assert ours.__module__ == "msau_tpu_torch.config"
    assert name in msau_tpu_torch.__all__
    assert not hasattr(msau_tpu_torch, "configure_tpu_precision")


def test_config_round_trip_matches_jax(tmp_path):
    """Config: the JAX Config's dict, and its JSON round trip (unknown keys
    dropped, lists back to tuples)."""
    ours = tconfig.Config(model=tconfig.ModelConfig(feat_root=16,
                                                    flat_scales=3))
    theirs = msau_tpu.config.Config(
        model=msau_tpu.config.ModelConfig(feat_root=16, flat_scales=3))
    assert ours.to_dict() == theirs.to_dict()
    assert tconfig.Config.from_json(theirs.to_json()) == ours
    d = ours.to_dict()
    d["model"]["bogus"] = 1
    assert tconfig.Config.from_dict(d) == ours
    path = str(tmp_path / "c.json")
    ours.save(path)
    assert tconfig.Config.load(path) == ours
    assert msau_tpu.config.Config.load(path) == theirs
    assert [f.name for f in dataclasses.fields(tconfig.Config)] == [
        f.name for f in dataclasses.fields(msau_tpu.config.Config)]
