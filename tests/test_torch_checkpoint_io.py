"""Rich checkpoints (``utils.io.save_checkpoint`` / ``load_checkpoint``):
the train state of a small Trainer (2 stages, 64^2, f32) round-trips equal
in bits and trains on equal in bits; the sidecars equal the JAX package's
for the same config, auxiliary arrays and epoch; a template that does not
match raises and stays as it was; ``KVModel.load(model_weight=)`` serves
the checkpoint directory.
"""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from msau_tpu.utils import io as jax_io
from msau_tpu_torch.config import InferConfig, ModelConfig, TrainConfig
from msau_tpu_torch.data.synth import make_structured_batch
from msau_tpu_torch.infer.kv_model import KVModel
from msau_tpu_torch.train.trainer import Trainer
from msau_tpu_torch.utils import io
from msau_tpu_torch.utils.checkpoint import CHECKPOINT_FILE

FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures", "kv_sample.json")
CHARS = "Bank NameFirst National Account 0123456789 Alexandra Example Savings"
N_CLASS = 5
HW = 64


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread for this file: its CPU runs stay fast when the
    suite's other workers load every core (OpenMP's barriers spin)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def charset_file(tmp_path_factory):
    p = tmp_path_factory.mktemp("cs") / "charset.txt"
    p.write_text("".join(sorted(set(CHARS))))
    return str(p)


@pytest.fixture(scope="module")
def n_token(charset_file):
    return KVModel(device="cpu").load(charset=charset_file).charset.n_token


def _config(n_token, **kw):
    return ModelConfig(**{**dict(img_channels=n_token, n_class=N_CLASS,
                                 scale_space_num=2, res_depth=1, feat_root=4,
                                 num_blocks=2), **kw})


def _trainer(mc, optimizer="adam", seed=0):
    tr = Trainer(mc, TrainConfig(learning_rate=1e-3, optimizer=optimizer,
                                 lr_decay_staircase=False), device="cpu")
    x, y = make_structured_batch(np.random.default_rng(2), 2, HW, N_CLASS,
                                 mc.img_channels)
    tr.init_state(x, seed=seed)
    return tr, tr.put_batch({"input": x, "label": y,
                             "valid": np.ones(y.shape, bool)})


def _state_tensors(state):
    out = {f"params/{k}": v for k, v in state.params.items()}
    for k, v in state.opt_state.items():
        if isinstance(v, dict):
            out.update({f"{k}/{n}": t for n, t in v.items()})
    return out


def _assert_same_bits(a, b):
    ta, tb = _state_tensors(a), _state_tensors(b)
    assert ta.keys() == tb.keys()
    for k in ta:
        assert ta[k].dtype == tb[k].dtype and ta[k].device == tb[k].device, k
        assert torch.equal(ta[k], tb[k]), k
    assert a.step == b.step
    assert a.opt_state["count"] == b.opt_state["count"]


CONFIG = {"model": {"feat_root": 4, "scale_space_num": 2, "buckets": [64]},
          "lr": 1e-3, "name": "small"}
CG = {"pred_map": np.arange(12, dtype=np.float32).reshape(3, 4),
      "labels": np.array([0, 2, 1], np.int64), "dropped": None}


def test_round_trip_equal_in_bits(tmp_path, n_token):
    """3 steps, save_checkpoint, load_checkpoint into a fresh Trainer's
    state (other seed); the states are equal in bits, and 2 more steps
    from each give equal losses and equal states."""
    mc = _config(n_token)
    tr, batch = _trainer(mc)
    for _ in range(3):
        tr.state, _ = tr.train_step(tr.state, batch)
    path = str(tmp_path / "ckpt")
    io.save_checkpoint(path, tr.state, config=CONFIG, cg_dict=CG, epoch=3)
    assert os.path.isfile(os.path.join(path, CHECKPOINT_FILE))

    fresh, _ = _trainer(mc, seed=1)
    params_before = dict(fresh.state.params)
    state, meta = io.load_checkpoint(path, fresh.state)
    assert state is fresh.state
    # the model's own parameters were filled, not replaced
    assert all(state.params[k] is params_before[k] for k in params_before)
    assert all(p is state.params[n]
               for n, p in fresh.model.named_parameters())
    assert meta == {"epoch": 3, "config": json.loads(json.dumps(CONFIG))}
    _assert_same_bits(state, tr.state)

    losses = []
    for t in (tr, fresh):
        run = []
        for _ in range(2):
            t.state, m = t.train_step(t.state, batch)
            run.append(float(m["loss"]))
        losses.append(run)
    assert losses[0] == losses[1]
    _assert_same_bits(fresh.state, tr.state)
    assert fresh.state.step == 5


def test_sidecars_equal_jax(tmp_path):
    """The same config, cg_dict and epoch through the JAX save_checkpoint
    (orbax) and the port's: the JSON sidecars equal byte for byte, the npz
    archives hold the same arrays."""
    mc = _config(10)
    tr, _ = _trainer(mc)
    ours, theirs = str(tmp_path / "ours"), str(tmp_path / "theirs")
    io.save_checkpoint(ours, tr.state, config=CONFIG, cg_dict=CG, epoch=7)
    jax_io.save_checkpoint(theirs, {"w": jnp.arange(4.0)}, config=CONFIG,
                           cg_dict=CG, epoch=7)
    with open(ours + ".meta.json", "rb") as a, \
            open(theirs + ".meta.json", "rb") as b:
        assert a.read() == b.read()
    with np.load(ours + ".cg.npz") as a, np.load(theirs + ".cg.npz") as b:
        assert sorted(a.files) == sorted(b.files) == ["labels", "pred_map"]
        for k in b.files:
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k])
    # defaults: no config, no cg_dict -> {"epoch": -1, "config": {}} and no npz
    io.save_checkpoint(ours + "2", tr.state)
    jax_io.save_checkpoint(theirs + "2", {"w": jnp.arange(4.0)})
    with open(ours + "2.meta.json") as a, open(theirs + "2.meta.json") as b:
        assert json.load(a) == json.load(b) == {"epoch": -1, "config": {}}
    assert not os.path.exists(ours + "2.cg.npz")
    assert not os.path.exists(theirs + "2.cg.npz")
    _, jmeta = jax_io.load_checkpoint(theirs, {"w": jnp.zeros(4)})
    _, meta = io.load_checkpoint(ours, _trainer(mc)[0].state)
    assert meta == jmeta


@pytest.mark.parametrize("kind", ["shape", "optimizer keys", "param keys"])
def test_mismatched_template_raises_and_stays(tmp_path, n_token, kind):
    tr, _ = _trainer(_config(n_token))
    path = str(tmp_path / "ckpt")
    io.save_checkpoint(path, tr.state)
    if kind == "shape":
        other, _ = _trainer(_config(n_token, feat_root=8))
    elif kind == "optimizer keys":
        other, _ = _trainer(_config(n_token), optimizer="rmsprop")
    else:
        other, _ = _trainer(_config(n_token, scale_space_num=3))
    before = {k: v.clone() for k, v in _state_tensors(other.state).items()}
    with pytest.raises(ValueError, match="checkpoint"):
        io.load_checkpoint(path, other.state)
    for k, v in _state_tensors(other.state).items():
        assert torch.equal(v, before[k]), k
    # Trainer.restore reads through the same checks
    with pytest.raises(ValueError, match="checkpoint"):
        other.restore(path)


def test_no_sidecar_gives_empty_meta(tmp_path, n_token):
    """A Trainer.save directory is a checkpoint without sidecars."""
    mc = _config(n_token)
    tr, batch = _trainer(mc)
    tr.state, _ = tr.train_step(tr.state, batch)
    tr.save(str(tmp_path / "plain"))
    fresh, _ = _trainer(mc, seed=3)
    state, meta = io.load_checkpoint(str(tmp_path / "plain"), fresh.state)
    assert meta == {}
    _assert_same_bits(state, tr.state)


def test_kv_model_serves_the_checkpoint(tmp_path, charset_file, n_token):
    mc = _config(n_token)
    tr, batch = _trainer(mc)
    for _ in range(2):
        tr.state, _ = tr.train_step(tr.state, batch)
    path = str(tmp_path / "rich")
    io.save_checkpoint(path, tr.state, config=mc.to_model_kwargs(),
                       cg_dict={"step": np.asarray(2)}, epoch=1)
    icfg = InferConfig(n_class=N_CLASS)
    own = KVModel(model_config=mc, infer_config=icfg, device="cpu").load(
        charset=charset_file, n_class=N_CLASS,
        params={k: v.detach().clone() for k, v in tr.state.params.items()})
    want_res, want = own.predict(FIXTURE)
    kv = KVModel(model_config=mc, infer_config=icfg, device="cpu").load(
        model_weight=path, charset=charset_file, n_class=N_CLASS)
    res, got = kv.predict(FIXTURE)
    assert torch.equal(got["pred"], want["pred"])
    assert res == want_res
