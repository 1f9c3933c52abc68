"""The port's optional model components (msau_tpu_torch.models.extras and
``layers.DownSampleResNet``) against the JAX package's on the CPU, same
weights (bridged by utils.transplant) and same numpy inputs: ``SparseConv``
with an explicit and an automatic mask, ``affinity_propagate`` with and
without sparse anchors (forward and gradients), ``SeparableRNNBlock`` as
the identity and as the row / column LSTM (forward and gradients, one
cell's weights for both directions), ``DownSampleResNet`` at strides 1 and
2 on odd sizes, and a ``use_lstm`` + ``use_spn`` model's forward and train
step.

Tolerances (f32 on both sides): layer outputs within atol 1e-5 and
gradients within 1e-4 of each tensor's largest |gradient| (a few convs or
LSTM steps in another summation order); the model's logits and
probabilities within atol 1e-4 and its step as tests/test_torch_train.py
holds the flagship's (loss rel 1e-5, each gradient within 1e-4 of that
tensor's largest |gradient| plus 1e-6 of the model's).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from msau_tpu.config import ModelConfig
from msau_tpu.models import extras as jextras
from msau_tpu.models.layers import DownSampleResNet as JaxDownSampleResNet
from msau_tpu.models.msau import build_model as jax_build_model
from msau_tpu.train import loss as jloss
from msau_tpu_torch.config import ModelConfig as TorchModelConfig
from msau_tpu_torch.data.synth import make_structured_batch
from msau_tpu_torch.models import extras
from msau_tpu_torch.models.layers import DownSampleResNet
from msau_tpu_torch.models.msau import build_model
from msau_tpu_torch.train.trainer import make_loss_and_grad
from msau_tpu_torch.utils.transplant import flax_to_torch

GEN = lambda: torch.Generator().manual_seed(0)


def _np_tree(params):
    return jax.tree_util.tree_map(np.asarray, params)


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(a)).permute(0, 3, 1, 2)


def _nhwc(t):
    return t.detach().permute(0, 2, 3, 1).numpy()


def _close_grads(got, want, what):
    want = np.asarray(want)
    np.testing.assert_allclose(
        got, want, rtol=0, atol=1e-4 * max(np.abs(want).max(), 1e-6),
        err_msg=what)


@pytest.mark.parametrize("mask", ["explicit", "auto"])
def test_sparse_conv_matches_jax(mask):
    rng = np.random.default_rng(0)
    x = rng.random((2, 9, 7, 3)).astype(np.float32)
    x[:, 3:5] = 0.0   # all-zero pixels: invalid under the automatic mask
    m = None
    if mask == "explicit":
        m = (rng.random((2, 9, 7, 1)) < 0.4).astype(np.float32)
    jm = jextras.SparseConv(features=4)
    args = (jnp.asarray(x),) + (() if m is None else (jnp.asarray(m),))
    params = jm.init(jax.random.PRNGKey(0), *args)
    jout, jmask = jm.apply(params, *args)
    tm = extras.SparseConv(3, 4, gen=GEN())
    tm.load_state_dict(flax_to_torch(_np_tree(params)))
    with torch.no_grad():
        tout, tmask = tm(_nchw(x), None if m is None else _nchw(m))
    np.testing.assert_allclose(_nhwc(tout), np.asarray(jout), atol=1e-5)
    np.testing.assert_array_equal(_nhwc(tmask), np.asarray(jmask))


@pytest.mark.parametrize("sparse", [False, True])
def test_affinity_propagate_matches_jax(sparse):
    rng = np.random.default_rng(1)
    g = rng.standard_normal((2, 10, 9, 8)).astype(np.float32)
    g[:, :3, :3, 2] = 0.0    # a gate whose weight sum is 0: the 1e-8 branch
    blur = rng.standard_normal((2, 10, 9, 1)).astype(np.float32)
    s = None
    if sparse:
        s = np.where(rng.random((2, 10, 9, 1)) < 0.2,
                     rng.standard_normal((2, 10, 9, 1)), 0.0).astype(np.float32)
    cot = rng.standard_normal((2, 10, 9, 1)).astype(np.float32)
    kw = dict(num_layers=4)

    def jloss(g, b):
        out = jextras.affinity_propagate(
            g, b, None if s is None else jnp.asarray(s), **kw)
        return jnp.sum(out * cot), out

    (_, jout), (jg, jb) = jax.value_and_grad(jloss, argnums=(0, 1),
                                             has_aux=True)(
        jnp.asarray(g), jnp.asarray(blur))
    tg, tb = _nchw(g).requires_grad_(), _nchw(blur).requires_grad_()
    out = extras.affinity_propagate(tg, tb, None if s is None else _nchw(s),
                                    **kw)
    np.testing.assert_allclose(_nhwc(out), np.asarray(jout), atol=1e-5)
    (out * _nchw(cot)).sum().backward()
    _close_grads(_nhwc(tg.grad), jg, "guidance")
    _close_grads(_nhwc(tb.grad), jb, "blur")


@pytest.mark.parametrize("identity", [True, False])
def test_separable_rnn_block_matches_jax(identity):
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 5, 7, 6)).astype(np.float32)
    cot = rng.standard_normal((2, 5, 7, 6)).astype(np.float32)
    jm = jextras.SeparableRNNBlock(features=6, identity=identity)
    params = jm.init(jax.random.PRNGKey(0), jnp.asarray(x))
    tm = extras.SeparableRNNBlock(6, identity=identity, gen=GEN())
    if identity:
        assert not list(tm.parameters())
        assert torch.equal(tm(_nchw(x)), _nchw(x))
        return
    # one cell (8 kernels, 4 biases) runs both directions of each axis
    sd = flax_to_torch(_np_tree(params))
    assert set(sd) == set(tm.state_dict())
    assert sum(k.startswith("row_cell.") for k in sd) == 12
    tm.load_state_dict(sd)

    def jloss(p, x):
        out = jm.apply(p, x)
        return jnp.sum(out * cot), out

    (_, jout), (jgp, jgx) = jax.value_and_grad(jloss, argnums=(0, 1),
                                               has_aux=True)(
        params, jnp.asarray(x))
    tx = _nchw(x).requires_grad_()
    out = tm(tx)
    np.testing.assert_allclose(_nhwc(out), np.asarray(jout), atol=1e-5)
    (out * _nchw(cot)).sum().backward()
    _close_grads(_nhwc(tx.grad), jgx, "x")
    want = flax_to_torch(_np_tree(jgp))
    for name, p in tm.named_parameters():
        _close_grads(p.grad.numpy(), want[name].numpy(), name)


@pytest.mark.parametrize("stride", [1, 2])
def test_downsample_resnet_matches_jax(stride):
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 13, 11, 5)).astype(np.float32)
    jm = JaxDownSampleResNet(channel_in=5, channel_out=8, res_depth=2,
                             aux_stride=stride)
    params = jm.init(jax.random.PRNGKey(0), jnp.asarray(x))
    want = np.asarray(jm.apply(params, jnp.asarray(x)))
    tm = DownSampleResNet(5, 8, res_depth=2, aux_stride=stride, gen=GEN())
    tm.load_state_dict(flax_to_torch(_np_tree(params)))
    with torch.no_grad():
        got = _nhwc(tm(_nchw(x)))
    assert got.shape == want.shape == (2, -(-7 // stride), -(-6 // stride), 8)
    np.testing.assert_allclose(got, want, atol=1e-5)


CFG = dict(img_channels=6, n_class=5, scale_space_num=3, res_depth=2,
           feat_root=4, num_blocks=2, final_act="softmax", use_lstm=True,
           use_spn=True)


@pytest.fixture(scope="module")
def lstm_spn_models():
    cfg = ModelConfig(**CFG)
    x, y = make_structured_batch(np.random.default_rng(0), 2, 40,
                                 cfg.n_class, cfg.img_channels, n_rects=6)
    valid = np.ones(y.shape, bool)
    valid[:, :, -5:] = False
    jm = jax_build_model(cfg)
    params = jm.init(jax.random.PRNGKey(0), jnp.asarray(x[:1]))
    tm = build_model(TorchModelConfig(**CFG), GEN())
    sd = flax_to_torch(_np_tree(params))
    assert set(sd) == set(tm.state_dict())
    tm.load_state_dict(sd)
    return jm, params, tm, {"input": x, "label": y, "valid": valid}


def test_lstm_spn_model_forward_matches_jax(lstm_spn_models):
    jm, params, tm, _ = lstm_spn_models
    sd = tm.state_dict()
    # the LSTM in every stage, the CSPN guidance in the last only
    assert any(k.startswith("net.block_0.lstm.col_cell.") for k in sd)
    assert not any(k.startswith("net.block_0.spn_guidance.") for k in sd)
    assert any(k.startswith("net.block_1.spn_guidance.") for k in sd)
    x = np.random.default_rng(1).normal(size=(2, 37, 29, 6)).astype(np.float32)
    jp, jl, ja = jax.jit(jm.apply)(params, jnp.asarray(x))
    with torch.no_grad():
        tp, tl, ta = tm(torch.from_numpy(x))
    for got, want in ((tl, jl), (ta, ja), (tp, jp)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)


def test_lstm_spn_train_step_matches_jax(lstm_spn_models):
    jm, params, tm, batch = lstm_spn_models
    jb = {k: jnp.asarray(v) for k, v in batch.items()}

    def jax_loss(p):
        _, logits, aux = jm.apply(p, jb["input"], train=True)
        return jloss.masked_cross_entropy(logits, aux, jb["label"], jb["valid"])

    (_, jmet), jgrads = jax.value_and_grad(jax_loss, has_aux=True)(params)
    _, tmet, tgrads = make_loss_and_grad(tm)(
        {k: torch.from_numpy(v) for k, v in batch.items()})
    for k in ("loss", "loss_final", "loss_aux", "accuracy"):
        assert abs(float(tmet[k]) - float(jmet[k])) <= 1e-5 * abs(float(jmet[k]))
    want = flax_to_torch(_np_tree(jgrads))
    scale = max(float(w.abs().max()) for w in want.values())
    for name, g in tgrads.items():
        w = want[name].numpy()
        np.testing.assert_allclose(
            g.numpy(), w, rtol=0, atol=1e-4 * np.abs(w).max() + 1e-6 * scale,
            err_msg=name)
    # the LSTM's hidden biases and input kernels learn: one bias per gate,
    # as flax's cell (a second, input bias would double its update)
    assert float(tgrads["net.block_1.lstm.row_cell.hf.bias"].abs().max()) > 0
