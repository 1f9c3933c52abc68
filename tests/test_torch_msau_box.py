"""The box-convolution MSAU (BMSAU) of the port against the JAX package's on
the CPU, same weights (bridged from the flax init by utils.transplant) and
same numpy inputs: ``MultiBoxConvBlock``, the ``MSAUWrapper`` forward in
NHWC and NCHW, and the train step's loss and gradients against
``jax.value_and_grad`` of the masked CE and JAX's ``make_train_step``;
``check_supported`` for the box model.

Tolerances (f32 on both sides): the block within atol 1e-5; the model's
logits and probabilities within atol 1e-4, as the flagship's forward test
(tests/test_torch_model.py); the step's loss and metrics rel 1e-5 and each
gradient within 1e-4 of that tensor's largest |gradient| plus 1e-6 of the
model's, as tests/test_torch_train.py holds the flagship's step.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from msau_tpu.config import ModelConfig
from msau_tpu.models.msau import build_model as jax_build_model
from msau_tpu.models.msau_box import MultiBoxConvBlock as JaxBlock
from msau_tpu.train import loss as jloss
from msau_tpu.train.trainer import TrainState as JaxTrainState
from msau_tpu.train.trainer import make_train_step as jax_make_train_step
from msau_tpu_torch.config import ModelConfig as TorchModelConfig
from msau_tpu_torch.data.synth import make_structured_batch
from msau_tpu_torch.models.msau import build_model, check_supported
from msau_tpu_torch.models.msau_box import MultiBoxConvBlock
from msau_tpu_torch.train.trainer import make_loss_and_grad
from msau_tpu_torch.utils.transplant import flax_to_torch

CFG = dict(model="msau_box", img_channels=6, n_class=5, scale_space_num=3,
           res_depth=2, feat_root=4, num_blocks=2, final_act="softmax",
           num_box_convs=2, num_box_per_channel=2, max_box_size=6)


def _np_tree(params):
    return jax.tree_util.tree_map(np.asarray, params)


def _rel(a, b):
    return abs(float(a) - float(b)) / max(abs(float(b)), 1e-12)


def test_multi_box_conv_block_matches_jax():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 14, 11, 4)).astype(np.float32)
    jb = JaxBlock(channels=4, num_convs=3, num_boxes=2, max_box_size=5)
    params = jb.init(jax.random.PRNGKey(1), jnp.asarray(x))
    want = np.asarray(jb.apply(params, jnp.asarray(x)))
    tb = MultiBoxConvBlock(4, 3, 2, 5, gen=torch.Generator().manual_seed(0))
    tb.load_state_dict(flax_to_torch(_np_tree(params)))
    with torch.no_grad():
        got = tb(torch.from_numpy(x).permute(0, 3, 1, 2))
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want,
                               rtol=0, atol=1e-5)


@pytest.fixture(scope="module")
def box_models():
    cfg = ModelConfig(**CFG)
    x, y = make_structured_batch(np.random.default_rng(0), 2, 40,
                                 cfg.n_class, cfg.img_channels, n_rects=6)
    valid = np.ones(y.shape, bool)
    valid[:, :, -5:] = False
    jm = jax_build_model(cfg)
    params = jm.init(jax.random.PRNGKey(0), jnp.asarray(x[:1]))
    tm = build_model(TorchModelConfig(**CFG), torch.Generator().manual_seed(0))
    tm.load_state_dict(flax_to_torch(_np_tree(params)))
    return jm, params, tm, {"input": x, "label": y, "valid": valid}


def test_box_tree_is_flax_tree(box_models):
    _, params, tm, _ = box_models
    keys = set(flax_to_torch(_np_tree(params)))
    assert keys == set(tm.state_dict())
    assert all(k.startswith("net.bmsau.") for k in keys)
    assert any(k.endswith("box_conv_1.ybox") for k in keys)


@pytest.mark.parametrize("layout,hw", [("NHWC", (40, 40)),
                                       ("NCHW", (37, 29))])
def test_bmsau_forward_matches_jax(box_models, layout, hw):
    jm, params, tm, _ = box_models
    x = np.random.default_rng(1).normal(size=(2, *hw, 6)).astype(np.float32)
    jp, jl, ja = jax.jit(jm.apply, static_argnames="logits_layout")(
        params, jnp.asarray(x), logits_layout=layout)
    with torch.no_grad():
        tp, tl, ta = tm(torch.from_numpy(x), logits_layout=layout)
    assert tl.shape == jl.shape and tl.dtype == torch.float32
    for got, want in ((tl, jl), (ta, ja), (tp, jp)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)


def test_bmsau_train_step_matches_jax(box_models):
    jm, params, tm, batch = box_models
    jb = {k: jnp.asarray(v) for k, v in batch.items()}

    def jax_loss(p):
        _, logits, aux = jm.apply(p, jb["input"], train=True)
        return jloss.masked_cross_entropy(logits, aux, jb["label"], jb["valid"])

    (_, jmet), jgrads = jax.value_and_grad(jax_loss, has_aux=True)(params)
    jopt = optax.adam(1e-4)
    _, jstep = jax_make_train_step(jm, jopt, donate=False)(
        JaxTrainState.create(params, jopt), jb)
    _, tmet, tgrads = make_loss_and_grad(tm)(
        {k: torch.from_numpy(v) for k, v in batch.items()})
    for k in ("loss", "loss_final", "loss_aux", "accuracy"):
        assert _rel(tmet[k], jmet[k]) <= 1e-5, k
        assert _rel(tmet[k], jstep[k]) <= 1e-5, k
    want = flax_to_torch(_np_tree(jgrads))
    assert set(want) == set(tgrads)
    scale = max(float(w.abs().max()) for w in want.values())
    for name, g in tgrads.items():
        w = want[name].numpy()
        np.testing.assert_allclose(
            g.numpy(), w, rtol=0, atol=1e-4 * np.abs(w).max() + 1e-6 * scale,
            err_msg=name)
    assert any(float(tgrads[k].abs().max()) > 0 for k in tgrads
               if k.endswith("xbox"))


@pytest.mark.parametrize("extra", [dict(model="msau_box"),
                                   dict(use_spn=True)])
def test_check_supported_box_and_spn(extra):
    base = {k: v for k, v in CFG.items() if k != "model"}
    check_supported(TorchModelConfig(**base, **extra))
    with pytest.raises(ValueError, match="flat_scales"):
        check_supported(TorchModelConfig(**base, **extra, flat_scales=1))
    check_supported(TorchModelConfig(**base, use_lstm=True, flat_scales=1))
