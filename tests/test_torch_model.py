"""MSAU model parity: the port's MSAUWrapper against the flax MSAUWrapper on
the CPU, same weights (bridged from the flax init) and same numpy input, at
flat_scales 0 and at every flat_scales the config allows (the port's flat
ops against the flax model at 0, and once against the flax flat model with
its Pallas kernels in interpret mode); and the port's compute-dtype and
logits-layout contract.

Tolerance: atol 1e-4 on logits/aux/probs — f32 on both sides; the residue
is summation order across ~40 convs (CPU conv kernels of two frameworks).
The dtype check is exact, and so are the layout check's logits.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from msau_tpu.config import ModelConfig
from msau_tpu.models.layers import local_response_norm as jax_lrn
from msau_tpu.models.msau import build_model as jax_build_model
from msau_tpu_torch.models.layers import local_response_norm, same_padding
from msau_tpu_torch.models.msau import build_model
from msau_tpu_torch.train.trainer import Trainer
from msau_tpu_torch.utils.transplant import flax_to_torch, torch_to_flax

ATOL = 1e-4
CFG = dict(img_channels=6, n_class=5, scale_space_num=3, res_depth=2,
           feat_root=4, num_blocks=2, final_act="softmax")


@pytest.fixture(scope="module")
def models():
    cfg = ModelConfig(**CFG)
    jm = jax_build_model(cfg)
    params = jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 6)))
    tm = build_model(cfg, torch.Generator().manual_seed(0))
    tm.load_state_dict(flax_to_torch(jax.tree_util.tree_map(np.asarray,
                                                            params)))
    return jm, params, tm.eval()


@pytest.mark.parametrize("hw", [(64, 64), (83, 57)])
def test_wrapper_matches_flax(models, hw):
    jm, params, tm = models
    x = np.random.default_rng(1).normal(size=(1, *hw, 6)).astype(np.float32)
    jp, jl, ja = jax.jit(jm.apply)(params, jnp.asarray(x))
    with torch.no_grad():
        tp, tl, ta = tm(torch.from_numpy(x))
    assert tl.shape == (1, *hw, 5) and ta.shape == tl.shape
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL)
    np.testing.assert_allclose(ta.numpy(), np.asarray(ja), atol=ATOL)
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), atol=ATOL)


@pytest.mark.parametrize("fs", [1, 2])
@pytest.mark.parametrize("hw", [(64, 64), (83, 57)])
def test_flat_scales_match_fs0_and_flax(models, fs, hw):
    """The flat-layout ops (plain versions on the CPU) give the model at
    flat_scales fs the function of flat_scales 0, in the port and in
    flax."""
    jm, params, tm = models
    flat = build_model(ModelConfig(**CFG, flat_scales=fs),
                       torch.Generator().manual_seed(1))
    flat.load_state_dict(tm.state_dict())
    x = np.random.default_rng(fs).normal(size=(1, *hw, 6)).astype(np.float32)
    jp, jl, ja = jax.jit(jm.apply)(params, jnp.asarray(x))
    with torch.no_grad():
        outs = flat.eval()(torch.from_numpy(x))
        outs0 = tm(torch.from_numpy(x))
    for got, want0, want in zip(outs, outs0, (jp, jl, ja)):
        assert got.shape == (1, *hw, 5)
        np.testing.assert_allclose(got.numpy(), want0.numpy(), atol=ATOL)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


def test_flat_model_matches_flax_flat_model(monkeypatch):
    """The port at flat_scales 1 against the flax model at flat_scales 1,
    whose flat convs, fused res block and concat 1x1 run as Pallas kernels
    (interpret mode); weights drawn by the port and bridged to flax."""
    from jax.experimental import pallas as pl

    seen = set()
    real = pl.pallas_call

    def spy(kernel, *args, **kwargs):
        fn = getattr(kernel, "func", kernel)
        seen.add(f"{fn.__module__.rsplit('.', 1)[-1]}.{fn.__name__}")
        return real(kernel, *args, **kwargs)

    monkeypatch.setattr(pl, "pallas_call", spy)
    cfg = ModelConfig(img_channels=6, n_class=5, feat_root=8,
                      scale_space_num=2, num_blocks=2, res_depth=2,
                      final_act="softmax", flat_scales=1)
    tm = build_model(cfg, torch.Generator().manual_seed(2)).eval()
    x = np.random.default_rng(2).normal(size=(1, 32, 48, 6)).astype(np.float32)
    jp, jl, ja = jax_build_model(cfg).apply(torch_to_flax(tm.state_dict()),
                                            jnp.asarray(x))
    assert {"flatconv._fwd_kernel", "flatres._fwd_kernel",
            "flatconv._cc_fwd_kernel"} <= seen
    with torch.no_grad():
        tp, tl, ta = tm(torch.from_numpy(x))
    # these weights give logits of ~300, where f32 summation order alone
    # moves the last digits (flax's flat and fs=0 models differ by 3e-4
    # there): atol 1e-4 or 1e-5 of the output's scale, whichever is larger
    for got, want in ((tl, jl), (ta, ja), (tp, jp)):
        want = np.asarray(want)
        np.testing.assert_allclose(
            got.numpy(), want, atol=max(ATOL, 1e-5 * np.abs(want).max()))


def test_state_dict_keys_do_not_depend_on_flat_scales():
    cfg = dict(CFG, scale_space_num=4)
    keys = [list(build_model(ModelConfig(**cfg, flat_scales=fs),
                             torch.Generator().manual_seed(0)).state_dict())
            for fs in (0, 3)]
    assert keys[0] == keys[1]
    with pytest.raises(ValueError, match="deepest"):
        build_model(ModelConfig(**cfg, flat_scales=4),
                    torch.Generator().manual_seed(0))


def test_state_dict_names_follow_flax_tree(models):
    _, _, tm = models
    keys = set(tm.state_dict())
    for k in ("net.block_0.down.dil_conv_0.Conv_0.weight",
              "net.block_0.down.res_block_1.ConvBnLrnDrop_1.Conv_0.bias",
              "net.block_1.down.couple_conv_2.Conv_0.weight",
              "net.block_1.down.attention_2.f.weight",
              "net.block_0.up.deconv_0.weight",
              "net.block_1.up.merge_conv_1.Conv_0.weight",
              "net.end_conv_1.Conv_0.weight"):
        assert k in keys, k


def test_same_padding_even_kernel_extra_pixel_bottom_right():
    assert same_padding(4) == (1, 2)
    assert same_padding(3, dilation=4) == (4, 4)


def test_lrn_matches_flax():
    x = np.random.default_rng(2).normal(size=(2, 5, 7, 16)).astype(np.float32)
    want = np.asarray(jax_lrn(jnp.asarray(x), size=16))
    got = local_response_norm(torch.from_numpy(x).permute(0, 3, 1, 2), 16)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want,
                               rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("field,value", [("spatial_shards", 2),
                                         ("model", "msau_box"),
                                         ("use_lstm", True),
                                         ("use_spn", True)])
def test_unported_options_raise(field, value):
    """No option is left unported: spatial_shards, the box model, use_lstm
    and use_spn build at flat_scales 0 and raise no NotImplementedError
    (spatial_shards applies to the flat scales and is a no-op there, as in
    the JAX package); at flat_scales > 0 spatial_shards and use_lstm build,
    while the box model and use_spn are undefined (the JAX package
    asserts) and raise ValueError."""
    cfg = ModelConfig(**{**CFG, field: value})
    build_model(cfg, torch.Generator().manual_seed(0))
    flat = ModelConfig(**{**CFG, field: value, "flat_scales": 1})
    if field in ("use_lstm", "spatial_shards"):
        build_model(flat, torch.Generator().manual_seed(0))
    else:
        with pytest.raises(ValueError, match="flat_scales"):
            build_model(flat, torch.Generator().manual_seed(0))


def test_trainer_builds_at_flat_scales():
    """flat_scales > 0 trains (tests/test_torch_flat_train.py): the
    trainer no longer refuses it."""
    tr = Trainer(ModelConfig(**{**CFG, "flat_scales": 2}), device="cpu")
    assert tr.model.config.flat_scales == 2


def test_bf16_config_casts_f32_params_at_use():
    """A bf16 config with f32 parameters computes exactly what the same
    model cast to bf16 computes (flax dtype semantics), and its gradients
    are f32."""
    cfg = ModelConfig(**{**CFG, "dtype": "bfloat16"})
    m = build_model(cfg, torch.Generator().manual_seed(0))
    assert {p.dtype for p in m.parameters()} == {torch.float32}
    cast = build_model(cfg, torch.Generator().manual_seed(0)).to(torch.bfloat16)
    x = torch.from_numpy(np.random.default_rng(5).normal(
        size=(1, 32, 24, 6)).astype(np.float32))
    outs = m(x)
    with torch.no_grad():
        want = cast(x)
    for a, b in zip(outs, want):
        assert a.dtype == torch.float32
        assert torch.equal(a.detach(), b)
    outs[1].square().mean().backward()
    # the last stage's attention feeds nothing, so it alone has no gradient
    grads = [p.grad for n, p in m.named_parameters()
             if ".block_1.down.attention_" not in n]
    assert all(g is not None and g.dtype == torch.float32 for g in grads)


def test_logits_layout(models):
    _, _, tm = models
    x = torch.from_numpy(np.random.default_rng(6).normal(
        size=(2, 20, 28, 6)).astype(np.float32))
    with torch.no_grad():
        nhwc = tm(x)
        nchw = tm(x, logits_layout="NCHW")
    # logits are the same tensor permuted; softmax along a strided axis may
    # sum in another order
    assert torch.equal(nhwc[1], nchw[1].permute(0, 2, 3, 1))
    assert torch.equal(nhwc[2], nchw[2].permute(0, 2, 3, 1))
    torch.testing.assert_close(nhwc[0], nchw[0].permute(0, 2, 3, 1),
                               rtol=1e-6, atol=1e-7)
    with pytest.raises(ValueError, match="logits_layout"):
        tm(x, logits_layout="NWHC")


@pytest.mark.parametrize("fs", [0, 2])
def test_body_logits_are_channel_major(models, fs):
    """"BODY": [N, C, H*W] f32 logits and aux, the NCHW ones flattened (the
    port's counterpart of the JAX body-flat [N, C, LB]), probs over dim 1."""
    _, _, tm = models
    m = build_model(ModelConfig(**CFG, flat_scales=fs),
                    torch.Generator().manual_seed(0))
    m.load_state_dict(tm.state_dict())
    x = torch.from_numpy(np.random.default_rng(7).normal(
        size=(2, 20, 28, 6)).astype(np.float32))
    with torch.no_grad():
        body = m(x, logits_layout="BODY")
        nchw = m(x, logits_layout="NCHW")
    assert body[1].shape == (2, 5, 20 * 28) and body[1].dtype == torch.float32
    assert torch.equal(body[1], nchw[1].flatten(2))
    assert torch.equal(body[2], nchw[2].flatten(2))
    torch.testing.assert_close(body[0].sum(1), torch.ones(2, 20 * 28))
