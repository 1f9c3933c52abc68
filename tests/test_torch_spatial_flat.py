"""Spatial shards on the flat scales in one process (``spatial_shards``, the
batch axis carrying sp*N shard-major entries), against the JAX package's
sharded geometry (``FlatGeom.sp``, its Pallas kernels in interpret mode,
checked by a spy on ``pl.pallas_call``) and against the port's sp = 1.

  * The flat conv (dilation 1 and 2), the 3x3 concat (merge) conv and the
    stride-2 deconv of a layer on H-shards, against JAX's flat_conv2d,
    flat_concat_conv2d and its flat deconv layer on the sp = 2 geometry
    of tests/test_spatial_flat.py (64 x 48, 8 channels), to 1e-5; their
    input and weight gradients against the port's own op at sp = 1.
  * The model at spatial_shards 2 with the config of
    tests/test_spatial_flat.py: forward logits and aux against the JAX
    model's at spatial_shards 2 within 1e-5 of their largest |value| (the
    bound of tests/test_torch_model.py; the logits reach ~110 here).  The
    gradients of sum(sin(logits)) + 0.5 sum(sin(aux)) against the port's
    sp = 1 from the same weights in float64, where neither side rounds to
    f32: the logits and aux within 1e-12 of their largest, the gradients
    within JAX's rule (max |a - b| / (max |b| + 1e-2) < 1e-2) and the
    port's tighter 1e-9 of each tensor's largest |gradient| plus 1e-15 of
    the model's (measured: 1.5e-10, 0.15 of it).  In f32 that loss's
    gradients carry noise past JAX's rule at sp 1 already (the attention's
    f-projection bias has an exact gradient of 0 and gets ~5e-4; deep
    residual-block weights 1.3e-4 of their largest at sp 1, 2.4e-4 at sp
    2), so the f32 gradients at sp 1 and sp 2 are held to the float64
    step at chip_smoke's f32 bound: 1e-3 of each tensor's largest plus
    1e-6 of the model's.
  * The raises: H not divisible by sp * 2**flat_scales, a shard smaller
    than a conv's reach.
  * The kernels one train step of the flagship's structure launches at
    sp 1 and sp 4 (each kernel wrapper replaced by a counting one that
    runs the plain version): chip_smoke's PER_STEP[3] and PER_STEP_SP4,
    where the fused residual block launches no time.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from msau_tpu.config import ModelConfig as JaxModelConfig
from msau_tpu.models.layers import DeconvBnLrnDrop as JaxDeconv
from msau_tpu.models.msau import build_model as jax_build_model
from msau_tpu.ops.flatconv import (
    FlatGeom,
    choose_geom,
    flat_concat_conv2d,
    flat_conv2d,
    from_body,
    to_body,
)
from msau_tpu_torch.config import ModelConfig
from msau_tpu_torch.models.layers import (
    ConvBnLrnDrop,
    DeconvBnLrnDrop,
    DilConvBnLrnDrop,
)
from msau_tpu_torch.models.msau import build_model
from msau_tpu_torch.parallel.spatial import (
    SpatialShards,
    merge_spatial,
    split_spatial,
)
from msau_tpu_torch.utils.transplant import flax_to_torch

H, W, C, SP = 64, 48, 8, 2
MODEL = dict(img_channels=6, n_class=5, scale_space_num=3, res_depth=2,
             feat_root=8, num_blocks=2, final_act="softmax", flat_scales=2)


@pytest.fixture(autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture
def pallas_seen(monkeypatch):
    seen = set()
    real = pl.pallas_call

    def spy(kernel, *args, **kwargs):
        seen.add(getattr(kernel, "func", kernel).__name__)
        return real(kernel, *args, **kwargs)

    monkeypatch.setattr(pl, "pallas_call", spy)
    return seen


def _geoms(h, w):
    g = choose_geom(h, w)
    return g, FlatGeom(h // SP, w, g.P, min(g.tile_h, h // SP), SP)


def _split(x, g_sh):
    """JAX NCHW [N, C, H, W] -> shard-major body-flat (test_spatial_flat)."""
    n, c, h, w = x.shape
    xs = x.reshape(n, c, SP, h // SP, w).transpose(2, 0, 1, 3, 4)
    return to_body(xs.reshape(SP * n, c, h // SP, w), g_sh)


def _unsplit(yb, g_sh):
    y = from_body(yb, g_sh)
    return np.asarray(merge_spatial(torch.from_numpy(np.array(y)), SP))


def _t(a):
    return torch.from_numpy(np.array(a))


def _port_grads(layer_fn, xs, layer):
    """d sum(sin(layer(xs))) / d (xs, parameters)."""
    xs = [x.clone().requires_grad_(True) for x in xs]
    y = layer_fn(*xs)
    return torch.autograd.grad(torch.sin(y).sum(),
                               xs + list(layer.parameters()))


def _check_grads(got, want):
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5,
                                   atol=1e-5 * float(b.abs().max()))


@pytest.mark.parametrize("d", [1, 2])
def test_sharded_flat_conv_matches_jax(d, pallas_seen):
    _, g_sh = _geoms(H, W)
    x = jax.random.normal(jax.random.PRNGKey(0), (3, C, H, W))
    wk = jax.random.normal(jax.random.PRNGKey(1), (3, 3, C, C)) * 0.3
    b = jax.random.normal(jax.random.PRNGKey(2), (C,))
    want = _unsplit(flat_conv2d(_split(x, g_sh), wk, b, g_sh, dilation=d),
                    g_sh)
    assert "_fwd_kernel" in pallas_seen
    layer = DilConvBnLrnDrop(C, C, rate=d, activation=None, use_lrn=False,
                             gen=torch.Generator().manual_seed(0), flat=True)
    layer.load_state_dict({"Conv_0.weight": _t(wk).permute(3, 2, 0, 1),
                           "Conv_0.bias": _t(b)})
    xt = _t(x)
    layer.shards = SpatialShards(SP)
    got = merge_spatial(layer(split_spatial(xt, SP)), SP)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-5,
                               atol=1e-5)
    sharded = _port_grads(lambda t: merge_spatial(layer(split_spatial(t, SP)),
                                                  SP), [xt], layer)
    layer.shards = None
    _check_grads(sharded, _port_grads(layer, [xt], layer))


def test_sharded_concat_conv_matches_jax(pallas_seen):
    """The up tower's 3x3 merge conv of a pair, never concatenated."""
    _, g_sh = _geoms(H, W)
    a = jax.random.normal(jax.random.PRNGKey(3), (2, C, H, W))
    bb = jax.random.normal(jax.random.PRNGKey(4), (2, C, H, W))
    wk = jax.random.normal(jax.random.PRNGKey(5), (3, 3, 2 * C, C)) * 0.3
    b = jax.random.normal(jax.random.PRNGKey(6), (C,))
    want = _unsplit(flat_concat_conv2d(_split(a, g_sh), _split(bb, g_sh), wk,
                                       b, g_sh), g_sh)
    assert "_fwd_kernel" in pallas_seen
    layer = ConvBnLrnDrop(2 * C, C, (3, 3), activation=None,
                          gen=torch.Generator().manual_seed(0), flat=True)
    layer.load_state_dict({"Conv_0.weight": _t(wk).permute(3, 2, 0, 1),
                           "Conv_0.bias": _t(b)})
    at, bt = _t(a), _t(bb)

    def run(x, y):
        return merge_spatial(layer((split_spatial(x, SP),
                                    split_spatial(y, SP))), SP)

    layer.shards = SpatialShards(SP)
    np.testing.assert_allclose(run(at, bt).detach().numpy(), want, rtol=1e-5,
                               atol=1e-5)
    sharded = _port_grads(run, [at, bt], layer)
    layer.shards = None
    _check_grads(sharded, _port_grads(lambda x, y: layer((x, y)), [at, bt],
                                      layer))


def test_sharded_deconv_matches_jax(pallas_seen):
    """The stride-2 deconv: the port extends its input by a row of each
    neighbour and crops; JAX upsamples onto the sharded geometry and runs
    its flat conv there."""
    _, g_sh = _geoms(H, W)
    _, g1_sh = _geoms(H // 2, W // 2)
    x = jax.random.normal(jax.random.PRNGKey(7), (2, 2 * C, H // 2, W // 2))
    jl = JaxDeconv(features=C)
    xb = _split(x, g1_sh)
    params = jl.init(jax.random.PRNGKey(8), xb, (H // SP, W), geom_in=g1_sh,
                     geom_out=g_sh)
    want = _unsplit(jl.apply(params, xb, (H // SP, W), geom_in=g1_sh,
                             geom_out=g_sh), g_sh)
    assert "_fwd_kernel" in pallas_seen
    layer = DeconvBnLrnDrop(2 * C, C, gen=torch.Generator().manual_seed(0),
                            flat=True)
    sd = flax_to_torch({"deconv_0": jax.tree_util.tree_map(
        np.asarray, params["params"])})
    layer.load_state_dict({k.split(".", 1)[1]: v for k, v in sd.items()})
    xt = _t(x)

    def run(t):
        return merge_spatial(layer(split_spatial(t, SP), (H // SP, W)), SP)

    layer.shards = SpatialShards(SP)
    np.testing.assert_allclose(run(xt).detach().numpy(), want, rtol=1e-5,
                               atol=1e-5)
    sharded = _port_grads(run, [xt], layer)
    layer.shards = None
    _check_grads(sharded, _port_grads(lambda t: layer(t, (H, W)), [xt],
                                      layer))


def _model_grads(cfg, weights, x, dtype):
    """(logits, aux, gradients of sum(sin(logits)) + 0.5 sum(sin(aux)) by
    parameter name) of the port at ``cfg`` in ``dtype``."""
    m = build_model(dataclasses.replace(cfg, dtype=dtype),
                    torch.Generator().manual_seed(0))
    m.load_state_dict(weights)
    if dtype == "float64":
        m.double()
        x = x.double()
    _, lg, ax = m(x)
    loss = torch.sin(lg).sum() + 0.5 * torch.sin(ax).sum()
    names, params = zip(*m.named_parameters())
    return lg.detach(), ax.detach(), dict(zip(names, torch.autograd.grad(
        loss, params, materialize_grads=True)))


def _worst(got, want, rel, model_rel, offset=0.0):
    """max over tensors of max |a - b| / (rel max |b| + model_rel * model
    max + offset)."""
    top = max(float(w.abs().max()) for w in want.values())
    return max(float((got[k] - w).abs().max())
               / (rel * float(w.abs().max()) + model_rel * top + offset)
               for k, w in want.items())


def test_model_spatial_shards_matches_jax(pallas_seen):
    cfg1 = ModelConfig(**MODEL)
    cfg2 = dataclasses.replace(cfg1, spatial_shards=SP)
    x = jax.random.normal(jax.random.PRNGKey(0), (1, 64, 64, 6))
    jm = jax_build_model(JaxModelConfig(**MODEL, spatial_shards=SP))
    params = jax_build_model(JaxModelConfig(**MODEL)).init(
        jax.random.PRNGKey(1), x)
    _, want_lg, want_ax = jm.apply(params, x, logits_layout="NHWC")
    assert {"_fwd_kernel", "_mp_fwd_kernel"} <= pallas_seen
    weights = flax_to_torch(jax.tree_util.tree_map(np.asarray, params))
    xt = _t(x)
    exact = {sp: _model_grads(c, weights, xt, "float64")
             for sp, c in ((1, cfg1), (SP, cfg2))}
    f32 = {sp: _model_grads(c, weights, xt, "float32")
           for sp, c in ((1, cfg1), (SP, cfg2))}
    for got, want in zip(f32[SP][:2], (want_lg, want_ax)):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=1e-5 * np.abs(want).max())
    for got, want in zip(exact[SP][:2], exact[1][:2]):
        assert float((got - want).abs().max()) <= 1e-12 * float(
            want.abs().max())
    assert _worst(exact[SP][2], exact[1][2], 1.0, 0.0, 1e-2) < 1e-2  # JAX's
    assert _worst(exact[SP][2], exact[1][2], 1e-9, 1e-15) <= 1.0
    for sp in (1, SP):
        got = {k: v.double() for k, v in f32[sp][2].items()}
        assert _worst(got, exact[1][2], 1e-3, 1e-6) <= 1.0, sp


@pytest.mark.parametrize("h,sp,fs,match", [
    (36, 2, 2, "divisible"),      # 36 % (2 * 4)
    (64, 8, 3, "reach"),          # scale 2: 64 / 32 = 2 rows < 4
])
def test_shard_rows_raise(h, sp, fs, match):
    cfg = ModelConfig(**{**MODEL, "scale_space_num": 4, "flat_scales": fs,
                         "num_blocks": 1, "spatial_shards": sp})
    m = build_model(cfg, torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match=match):
        m(torch.zeros(1, h, 48, 6))


def _launches_per_step(monkeypatch, model_kwargs):
    """Kernel launches of one masked-CE train step at 64^2 on the CPU, each
    flat kernel's wrapper replaced by a counter that runs its plain
    version."""
    from msau_tpu_torch.ops import flatconv, flatres
    from msau_tpu_torch.train.trainer import make_loss_and_grad

    counts = {}
    for mod in (flatconv, flatres):
        monkeypatch.setattr(mod, "on_cuda", lambda name, t: True)
        for attr in dir(mod):
            if attr.endswith("_cuda") and hasattr(mod, attr[:-5] + "_plain"):
                name = attr[:-5]
                plain = getattr(mod, name + "_plain")

                def counted(*a, _name=name, _plain=plain, **k):
                    counts[_name] = counts.get(_name, 0) + 1
                    return _plain(*a, **k)

                monkeypatch.setattr(mod, attr, counted)
    model = build_model(ModelConfig(**model_kwargs),
                        torch.Generator().manual_seed(0))
    rng = np.random.default_rng(0)
    batch = {"input": torch.from_numpy(
                 rng.random((1, 64, 64, 8)).astype(np.float32)),
             "label": torch.from_numpy(
                 rng.integers(0, 17, (1, 64, 64)).astype(np.int32))}
    make_loss_and_grad(model)(batch)
    return counts


@pytest.mark.parametrize("sp", [1, 4])
def test_flat_launches_per_step(monkeypatch, sp):
    """The flagship's structure (4 scales, 3 stages, res_depth 2, feat_root
    8, flat_scales 3, 17 classes; 8 input channels) launches the flat
    kernels chip_smoke asserts on the card."""
    import chip_smoke

    table = chip_smoke.PER_STEP[3] if sp == 1 else chip_smoke.PER_STEP_SP4
    flat = {k: v for k, v in table.items()
            if not k.startswith(("resident_", "masked_ce_", "fused_"))}
    got = _launches_per_step(monkeypatch, {
        **chip_smoke.FLAGSHIP, "img_channels": 8, "flat_scales": 3,
        "spatial_shards": sp})
    assert {k: v for k, v in got.items() if v} == {k: v for k, v in
                                                  flat.items() if v}
    if sp > 1:
        assert table["flat_res_block"] == table["flat_res_block_bwd"] == 0
