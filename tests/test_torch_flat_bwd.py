"""Flat-layout backward: the port's ops (plain versions on the CPU, through
their autograd Functions) against ``jax.vjp`` of the JAX package's flat ops
on the body-flat layout, whose Pallas backward kernels run in interpret
mode.  The same seeded numpy inputs and cotangent go to both sides; a spy
on ``pl.pallas_call`` asserts by name that each Pallas backward body ran
(the JAX entry points take XLA branches at some shapes).

Tolerances, f32 on both sides: the input's cotangent within 1e-5, weight
and bias gradients within 1e-4, of each tensor's largest magnitude (sums
over the batch's pixels in another order).  The pool's routing is exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from msau_tpu.models.flat_layers import make_scale_geoms
from msau_tpu.ops import flatconv as jfc
from msau_tpu.ops.flatres import flat_res_block as jax_res_block
from msau_tpu_torch.ops.flatconv import (
    act_code,
    act_grad,
    concat_conv1x1,
    concat_conv1x1_bwd_plain,
    flat_conv2d,
    flat_conv_bwd_plain,
    flat_conv_dx_plain,
    flat_deconv2,
    flat_maxpool2,
)
from msau_tpu_torch.ops.flatres import flat_res_block

DX_TOL, DW_TOL = 1e-5, 1e-4


@pytest.fixture
def kernels_run(monkeypatch):
    """Names of the Pallas kernel bodies launched during the test."""
    seen = []
    real = pl.pallas_call

    def spy(kernel, *args, **kwargs):
        seen.append(getattr(kernel, "func", kernel).__name__)
        return real(kernel, *args, **kwargs)

    monkeypatch.setattr(pl, "pallas_call", spy)
    return seen


def _close(got: torch.Tensor, want, tol: float) -> None:
    want = np.asarray(want)
    assert tuple(got.shape) == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=0,
                               atol=tol * max(np.abs(want).max(), 1e-30))


def _oihw(w: np.ndarray) -> torch.Tensor:
    """flax HWIO [KH, KW, Cin, Cout] -> torch OIHW."""
    return torch.from_numpy(np.ascontiguousarray(w.transpose(3, 2, 0, 1)))


def _hwio(dw) -> np.ndarray:
    return np.asarray(dw).transpose(3, 2, 0, 1)


def _port_grads(fn, inputs):
    """torch.autograd.grad of fn(*inputs) for cotangent inputs[-1]."""
    *xs, g = inputs
    xs = [x.detach().clone().requires_grad_() for x in xs]
    y = fn(*xs)
    assert y.shape == g.shape
    return torch.autograd.grad(y, xs, g)


def _normal(rng, *shape, scale=1.0):
    return (rng.normal(size=shape) * scale).astype(np.float32)


# (cin, cout, k, dilation, act, lrn size): the LRN at sizes 8 and 16 (size
# 8 over 12 and 16 channels: the window is clamped at both ends and
# asymmetric, so a window and its mirror differ), acts, dilations 2 and 4,
# the 4x4 end conv (the dx pads are (2, 1)) and no epilogue at all
CONV_CASES = [
    (8, 8, 3, 1, None, 8),
    (8, 12, 3, 2, None, 8),
    (16, 16, 3, 4, None, 16),
    (6, 16, 3, 1, "relu", 8),
    (8, 8, 3, 2, "elu", 0),
    (8, 12, 3, 1, "elu", 8),
    (8, 17, 4, 1, None, 0),
    (8, 8, 3, 1, None, 0),
]


@pytest.mark.parametrize("cin,cout,k,d,act,lrn", CONV_CASES)
def test_conv_vjp_matches_pallas(kernels_run, cin, cout, k, d, act, lrn):
    geom = jfc.choose_geom(32, 48)
    rng = np.random.default_rng(cin * 7 + cout + k + d + lrn)
    x = _normal(rng, 2, cin, 32, 48)
    wk = _normal(rng, k, k, cin, cout, scale=0.3)
    b = _normal(rng, cout)
    g = _normal(rng, 2, cout, 32, 48)

    def jf(xb, w, bias):
        return jfc.flat_conv2d(xb, w, bias, geom, dilation=d, act=act,
                               lrn_size=lrn or None)

    _, vjp = jax.vjp(jf, jfc.to_body(jnp.asarray(x), geom), jnp.asarray(wk),
                     jnp.asarray(b))
    jdx, jdw, jdb = vjp(jfc.to_body(jnp.asarray(g), geom))
    bwd = "_epi_bwd_kernel" if (act or lrn) else "_dw_kernel"
    assert kernels_run.count("_fwd_kernel") == 2 and bwd in kernels_run
    dx, dw, db = _port_grads(
        lambda xt, w, bias: flat_conv2d(xt, w, bias, dilation=d, act=act,
                                        lrn_size=lrn),
        [torch.from_numpy(x), _oihw(wk), torch.from_numpy(b),
         torch.from_numpy(g)])
    _close(dx, jfc.from_body(jdx, geom), DX_TOL)
    _close(dw, _hwio(jdw), DW_TOL)
    _close(db, jdb, DW_TOL)


@pytest.mark.parametrize("ca,cb,cout", [(8, 8, 8), (16, 8, 16)])
def test_merge_conv_vjp_matches_pallas(kernels_run, ca, cb, cout):
    """The up-tower merge conv of [skip; up]: dw from _dw_kernel over the
    tuple input, the two branch cotangents from the dx conv's split
    outputs."""
    geom = jfc.choose_geom(32, 48)
    rng = np.random.default_rng(ca + cb + cout)
    a, bb = _normal(rng, 2, ca, 32, 48), _normal(rng, 2, cb, 32, 48)
    wk = _normal(rng, 3, 3, ca + cb, cout, scale=0.3)
    bias = _normal(rng, cout)
    g = _normal(rng, 2, cout, 32, 48)
    body = lambda t: jfc.to_body(jnp.asarray(t), geom)
    _, vjp = jax.vjp(lambda p, q, w, c: jfc.flat_concat_conv2d(p, q, w, c, geom),
                     body(a), body(bb), jnp.asarray(wk), jnp.asarray(bias))
    jda, jdb_in, jdw, jdb = vjp(body(g))
    assert {"_dw_kernel", "_fwd_kernel"} <= set(kernels_run)
    assert kernels_run.count("_fwd_kernel") == 2
    da, db_in, dw, db = _port_grads(
        lambda p, q, w, c: flat_conv2d((p, q), w, c),
        [torch.from_numpy(a), torch.from_numpy(bb), _oihw(wk),
         torch.from_numpy(bias), torch.from_numpy(g)])
    _close(da, jfc.from_body(jda, geom), DX_TOL)
    _close(db_in, jfc.from_body(jdb_in, geom), DX_TOL)
    _close(dw, _hwio(jdw), DW_TOL)
    _close(db, jdb, DW_TOL)


@pytest.mark.parametrize("c,act", [(8, "relu"), (16, "elu")])
def test_concat_conv1x1_vjp_matches_pallas(kernels_run, c, act):
    """The coupling conv through its autograd Function: its da, db, dwa,
    dwb, dbias from _cc_bwd_kernel; the port's from its one-pass backward
    (concat_conv1x1_bwd)."""
    geom = jfc.choose_geom(32, 48)
    rng = np.random.default_rng(c)
    a, bb = _normal(rng, 2, c, 32, 48), _normal(rng, 2, c, 32, 48)
    wk = _normal(rng, 1, 1, 2 * c, c, scale=0.3)
    bias = _normal(rng, c)
    g = _normal(rng, 2, c, 32, 48)
    body = lambda t: jfc.to_body(jnp.asarray(t), geom)
    _, vjp = jax.vjp(lambda p, q, w, z: jfc.flat_concat_conv1x1(
        p, q, w, z, geom, act=act), body(a), body(bb), jnp.asarray(wk),
        jnp.asarray(bias))
    jda, jdb_in, jdw, jdb = vjp(body(g))
    assert kernels_run == ["_cc_fwd_kernel", "_cc_bwd_kernel"]
    da, db_in, dw, db = _port_grads(
        lambda p, q, w, z: concat_conv1x1(p, q, w, z, act=act),
        [torch.from_numpy(a), torch.from_numpy(bb), _oihw(wk),
         torch.from_numpy(bias), torch.from_numpy(g)])
    _close(da, jfc.from_body(jda, geom), DX_TOL)
    _close(db_in, jfc.from_body(jdb_in, geom), DX_TOL)
    _close(dw, _hwio(jdw), DW_TOL)
    _close(db, jdb, DW_TOL)


# (H, W): the tests' usual 32x48 and a ragged size (H prime, W not a
# multiple of 8; the JAX layout takes it with one-row tiles)
CC_SIZES = [(32, 48), (37, 46)]


def _cc_operands(seed, ca, cb, cout, h, w):
    rng = np.random.default_rng(seed)
    a, bb = _normal(rng, 2, ca, h, w), _normal(rng, 2, cb, h, w)
    wk = _normal(rng, 1, 1, ca + cb, cout, scale=0.3)
    return a, bb, wk, _normal(rng, cout), _normal(rng, 2, cout, h, w)


@pytest.mark.parametrize("h,w", CC_SIZES)
@pytest.mark.parametrize("act", ["relu", "elu", None])
def test_concat_conv1x1_bwd_plain_matches_pallas(kernels_run, act, h, w):
    """The one-pass coupling backward's plain version (the oracle its
    kernel is held to on the card) against _cc_bwd_kernel: unequal inputs
    (8 and 16 channels), 12 output channels."""
    geom = jfc.choose_geom(h, w)
    a, bb, wk, bias, g = _cc_operands(h + len(str(act)), 8, 16, 12, h, w)
    body = lambda t: jfc.to_body(jnp.asarray(t), geom)
    _, vjp = jax.vjp(lambda p, q, wt, z: jfc.flat_concat_conv1x1(
        p, q, wt, z, geom, act=act), body(a), body(bb), jnp.asarray(wk),
        jnp.asarray(bias))
    jda, jdb_in, jdw, jdb = vjp(body(g))
    assert "_cc_bwd_kernel" in kernels_run
    da, db_in, dw, db = concat_conv1x1_bwd_plain(
        torch.from_numpy(a), torch.from_numpy(bb), _oihw(wk),
        torch.from_numpy(bias), torch.from_numpy(g), act=act)
    assert da.dtype == db_in.dtype == torch.float32
    _close(da, jfc.from_body(jda, geom), DX_TOL)
    _close(db_in, jfc.from_body(jdb_in, geom), DX_TOL)
    _close(dw, _hwio(jdw), DW_TOL)
    _close(db, jdb, DW_TOL)


@pytest.mark.parametrize("act", ["relu", "elu"])
def test_concat_conv1x1_bwd_bf16_rounds_as_the_split_path(act):
    """bf16: the one pass against the split path it replaced (conv stage 1,
    then the dx conv of its bf16 g0), on the same inputs.  Both round g0
    to bf16 once: da and db are sums of the same bf16 products in another
    order, rounded to bf16 (within one bf16 ulp of max |want|, 2^-7); dw
    sums the rounded g0 and dbias the f32 one, f32 sums in another order
    (1e-5 of max |want|).  The rounding contract is what the test pins
    (with elu, whose g0 bf16 cannot hold): dw from the f32 g0, or dbias
    from the rounded one, would lie outside those bounds."""
    a, bb, wk, bias, g = _cc_operands(5, 8, 16, 12, 32, 48)
    a, bb, g = (torch.from_numpy(t).bfloat16() for t in (a, bb, g))
    w, bias = _oihw(wk), torch.from_numpy(bias)
    da, db_in, dw, db = concat_conv1x1_bwd_plain(a, bb, w, bias, g, act=act)
    g0, want_dw, want_db = flat_conv_bwd_plain(a, bb, w, bias, g, act=act)
    want_da, want_db_in = flat_conv_dx_plain(g0, w, (8, 16))
    assert da.dtype == db_in.dtype == torch.bfloat16
    for got, want in ((da, want_da), (db_in, want_db_in)):
        _close(got.float(), want.float().numpy(), 2.0 ** -7)
    _close(dw, want_dw.numpy(), 1e-5)
    _close(db, want_db.numpy(), 1e-5)
    if act == "relu":
        return   # g0 = g or 0, bf16 values: rounding it changes nothing
    # with elu the contract bites: dw from the f32 g0, or dbias from the
    # rounded one, lies outside those bounds
    x = torch.cat([a, bb], 1).float()
    z = torch.einsum("oc,nchw->nohw", w.bfloat16().float()[:, :, 0, 0], x)
    g0f = g.float() * act_grad(z + bias[:, None, None], act_code(act))
    for other, got in ((torch.einsum("nohw,nchw->oc", g0f, x), dw[:, :, 0, 0]),
                       (g0.float().sum((0, 2, 3)), db)):
        assert (other - got).abs().max() > 1e-5 * got.abs().max()


# (geometry, backward body): 64x248 with P 4 has Wp 256 (the lane-aligned
# body); 64x96 takes the classic body
RES_GEOMS = {"aligned": (jfc.FlatGeom(64, 248, 4, 8), "_bwd_kernel_al"),
             "classic": (jfc.choose_geom(64, 96), "_bwd_kernel")}


@pytest.mark.parametrize("layout", sorted(RES_GEOMS))
@pytest.mark.parametrize("c,act", [(8, "relu"), (16, "elu"), (4, "relu"),
                                   (32, "elu")])
def test_res_block_vjp_matches_pallas(kernels_run, layout, c, act):
    geom, body = RES_GEOMS[layout]
    rng = np.random.default_rng(c + len(layout))
    x = _normal(rng, 2, c, geom.H, geom.W)
    w1, w2 = (_normal(rng, 3, 3, c, c, scale=0.3) for _ in range(2))
    b1, b2 = (_normal(rng, c, scale=0.1) for _ in range(2))
    g = _normal(rng, 2, c, geom.H, geom.W)
    _, vjp = jax.vjp(lambda xb, *p: jax_res_block(xb, *p, geom, act),
                     jfc.to_body(jnp.asarray(x), geom),
                     *map(jnp.asarray, (w1, b1, w2, b2)))
    jdx, jdw1, jdb1, jdw2, jdb2 = vjp(jfc.to_body(jnp.asarray(g), geom))
    assert body in kernels_run
    dx, dw1, db1, dw2, db2 = _port_grads(
        lambda *t: flat_res_block(*t, act),
        [torch.from_numpy(x), _oihw(w1), torch.from_numpy(b1), _oihw(w2),
         torch.from_numpy(b2), torch.from_numpy(g)])
    _close(dx, jfc.from_body(jdx, geom), DX_TOL)
    for got, want in ((dw1, _hwio(jdw1)), (db1, jdb1), (dw2, _hwio(jdw2)),
                      (db2, jdb2)):
        _close(got, want, DW_TOL)


def _deconv_operands(seed, cin, cout, h, w, ho, wo):
    rng = np.random.default_rng(seed)
    x = _normal(rng, 2, cin, h, w)
    # asymmetric taps: a flipped or transposed kernel cannot pass
    wk = (_normal(rng, 3, 3, cin, cout, scale=0.3)
          + np.arange(9, dtype=np.float32).reshape(3, 3, 1, 1) * 0.05)
    b = _normal(rng, cout)
    g = _normal(rng, 2, cout, ho, wo)
    # torch's ConvTranspose2d weight [in, out, kh, kw] is the flax kernel's
    # spatial flip
    w_torch = torch.from_numpy(np.ascontiguousarray(
        np.flip(wk, (0, 1)).transpose(2, 3, 0, 1)))
    return x, wk, b, g, w_torch


def _deconv_port(x, w_torch, b, g, target):
    dx, dw, db = _port_grads(lambda *t: flat_deconv2(*t, target),
                             [torch.from_numpy(x), w_torch,
                              torch.from_numpy(b), torch.from_numpy(g)])
    # the flax kernel's gradient is the spatial flip of torch's
    return dx, np.flip(dw.numpy(), (2, 3)).transpose(2, 3, 0, 1), db


def _check_deconv(got, jdx, jdw, jdb, g_in):
    dx, dw, db = got
    _close(dx, jfc.from_body(jdx, g_in), DX_TOL)
    _close(torch.from_numpy(np.ascontiguousarray(dw)), np.asarray(jdw), DW_TOL)
    _close(db, jdb, DW_TOL)


@pytest.mark.parametrize("cin,cout", [(16, 8), (8, 16)])
def test_deconv_vjp_matches_fused_pallas(kernels_run, cin, cout):
    """The fused deconv's backward: _dc_dx_kernel and _dc_dw_kernel."""
    g_out, g_in = make_scale_geoms(32, 248, 2, itemsize=4)
    x, wk, b, g, w_torch = _deconv_operands(cin, cin, cout, g_in.H, g_in.W,
                                            g_out.H, g_out.W)
    _, vjp = jax.vjp(lambda xb, w, c: jfc.flat_deconv2(xb, w, c, g_in, g_out),
                     jfc.to_body(jnp.asarray(x), g_in), jnp.asarray(wk),
                     jnp.asarray(b))
    jdx, jdw, jdb = vjp(jfc.to_body(jnp.asarray(g), g_out))
    assert {"_dc_dx_kernel", "_dc_dw_kernel"} <= set(kernels_run)
    _check_deconv(_deconv_port(x, w_torch, b, g, (g_out.H, g_out.W)),
                  jdx, jdw, jdb, g_in)


def test_deconv_vjp_matches_pallas_upsample_then_conv(kernels_run):
    """The two-op form's backward: the conv's dx (_fwd_kernel) and dw
    (_dw_kernel), then the zero-insert's backward (_ups_bwd_kernel)."""
    g_out, g_in = make_scale_geoms(32, 248, 2, itemsize=4)
    x, wk, b, g, w_torch = _deconv_operands(3, 8, 8, g_in.H, g_in.W,
                                            g_out.H, g_out.W)
    _, vjp = jax.vjp(lambda xb, w, c: jfc.flat_conv2d(
        jfc.flat_upsample2(xb, g_in, g_out), w, c, g_out),
        jfc.to_body(jnp.asarray(x), g_in), jnp.asarray(wk), jnp.asarray(b))
    jdx, jdw, jdb = vjp(jfc.to_body(jnp.asarray(g), g_out))
    assert {"_ups_bwd_kernel", "_dw_kernel"} <= set(kernels_run)
    assert kernels_run.count("_fwd_kernel") == 2
    _check_deconv(_deconv_port(x, w_torch, b, g, (g_out.H, g_out.W)),
                  jdx, jdw, jdb, g_in)


@pytest.mark.parametrize("h,w", [(16, 24), (8, 12)])
def test_deconv_odd_target_vjp_matches_zero_insert_then_pallas_conv(
        kernels_run, h, w):
    """Odd targets (2H-1): the zero-inserted canvas cropped (XLA), then the
    flat conv, whose dx and dw are Pallas kernels.  The output geometry is
    built by hand (one guard block of all rows, Wp = 128: the width stays
    even), as the JAX package finds no flat geometry for odd sizes."""
    ho, wo = 2 * h - 1, 2 * w
    g_in = jfc.choose_geom(h, w)
    g_out = jfc.FlatGeom(ho, wo, (128 - wo) // 2, ho)
    x, wk, b, g, w_torch = _deconv_operands(h * w, 8, 8, h, w, ho, wo)
    _, vjp = jax.vjp(lambda xb, wt, c: jfc.flat_conv2d(
        jfc.body_upsample2(xb, g_in, g_out), wt, c, g_out),
        jfc.to_body(jnp.asarray(x), g_in), jnp.asarray(wk), jnp.asarray(b))
    jdx, jdw, jdb = vjp(jfc.to_body(jnp.asarray(g), g_out))
    assert "_dw_kernel" in kernels_run
    _check_deconv(_deconv_port(x, w_torch, b, g, (ho, wo)),
                  jdx, jdw, jdb, g_in)


def _tied(rng, *shape):
    """Post-relu values on a coarse grid: many zeros and repeated values,
    so pool windows hold ties of every kind."""
    return (np.round(np.maximum(rng.normal(size=shape), 0) * 2) / 2).astype(
        np.float32)


def test_maxpool_vjp_matches_pallas_tie_rule(kernels_run):
    """Even sizes: _mp_bwd_kernel's rule (the column with the larger
    row-pair max, a tie to the even column, then the upper row unless the
    lower is larger), not torch's first match; exact."""
    g_in, g_out = make_scale_geoms(32, 248, 2, itemsize=4)
    rng = np.random.default_rng(7)
    x = _tied(rng, 2, 8, 32, 248)
    x[0, 0, :2, :2] = [[1, 5], [5, 0]]    # bottom-left; torch: top-right
    g = _normal(rng, 2, 8, 16, 124)
    _, vjp = jax.vjp(lambda xb: jfc.body_maxpool2(xb, g_in, g_out),
                     jfc.to_body(jnp.asarray(x), g_in))
    (jdx,) = vjp(jfc.to_body(jnp.asarray(g), g_out))
    assert kernels_run == ["_mp_fwd_kernel", "_mp_bwd_kernel"]
    (dx,) = _port_grads(flat_maxpool2, [torch.from_numpy(x),
                                        torch.from_numpy(g)])
    want = np.asarray(jfc.from_body(jdx, g_in))
    np.testing.assert_array_equal(dx.numpy(), want)
    assert want[0, 0, 1, 0] == g[0, 0, 0, 0] and want[0, 0, 0, 1] == 0
    ties = (x.reshape(2, 8, 16, 2, 124, 2).max((3, 5), keepdims=True)
            == x.reshape(2, 8, 16, 2, 124, 2)).sum((3, 5))
    assert (ties > 1).mean() > 0.2


@pytest.mark.parametrize("h,w", [(15, 24), (31, 16), (7, 8)])
def test_maxpool_odd_vjp_splits_ties_like_jax(kernels_run, h, w):
    """Odd sizes: the JAX package's -inf-padded reshape max (XLA), whose
    gradient splits a tie evenly over the tied elements."""
    g_in = jfc.choose_geom(h, w)
    g_out = jfc.choose_geom(-(-h // 2), -(-w // 2))
    rng = np.random.default_rng(h * w)
    x = _tied(rng, 2, 8, h, w)
    g = _normal(rng, 2, 8, g_out.H, g_out.W)
    _, vjp = jax.vjp(lambda xb: jfc.body_maxpool2(xb, g_in, g_out),
                     jfc.to_body(jnp.asarray(x), g_in))
    (jdx,) = vjp(jfc.to_body(jnp.asarray(g), g_out))
    assert kernels_run == []
    (dx,) = _port_grads(flat_maxpool2, [torch.from_numpy(x),
                                        torch.from_numpy(g)])
    want = np.asarray(jfc.from_body(jdx, g_in))
    np.testing.assert_allclose(dx.numpy(), want, rtol=1e-6, atol=0)
    assert np.any((want != 0) & (np.abs(want) < np.abs(g).max() / 2 - 1e-3))
