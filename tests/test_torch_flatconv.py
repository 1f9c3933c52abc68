"""Flat-layout forward ops: the port's plain versions (msau_tpu_torch.ops.
flatconv, NCHW) against the JAX package's Pallas kernels in interpret mode
on the body-flat layout, same numpy inputs, converted with ``to_body`` /
``from_body``.  Every JAX-side case asserts that its Pallas kernel ran (a
spy on ``pl.pallas_call`` records the kernel names): the public JAX entry
points take XLA branches at some shapes, and a case landing there would
compare nothing Pallas computed.

Tolerance: f32 on both sides, max abs error within 1e-5 of the output's
scale (max(1, max |want|)): the residue is the conv sums' order.  Layout
conversion and max pooling are exact.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from jax.experimental import pallas as pl

from msau_tpu.models.flat_layers import make_scale_geoms
from msau_tpu.ops import flatconv as jfc
from msau_tpu_torch.ops.flatconv import (
    concat_conv1x1,
    concat_conv1x1_plain,
    flat_conv2d,
    flat_conv2d_plain,
    flat_deconv2,
    flat_deconv2_plain,
    flat_maxpool2,
    flat_maxpool2_plain,
    to_nchw,
    to_nchw_plain,
)
from msau_tpu_torch.utils.flat_cases import (
    FLAT_BWD_CASES,
    FLAT_CASES,
    flat_bwd_case_fns,
    flat_bwd_case_tensors,
    flat_bwd_errors,
    flat_case_fns,
    flat_case_tensors,
)

REL = 1e-5


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


def _close(got: torch.Tensor, want) -> None:
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=REL * max(1.0, np.abs(want).max()))


def _body(x: np.ndarray, geom):
    return jfc.to_body(jnp.asarray(x), geom)


def _hwio_to_oihw(w: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(w.transpose(3, 2, 0, 1)))


def _conv_inputs(seed, n, cin, cout, h, w, kh, kw):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, cin, h, w)).astype(np.float32)
    wk = (rng.normal(size=(kh, kw, cin, cout)) * 0.3).astype(np.float32)
    b = rng.normal(size=(cout,)).astype(np.float32)
    return x, wk, b


# (cin, cout, k, dilation, act, lrn): the model's dil convs (rate 1/2/4 +
# LRN), end conv (4x4, even kernel: the extra pad row/col bottom-right) and
# the epilogue's act x LRN grid
CONV_CASES = [
    (8, 8, 3, 1, None, True),
    (8, 16, 3, 2, None, True),
    (16, 8, 3, 4, None, True),
    (8, 17, 4, 1, None, False),
    (8, 8, 3, 1, "relu", False),
    (8, 8, 3, 1, "relu", True),
    (8, 8, 3, 2, "elu", False),
    (16, 16, 3, 1, "elu", True),
    (8, 8, 3, 1, None, False),
]


@pytest.mark.parametrize("cin,cout,k,d,act,lrn", CONV_CASES)
def test_conv_matches_pallas(kernels_run, cin, cout, k, d, act, lrn):
    geom = jfc.choose_geom(32, 48)
    x, wk, b = _conv_inputs(cin * k + d, 2, cin, cout, 32, 48, k, k)
    want = jfc.from_body(jfc.flat_conv2d(
        _body(x, geom), jnp.asarray(wk), jnp.asarray(b), geom, dilation=d,
        act=act, lrn_size=cout if lrn else None), geom)
    assert kernels_run == ["_fwd_kernel"]
    got = flat_conv2d_plain(torch.from_numpy(x), None, _hwio_to_oihw(wk),
                            torch.from_numpy(b), dilation=d, act=act,
                            lrn_size=cout if lrn else 0)
    _close(got, want)


@pytest.mark.parametrize("ca,cb,cout", [(8, 8, 8), (8, 16, 8)])
def test_concat_conv_matches_pallas(kernels_run, ca, cb, cout):
    """The up-tower merge: a 3x3 conv of the channel concat [skip; up]."""
    geom = jfc.choose_geom(32, 48)
    rng = np.random.default_rng(ca + cb)
    a = rng.normal(size=(2, ca, 32, 48)).astype(np.float32)
    b = rng.normal(size=(2, cb, 32, 48)).astype(np.float32)
    wk = (rng.normal(size=(3, 3, ca + cb, cout)) * 0.3).astype(np.float32)
    bias = rng.normal(size=(cout,)).astype(np.float32)
    want = jfc.from_body(jfc.flat_concat_conv2d(
        _body(a, geom), _body(b, geom), jnp.asarray(wk), jnp.asarray(bias),
        geom), geom)
    assert kernels_run == ["_fwd_kernel"]
    got = flat_conv2d((torch.from_numpy(a), torch.from_numpy(b)),
                      _hwio_to_oihw(wk), torch.from_numpy(bias))
    _close(got, want)


@pytest.mark.parametrize("c,act", [(8, "relu"), (16, "elu"), (32, None)])
def test_concat_conv1x1_matches_pallas(kernels_run, c, act):
    """The coupling conv act(W [prev; y] + b), 1x1."""
    geom = jfc.choose_geom(32, 48)
    rng = np.random.default_rng(c)
    a, b = (rng.normal(size=(2, c, 32, 48)).astype(np.float32)
            for _ in range(2))
    wk = (rng.normal(size=(1, 1, 2 * c, c)) * 0.3).astype(np.float32)
    bias = rng.normal(size=(c,)).astype(np.float32)
    want = jfc.from_body(jfc.flat_concat_conv1x1(
        _body(a, geom), _body(b, geom), jnp.asarray(wk), jnp.asarray(bias),
        geom, act=act), geom)
    assert kernels_run == ["_cc_fwd_kernel"]
    args = (torch.from_numpy(a), torch.from_numpy(b), _hwio_to_oihw(wk),
            torch.from_numpy(bias))
    _close(concat_conv1x1_plain(*args, act=act), want)
    _close(concat_conv1x1(*args, act=act), want)


def _deconv_geoms():
    # geom_out Wp 256: the lane-aligned output the fused TPU deconv needs
    g_out, g_in = make_scale_geoms(32, 248, 2, itemsize=4)
    return g_in, g_out


def _deconv_inputs(seed, cin, cout, h, w):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(2, cin, h, w)).astype(np.float32)
    # asymmetric taps: a flipped or transposed kernel cannot pass
    wk = (rng.normal(size=(3, 3, cin, cout)) * 0.3
          + np.arange(9).reshape(3, 3, 1, 1) * 0.05).astype(np.float32)
    b = rng.normal(size=(cout,)).astype(np.float32)
    # torch's ConvTranspose2d weight [in, out, kh, kw] is the flax
    # kernel's spatial flip (utils/transplant.py)
    w_torch = torch.from_numpy(np.ascontiguousarray(
        np.flip(wk, (0, 1)).transpose(2, 3, 0, 1)))
    return x, wk, b, w_torch


@pytest.mark.parametrize("cin,cout", [(16, 8), (8, 16)])
def test_deconv_matches_fused_pallas(kernels_run, cin, cout):
    g_in, g_out = _deconv_geoms()
    x, wk, b, w_torch = _deconv_inputs(cin, cin, cout, g_in.H, g_in.W)
    want = jfc.flat_deconv2(_body(x, g_in), jnp.asarray(wk), jnp.asarray(b),
                            g_in, g_out)
    assert want is not None and kernels_run == ["_dc_fwd_kernel"]
    got = flat_deconv2_plain(torch.from_numpy(x), w_torch,
                             torch.from_numpy(b), (g_out.H, g_out.W))
    _close(got, jfc.from_body(want, g_out))


def test_deconv_matches_pallas_upsample_then_conv(kernels_run):
    """The JAX two-op form (zero-insert kernel, then the flat conv), which
    it takes where the fused deconv's alignment gate fails."""
    g_in, g_out = _deconv_geoms()
    x, wk, b, w_torch = _deconv_inputs(3, 8, 8, g_in.H, g_in.W)
    up = jfc.flat_upsample2(_body(x, g_in), g_in, g_out)
    want = jfc.flat_conv2d(up, jnp.asarray(wk), jnp.asarray(b), g_out)
    assert kernels_run == ["_ups_fwd_kernel", "_fwd_kernel"]
    got = flat_deconv2_plain(torch.from_numpy(x), w_torch,
                             torch.from_numpy(b), (g_out.H, g_out.W))
    _close(got, jfc.from_body(want, g_out))


@pytest.mark.parametrize("h,w", [(16, 24), (8, 12)])
def test_deconv_odd_target_matches_zero_insert_then_pallas_conv(
        kernels_run, h, w):
    """An odd target (2H-1): the zero-inserted canvas cropped, then the
    SAME conv, as DeconvBnLrnDrop's flat path computes it.  The JAX
    package finds no flat geometry for odd sizes (it drops to
    flat_scales=0 there), so the output geometry is built by hand: one
    guard block of all 2H-1 rows, Wp = 128."""
    g_in = jfc.choose_geom(h, w)
    g_out = jfc.FlatGeom(2 * h - 1, 2 * w, (128 - 2 * w) // 2, 2 * h - 1)
    x, wk, b, w_torch = _deconv_inputs(h * w, 8, 8, h, w)
    up = jfc.body_upsample2(_body(x, g_in), g_in, g_out)
    want = jfc.flat_conv2d(up, jnp.asarray(wk), jnp.asarray(b), g_out)
    assert kernels_run == ["_fwd_kernel"]
    got = flat_deconv2_plain(torch.from_numpy(x), w_torch,
                             torch.from_numpy(b), (2 * h - 1, 2 * w))
    _close(got, jfc.from_body(want, g_out))


def test_maxpool_matches_pallas(kernels_run):
    g_in, g_out = make_scale_geoms(32, 248, 2, itemsize=4)
    x = np.random.default_rng(7).normal(size=(2, 8, 32, 248)).astype(np.float32)
    want = jfc.body_maxpool2(_body(x, g_in), g_in, g_out)
    assert kernels_run == ["_mp_fwd_kernel"]
    got = flat_maxpool2(torch.from_numpy(x))
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(jfc.from_body(want, g_out)))


@pytest.mark.parametrize("h,w", [(15, 24), (31, 16), (7, 8)])
def test_maxpool_odd_matches_xla_fallback(kernels_run, h, w):
    """Odd sizes: the -inf-padded SAME pool, which the JAX package runs in
    XLA (no Pallas kernel)."""
    g_in = jfc.choose_geom(h, w)
    g_out = jfc.choose_geom(-(-h // 2), -(-w // 2))
    x = np.random.default_rng(h * w).normal(size=(2, 8, h, w)).astype(
        np.float32)
    want = jfc.from_body(jfc.body_maxpool2(_body(x, g_in), g_in, g_out), g_out)
    assert kernels_run == []
    np.testing.assert_array_equal(
        flat_maxpool2_plain(torch.from_numpy(x)).numpy(), np.asarray(want))


@pytest.mark.parametrize("dtype", [np.float32, jnp.bfloat16])
def test_to_nchw_matches_pallas(kernels_run, dtype):
    geom = jfc.FlatGeom(64, 128, 64, 8)   # W and Wp multiples of 128
    x = np.random.default_rng(0).normal(size=(2, 64, 128, 16)).astype(
        np.float32)
    xj = jnp.asarray(x).astype(dtype)
    want = jfc.to_body_nhwc_fused(xj, geom)
    assert want is not None and kernels_run == ["_to_body_kernel"]
    want = np.asarray(jfc.from_body(want, geom).astype(jnp.float32))
    tdtype = torch.float32 if dtype == np.float32 else torch.bfloat16
    got = to_nchw_plain(torch.from_numpy(x).to(tdtype), tdtype)
    assert got.dtype == tdtype and got.is_contiguous()
    np.testing.assert_array_equal(got.float().numpy(), want)


def test_to_nchw_casts_in_the_same_pass():
    x = torch.randn(1, 5, 7, 3, generator=torch.Generator().manual_seed(0))
    got = to_nchw(x, torch.bfloat16)
    assert got.dtype == torch.bfloat16 and got.shape == (1, 3, 5, 7)
    assert torch.equal(got, x.permute(0, 3, 1, 2).bfloat16())


def _grads(fn, *xs):
    """torch.autograd.grad of fn(*xs) against a seeded cotangent."""
    xs = [x.detach().clone().requires_grad_() for x in xs]
    y = fn(*xs)
    g = torch.randn(y.shape, generator=torch.Generator().manual_seed(5))
    return torch.autograd.grad(y, xs, g)


@pytest.mark.parametrize("op", ["conv_lrn", "conv_elu_pair", "end_conv",
                                 "concat1x1", "pool", "deconv"])
def test_gradient_flows_through_each_flat_op(op):
    """Each flat op's backward (plain versions on the CPU) against torch
    autograd of the same function written with torch ops; f32, 1e-5 of
    each gradient's scale."""
    rng = np.random.default_rng(len(op))
    t = lambda *s: torch.from_numpy(rng.normal(size=s).astype(np.float32))
    F = torch.nn.functional
    if op == "conv_lrn":
        args = (t(2, 6, 9, 11), t(12, 6, 3, 3) * 0.3, t(12))
        ours = lambda x, w, b: flat_conv2d(x, w, b, dilation=2, lrn_size=8)
        ref = lambda x, w, b: F.local_response_norm(
            F.conv2d(x, w, b, padding=2, dilation=2), 8)
    elif op == "conv_elu_pair":
        args = (t(2, 4, 7, 5), t(2, 3, 7, 5), t(8, 7, 3, 3) * 0.3, t(8))
        ours = lambda a, b, w, bias: flat_conv2d((a, b), w, bias, act="elu")
        ref = lambda a, b, w, bias: F.elu(F.conv2d(torch.cat([a, b], 1), w,
                                                   bias, padding=1))
    elif op == "end_conv":
        args = (t(1, 8, 9, 6), t(17, 8, 4, 4) * 0.3, t(17))
        ours = lambda x, w, b: flat_conv2d(x, w, b)
        ref = lambda x, w, b: F.conv2d(F.pad(x, (1, 2, 1, 2)), w, b)
    elif op == "concat1x1":
        args = (t(2, 5, 6, 7), t(2, 5, 6, 7), t(5, 10, 1, 1), t(5))
        ours = lambda a, b, w, bias: concat_conv1x1(a, b, w, bias, act="relu")
        ref = lambda a, b, w, bias: F.relu(F.conv2d(torch.cat([a, b], 1), w,
                                                    bias))
    elif op == "pool":
        args = (t(2, 3, 9, 7),)
        ours = flat_maxpool2
        ref = lambda x: F.max_pool2d(x, 2, 2, ceil_mode=True)
    else:
        args = (t(2, 6, 5, 7), t(6, 4, 3, 3), t(4))
        ours = lambda x, w, b: flat_deconv2(x, w, b, (9, 14))
        ref = lambda x, w, b: F.conv_transpose2d(x, w, b, stride=2, padding=1,
                                                 output_padding=(0, 1))
    for got, want in zip(_grads(ours, *args), _grads(ref, *args)):
        _close(got, want.numpy())


def test_bf16_ops_round_once_from_f32():
    """bf16 activations: f32 accumulation and epilogue, one rounding at the
    end (the kernels' contract), so the result is the f32 result of the
    bf16-rounded operands, rounded."""
    x, wk, b = _conv_inputs(0, 1, 8, 8, 12, 10, 3, 3)
    xb = torch.from_numpy(x).bfloat16()
    w = _hwio_to_oihw(wk)
    got = flat_conv2d_plain(xb, None, w, torch.from_numpy(b), act="elu",
                            lrn_size=8)
    want = flat_conv2d_plain(xb.float(), None, w.bfloat16().float(),
                             torch.from_numpy(b), act="elu", lrn_size=8)
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, want.bfloat16())


@pytest.mark.parametrize("case", [c for c in FLAT_BWD_CASES if not c["per_step"]],
                         ids=lambda c: f"{c['op']}-{c['name']}")
def test_card_bwd_cases_take_the_plain_version_on_the_cpu(case):
    """The backward kernels' ragged card cases on CPU tensors: the CUDA
    wrapper refuses them, the plain version gives outputs of the kinds and
    shapes the card check compares."""
    tensors = flat_bwd_case_tensors(case, np.random.default_rng(0),
                                    torch.device("cpu"), torch.float32)
    kernel, plain = flat_bwd_case_fns(case, tensors)
    with pytest.raises(ValueError, match="CUDA"):
        kernel()
    got = plain()
    errs = flat_bwd_errors(case, got, got, "float32")
    assert [e[1] for e in errs] == [0.0] * len(got)
    assert all(torch.isfinite(t).all() for t in got)


@pytest.mark.parametrize("case", [c for c in FLAT_CASES if not c["per_request"]],
                         ids=lambda c: f"{c['op']}-{c['name']}")
def test_card_cases_take_the_plain_version_on_the_cpu(case):
    """The card's ragged cases (utils.flat_cases) on CPU tensors: the CUDA
    wrapper refuses them, the plain version gives the op's shape."""
    tensors = flat_case_tensors(case, np.random.default_rng(0),
                                torch.device("cpu"), torch.float32)
    kernel, plain = flat_case_fns(case, tensors, torch.float32)
    with pytest.raises(ValueError, match="CUDA"):
        kernel()
    got = plain()
    n, h, w = tensors[0].shape[0], case.get("ho", case["h"]), case.get(
        "wo", case["w"])
    if case["op"] == "flat_maxpool2":
        h, w = -(-h // 2), -(-w // 2)
    c = case.get("cout", case["c"])
    assert got.shape == (n, c, h, w) and torch.isfinite(got).all()


# ---- f32 on the tensor cores: the arithmetic of csrc/conv_fast.cuh's
# conv_core_tc, emulated with torch casts

def _bf16_parts(x: torch.Tensor, parts: int):
    """x (f32) as ``parts`` bf16-valued f32 tensors, the largest first, each
    the rounded remainder of the ones before (attention_mma.cuh:split2)."""
    out, r = [], x
    for _ in range(parts):
        b = r.to(torch.bfloat16).float()
        out.append(b)
        r = r - b
    return out


def _conv_of_parts(x, w, dilation, parts, terms):
    """The conv as the kernel sums it: x and w in ``parts`` bf16 parts, the
    products of parts (qa, qb) in ``terms``, each exact in f32 (8-bit
    significands), summed over the taps and channels in f32."""
    xs, ws = _bf16_parts(x, parts), _bf16_parts(w, parts)
    return sum(F.conv2d(xs[qa], ws[qb], dilation=dilation)
               for qa, qb in terms)


def _part_errors(x, w, d):
    """The scaled error (against 1e-5 of max(1, max |want|), the card
    test's) of the six products of three parts, of the three products of
    two parts and of a plain f32 conv, each against the float64 conv of x
    (padded to the kernel's "same" output) and w at dilation d."""
    k = w.shape[-1]
    lo = (k - 1) * d // 2
    x = F.pad(x, (lo, (k - 1) * d - lo, lo, (k - 1) * d - lo))
    want = F.conv2d(x.double(), w.double(), dilation=d)

    def err(got):
        return float((got.double() - want).abs().max()
                     / max(1.0, float(want.abs().max())))

    six = err(_conv_of_parts(x, w, d, 3, [(0, 2), (1, 1), (2, 0), (0, 1),
                                          (1, 0), (0, 0)]))
    three = err(_conv_of_parts(x, w, d, 2, [(0, 1), (1, 0), (0, 0)]))
    return six, three, err(F.conv2d(x, w, dilation=d))


TC_SHAPES = [(8, 8, 3, 1), (16, 32, 3, 4), (8, 17, 4, 1)]


@pytest.mark.parametrize("cin,cout,k,d", TC_SHAPES)
def test_three_bf16_parts_carry_the_f32_conv(cin, cout, k, d):
    """Three bf16 parts of input and weights, the six products qa + qb < 3,
    hold the conv to f32's own rounding: within the card test's tolerance
    (1e-5 of max(1, max |want|)) of the float64 conv and within twice
    where a plain f32 conv lies.  Two parts with three products carry 16
    bits: they lie over five times as far as the f32 conv (at these
    operands still inside 1e-5, a tolerance looser than f32's rounding),
    so the kernel takes three."""
    rng = np.random.default_rng(24)
    x = torch.from_numpy(rng.normal(size=(2, cin, 19, 23)).astype(np.float32))
    w = torch.from_numpy((rng.normal(size=(cout, cin, k, k))
                          * (k * k * cin) ** -0.5).astype(np.float32))
    six, three, f32 = _part_errors(x, w, d)
    assert six <= REL and six <= 2 * f32, (six, f32)
    assert three > 5 * f32 and three > 10 * six, (three, f32, six)


@pytest.mark.parametrize("cin,cout,k,d", TC_SHAPES)
def test_two_bf16_parts_miss_the_f32_tolerance(cin, cout, k, d):
    """Where the parts' remainders share a sign, the products that two
    parts leave out (x1 w1, x0 w2, x2 w0: 2^-16 of each product) add up
    instead of cancelling: operands of bf16 values in [0.5, 0.53) plus just
    under half their unit in the last place, weights scaled by a power of
    two so the largest output lies in [1, 2).  Two parts with three
    products then miss the card test's 1e-5; three parts with six hold the
    conv within a plain f32 conv's error."""
    rng = np.random.default_rng(24)

    def remainders_up(shape):
        base = torch.from_numpy(rng.uniform(0.5, 0.53, size=shape)
                                .astype(np.float32)).to(torch.bfloat16)
        up = rng.uniform(0.46, 0.49, size=shape).astype(np.float32) * 2.0**-8
        return base.float() + torch.from_numpy(up)

    x = remainders_up((2, cin, 19, 23))
    w = remainders_up((cout, cin, k, k)) * 2.0 ** -math.floor(
        math.log2(k * k * cin / 4))
    six, three, f32 = _part_errors(x, w, d)
    assert three > REL, (three, six, f32)
    assert six <= f32 <= REL, (six, f32)
