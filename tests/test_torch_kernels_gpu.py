"""The port's CUDA kernels against their plain PyTorch versions on the card,
at the serve slice's shapes.  Every test here needs a CUDA card and skips
without one.  This file imports no JAX, so it runs on the machine with the
card (which has none):

    python -m pytest tests/test_torch_kernels_gpu.py -m gpu --noconftest -q

Tolerances: paint and CCL are integer maps, exact, with the same bits on a
second run (both scatter or unite with atomics in any order); the CCL's
page axis too (each page of a [B, H, W] stack against the plain version of
that page alone and against the kernel's own [H, W] call), and
``paint_planes`` through the paint kernel; the resident attention
forward within 1e-5 (rtol and atol) of its plain version in float64 for f32
operands (three-part bf16 products with f32 sums against the exact answer;
at N 16 on the H100 the kernel lies 9.9e-6 from it and 3.2e-5 from the f32
plain version, which is so at least 2.2e-5 away), and 2e-2 of the bf16
plain version for bf16 inputs (A
rounded to bf16 on both sides, the output rounded to bf16), its softmax
statistics within 1e-4 (m absolute, l relative: the kernel takes exp on
the SFU, ``ex2.approx``).  The attention backward's largest error, scaled
by max(1, the largest |gradient|), is at most 1e-4 in f32 (sums over T =
4096 keys in another order, and rho cancels against h . dout) and 2e-2 for
bf16 (rounded outputs).  Both run on every ``ATTN_SHAPES`` entry (the
train step's and a page's instances, ragged T, every width of
``SPECIALISED_WIDTHS``, and ``GENERAL_SHAPES``: widths outside it, which
the general kernels take, C 4 to 2400 and Cb 1 to 300, padding edges
included) with the
same bits on a second run (the general backward on three), and in bf16 with integer logits near 2e5 (at Cb 8 and at Cb 64);
the general streaming forward against its plain version in float64.  The
masked CE: ``correct`` exact (sums of 0/1), ``ce_sum`` to rel 1e-5 (f32 sums in another order),
dlogits to 1e-6 in f32 and 1e-2 in bf16 (one bf16 rounding of values <= 1).
The flat-layout ops (``utils.flat_cases``: the flagship's serve shapes and
ragged ones): the layout copy and the max pool exact; the convs, the
deconv and the fused residual block within 1e-5 of max(1, max |want|) in
f32 (sum order) and 2e-2 of it in bf16 (both sides sum the same bf16
operands in f32 and round once; the residual block also rounds conv1's
output, where one flipped rounding moves conv2's sum by a bf16 ulp).
Their backward kernels (``utils.flat_cases.FLAT_BWD_CASES``): the pool's
exact (also on each of its paths: 16-byte pieces, the scalar kernel for odd
sizes, other widths and misaligned bases); every other output within ``FLAT_BWD_TOL`` (activation-shaped
cotangents 1e-5 of max(1, max |want|) in f32, 2e-2 in bf16; weight and bias
gradients, sums over every pixel of the batch in another order than
cuDNN's, 1e-3 of max |want| in f32, 2e-2 in bf16), and the same bits on a
second run.
The streaming attention (``fused_attention_cuda``): f32 output whatever the
operands, 1e-5 of max(1, max |want|) against the blockwise plain version in
f32 and for bf16 operands alike (both sides upcast the same bf16 values and
compute in f32; nothing is rounded on the way out), m within 1e-5 and l a
relative 1e-5, the same bits on a second run at ragged T, and m to the bit
with integer logits near 2e5; its backward (the rows
kernel on an f32 cotangent, its f32 path) 1e-4 of the largest |gradient|
in f32 and 2e-2 for bf16 operands (gradients rounded to bf16), and the same
bits on a second run.
"""

import numpy as np
import pytest
import torch

from msau_tpu_torch.ops import attention as attn_ops
from msau_tpu_torch.ops.attention import (
    fused_attention,
    fused_attention_bwd_cuda,
    fused_attention_bwd_plain,
    fused_attention_cuda,
    fused_attention_plain_stats,
    resident_attention_bwd_cuda,
    resident_attention_bwd_plain,
    resident_attention_cuda,
    resident_attention_plain_stats,
)
from msau_tpu_torch.ops.ce_loss import (
    masked_ce_bwd_cuda,
    masked_ce_bwd_plain,
    masked_ce_fwd_cuda,
    masked_ce_fwd_plain,
)
from msau_tpu_torch.ops.ccl import (
    connected_components_multiclass_cuda,
    connected_components_multiclass_plain,
)
from msau_tpu_torch.ops.paint import paint_boxes_cuda, paint_boxes_plain
from msau_tpu_torch.utils.flat_cases import (
    FLAT_BWD_CASES,
    FLAT_CASES,
    flat_bwd_case_fns,
    flat_bwd_case_tensors,
    flat_bwd_errors,
    flat_case_fns,
    flat_case_tensors,
)
from msau_tpu_torch.utils.kernel_inputs import (
    PAINT_EDGE_CASES,
    attention_inputs,
    ccl_map,
    ce_inputs,
    page_programs,
    paint_edge_program,
    paint_program,
    planes_program,
)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: run on the H100")
    return torch.device("cuda")


# paint: random programs, the edge programs at 512^2 and at an odd size
# (the map pass's ragged tail), and the serve path's programs of the 512^2
# bench page and of the page in the 1024 bucket
PAINT_CASES = (["random 512x512", "random 100x70"]
               + [f"{name} {h}x{w}" for h, w in ((512, 512), (130, 97))
                  for name in PAINT_EDGE_CASES]
               + [f"{name} page {side}" for side in (512, 1024)
                  for name in ("char", "line_id", "char_id")])


def _paint_case(case):
    """-> (boxes, values, h, w) numpy int32 of one PAINT_CASES entry."""
    name, size = case.rsplit(" ", 1)
    if name == "random":
        h, w = map(int, size.split("x"))
        n, pad = (3000, 4096) if h == 512 else (50, 64)
        return (*paint_program(np.random.default_rng(0), n, h, w, pad), h, w)
    if name in PAINT_EDGE_CASES:
        h, w = map(int, size.split("x"))
        return (*paint_edge_program(name, h, w), h, w)
    progs, (h, w) = page_programs(5 if size == "512" else 10)
    return (*progs[name.split()[0]], h, w)


@pytest.mark.gpu
@pytest.mark.parametrize("case", PAINT_CASES)
def test_paint_kernel_matches_plain(cuda, case):
    boxes, values, h, w = _paint_case(case)
    b = torch.from_numpy(boxes).to(cuda)
    v = torch.from_numpy(values).to(cuda)
    got = paint_boxes_cuda(b, v, h, w)
    again = paint_boxes_cuda(b, v, h, w)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    assert torch.equal(got, paint_boxes_plain(b, v, h, w))


# CCL: the three map kinds at 512^2 and 1024^2, sizes no 32 x 32 tile
# divides, one row and one column, one class over the whole map (root
# contention) and a checkerboard (every pixel its own component)
CCL_CASES = ([(kind, s, s) for s in (512, 1024)
              for kind in ("blobby", "noisy", "maze")]
             + [("noisy", 865, 860), ("maze", 865, 860), ("noisy", 1, 4096),
                ("noisy", 4096, 1), ("one_class", 1024, 1024),
                ("checker", 512, 512)])


@pytest.mark.gpu
@pytest.mark.parametrize("kind,h,w", CCL_CASES)
def test_ccl_kernel_matches_plain(cuda, kind, h, w):
    cls = ccl_map(kind, h, w, np.random.default_rng(5))
    t = torch.from_numpy(cls).to(cuda)
    got = connected_components_multiclass_cuda(t)
    again = connected_components_multiclass_cuda(t)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    assert torch.equal(got, connected_components_multiclass_plain(t))


def ccl_stack(b, h, w, seed):
    """[B, H, W] int32: the blobby, noisy and maze kinds in turn, each page
    its own draw."""
    rng = np.random.default_rng(seed)
    kinds = ("blobby", "noisy", "maze")
    return np.stack([ccl_map(kinds[i % 3], h, w, rng) for i in range(b)])


@pytest.mark.gpu
@pytest.mark.parametrize("b", [1, 3, 8])
@pytest.mark.parametrize("h,w", [(512, 512), (865, 860)])
def test_ccl_kernel_page_axis_matches_plain(cuda, b, h, w):
    """One call labels the stack: each page equals the plain version of that
    page alone and the kernel's [H, W] call on it, the same bits on a
    rerun."""
    t = torch.from_numpy(ccl_stack(b, h, w, seed=b)).to(cuda)
    before = connected_components_multiclass_cuda.launches
    got = connected_components_multiclass_cuda(t)
    assert connected_components_multiclass_cuda.launches == before + 1
    again = connected_components_multiclass_cuda(t)
    torch.cuda.synchronize()
    assert got.shape == t.shape
    assert torch.equal(got, again)
    for i in range(b):
        assert torch.equal(got[i], connected_components_multiclass_plain(t[i]))
        assert torch.equal(got[i], connected_components_multiclass_cuda(
            t[i].contiguous()))


@pytest.mark.gpu
@pytest.mark.parametrize("h,w,n,planes", [(512, 512, 3000, 3),
                                          (130, 97, 200, 4)])
def test_paint_planes_on_card_matches_plain(cuda, h, w, n, planes):
    from msau_tpu_torch.data.rasterize import paint_planes

    boxes, values, ids = planes_program(np.random.default_rng(n), n, h, w,
                                        planes)
    b, v, i = (torch.from_numpy(a).to(cuda) for a in (boxes, values, ids))
    before = paint_boxes_cuda.launches
    got = paint_planes(b, v, i, h, w, planes)
    assert paint_boxes_cuda.launches == before + 1
    again = paint_planes(b, v, i, h, w, planes)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    for p in range(planes):
        sel = i == p
        assert torch.equal(got[p], paint_boxes_plain(b[sel], v[sel], h, w))


def _scaled_err(got, want):
    want = want.double()
    return float((got.double() - want).abs().max()
                 / max(1.0, float(want.abs().max())))


# (N, T, Cb, C) of the resident attention: the flagship train step's
# instance and a page's, ragged T, and the other instantiated widths
# (SPECIALISED_WIDTHS); then widths the general kernels take, the model's
# (feat_root 12: C 96; pool 3: C 216; 6 scales at feat_root 16 and 32: C
# 512, 1024) and odd ones, at small and ragged T, and the feat_root-12
# train step's instance (N 16, T 4096); then widths that stress the
# padding (Cb not a multiple of 8 or 16, C not one of 16: k and n tiles
# partly past the edge), C 1024 at a T of many ragged tiles, a Cb past
# 128 (the backward's dg and df in two launches of 128 columns) and one
# past the 256 columns the kernels stage (the rest read from global
# memory; dg and df in three launches)
GENERAL_SHAPES = [(2, 37, 1, 4), (2, 300, 2, 20), (2, 129, 3, 24),
                  (2, 300, 12, 96), (16, 4096, 12, 96), (1, 324, 27, 216),
                  (2, 100, 48, 384), (4, 256, 64, 512), (2, 70, 128, 1024),
                  (2, 300, 5, 40), (1, 361, 27, 216), (3, 45, 7, 52),
                  (1, 1000, 128, 1024), (1, 100, 200, 256),
                  (1, 64, 300, 2400)]
ATTN_SHAPES = [(16, 4096, 8, 64), (1, 4096, 8, 64), (2, 1000, 8, 64),
               (3, 66, 8, 64), (2, 300, 1, 8), (2, 300, 2, 16),
               (1, 520, 4, 32), (1, 300, 16, 128), (2, 300, 32, 256)
               ] + GENERAL_SHAPES


def _attention_case(cuda, n, t, cb, c, dtype, scale=1.0):
    """Seeded f, g, h, dout; with ``scale``, f and g times scale rounded to
    integers (every logit an integer below 2^24: exact in any sum order)."""
    rng = np.random.default_rng(t)
    f, g, h = attention_inputs(rng, n, t, cb, c)
    if scale != 1.0:
        f, g = np.round(f * scale), np.round(g * scale)
    f, g, h = (torch.from_numpy(a).to(cuda, dtype) for a in (f, g, h))
    dout = torch.from_numpy(rng.normal(size=(n, t, c)).astype(np.float32)
                            ).to(cuda, dtype)
    return f, g, h, dout


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("n,t,cb,c", ATTN_SHAPES)
def test_attention_kernel_matches_plain(cuda, n, t, cb, c, dtype, tol):
    f, g, h, _ = _attention_case(cuda, n, t, cb, c, dtype)
    got = resident_attention_cuda(f, g, h)
    again = resident_attention_cuda(f, g, h)
    torch.cuda.synchronize()
    want, wm, wl = resident_attention_plain_stats(f, g, h)
    if dtype == torch.float32:
        # the exact answer: the plain version in float64
        want = resident_attention_plain_stats(f.double(), g.double(),
                                              h.double())[0]
    assert got[0].dtype == dtype and got[0].shape == (n, t, c)
    torch.testing.assert_close(got[0].double(), want.double(), rtol=tol,
                               atol=tol)
    torch.testing.assert_close(got[1], wm, rtol=0, atol=1e-4)
    torch.testing.assert_close(got[2], wl, rtol=1e-4, atol=0)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("n,t,cb,c", ATTN_SHAPES)
def test_attention_bwd_kernel_matches_plain(cuda, n, t, cb, c, dtype, tol):
    f, g, h, dout = _attention_case(cuda, n, t, cb, c, dtype)
    _, m, l = resident_attention_plain_stats(f, g, h)
    got = resident_attention_bwd_cuda(f, g, h, m, l, dout)
    again = resident_attention_bwd_cuda(f, g, h, m, l, dout)
    torch.cuda.synchronize()
    want = resident_attention_bwd_plain(f, g, h, m, l, dout)
    for name, a, b, a2 in zip(("df", "dg", "dh"), got, want, again):
        assert a.dtype == dtype and a.shape == b.shape, name
        assert _scaled_err(a, b) <= tol, (name, _scaled_err(a, b))
        assert torch.equal(a, a2), name


@pytest.mark.gpu
def test_attention_kernels_bf16_large_logits(cuda):
    """Integer logits near 2e5 (f and g scaled by 100, rounded), the size
    the flagship's bf16 model reaches at flat_scales 0: the softmax must
    subtract m before its exponent (a folded exponent, s log2e - (m log2e +
    log2 l), loses whole ulps of m log2e there)."""
    f, g, h, dout = _attention_case(cuda, 2, 1000, 8, 64, torch.bfloat16, 100.0)
    got, m, l = resident_attention_cuda(f, g, h)
    want, wm, wl = resident_attention_plain_stats(f, g, h)
    torch.testing.assert_close(got.float(), want.float(), rtol=2e-2,
                               atol=2e-2)
    torch.testing.assert_close(m, wm, rtol=0, atol=0)
    torch.testing.assert_close(l, wl, rtol=1e-4, atol=0)
    grads = resident_attention_bwd_cuda(f, g, h, wm, wl, dout)
    wgrads = resident_attention_bwd_plain(f, g, h, wm, wl, dout)
    for name, a, b in zip(("df", "dg", "dh"), grads, wgrads):
        assert _scaled_err(a, b) <= 2e-2, (name, _scaled_err(a, b))


@pytest.mark.gpu
@pytest.mark.parametrize("op", ["resident", "streaming"])
def test_general_attention_bf16_large_logits(cuda, op):
    """Integer logits near 2e5 and above at Cb 64, C 512 (the general
    kernels; each logit an integer below 2^24, exact in any sum order): m
    to the bit, the output and gradients within the bf16 tolerances."""
    f, g, h, dout = _attention_case(cuda, 2, 256, 64, 512, torch.bfloat16,
                                    100.0)
    if op == "resident":
        got, m, l = resident_attention_cuda(f, g, h)
        want, wm, wl = resident_attention_plain_stats(f, g, h)
        tol, bwd, bwd_plain = 2e-2, resident_attention_bwd_cuda, \
            resident_attention_bwd_plain
    else:
        got, m, l = fused_attention_cuda(f, g, h)
        want, wm, wl = fused_attention_plain_stats(f, g, h)
        tol, bwd, bwd_plain = 1e-5, fused_attention_bwd_cuda, \
            fused_attention_bwd_plain
        dout = dout.float()
    assert _scaled_err(got, want) <= tol
    torch.testing.assert_close(m, wm, rtol=0, atol=0)
    torch.testing.assert_close(l, wl, rtol=1e-4, atol=0)
    grads = bwd(f, g, h, wm, wl, dout)
    again = bwd(f, g, h, wm, wl, dout)
    for name, a, b, a2 in zip(("df", "dg", "dh"), grads,
                              bwd_plain(f, g, h, wm, wl, dout), again):
        assert _scaled_err(a, b) <= 2e-2, (name, _scaled_err(a, b))
        assert torch.equal(a, a2), name


@pytest.mark.gpu
@pytest.mark.parametrize("op", ["resident", "streaming"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,t,cb,c", [(16, 4096, 12, 96), (1, 361, 27, 216),
                                      (4, 256, 64, 512), (2, 70, 128, 1024),
                                      (1, 64, 300, 2400)])
def test_general_attention_bwd_same_bits(cuda, op, dtype, n, t, cb, c):
    """The general backward gives the same bits on every run: its df is
    summed through per-block slices added in block order and its rho
    through per-group slices added in group order, never by float atomics
    (three runs, each with a fresh scratch)."""
    f, g, h, dout = _attention_case(cuda, n, t, cb, c, dtype)
    if op == "resident":
        _, m, l = resident_attention_cuda(f, g, h)
        bwd = resident_attention_bwd_cuda
    else:
        _, m, l = fused_attention_cuda(f, g, h)
        bwd, dout = fused_attention_bwd_cuda, dout.float()
    runs = [bwd(f, g, h, m, l, dout) for _ in range(3)]
    torch.cuda.synchronize()
    for other in runs[1:]:
        for name, a, b in zip(("df", "dg", "dh"), runs[0], other):
            assert torch.equal(a, b), name


@pytest.mark.gpu
def test_general_attention_refuses_a_short_scratch(cuda):
    """The general backward refuses a scratch smaller than the rho and df
    slices its kernels write (the host's plan and the kernels' own
    geometry must agree), before any launch."""
    from msau_tpu_torch.ops import cuda_lib

    n, t, cb, c = 1, 64, 300, 2400
    f, g, h, dout = _attention_case(cuda, n, t, cb, c, torch.float32)
    _, m, l = resident_attention_cuda(f, g, h)
    per_image, floats = attn_ops.general_bwd_plan(n, t, cb, c, True)
    short = torch.empty((floats - 1,), dtype=torch.float32, device=cuda)
    outs = [torch.empty_like(x) for x in (f, g, h)]
    code = cuda_lib.library().msau_resident_attention_bwd(
        *(x.data_ptr() for x in (f, g, h, dout, m, l, *outs, short)),
        short.numel(), per_image, n, t, cb, c, 0,
        cuda_lib.stream_ptr(f.device))
    assert code != 0


# (N, T, Cb, C): config 5's deepest scale, ragged T above and below the
# streaming threshold, and the other instantiated widths
FUSED_SHAPES = [(2, 16384, 8, 64), (1, 8200, 8, 64), (3, 66, 8, 64),
                (2, 300, 1, 8), (2, 300, 2, 16), (1, 520, 4, 32),
                (1, 300, 16, 128), (2, 300, 32, 256)]
# the streaming pair at the general kernels' widths (but the N 16 train
# step) and config 5 at feat_root 12 (C 96, T 16384)
GENERAL_FUSED_SHAPES = [s for s in GENERAL_SHAPES if s[0] != 16] + [
    (2, 16384, 12, 96)]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,t,cb,c", FUSED_SHAPES)
def test_fused_attention_kernel_matches_plain(cuda, n, t, cb, c, dtype):
    f, g, h = (torch.from_numpy(a).to(cuda, dtype) for a in
               attention_inputs(np.random.default_rng(t), n, t, cb, c))
    got, m, l = fused_attention_cuda(f, g, h)
    again = fused_attention_cuda(f, g, h)
    torch.cuda.synchronize()
    want, wm, wl = fused_attention_plain_stats(f, g, h)
    assert got.dtype == torch.float32 and got.shape == (n, t, c)
    assert _scaled_err(got, want) <= 1e-5
    torch.testing.assert_close(m, wm, rtol=0, atol=1e-5)
    torch.testing.assert_close(l, wl, rtol=1e-5, atol=0)
    assert all(torch.equal(a, b) for a, b in zip((got, m, l), again))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n", [1, 2, 3])
@pytest.mark.parametrize("t", [66, 8200])
def test_fused_attention_kernel_ragged_same_bits(cuda, t, n, dtype):
    """Ragged T (the last 128-row chunk partly past T) at every batch the
    grid layouts differ by, in both dtypes, and the same bits on a rerun."""
    f, g, h = (torch.from_numpy(a).to(cuda, dtype) for a in
               attention_inputs(np.random.default_rng(n), n, t, 8, 64))
    got = fused_attention_cuda(f, g, h)
    again = fused_attention_cuda(f, g, h)
    torch.cuda.synchronize()
    want, wm, wl = fused_attention_plain_stats(f, g, h)
    assert _scaled_err(got[0], want) <= 1e-5
    torch.testing.assert_close(got[1], wm, rtol=0, atol=1e-5)
    torch.testing.assert_close(got[2], wl, rtol=1e-5, atol=0)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fused_attention_kernel_large_logits(cuda, dtype):
    """Integer logits near 2e5, exact in any sum order in either operand
    dtype, so m agrees to the bit (the exponent subtracts m first)."""
    f, g, h, _ = _attention_case(cuda, 2, 1000, 8, 64, dtype, 100.0)
    got, m, l = fused_attention_cuda(f, g, h)
    want, wm, wl = fused_attention_plain_stats(f, g, h)
    assert _scaled_err(got, want) <= 1e-5
    torch.testing.assert_close(m, wm, rtol=0, atol=0)
    torch.testing.assert_close(l, wl, rtol=1e-5, atol=0)


def _pool_input(rng, shape):
    """A pool input quantized after a relu: many ties in every window."""
    return np.round(np.maximum(rng.normal(size=shape), 0) * 2).astype(
        np.float32) / 2


# (N, C, H, W) of the pool backward's paths: the vector path in both
# dtypes (W a multiple of 8), W a multiple of 4 only (f32 vector, bf16
# scalar), an even W that is neither, odd H, odd W, both odd
POOL_BWD_SHAPES = [(2, 3, 16, 32), (2, 3, 16, 12), (2, 3, 16, 10),
                   (2, 3, 15, 32), (2, 3, 16, 31), (1, 2, 9, 7)]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", POOL_BWD_SHAPES)
@pytest.mark.parametrize("offset", [0, 1])
def test_pool_bwd_kernel_paths_exact(cuda, shape, dtype, offset):
    """Every path of the pool backward against its plain version, exact;
    ``offset`` 1 puts x, g and dx one element past an aligned base (the
    scalar path)."""
    from msau_tpu_torch.ops.flatconv import (
        flat_maxpool2_bwd_cuda,
        flat_maxpool2_bwd_plain,
    )

    rng = np.random.default_rng(7)
    n, c, h, w = shape
    gshape = (n, c, (h + 1) // 2, (w + 1) // 2)
    x = torch.from_numpy(_pool_input(rng, shape)).to(cuda, dtype)
    g = torch.from_numpy(rng.normal(size=gshape).astype(np.float32)).to(
        cuda, dtype)
    if offset:
        x = torch.cat([x.new_zeros(offset), x.flatten()])[offset:].view(shape)
        g = torch.cat([g.new_zeros(offset), g.flatten()])[offset:].view(gshape)
    got = flat_maxpool2_bwd_cuda(x, g)
    torch.cuda.synchronize()
    assert torch.equal(got, flat_maxpool2_bwd_plain(x, g))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("n,t,cb,c", FUSED_SHAPES)
def test_fused_attention_bwd_kernel_matches_plain(cuda, n, t, cb, c, dtype,
                                                  tol):
    rng = np.random.default_rng(t)
    f, g, h = (torch.from_numpy(a).to(cuda, dtype)
               for a in attention_inputs(rng, n, t, cb, c))
    dout = torch.from_numpy(rng.normal(size=(n, t, c)).astype(np.float32)
                            ).to(cuda)
    _, m, l = fused_attention_plain_stats(f, g, h)
    got = fused_attention_bwd_cuda(f, g, h, m, l, dout)
    again = fused_attention_bwd_cuda(f, g, h, m, l, dout)
    torch.cuda.synchronize()
    want = fused_attention_bwd_plain(f, g, h, m, l, dout)
    for name, a, b, a2 in zip(("df", "dg", "dh"), got, want, again):
        assert a.dtype == dtype and a.shape == b.shape, name
        assert _scaled_err(a, b) <= tol, (name, _scaled_err(a, b))
        assert torch.equal(a, a2), name


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,t,cb,c", GENERAL_FUSED_SHAPES)
def test_general_fused_attention_kernel_matches_exact(cuda, n, t, cb, c,
                                                      dtype):
    """The general streaming forward against the plain version in float64
    (the exact answer for either operand dtype): at Cb 64 and above the
    logits reach 60-90, where the f32 plain version's own m lies ~1e-5
    off (one f32 ulp there is 7.6e-6), while the kernel sums the f32
    scores in f64 and rounds m once.  1e-5 of max(1, max |want|), m 1e-5,
    l a relative 1e-5, the same bits on a rerun."""
    f, g, h = (torch.from_numpy(a).to(cuda, dtype) for a in
               attention_inputs(np.random.default_rng(t), n, t, cb, c))
    got = fused_attention_cuda(f, g, h)
    again = fused_attention_cuda(f, g, h)
    torch.cuda.synchronize()
    want, wm, wl = fused_attention_plain_stats(f.double(), g.double(),
                                               h.double())
    assert got[0].dtype == torch.float32 and got[0].shape == (n, t, c)
    assert _scaled_err(got[0], want) <= 1e-5
    torch.testing.assert_close(got[1].double(), wm, rtol=0, atol=1e-5)
    torch.testing.assert_close(got[2].double(), wl, rtol=1e-5, atol=0)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("n,t,cb,c", GENERAL_FUSED_SHAPES)
def test_general_fused_attention_bwd_kernel_matches_plain(cuda, n, t, cb, c,
                                                          dtype, tol):
    test_fused_attention_bwd_kernel_matches_plain(cuda, n, t, cb, c, dtype,
                                                  tol)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fused_attention_autograd_on_card(cuda, dtype):
    """The autograd op end to end on the card against itself on the CPU."""
    rng = np.random.default_rng(2)
    f, g, h = (torch.from_numpy(a).to(dtype)
               for a in attention_inputs(rng, 2, 600, 8, 64))
    w = torch.from_numpy(rng.normal(size=(2, 600, 64)).astype(np.float32))
    grads = {}
    for dev in ("cpu", cuda):
        leaves = [x.detach().to(dev).requires_grad_() for x in (f, g, h)]
        out = fused_attention(*leaves)
        assert out.dtype == torch.float32
        (out * w.to(dev)).sum().backward()
        grads[str(dev)] = [x.grad.cpu() for x in leaves]
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    for a, b in zip(grads[str(cuda)], grads["cpu"]):
        assert a.dtype == dtype and _scaled_err(a, b) <= tol


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-6),
                                       (torch.bfloat16, 1e-2)])
def test_masked_ce_kernels_match_plain(cuda, dtype, tol):
    logits, labels, maskf = (
        torch.from_numpy(a).to(cuda) for a in
        ce_inputs(np.random.default_rng(0), 4, 17, 128 * 128,
                  out_of_range=True))
    logits = logits.to(dtype)
    s, c = masked_ce_fwd_cuda(logits, labels, maskf)
    torch.cuda.synchronize()
    ps, pc = masked_ce_fwd_plain(logits, labels, maskf)
    assert float(c) == float(pc)
    assert abs(float(s) - float(ps)) <= 1e-5 * abs(float(ps))
    g = torch.tensor(0.37, device=cuda)
    dl = masked_ce_bwd_cuda(logits, labels, maskf, g)
    torch.cuda.synchronize()
    want = masked_ce_bwd_plain(logits, labels, maskf, g)
    assert dl.dtype == dtype
    assert float((dl.double() - want.double()).abs().max()) <= tol


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", FLAT_CASES,
                         ids=[f"{c['op']}-{c['name']}" for c in FLAT_CASES])
def test_flat_kernels_match_plain(cuda, case, dtype):
    tensors = flat_case_tensors(case, np.random.default_rng(11), cuda, dtype)
    kernel, plain = flat_case_fns(case, tensors, dtype)
    got = kernel()
    torch.cuda.synchronize()
    want = plain()
    assert got.dtype == want.dtype == dtype and got.shape == want.shape
    if case["op"] in ("to_nchw", "flat_maxpool2"):
        assert torch.equal(got, want)
    else:
        tol = 1e-5 if dtype == torch.float32 else 2e-2
        assert _scaled_err(got, want) <= tol


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", FLAT_BWD_CASES,
                         ids=[f"{c['op']}-{c['name']}" for c in FLAT_BWD_CASES])
def test_flat_bwd_kernels_match_plain(cuda, case, dtype):
    tensors = flat_bwd_case_tensors(case, np.random.default_rng(13), cuda,
                                    dtype)
    kernel, plain = flat_bwd_case_fns(case, tensors)
    got = kernel()
    again = kernel()
    torch.cuda.synchronize()
    want = plain()
    for kind, err, tol in flat_bwd_errors(case, got, want,
                                          str(dtype).split(".")[-1]):
        assert err <= tol, (kind, err, tol)
    for a, b in zip(got, again):
        assert torch.equal(a, b)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flat_conv_tensor_core_launches_in_a_train_step(cuda, dtype):
    """One training step of a model shaped as the benchmark's msau_default
    (feat_root 8, res depth 3, so its residual blocks are flat convs;
    flat_scales 3), at 4 scales on 64^2 pages: in f32 every launch of the
    flat conv's kernel (forward, the couplings' forward, dx) runs on the
    tensor cores, ``ops.tc_launch_counts()`` equal to the wrappers'
    ``launches``; in bf16 none does."""
    from msau_tpu_torch import ops
    from msau_tpu_torch.config import ModelConfig, TrainConfig
    from msau_tpu_torch.train.trainer import Trainer

    cfg = ModelConfig(img_channels=64, n_class=17, scale_space_num=4,
                      res_depth=3, feat_root=8, num_blocks=3,
                      final_act="softmax", flat_scales=3, dtype=dtype)
    tr = Trainer(cfg, TrainConfig(optimizer="adam", learning_rate=1e-4),
                 device=cuda)
    tr.init_state(np.zeros((2, 64, 64, 64), np.float32))
    rng = np.random.default_rng(0)
    batch = tr.put_batch({
        "input": (rng.random((2, 64, 64, 64)) < 0.05).astype(np.float32),
        "label": rng.integers(0, 17, (2, 64, 64)).astype(np.int32),
        "valid": np.ones((2, 64, 64), bool)})
    tr.state, _ = tr.train_step(tr.state, batch)
    ops.reset_launch_counts()
    tr.state, metrics = tr.train_step(tr.state, batch)
    torch.cuda.synchronize()
    assert np.isfinite(float(metrics["loss"]))
    launches, tc = ops.launch_counts(), ops.tc_launch_counts()
    assert all(launches[k] > 0 for k in tc), launches
    assert tc == {k: launches[k] if dtype == "float32" else 0 for k in tc}


@pytest.mark.gpu
@pytest.mark.parametrize("name,tc", [
    ("5x5 12 -> 8 23x31 (general)", False),
    ("64 + 64 -> 64 18x40 (general)", False),
    ("40 -> 40 21x37 (f32 on the FP32 pipes)", False),
    ("dil_conv_0 stage 0", True), ("end_conv", True)])
def test_flat_conv_tensor_core_count_follows_the_shape(cuda, name, tc):
    """A launch off the fast path (the general kernels) or on its FP32
    pipes counts in ``launches`` and not in ``tc_launches``; an f32 launch
    on the tensor cores counts in both, a bf16 one in ``launches`` alone."""
    from msau_tpu_torch import ops

    case = next(c for c in FLAT_CASES
                if c["op"] == "flat_conv2d" and c["name"] == name)
    for dtype in (torch.float32, torch.bfloat16):
        tensors = flat_case_tensors(dict(case, n=1, h=24, w=40),
                                    np.random.default_rng(3), cuda, dtype)
        kernel, _ = flat_case_fns(case, tensors, dtype)
        ops.reset_launch_counts()
        kernel()
        torch.cuda.synchronize()
        assert ops.launch_counts()["flat_conv2d"] == 1
        assert ops.tc_launch_counts()["flat_conv2d"] == int(
            tc and dtype == torch.float32)


@pytest.mark.gpu
@pytest.mark.parametrize("case", [c for c in FLAT_CASES if c["per_request"]
                                  and c["op"] in ("flat_conv2d",
                                                  "concat_conv1x1")],
                         ids=lambda c: f"{c['op']}-{c['name']}")
def test_flat_conv_f32_tensor_cores_same_bits(cuda, case):
    """The f32 conv on the tensor cores sums in a fixed order: two launches
    of the forward at a train step's batch give the same bits."""
    tensors = flat_case_tensors(dict(case, n=4), np.random.default_rng(4),
                                cuda, torch.float32)
    kernel, _ = flat_case_fns(case, tensors, torch.float32)
    first = kernel()
    again = kernel()
    torch.cuda.synchronize()
    assert torch.equal(first, again)


@pytest.mark.gpu
def test_tf32_stays_off_after_import(cuda):
    """Importing the port turns TF32 off for cuDNN and for matmul, so the
    f32 products of this slice (cuDNN convs, the LSTM's cuDNN cell, the
    box convolution's banded einsums) keep f32's rounding: each within
    1e-5 of max(1, max |want|) of the float64 result on the CPU (on the
    CPU in f32: 5e-7, 4e-7 and 3e-7), where TF32's 10-bit mantissa misses
    the matmul by 2.7e-4; the box convolution within 5e-5 (its f32
    integral image cancels: 4.6e-6 on the CPU), where TF32 would round
    prefix sums near 2000 by ~1."""
    import msau_tpu_torch  # noqa: F401  (sets the policy)
    from msau_tpu_torch.models.extras import LSTMCell
    from msau_tpu_torch.ops.boxconv import box_conv2d

    assert torch.backends.cudnn.allow_tf32 is False
    assert torch.backends.cuda.matmul.allow_tf32 is False
    gen = torch.Generator().manual_seed(0)

    def err(got, want):
        return float((got.cpu().double() - want).abs().max()
                     / max(1.0, float(want.abs().max())))

    a, b = torch.randn(512, 1024, generator=gen), torch.randn(1024, 256,
                                                                generator=gen)
    assert err(a.to(cuda) @ b.to(cuda), a.double() @ b.double()) <= 1e-5
    x, w = torch.randn(2, 64, 40, 40, generator=gen), torch.randn(
        64, 64, 3, 3, generator=gen)
    assert err(torch.nn.functional.conv2d(x.to(cuda), w.to(cuda)),
               torch.nn.functional.conv2d(x.double(), w.double())) <= 1e-5
    cell = LSTMCell(64, 64, gen=gen)
    seq = torch.randn(8, 48, 64, generator=gen)
    with torch.no_grad():
        want = cell.double()(seq.double())
        got = cell.float().to(cuda)(seq.to(cuda))
    assert err(got, want) <= 1e-5
    img = torch.rand(2, 8, 64, 64, generator=gen)
    lo = torch.rand(4, 8, 3, generator=gen) * 20 - 14
    coords = [lo[0], lo[0] + 6, lo[1], lo[1] + 9]
    kw = dict(max_h=28, max_w=28)
    want = box_conv2d(img.double(), *(c.double() for c in coords), **kw)
    got = box_conv2d(img.to(cuda), *(c.to(cuda) for c in coords), **kw)
    assert err(got, want) <= 5e-5


@pytest.mark.gpu
def test_train_step_spans_on_card(cuda, tmp_path):
    """A training step traced on the card (``utils.profiling.trace``):
    every kernel of the step was launched inside the host span of
    ``msau.train_step``, the backward's by autograd's device thread too,
    so the span's device-side extent (its first to its last kernel)
    covers the step.  The profiler writes a device twin
    (``gpu_user_annotation``) of each phase, in order inside that extent,
    and the backward's twin spans the kernels that autograd's thread
    launched.  ``allocator_calls`` equals the allocator's own count
    of device allocations and frees over the step
    (``torch.cuda.memory_stats``), which an emptied cache makes nonzero."""
    import json

    from msau_tpu_torch.config import ModelConfig, TrainConfig
    from msau_tpu_torch.train.trainer import Trainer
    from msau_tpu_torch.utils import profiling

    cfg = ModelConfig(img_channels=3, n_class=3, scale_space_num=3,
                      res_depth=1, feat_root=4, num_blocks=1,
                      final_act="softmax", flat_scales=1)
    tr = Trainer(cfg, TrainConfig(optimizer="adam", learning_rate=1e-3),
                 device=cuda)
    tr.init_state(np.zeros((2, 32, 32, 3), np.float32))
    rng = np.random.default_rng(0)
    batch = tr.put_batch({
        "input": rng.random((2, 32, 32, 3)).astype(np.float32),
        "label": rng.integers(0, 3, (2, 32, 32)).astype(np.int32),
        "valid": np.ones((2, 32, 32), bool)})
    for _ in range(2):
        tr.state, _ = tr.train_step(tr.state, batch)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    profiling.reset_spans()

    def allocs():
        s = torch.cuda.memory_stats(cuda)
        return s["num_device_alloc"] + s["num_device_free"]

    with profiling.capture_trace(str(tmp_path)):
        n0 = allocs()
        tr.state, metrics = tr.train_step(tr.state, batch)
        n1 = allocs()
        torch.cuda.synchronize()
    assert np.isfinite(float(metrics["loss"]))
    assert profiling.counter_totals() == {"allocator_calls": n1 - n0}
    assert n1 - n0 > 0
    assert {k: v[0] for k, v in profiling.span_totals().items()} == {
        "msau.train_step": 1, "msau.forward": 1, "msau.backward": 1,
        "msau.update": 1}
    profiling.reset_spans()

    events = [e for e in json.loads((tmp_path / "trace.json").read_text())[
        "traceEvents"] if e.get("ph") == "X"]
    extent = lambda e: (float(e["ts"]), float(e["ts"]) + float(e["dur"]))
    launched = {e["args"]["correlation"]: (float(e["ts"]), e["tid"])
                for e in events if e.get("cat") in ("cuda_runtime", "cuda_driver")
                and "correlation" in e.get("args", {})}
    # kernels, copies and sets on the card, with their launches
    ops = [(e["cat"], extent(e), launched[e["args"]["correlation"]])
           for e in events if e.get("cat") in ("kernel", "gpu_memcpy",
                                               "gpu_memset")]
    (step,) = [e for e in events if e.get("cat") == "user_annotation"
               and e["name"] == "msau.train_step"]
    a, b = extent(step)
    assert ops
    assert all(a <= t <= b for _, _, (t, _) in ops), (a, b)
    # the backward's kernels come from another thread
    assert len({tid for cat, _, (_, tid) in ops if cat == "kernel"}) == 2
    first = min(x[0] for _, x, _ in ops)
    last = max(x[1] for _, x, _ in ops)
    backward = [x for _, x, (_, tid) in ops if tid != step["tid"]]
    twins = {e["name"]: extent(e) for e in events
             if e.get("cat") == "gpu_user_annotation"}
    fwd, bwd, update = (twins["msau.forward"], twins["msau.backward"],
                        twins["msau.update"])
    ns = 2e-3   # the trace prints times to the ns, rounded apart (us)
    assert (first - ns <= fwd[0] and fwd[1] <= bwd[0] + ns
            and bwd[1] <= update[0] + ns and update[1] <= last + ns), (
        first, last, twins)
    assert (bwd[0] - ns <= min(x[0] for x in backward)
            and max(x[1] for x in backward) <= bwd[1] + ns), (
        min(x[0] for x in backward), max(x[1] for x in backward), bwd)


# the box convolution at every scale of benchmark/configs/bmsau_default.json
# (batch 16, featRoot 8, 6 scales from 512 x 512; 3 boxes of up to 28)
# (N, C, H, W), then planes that end inside a tile: odd sizes, a wide and a
# tall one
BOX_SHAPES = ([(16, 8 * 2 ** s, 512 // 2 ** s, 512 // 2 ** s) for s in range(6)]
              + [(3, 5, 45, 29), (2, 4, 7, 130), (2, 4, 100, 3)])
BOX_KINDS = ("fractional", "swapped", "tied", "clamped")
BOX_MAX = 28


def _box_coords(rng, c, b, kind, m=BOX_MAX):
    """ybox, xbox [2, C, B] (raw min, max) of one kind: fractional ends;
    swapped pairs (min above max); y tied, and x tied too in every other
    box (an area of exactly 1); on and past +-max."""
    def u(lo, hi):
        return rng.uniform(lo, hi, (c, b)).astype(np.float32)

    if kind == "fractional":
        y, x = u(-26, 10), u(-26, 10)
        pairs = (y, y + u(0.3, 16), x, x + u(0.3, 16))
    elif kind == "swapped":
        y, x = u(-20, 20), u(-20, 20)
        pairs = (y + 5.5, y, x + 2.25, x - 3.0)
    elif kind == "tied":
        y, x = u(-20, 20), u(-20, 20)
        both = (np.arange(b) % 2 == 0)[None, :]
        pairs = (y, y.copy(), np.where(both, x, x - 4.5),
                 np.where(both, x, x + 7.75))
    else:
        lo = np.full((c, b), -m, np.float32)
        pairs = (lo, -lo, np.where(rng.random((c, b)) < 0.5, -m, -m - 2.5),
                 np.where(rng.random((c, b)) < 0.5, m, 3.25))
    yb, xb = (np.stack(p).astype(np.float32) for p in (pairs[:2], pairs[2:]))
    return torch.from_numpy(yb), torch.from_numpy(xb)


def _box_errors(cuda, n, c, h, w, kind, dtype=torch.float32):
    """The kernels' and the plain version's largest errors, both on an
    input of ``dtype``, against the plain version in float64 on the same
    input (forward, dx, dybox, dxbox), each over max(1, max |want|) of its
    tensor, and the kernels' outputs twice."""
    from msau_tpu_torch.ops.boxconv import (
        box_conv_bwd_cuda,
        box_conv_bwd_plain,
        box_conv_fwd_cuda,
        box_conv_plain,
    )

    rng = np.random.default_rng(c * 7 + BOX_KINDS.index(kind))
    yb, xb = _box_coords(rng, c, 3, kind)
    x = torch.from_numpy(rng.random((n, c, h, w), dtype=np.float32))
    g = torch.from_numpy(rng.standard_normal((n, c * 3, h, w),
                                             dtype=np.float32))
    x, yb, xb, g = (t.to(cuda) for t in (x, yb, xb, g))
    x = x.to(dtype)
    kw = dict(max_h=BOX_MAX, max_w=BOX_MAX)
    runs = [(box_conv_fwd_cuda(x, yb, xb, **kw),
             *box_conv_bwd_cuda(x, yb, xb, g, **kw)) for _ in range(2)]
    assert runs[0][0].dtype == torch.float32 and runs[0][1].dtype == dtype
    want = (box_conv_plain(x.double(), yb.double(), xb.double(), **kw),
            *box_conv_bwd_plain(x.double(), yb.double(), xb.double(),
                                g.double(), **kw))
    plain = (box_conv_plain(x, yb, xb, **kw),
             *box_conv_bwd_plain(x, yb, xb, g, **kw))
    torch.cuda.synchronize()
    errs = [_scaled_err(a, w) for a, w in zip(runs[0], want)]
    plain_errs = [_scaled_err(a, w) for a, w in zip(plain, want)]
    return errs, plain_errs, runs


@pytest.mark.gpu
@pytest.mark.parametrize("kind", BOX_KINDS)
@pytest.mark.parametrize("n,c,h,w", BOX_SHAPES)
def test_box_conv_kernels_match_plain(cuda, n, c, h, w, kind):
    """The box filter's forward, dx and both coordinate gradients against
    the plain version (``box_conv2d``, autograd) in float64, on every scale
    shape of the BMSAU and on planes that end inside a tile, on fractional, swapped, tied and clamped
    coordinates, with the same bits on a rerun.  Tolerances, over max(1,
    max |want|) of each tensor: the forward 2e-3, dx 2e-5, the coordinate
    gradients 5e-5.  The forward samples f32 integral images of a tile
    and its halo (up to 122 x 122 values in [0, 1), sums up to ~7.5e3
    that round at ~4.9e-4): a box of area 1 (the tied case) is four such
    roundings over 1, 1.3e-3 at 512 x 512 on the H100, a wide box far less
    (1e-4).  The backward samples the cotangent's images, whose normal
    values sum to far less: dx 9.5e-6, and the coordinate gradients,
    these samples' edge terms against x summed over the batch's pixels,
    5.3e-6.  And no further from float64 than twice the f32 plain version
    (integral images of the whole plane, up to 1.3e5 at 512 x 512: 2e-2
    there), or within 1e-5 where both form images of the same few values
    (planes of 64 or less)."""
    errs, plain_errs, runs = _box_errors(cuda, n, c, h, w, kind)
    print(f"box {kind} N{n} C{c} {h}x{w}: kernel {errs}, f32 plain {plain_errs}")
    for name, e, pe, tol in zip(("out", "dx", "dybox", "dxbox"), errs,
                                plain_errs, (2e-3, 2e-5, 5e-5, 5e-5)):
        assert e <= tol, (name, e)
        assert e <= max(2 * pe, 1e-5), (name, e, pe)
    for a, b in zip(*runs):
        assert torch.equal(a, b)


@pytest.mark.gpu
@pytest.mark.parametrize("kind", BOX_KINDS)
@pytest.mark.parametrize("n,c,h,w", BOX_SHAPES)
def test_box_conv_kernels_bf16_match_plain(cuda, n, c, h, w, kind):
    """A bf16 input (a bf16 BMSAU): the kernels read it and sum in f32, so
    against float64 on the same rounded input the forward and the
    coordinate gradients keep the f32 tolerances of
    ``test_box_conv_kernels_match_plain`` (2e-3, 5e-5), and dx, rounded
    once to bf16, 4e-3 (bf16's unit roundoff 2^-8 of the largest |dx|,
    and the f32 sums; the H100 read 2.6e-3 to 3.4e-3).  None is further from float64 than the bf16 plain
    version, whose integral image is a bf16 cumsum (at most the
    tolerance where that one is closer).  The same bits on a rerun."""
    errs, plain_errs, runs = _box_errors(cuda, n, c, h, w, kind,
                                         torch.bfloat16)
    print(f"box bf16 {kind} N{n} C{c} {h}x{w}: kernel {errs}, "
          f"bf16 plain {plain_errs}")
    for name, e, pe, tol in zip(("out", "dx", "dybox", "dxbox"), errs,
                                plain_errs, (2e-3, 4e-3, 5e-5, 5e-5)):
        assert e <= tol, (name, e)
        assert e <= max(pe, tol), (name, e, pe)
    for a, b in zip(*runs):
        assert torch.equal(a, b)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_box_conv_train_step_runs_the_kernels(cuda, dtype):
    """A BMSAU training step on the card (f32 and bf16) runs every box
    convolution as one forward and one backward launch of the kernels,
    and no torch op of the plain formulation (its integral image's
    cumsum, the bands' floor; the LRN's band product is an einsum too)."""
    from torch.profiler import ProfilerActivity, profile

    from msau_tpu_torch import ops
    from msau_tpu_torch.config import ModelConfig
    from msau_tpu_torch.models.msau import build_model
    from msau_tpu_torch.train.trainer import make_loss_and_grad

    cfg = ModelConfig(model="msau_box", img_channels=6, n_class=5,
                      scale_space_num=4, feat_root=8, num_blocks=2,
                      final_act="softmax", num_box_convs=2,
                      num_box_per_channel=3, max_box_size=6, dtype=dtype)
    net = build_model(cfg, torch.Generator().manual_seed(0)).to(cuda)
    rng = np.random.default_rng(0)
    batch = {"input": torch.from_numpy(
                 rng.random((2, 64, 64, 6), dtype=np.float32)).to(cuda),
             "label": torch.from_numpy(
                 rng.integers(0, 5, (2, 64, 64)).astype(np.int32)).to(cuda)}
    step = make_loss_and_grad(net)
    step(batch)
    ops.reset_launch_counts()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _, _, grads = step(batch)
        torch.cuda.synchronize()
    calls = 2 * (4 + 3) * 2   # stages x scales (down, up) x box convs
    counts = ops.launch_counts()
    assert counts["box_conv_fwd"] == calls and counts["box_conv_bwd"] == calls
    names = {e.key for e in prof.key_averages()}
    assert not names & {"aten::cumsum", "aten::floor"}, names
    assert all(float(g.abs().max()) > 0 for k, g in grads.items()
               if k.endswith("ybox"))
