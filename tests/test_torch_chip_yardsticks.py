"""chip_smoke's yardsticks for the flat conv, the fused residual block,
the attention kernels, paint and the CCL, on the CPU at small sizes: the library call it times beside the forward kernel
(one ``F.conv2d`` of the merge convs' pre-concatenated input), and the bound
it sets beside each kernel (bf16 operations at the tensor-core peak where
the fast path of ``csrc/conv_fast.cuh`` takes the shape, and for the
residual block's kernels and the resident attention's, else at the FP32
peak).

Tolerance: the library call and the plain version are both f32 convs of
the same operands on the CPU, so they agree to 1e-5 of the output's scale.
"""

import types

import numpy as np
import pytest
import torch

import chip_smoke as cs
from msau_tpu_torch.ops.flatconv import flat_conv2d_plain
from msau_tpu_torch.utils.flat_cases import (
    FLAT_BWD_CASES,
    FLAT_CASES,
    flat_case_fns,
    flat_case_tensors,
)
from msau_tpu_torch.utils.kernel_inputs import page_programs


def _case(op, name, **small):
    pool = (FLAT_CASES if op in ("flat_conv2d", "concat_conv1x1",
                                 "flat_res_block")
            else FLAT_BWD_CASES)
    case = next(c for c in pool if c["op"] == op and c["name"] == name)
    return dict(case, **small)


@pytest.mark.parametrize("name", ["merge_conv_0", "merge_conv_1",
                                  "merge_conv_2", "32 + 32 -> 32 21x48"])
def test_library_conv_is_the_merge_forward(name):
    case = _case("flat_conv2d", name, n=2, h=13, w=19)
    tensors = flat_case_tensors(case, np.random.default_rng(5),
                                torch.device("cpu"), torch.float32)
    lib = cs._flat_library(case, tensors)
    assert lib is not None
    got = lib()
    _, plain = flat_case_fns(case, tensors, torch.float32)
    want = plain()
    a, b, w, bias = tensors
    assert torch.equal(want, flat_conv2d_plain(a, b, w, bias))
    scale = max(1.0, float(want.abs().max()))
    assert got.shape == want.shape
    assert float((got - want).abs().max()) <= 1e-5 * scale


@pytest.mark.parametrize("name", ["dil_conv_0 stage 0", "dil_conv_2",
                                  "end_conv", "ragged 83x57 4x4",
                                  "ragged 7x5 relu"])
def test_library_conv_is_none_with_an_epilogue_or_an_even_kernel(name):
    case = _case("flat_conv2d", name, n=1, h=9, w=11)
    tensors = flat_case_tensors(case, np.random.default_rng(5),
                                torch.device("cpu"), torch.float32)
    assert cs._flat_library(case, tensors) is None


@pytest.mark.parametrize("op", ["flat_conv_bwd", "flat_conv_dx",
                                "flat_conv2d"])
@pytest.mark.parametrize("name", ["dil_conv_0 stage 0", "merge_conv_2",
                                  "end_conv"])
def test_bound_counts_bf16_fast_convs_at_the_tensor_core_peak(op, name):
    case = _case(op, name)
    assert op in cs.DTYPE_AWARE and cs._conv_fast(case, 2)
    n = 16
    f32_ms, _ = cs._flat_bound(case, n, 4)
    bf16_ms, by = cs._flat_bound(case, n, 2)
    c, cb, cout, k = case["c"], case.get("cb", 0), case["cout"], case["k"]
    hw = case["h"] * case["w"]
    conv = 2 * n * hw * cout * (c + cb) * k * k
    epi = op == "flat_conv_bwd" and (case["act"] or case["lrn"])
    flops = conv * (2 if epi else 1)
    # f32 counts the FP32 peak (stage 1) or, for the forward and dx on the
    # tensor cores, a sixth of their peak; bf16 the tensor cores' (a bytes
    # bound here)
    f32_peak = (cs.PEAK_F32_TC_FLOPS if op != "flat_conv_bwd"
                else cs.PEAK_F32_FLOPS)
    assert (op != "flat_conv_bwd") == cs._conv_tc(case)
    assert f32_ms >= flops / f32_peak * 1e3 * (1 - 1e-9)
    assert bf16_ms >= flops / cs.PEAK_BF16_FLOPS * 1e3 * (1 - 1e-9)
    assert bf16_ms < flops / cs.PEAK_F32_FLOPS * 1e3
    assert by == "bytes"


@pytest.mark.parametrize("op", ["flat_conv_bwd", "flat_conv_dx",
                                "flat_conv2d"])
def test_bound_counts_the_general_path_at_the_fp32_peak(op):
    case = _case(op, "64 + 64 -> 64 18x40 (general)")
    assert not cs._conv_fast(case, 2)
    n, hw = case["n"], case["h"] * case["w"]
    conv = 2 * n * hw * 64 * 128 * 9
    bf16_ms, by = cs._flat_bound(case, n, 2)
    assert by == "operations"
    assert bf16_ms == pytest.approx(conv / cs.PEAK_F32_FLOPS * 1e3)


def test_fast_path_covers_the_train_cells_convs():
    """Every conv and coupling forward of the flagship fs=3 step and its
    ragged card cases takes the fast path in both dtypes (the LRN over 64
    channels' stage 1, the "(general)" cases and couplings wider than 64
    input channels excepted)."""
    for case in FLAT_CASES + FLAT_BWD_CASES:
        if case["op"] not in ("flat_conv2d", "flat_conv_bwd", "flat_conv_dx",
                              "concat_conv1x1"):
            continue
        general = ("(general)" in case["name"]
                   or case["c"] + case.get("cb", 0) > 64
                   or (case["op"] == "flat_conv_bwd" and case["cout"] > 32
                       and case["lrn"]))
        for itemsize in (4, 2):
            assert cs._conv_fast(case, itemsize) is not general, (
                case["op"], case["name"], itemsize)


@pytest.mark.parametrize("name", ["couple 8 ch 512^2", "couple 16 ch 256^2",
                                  "couple 32 ch 128^2"])
def test_bound_counts_the_bf16_coupling_forward_at_the_tensor_core_peak(
        name):
    """The 1x1 coupling conv's forward takes the fast path (its backward
    keeps its own one-pass kernel): bf16 bytes-bound at 989 TFLOP/s."""
    case = _case("concat_conv1x1", name)
    assert "concat_conv1x1" in cs.DTYPE_AWARE and cs._conv_fast(case, 2)
    c, cb, cout = case["c"], case["cb"], case["cout"]
    n, hw = 16, case["h"] * case["w"]
    flops = 2 * n * hw * cout * (c + cb)
    bf16_ms, by = cs._flat_bound(case, n, 2)
    assert by == "bytes"
    assert bf16_ms == pytest.approx(n * hw * (c + cb + cout) * 2
                                    / cs.PEAK_BYTES_PER_S * 1e3)
    assert bf16_ms > flops / cs.PEAK_BF16_FLOPS * 1e3


# (instance, op, itemsize) -> bound ms, bound_by at batch 16: bf16 operations
# at 989 TFLOP/s with 2-byte items (bytes bound them but the backward at 32
# channels: x, g and dx halve from one instance to the next, the operations
# do not), f32 at 67 TFLOP/s (2 convs forward, 6 GEMMs backward, 9 C^2 FMAs
# per pixel each: C^2 H W the same at all three)
RES_BOUNDS = [
    ("8 ch 512^2", "flat_res_block", 2, 0.0401, "bytes"),
    ("8 ch 512^2", "flat_res_block_bwd", 2, 0.0601, "bytes"),
    ("16 ch 256^2", "flat_res_block", 2, 0.0200, "bytes"),
    ("16 ch 256^2", "flat_res_block_bwd", 2, 0.0301, "bytes"),
    ("32 ch 128^2", "flat_res_block", 2, 0.0100, "bytes"),
    ("32 ch 128^2", "flat_res_block_bwd", 2, 0.0293, "operations"),
] + [(name, op, 4, ms, "operations")
     for name in ("8 ch 512^2", "16 ch 256^2", "32 ch 128^2")
     for op, ms in (("flat_res_block", 0.1442),
                    ("flat_res_block_bwd", 0.4327))]


@pytest.mark.parametrize("name,op,itemsize,ms,by", RES_BOUNDS)
def test_bound_of_the_residual_block(name, op, itemsize, ms, by):
    case = _case(op, name)
    assert op in cs.DTYPE_AWARE
    got_ms, got_by = cs._flat_bound(case, 16, itemsize)
    assert got_by == by
    assert got_ms == pytest.approx(ms, abs=5e-5)


# (kernel, N, T, itemsize) -> bound ms at Cb 8, C 64: the resident
# attention's bf16 products at 989 TFLOP/s, f32 at 67 TFLOP/s (the score
# product and A^T h forward, 2 N T^2 (Cb + C) FLOP; backward the score
# product, A dout, h dout^T, ds f and ds^T g, 2 N T^2 (3 Cb + 2 C)); the
# streaming forward (config 5's train step at N 2, a 1024^2 page at N 1)
# with bf16 operands at 989 TFLOP/s for its bf16 scores and three products
# for A^T h (A in f32 as three bf16 parts), 2 N T^2 (Cb + 3 C); with f32
# operands, like the streaming backward in both dtypes, at the FP32 peak;
# the N T^2 exponentials at 132 x 16 per clock at 1.98 GHz where they take
# longer (the resident bf16 forward); all bound by operations
ATTN_BOUNDS = [
    ("resident_attention_fwd", 16, 4096, 4, 0.5769),
    ("resident_attention_fwd", 16, 4096, 2, 0.0642),
    ("resident_attention_fwd", 1, 4096, 4, 0.0361),
    ("resident_attention_fwd", 1, 4096, 2, 0.00401),
    ("resident_attention_bwd", 16, 4096, 4, 1.2180),
    ("resident_attention_bwd", 16, 4096, 2, 0.0825),
    ("fused_attention_bwd", 2, 16384, 4, 2.4360),
    ("fused_attention_bwd", 2, 16384, 2, 2.4360),
    ("fused_attention_fwd", 2, 16384, 4, 1.1539),
    ("fused_attention_fwd", 2, 16384, 2, 0.2171),
    ("fused_attention_fwd", 1, 16384, 4, 0.5769),
    ("fused_attention_fwd", 1, 16384, 2, 0.1086),
]


@pytest.mark.parametrize("kernel,n,t,itemsize,ms", ATTN_BOUNDS)
def test_bound_of_the_attention(kernel, n, t, itemsize, ms):
    assert ("resident" in kernel) == (kernel in cs.DTYPE_AWARE)
    got_ms, got_by = cs._attention_bound(kernel, n, t, 8, 64, itemsize)
    assert got_by == "operations"
    assert got_ms == pytest.approx(ms, abs=5e-5)


# The pool backward's byte bound at the flagship fs=3 train step's three
# instances (batch 16): x read, g (a quarter) read, dx written, 2.25 x's
# bytes; 8 ch 512^2 moves 302 MB in f32 (0.0901 ms at 3.35 TB/s), and each
# scale down half that (twice the channels on a quarter of the pixels);
# bf16 half of f32
POOL_BWD_BOUNDS = [("8 ch 512^2", 4, 0.0901), ("8 ch 512^2", 2, 0.0451),
                   ("16 ch 256^2", 4, 0.0451), ("16 ch 256^2", 2, 0.0225),
                   ("32 ch 128^2", 4, 0.0225), ("32 ch 128^2", 2, 0.0113)]


@pytest.mark.parametrize("name,itemsize,ms", POOL_BWD_BOUNDS)
def test_bound_of_the_pool_backward(name, itemsize, ms):
    case = _case("flat_maxpool2_bwd", name)
    assert case["per_step"] == 3
    got_ms, got_by = cs._flat_bound(case, cs.TIMED_BATCH, itemsize)
    assert got_by == "bytes"
    assert got_ms == pytest.approx(ms, abs=5e-5)


# Paint's and the CCL's byte bounds at the serve path's instances: paint
# reads 20 bytes a box and writes the int32 grid (the 512^2 bench page's
# char program, 5632 padded boxes; the 1024-bucket page's, 23040), the CCL
# reads the int32 class map and writes the int32 labels
PAINT_CCL_BOUNDS = [("paint", 5, 512, 5632, 0.0003),
                    ("paint", 10, 1024, 23040, 0.0014),
                    ("ccl", 5, 512, None, 0.0006),
                    ("ccl", 10, 1024, None, 0.0025)]


@pytest.mark.parametrize("kernel,n_cols,side,n_boxes,ms", PAINT_CCL_BOUNDS)
def test_bound_of_paint_and_ccl(kernel, n_cols, side, n_boxes, ms):
    if kernel == "paint":
        progs, hw = page_programs(n_cols)
        assert hw == (side, side)
        assert progs["char"][0].shape == (n_boxes, 4)
        got_ms, got_by = cs.paint_bound(n_boxes, side, side)
    else:
        got_ms, got_by = cs.ccl_bound(side, side)
    assert got_by == "bytes"
    assert got_ms == pytest.approx(ms, abs=5e-5)


@pytest.mark.parametrize("fs", [0, 3])
def test_batch_launches_are_a_requests_per_group(fs):
    """Phase 2c's launches per predict_batch call: paint three a page; one
    CCL, three attention forwards (resident at 512^2, streaming at 1024^2,
    where the deepest of four scales holds 16384 tokens) and at flat_scales
    3 the flat forward kernels of one request, per bucket group."""
    got = cs._batch_launches(fs, cs.SERVE_BATCH_GROUPS)
    one = cs.SERVE_PER_REQUEST[fs]
    assert got["paint"] == 3 * len(cs.SERVE_BATCH_PAGES) == 24
    assert got["ccl_multiclass"] == 2
    assert got["resident_attention_fwd"] == got["fused_attention_fwd"] == 3
    flat = {k: v for k, v in one.items()
            if k not in ("paint", "ccl_multiclass", "resident_attention_fwd")}
    assert bool(flat) == (fs == 3)
    for name, n in flat.items():
        assert got[name] == 2 * n, name
    assert set(got) == set(flat) | {"paint", "ccl_multiclass",
                                    "resident_attention_fwd",
                                    "fused_attention_fwd"}


def test_serve_batch_pages_fill_two_buckets():
    """The host programs of SERVE_BATCH_PAGES land six pages in the 512
    bucket and two in the 1024 bucket, as phase 2c asserts on the card."""
    from msau_tpu_torch.data.charset import Charset
    from msau_tpu_torch.data.synth import BENCH_CHARSET
    from msau_tpu_torch.infer.kv_model import prepare_host

    cs_ = Charset(chars=" $" + BENCH_CHARSET)
    sides = {}
    for page in cs._pages(cs.SERVE_BATCH_PAGES):
        hb, wb = prepare_host(page, cs_, 3.0)[3:]
        assert hb == wb
        sides[hb] = sides.get(hb, 0) + 1
    assert sides == cs.SERVE_BATCH_GROUPS


def test_device_time_leaves_a_failed_profiler_alone(monkeypatch):
    """After the profiler fails a call outright, the calls of the next
    PROFILER_RETRY_S seconds take CUDA events and start no session; the
    first call after that asks it once more."""
    sessions, clock = [], [100.0]
    monkeypatch.setattr(cs, "TIMER", {"profiler_calls": 0, "event_calls": 0,
                                      "profiler_down": False, "retry_at": 0.0})
    monkeypatch.setattr(cs, "_profile_once",
                        lambda fn, iters: sessions.append(1))
    monkeypatch.setattr(cs, "_event_time", lambda fn, iters: (1.0, (1.0, 1.0)))
    monkeypatch.setattr(cs, "time", types.SimpleNamespace(
        perf_counter=lambda: clock[0], sleep=lambda s: None))
    assert cs._device_time(lambda: None, 2) == (1.0, (1.0, 1.0))
    assert len(sessions) == 3 and cs.TIMER["profiler_down"]
    clock[0] += cs.PROFILER_RETRY_S / 2
    cs._device_time(lambda: None, 2)
    assert len(sessions) == 3
    clock[0] += cs.PROFILER_RETRY_S
    cs._device_time(lambda: None, 2)
    assert len(sessions) == 4 and cs.TIMER["event_calls"] == 3


def test_tensor_cores_take_the_train_cells_f32_convs():
    """Every f32 conv forward, coupling forward and dx of the flagship fs=3
    step (its instances in FLAT_CASES and FLAT_BWD_CASES), of a residual
    block at res depth 3 (C -> C 3x3 at 8, 16 and 32 channels) and every
    ragged case on the fast path runs on the tensor cores (``_conv_tc``
    mirrors flatconv.cu's tc_plan); stage 1 and the general path never
    do, nor the f32 forward and dx of weights too wide for a block's shared
    memory in three parts, which keep the fast path's FP32 pipes."""
    res = [_case("flat_conv2d", "dil_conv_0 stages 1-2", c=c, cout=c, h=64,
                 w=64, lrn=False, act="relu") for c in (8, 16, 32)]
    res += [dict(c, op="flat_conv_dx") for c in res]
    for case in FLAT_CASES + FLAT_BWD_CASES + res:
        if case["op"] not in ("flat_conv2d", "flat_conv_bwd", "flat_conv_dx",
                              "concat_conv1x1"):
            continue
        tc = cs._conv_tc(case)
        if case["op"] == "flat_conv_bwd":
            assert not tc, case["name"]
        elif "FP32 pipes" in case["name"]:
            assert cs._conv_fast(case, 4) and not tc, (case["op"], case["name"])
        else:
            assert tc == cs._conv_fast(case, 4), (case["op"], case["name"])
        if case.get("per_request", 0) or case.get("per_step", 0):
            assert tc or case["op"] == "flat_conv_bwd", case["name"]


@pytest.mark.parametrize("shape", cs.BOX_SHAPES)
@pytest.mark.parametrize("kind", ["fwd", "bwd"])
def test_box_bytes_are_the_benchmarks(kind, shape):
    """The box filter's bound moves the bytes the benchmark's roofline
    counts (``benchmark/box_counts.py``) at f32."""
    from benchmark import box_counts

    n, c, h, w = shape
    assert cs._box_bytes(kind, n, c, h, w, 4) == box_counts.box_bytes(
        kind, (n, c, 3, h, w))


def test_box_launches_are_config4s(monkeypatch):
    """Config 4's step launches the box forward once a box convolution and
    once more under remat, the backward once; its request the forward
    once: counted on the plain version the CPU runs, at 32^2."""
    from msau_tpu_torch.config import ModelConfig
    from msau_tpu_torch.models.msau import build_model
    from msau_tpu_torch.ops import boxconv
    from msau_tpu_torch.train.trainer import make_loss_and_grad

    calls = []
    real = boxconv.box_conv_plain

    def counted(*args, **kwargs):
        calls.append(torch.is_grad_enabled())
        return real(*args, **kwargs)

    monkeypatch.setattr(boxconv, "box_conv_plain", counted)
    net = build_model(ModelConfig(**cs.CONFIG4, final_act="softmax"),
                      torch.Generator().manual_seed(0))
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.random((1, 32, 32, 64), dtype=np.float32))
    y = torch.from_numpy(rng.integers(0, 17, (1, 32, 32)).astype(np.int32))
    make_loss_and_grad(net)({"input": x, "label": y})
    boxes = sum(isinstance(m, boxconv.BoxConv2d) for m in net.modules())
    assert boxes == cs.PER_STEP_CONFIG4["box_conv_bwd"]
    assert sum(calls) == cs.PER_STEP_CONFIG4["box_conv_fwd"]
    calls.clear()
    with torch.no_grad():
        net(x)
    assert len(calls) == cs.SERVE_PER_REQUEST_BOX["box_conv_fwd"]
