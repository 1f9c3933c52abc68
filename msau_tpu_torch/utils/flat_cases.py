"""The flat-layout ops' cases on the card: the shapes the flagship's serve
path and train step run each op at, and ragged ones, with seeded operands,
shared by ``tests/test_torch_kernels_gpu.py`` and ``chip_smoke.py``."""

from __future__ import annotations

import re
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from msau_tpu_torch.ops import flatconv, flatres


def _case(op, name, per_request, **kw):
    return dict(op=op, name=name, per_request=per_request, **kw)


# The flat-layout ops of the flagship (img_channels 64, n_class 17,
# feat_root 8, 4 scales, 3 stages, relu) at flat_scales 3 on one 512^2 page,
# with how many times one request runs each, then ragged cases
# (per_request 0): odd sizes and images smaller than one tile, so a tile
# touches every image edge.  ``cb`` is a second input read as a channel
# concat; ``k`` the kernel side; ``d`` the dilation.
FLAT_CASES = [
    _case("to_nchw", "entry 512^2", 1, n=1, c=64, h=512, w=512),
    _case("to_nchw", "ragged 83x57", 0, n=2, c=64, h=83, w=57),
    _case("flat_maxpool2", "8 ch 512^2", 3, n=1, c=8, h=512, w=512),
    _case("flat_maxpool2", "16 ch 256^2", 3, n=1, c=16, h=256, w=256),
    _case("flat_maxpool2", "32 ch 128^2", 3, n=1, c=32, h=128, w=128),
    _case("flat_maxpool2", "ragged 83x57", 0, n=2, c=8, h=83, w=57),
    _case("flat_conv2d", "dil_conv_0 stage 0", 1, n=1, c=64, cout=8, h=512,
          w=512, k=3, d=1, act=None, lrn=True),
    _case("flat_conv2d", "dil_conv_0 stages 1-2", 2, n=1, c=17, cout=8,
          h=512, w=512, k=3, d=1, act=None, lrn=True),
    _case("flat_conv2d", "dil_conv_1", 3, n=1, c=8, cout=16, h=256, w=256,
          k=3, d=2, act=None, lrn=True),
    _case("flat_conv2d", "dil_conv_2", 3, n=1, c=16, cout=32, h=128, w=128,
          k=3, d=4, act=None, lrn=True),
    _case("flat_conv2d", "merge_conv_0", 3, n=1, c=8, cb=8, cout=8, h=512,
          w=512, k=3, d=1, act=None, lrn=False),
    _case("flat_conv2d", "merge_conv_1", 3, n=1, c=16, cb=16, cout=16,
          h=256, w=256, k=3, d=1, act=None, lrn=False),
    _case("flat_conv2d", "merge_conv_2", 3, n=1, c=32, cb=32, cout=32,
          h=128, w=128, k=3, d=1, act=None, lrn=False),
    _case("flat_conv2d", "end_conv", 3, n=1, c=8, cout=17, h=512, w=512,
          k=4, d=1, act=None, lrn=False),
    _case("flat_conv2d", "ragged 83x57 elu", 0, n=2, c=17, cout=8, h=83,
          w=57, k=3, d=2, act="elu", lrn=True),
    _case("flat_conv2d", "ragged 7x5 relu", 0, n=2, c=8, cb=8, cout=8, h=7,
          w=5, k=3, d=1, act="relu", lrn=False),
    _case("flat_conv2d", "ragged 83x57 4x4", 0, n=1, c=8, cout=17, h=83,
          w=57, k=4, d=1, act=None, lrn=False),
    # feat_root 16's dil_conv_2: an LRN over 64 channels
    _case("flat_conv2d", "LRN 64 ch 128^2 (feat_root 16)", 0, n=1, c=32,
          cout=64, h=128, w=128, k=3, d=4, act=None, lrn=True),
    # the fast conv tiles' edges (csrc/conv_fast.cuh: 32-column tiles of 4
    # rows in f32, 8 in bf16): 17 input channels (one float4 group / k16
    # step partly padding) over a batch of 3 whose tile rows do not divide
    # the height; 64 -> 8 on an image smaller than one tile; the 4x4 end
    # conv and a dilation of 4 on widths no 16-byte run divides; a
    # two-input merge conv whose width has whole runs but a partial tile
    _case("flat_conv2d", "cin 17 -> 8 batch 3 37x40 elu", 0, n=3, c=17,
          cout=8, h=37, w=40, k=3, d=1, act="elu", lrn=True),
    _case("flat_conv2d", "64 -> 8 3x21", 0, n=2, c=64, cout=8, h=3, w=21,
          k=3, d=1, act=None, lrn=True),
    _case("flat_conv2d", "4x4 8 -> 17 19x70", 0, n=2, c=8, cout=17, h=19,
          w=70, k=4, d=1, act=None, lrn=False),
    _case("flat_conv2d", "dil 4 16 -> 32 29x61", 0, n=2, c=16, cout=32,
          h=29, w=61, k=3, d=4, act=None, lrn=True),
    _case("flat_conv2d", "32 + 32 -> 32 21x48", 0, n=2, c=32, cb=32,
          cout=32, h=21, w=48, k=3, d=1, act=None, lrn=False),
    # f32 on the tensor cores stages 32 input channels a pass: two passes,
    # the second of 8 channels (its dx: 12 channels, one pass of 2 chunks)
    _case("flat_conv2d", "cin 40 -> 12 two passes 19x35 elu", 0, n=2, c=40,
          cout=12, h=19, w=35, k=3, d=2, act="elu", lrn=True),
    # f32 weights whose three bf16 parts pass a block's shared memory: the
    # fast path's FP32 pipes (bf16: the tensor cores as any fast shape)
    _case("flat_conv2d", "40 -> 40 21x37 (f32 on the FP32 pipes)", 0, n=2,
          c=40, cout=40, h=21, w=37, k=3, d=1, act=None, lrn=False),
    # just past the fast path: more than 64 input channels, and a 5x5
    # kernel, take the general kernels
    _case("flat_conv2d", "64 + 64 -> 64 18x40 (general)", 0, n=2, c=64,
          cb=64, cout=64, h=18, w=40, k=3, d=1, act=None, lrn=False),
    _case("flat_conv2d", "5x5 12 -> 8 23x31 (general)", 0, n=2, c=12,
          cout=8, h=23, w=31, k=5, d=1, act=None, lrn=False),
    _case("concat_conv1x1", "couple 8 ch 512^2", 4, n=1, c=8, cb=8, cout=8,
          h=512, w=512, act="relu"),
    _case("concat_conv1x1", "couple 16 ch 256^2", 4, n=1, c=16, cb=16,
          cout=16, h=256, w=256, act="relu"),
    _case("concat_conv1x1", "couple 32 ch 128^2", 4, n=1, c=32, cb=32,
          cout=32, h=128, w=128, act="relu"),
    _case("concat_conv1x1", "ragged 83x57 elu", 0, n=2, c=8, cb=8, cout=8,
          h=83, w=57, act="elu"),
    _case("concat_conv1x1", "ragged 83x57 no act", 0, n=2, c=16, cb=16,
          cout=16, h=83, w=57, act=None),
    # unequal inputs, output channels neither input's count nor a
    # multiple of 8
    _case("concat_conv1x1", "ca 8 cb 16 cout 12 37x45", 0, n=2, c=8, cb=16,
          cout=12, h=37, w=45, act="relu"),
    # feat_root 16's deepest coupling at flat_scales 3: wider than the
    # one-pass backward takes, so its wrapper runs the two general kernels
    _case("concat_conv1x1", "64 + 64 -> 64 40x48 (feat_root 16)", 0, n=2,
          c=64, cb=64, cout=64, h=40, w=48, act="relu"),
    _case("flat_deconv2", "64->32 to 128^2", 3, n=1, c=64, cout=32, h=64,
          w=64, ho=128, wo=128),
    _case("flat_deconv2", "32->16 to 256^2", 3, n=1, c=32, cout=16, h=128,
          w=128, ho=256, wo=256),
    _case("flat_deconv2", "16->8 to 512^2", 3, n=1, c=16, cout=8, h=256,
          w=256, ho=512, wo=512),
    _case("flat_deconv2", "ragged 42x29 to 83x57", 0, n=2, c=16, cout=8,
          h=42, w=29, ho=83, wo=57),
    _case("flat_deconv2", "ragged 42x29 to 84x57", 0, n=1, c=32, cout=16,
          h=42, w=29, ho=84, wo=57),
    # the deconv kernels' tile edges: output channels not a multiple of 8,
    # 3 input channels, 128 (several staged chunks), more than 32 output
    # channels (two passes), batch 16, and output channels past what one
    # dw staging holds (two dw launches in each dtype)
    _case("flat_deconv2", "cin 3 cout 12 19x23 to 38x45", 0, n=1, c=3,
          cout=12, h=19, w=23, ho=38, wo=45),
    _case("flat_deconv2", "cin 128 16x40 to 31x80", 0, n=1, c=128, cout=8,
          h=16, w=40, ho=31, wo=80),
    _case("flat_deconv2", "cout 40 10x9 to 20x17", 0, n=2, c=24, cout=40,
          h=10, w=9, ho=20, wo=17),
    _case("flat_deconv2", "batch 16 12x16 to 24x32", 0, n=16, c=32, cout=16,
          h=12, w=16, ho=24, wo=32),
    _case("flat_deconv2", "cout 240 6x7 to 12x14", 0, n=2, c=16, cout=240,
          h=6, w=7, ho=12, wo=14),
    # filter_size 5: the general kernels, forward and dw (dx takes any K)
    _case("flat_deconv2", "5x5 21x17 to 41x34", 0, n=2, c=12, cout=8, h=21,
          w=17, ho=41, wo=34, k=5),
    _case("flat_res_block", "8 ch 512^2", 6, n=1, c=8, h=512, w=512,
          act="relu"),
    _case("flat_res_block", "16 ch 256^2", 6, n=1, c=16, h=256, w=256,
          act="relu"),
    _case("flat_res_block", "32 ch 128^2", 6, n=1, c=32, h=128, w=128,
          act="relu"),
    _case("flat_res_block", "ragged 83x57 elu", 0, n=2, c=16, h=83, w=57,
          act="elu"),
    _case("flat_res_block", "ragged 7x5", 0, n=2, c=32, h=7, w=5, act="relu"),
    _case("flat_res_block", "ragged 37x45 8 ch", 0, n=1, c=8, h=37, w=45,
          act="elu"),
    _case("flat_res_block", "ragged 33x65 4 ch", 0, n=2, c=4, h=33, w=65,
          act="relu"),
    # the kernels' tiles (csrc/flatres.cu, flatres_bwd.cu: 8 or 16 rows by
    # 8 to 32 columns): 32 channels on a height no tile height divides and
    # a width with no 16-byte bf16 runs; batch 16 on an image small enough that the
    # persistent grid gives each block several tiles, so the partial rows
    # add across them; 4 and 8 channels with elu; a one-row image
    _case("flat_res_block", "32 ch 21x45", 0, n=2, c=32, h=21, w=45,
          act="relu"),
    _case("flat_res_block", "batch 16 16 ch 96x96", 0, n=16, c=16, h=96,
          w=96, act="relu"),
    _case("flat_res_block", "4 ch 29x70 elu", 0, n=2, c=4, h=29, w=70,
          act="elu"),
    _case("flat_res_block", "8 ch 50x72 elu", 0, n=1, c=8, h=50, w=72,
          act="elu"),
    _case("flat_res_block", "one row 1x77 16 ch", 0, n=2, c=16, h=1, w=77,
          act="relu"),
]


def flat_case_arrays(case: dict, rng: np.random.Generator,
                     n: Optional[int] = None):
    """float32 operands of a FLAT_CASES entry in the port's layouts (batch
    ``n`` or the case's): to_nchw (x NHWC,); flat_maxpool2 (x,);
    flat_conv2d and concat_conv1x1 (a, b or None, w OIHW, bias);
    flat_deconv2 (x, w [Cin, Cout, K, K] with asymmetric taps, bias);
    flat_res_block (x, w1, b1, w2, b2).  Weights are scaled by
    1/sqrt(fan-in), so activations stay O(1) through the epilogue."""
    op, n = case["op"], n or case["n"]
    c, h, w = case["c"], case["h"], case["w"]

    def normal(*shape, scale=1.0):
        return (rng.normal(size=shape) * scale).astype(np.float32)

    if op == "to_nchw":
        return (normal(n, h, w, c),)
    if op == "flat_maxpool2":
        return (normal(n, c, h, w),)
    if op in ("flat_conv2d", "concat_conv1x1"):
        cb, cout, k = case.get("cb", 0), case["cout"], case.get("k", 1)
        b = normal(n, cb, h, w) if cb else None
        wt = normal(cout, c + cb, k, k, scale=(k * k * (c + cb)) ** -0.5)
        return normal(n, c, h, w), b, wt, normal(cout, scale=0.1)
    if op == "flat_deconv2":
        cout, k = case["cout"], case.get("k", 3)
        wt = (normal(c, cout, k, k) + np.arange(k * k, dtype=np.float32)
              .reshape(k, k)) * (k * k * c) ** -0.5
        return (normal(n, c, h, w), wt.astype(np.float32),
                normal(cout, scale=0.1))
    if op == "flat_res_block":
        s = (9 * c) ** -0.5
        return (normal(n, c, h, w), normal(c, c, 3, 3, scale=s),
                normal(c, scale=0.1), normal(c, c, 3, 3, scale=s),
                normal(c, scale=0.1))
    raise ValueError(f"unknown flat op {op!r}")


def flat_case_tensors(case: dict, rng: np.random.Generator,
                      device: torch.device, dtype: torch.dtype,
                      n: Optional[int] = None):
    """``flat_case_arrays`` on ``device``: activations and weights in
    ``dtype``, biases f32; to_nchw's NHWC input stays f32 (the one-hot
    chargrid), its output takes ``dtype``."""
    op = case["op"]
    out = []
    for a in flat_case_arrays(case, rng, n):
        t = None if a is None else torch.from_numpy(a).to(device)
        if t is not None and op != "to_nchw" and t.ndim > 1:
            t = t.to(dtype)
        out.append(t)
    return out


def flat_case_fns(case: dict, tensors, dtype: torch.dtype
                  ) -> Tuple[Callable, Callable]:
    """(kernel, plain): zero-argument calls of a case's CUDA wrapper and
    plain version on ``flat_case_tensors``; ``dtype`` is to_nchw's output
    dtype."""
    op = case["op"]
    if op == "to_nchw":
        (x,) = tensors
        return (lambda: flatconv.to_nchw_cuda(x, dtype),
                lambda: flatconv.to_nchw_plain(x, dtype))
    if op == "flat_maxpool2":
        (x,) = tensors
        return (lambda: flatconv.flat_maxpool2_cuda(x),
                lambda: flatconv.flat_maxpool2_plain(x))
    if op == "flat_conv2d":
        a, b, w, bias = tensors
        kw = dict(dilation=case["d"], act=case["act"],
                  lrn_size=case["cout"] if case["lrn"] else 0)
        return (lambda: flatconv.flat_conv2d_cuda(a, b, w, bias, **kw),
                lambda: flatconv.flat_conv2d_plain(a, b, w, bias, **kw))
    if op == "concat_conv1x1":
        a, b, w, bias = tensors
        return (lambda: flatconv.concat_conv1x1_cuda(a, b, w, bias,
                                                     act=case["act"]),
                lambda: flatconv.concat_conv1x1_plain(a, b, w, bias,
                                                      act=case["act"]))
    if op == "flat_deconv2":
        x, w, bias = tensors
        hw = (case["ho"], case["wo"])
        return (lambda: flatconv.flat_deconv2_cuda(x, w, bias, hw),
                lambda: flatconv.flat_deconv2_plain(x, w, bias, hw))
    if op == "flat_res_block":
        args = tuple(tensors) + (case["act"],)
        return (lambda: flatres.flat_res_block_cuda(*args),
                lambda: flatres.flat_res_block_plain(*args))
    raise ValueError(f"unknown flat op {op!r}")


# The backward kernels' cases: one per forward case, named after it, with
# ``per_step`` the launches of one flagship train step at flat_scales 3
# (its forward counts; the stage-0 entry conv needs no dx: the chargrid
# has no gradient).  The ragged forward cases carry over with per_step 0.
_BWD_OF = {"flat_conv2d": ("flat_conv_bwd", "flat_conv_dx"),
           "concat_conv1x1": ("concat_conv1x1_bwd",),
           "flat_maxpool2": ("flat_maxpool2_bwd",),
           "flat_deconv2": ("flat_deconv2_dx", "flat_deconv2_dw"),
           "flat_res_block": ("flat_res_block_bwd",)}
FLAT_BWD_CASES = [
    dict(case, op=op, fwd_op=case["op"],
         per_step=0 if (op == "flat_conv_dx"
                        and case["name"] == "dil_conv_0 stage 0")
         else case["per_request"])
    for case in FLAT_CASES if case["op"] in _BWD_OF
    for op in _BWD_OF[case["op"]]]


def scaled_cases(side: int, n: int, in_channels: int):
    """The flat ops' instances of a flagship-shaped model (feat_root 8,
    n_class 17, 4 scales, flat_scales 3) on ``side``^2 pages at batch
    ``n`` with ``in_channels`` input planes: the serve cases of FLAT_CASES
    scaled from 512^2 -> (forward cases, backward cases), the backward
    cases one per kernel of each forward case's backward."""
    fwd = []
    for case in FLAT_CASES:
        if not case["per_request"]:
            continue
        c = dict(case, n=n)
        for k in ("h", "w", "ho", "wo"):
            if k in c:
                c[k] = c[k] * side // 512
        if case["op"] == "to_nchw" or case["name"] == "dil_conv_0 stage 0":
            c["c"] = in_channels
        layer = re.sub(r"\d+ ch|\d+\^2|to", "", case["name"]).strip()
        c["name"] = f"{layer} {c['c']} ch {c['h']}x{c['w']} batch {n}".strip()
        fwd.append(c)
    bwd = [dict(c, op=op, fwd_op=c["op"]) for c in fwd
           if c["op"] in _BWD_OF for op in _BWD_OF[c["op"]]]
    return fwd, bwd


def flat_bwd_case_tensors(case: dict, rng: np.random.Generator,
                          device: torch.device, dtype: torch.dtype,
                          n: Optional[int] = None):
    """The forward case's operands (``flat_case_tensors``) and a cotangent
    of its output, in ``dtype``.  The pool's input is quantized after a
    relu (many zeros, repeated values), so its windows hold ties."""
    fwd = dict(case, op=case["fwd_op"])
    arrays = list(flat_case_arrays(fwd, rng, n))
    nn, c, h, w = arrays[0].shape
    if case["fwd_op"] == "flat_maxpool2":
        arrays[0] = np.round(np.maximum(arrays[0], 0) * 2) / 2
        out = (nn, c, -(-h // 2), -(-w // 2))
    elif case["fwd_op"] == "flat_deconv2":
        out = (nn, case["cout"], case["ho"], case["wo"])
    else:
        out = (nn, case.get("cout", c), h, w)
    arrays.append(rng.normal(size=out).astype(np.float32))
    return [None if a is None else
            torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(
                device, dtype if a.ndim > 1 else torch.float32)
            for a in arrays]


def flat_bwd_case_fns(case: dict, tensors) -> Tuple[Callable, Callable]:
    """(kernel, plain): zero-argument calls of a backward case's CUDA
    wrapper and plain version on ``flat_bwd_case_tensors``, each returning
    a tuple of tensors (None entries dropped)."""
    op = case["op"]

    def pair(kernel, plain, *args, **kw):
        drop = lambda out: tuple(t for t in (out if isinstance(out, tuple)
                                             else (out,)) if t is not None)
        return (lambda: drop(kernel(*args, **kw)),
                lambda: drop(plain(*args, **kw)))

    if op == "flat_maxpool2_bwd":
        x, g = tensors
        return pair(flatconv.flat_maxpool2_bwd_cuda,
                    flatconv.flat_maxpool2_bwd_plain, x, g)
    if op in ("flat_conv_bwd", "flat_conv_dx"):
        a, b, w, bias, g = tensors
        if op == "flat_conv_dx":
            couts = (a.shape[1],) if b is None else (a.shape[1], b.shape[1])
            return pair(flatconv.flat_conv_dx_cuda,
                        flatconv.flat_conv_dx_plain, g, w, couts,
                        dilation=case.get("d", 1))
        kw = dict(dilation=case.get("d", 1), act=case["act"],
                  lrn_size=case["cout"] if case.get("lrn") else 0)
        return pair(flatconv.flat_conv_bwd_cuda, flatconv.flat_conv_bwd_plain,
                    a, b, w, bias, g, **kw)
    if op == "concat_conv1x1_bwd":
        a, b, w, bias, g = tensors
        return pair(flatconv.concat_conv1x1_bwd_cuda,
                    flatconv.concat_conv1x1_bwd_plain, a, b, w, bias, g,
                    act=case["act"])
    if op == "flat_deconv2_dx":
        x, w, _, g = tensors
        return pair(flatconv.flat_deconv2_dx_cuda,
                    flatconv.flat_deconv2_dx_plain, g, w, tuple(x.shape[-2:]))
    if op == "flat_deconv2_dw":
        x, w, _, g = tensors
        return pair(flatconv.flat_deconv2_dw_cuda,
                    flatconv.flat_deconv2_dw_plain, x, g, tuple(w.shape))
    if op == "flat_res_block_bwd":
        return pair(flatres.flat_res_block_bwd_cuda,
                    flatres.flat_res_block_bwd_plain, *tensors, case["act"])
    raise ValueError(f"unknown flat backward op {op!r}")


def flat_bwd_output_kinds(case: dict) -> Tuple[str, ...]:
    """Each output of a backward case: "act" (an activation-shaped
    cotangent in the activation dtype) or "param" (an f32 weight or bias
    gradient, a sum over every pixel)."""
    op = case["op"]
    if op == "flat_conv_bwd":
        epi = case["act"] is not None or case.get("lrn")
        return ("act",) * bool(epi) + ("param", "param")
    if op == "flat_conv_dx":
        return ("act",) * (2 if case.get("cb") else 1)
    if op == "concat_conv1x1_bwd":
        return ("act", "act", "param", "param")
    if op == "flat_deconv2_dw":
        return ("param",)
    if op == "flat_res_block_bwd":
        return ("act",) + ("param",) * 4
    return ("act",)


# Tolerances of a backward kernel against its plain version: an "act"
# output's largest error over max(1, its largest |value|), a "param"
# output's over its largest |value|.  f32: sum order.  A weight gradient
# sums up to 16 x 512^2 = 4.2M products of O(1) operands into values near
# sqrt(4.2M): f32 sums taken in two orders (per-block partials here,
# cuDNN's wgrad there) differ by ~1e-4 of the largest (2.4e-4 on an
# H100 at batch 16), hence 1e-3.  bf16: both sides round the same
# f32 values, and a rounding that flips on one side moves a sum by an
# ulp.  The pool backward only routes values: exact.
FLAT_BWD_TOL = {"float32": {"act": 1e-5, "param": 1e-3},
                "bfloat16": {"act": 2e-2, "param": 2e-2}}


def flat_bwd_errors(case: dict, got, want, dtype_name: str):
    """-> [(kind, scaled error, tolerance)] per output; raises on a shape,
    dtype or count mismatch."""
    kinds = flat_bwd_output_kinds(case)
    if len(got) != len(kinds) or len(want) != len(kinds):
        raise AssertionError(f"{case['op']} {case['name']}: {len(got)} / "
                             f"{len(want)} outputs, want {len(kinds)}")
    out = []
    for kind, a, b in zip(kinds, got, want):
        if a.shape != b.shape or a.dtype != b.dtype:
            raise AssertionError(f"{case['op']} {case['name']}: {a.shape} "
                                 f"{a.dtype} vs {b.shape} {b.dtype}")
        b64 = b.double()
        scale = float(b64.abs().max()) if b.numel() else 0.0
        scale = max(1.0, scale) if kind == "act" else max(scale, 1e-30)
        err = (float((a.double() - b64).abs().max()) / scale
               if b.numel() else 0.0)
        tol = (0.0 if case["op"] == "flat_maxpool2_bwd"
               else FLAT_BWD_TOL[dtype_name][kind])
        out.append((kind, err, tol))
    return out
