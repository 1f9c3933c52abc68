"""Forward ops of the flat-layout scales (``flat_scales > 0``) on NCHW.

Port of the forward half of ``msau_tpu/ops/flatconv.py``.  The JAX package
runs the shallow U-Net scales on a TPU-only body-flat layout (W on lanes,
guard blocks, pad columns, per-scale geometries, VMEM gates, insert
matrices, cin chunking); none of that carries over.  The port's tensors
stay compact NCHW, and each op's one CUDA kernel covers every fallback
branch the JAX package takes (odd sizes, wide cin, geometries without an
aligned tiling), so any H, W runs.

  op               kernel              TPU kernel it replaces
  to_nchw          csrc/layout.cu      _to_body_kernel
  flat_maxpool2    csrc/pool.cu        _mp_fwd_kernel
  flat_conv2d      csrc/flatconv.cu    _fwd_kernel
  concat_conv1x1   csrc/flatconv.cu    _cc_fwd_kernel (the KH = KW = 1 case)
  flat_deconv2     csrc/deconv.cu      _dc_fwd_kernel, _ups_fwd_kernel

A CUDA tensor launches the kernel (the ``*_cuda`` wrappers, each counting
its launches in ``.launches``); a CPU tensor takes the ``*_plain`` version.
Activations are f32 or bf16; weights are cast to the activation dtype,
biases are added in f32, and every op accumulates and runs its epilogue in
f32.  Each op is a ``torch.autograd.Function`` whose backward raises
``NotImplementedError``: the backward kernels are the next slice.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from msau_tpu_torch.ops import cuda_lib

DTYPES = (torch.float32, torch.bfloat16)
ACT_CODES = {None: 0, "relu": 1, "elu": 2}
BACKWARD_TODO = (
    "flat_scales > 0 has no backward yet: the flat-layout backward kernels "
    "are ROADMAP Queue 2 rows 7, 8, 10, 12, 14, 16 and 19 (the next slice); "
    "train at flat_scales=0, the same model and parameter tree")


def act_code(act: Optional[str]) -> int:
    """0 none, 1 relu, 2 elu: the activations the kernels fuse."""
    act = None if act in ("none", "identity") else act
    if act not in ACT_CODES:
        raise ValueError(f"the flat ops fuse relu or elu, not {act!r}")
    return ACT_CODES[act]


def apply_act(y: torch.Tensor, code: int) -> torch.Tensor:
    if code == 1:
        return F.relu(y)
    if code == 2:
        return F.elu(y)
    return y


def same_padding(k: int, dilation: int = 1) -> Tuple[int, int]:
    """TF-SAME (lo, hi) padding of a stride-1 conv; extra pixel at hi."""
    total = (k - 1) * dilation
    return total // 2, total - total // 2


def local_response_norm(x: torch.Tensor, size: int, alpha: float = 1e-4,
                        beta: float = 0.75, k: float = 1.0) -> torch.Tensor:
    """torch.nn.LocalResponseNorm semantics over the channel axis (dim 1).

    The windowed channel sum is one contraction with a [C, C] band matrix,
    in f32 whatever the input dtype (F.local_response_norm's avg_pool3d has
    no bf16 CPU kernel)."""
    c = x.shape[1]
    ci = torch.arange(c, device=x.device)
    band = ((ci[:, None] >= ci[None, :] - size // 2)
            & (ci[:, None] <= ci[None, :] + (size - 1) // 2)).float()
    xf = x.float()
    win = torch.einsum("nchw,cd->ndhw", xf * xf, band)
    return (xf / torch.pow(k + (alpha / size) * win, beta)).to(x.dtype)


class _ForwardOnly(torch.autograd.Function):
    """Runs ``impl(*tensors, **kwargs)``; a gradient through it raises, so
    none flows silently through a plain version either."""

    @staticmethod
    def forward(ctx, impl, kwargs, *tensors):
        return impl(*tensors, **kwargs)

    @staticmethod
    def backward(ctx, *grads):
        raise NotImplementedError(BACKWARD_TODO)


def forward_only(impl, kwargs: dict, *tensors: Optional[torch.Tensor]):
    return _ForwardOnly.apply(impl, kwargs, *tensors)


def on_cuda(name: str, t: torch.Tensor) -> bool:
    if t.device.type not in ("cuda", "cpu"):
        raise ValueError(f"{name}: unsupported device {t.device}")
    return t.device.type == "cuda"


def is_bf16(t: torch.Tensor) -> int:
    return int(t.dtype == torch.bfloat16)


def cast_params(name: str, x: torch.Tensor, *params: torch.Tensor):
    """Weights in ``x``'s dtype and biases in f32, contiguous, on ``x``'s
    device (pairs: weight, bias, weight, bias, ...)."""
    out = []
    for i, p in enumerate(params):
        if p.device != x.device:
            raise ValueError(f"{name}: parameter on {p.device}, input on "
                             f"{x.device}")
        out.append(p.to(x.dtype if i % 2 == 0 else torch.float32).contiguous())
    return out


# ---- K8: entry layout ---------------------------------------------------

def to_nchw_plain(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    return x.permute(0, 3, 1, 2).to(dtype).contiguous()


def to_nchw_cuda(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Launch the NHWC -> NCHW + cast kernel; ``.launches`` counts calls."""
    cuda_lib.require_cuda("to_nchw", x, DTYPES, 4)
    if dtype not in DTYPES:
        raise ValueError(f"to_nchw: output dtype {dtype} not supported")
    n, h, w, c = x.shape
    y = torch.empty((n, c, h, w), dtype=dtype, device=x.device)
    code = cuda_lib.library().msau_nhwc_to_nchw(
        x.data_ptr(), y.data_ptr(), n, h * w, c, is_bf16(x),
        int(dtype == torch.bfloat16), cuda_lib.stream_ptr(x.device))
    cuda_lib.check("msau_nhwc_to_nchw", code)
    to_nchw_cuda.launches += 1
    return y


to_nchw_cuda.launches = 0


def _to_nchw(x, *, dtype):
    return (to_nchw_cuda if on_cuda("to_nchw", x) else to_nchw_plain)(x, dtype)


def to_nchw(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """NHWC [N, H, W, C] -> contiguous NCHW [N, C, H, W] in ``dtype``."""
    return forward_only(_to_nchw, {"dtype": dtype}, x)


# ---- K7: 2x2 max pool ---------------------------------------------------

def flat_maxpool2_plain(x: torch.Tensor) -> torch.Tensor:
    # TF-SAME: odd sizes pad bottom/right with -inf, which is what
    # ceil_mode's partial last window computes
    return F.max_pool2d(x, kernel_size=2, stride=2, ceil_mode=True)


def flat_maxpool2_cuda(x: torch.Tensor) -> torch.Tensor:
    """Launch the pool kernel; ``.launches`` counts calls."""
    cuda_lib.require_cuda("flat_maxpool2", x, DTYPES, 4)
    n, c, h, w = x.shape
    y = torch.empty((n, c, (h + 1) // 2, (w + 1) // 2), dtype=x.dtype,
                    device=x.device)
    code = cuda_lib.library().msau_maxpool2(
        x.data_ptr(), y.data_ptr(), n * c, h, w, is_bf16(x),
        cuda_lib.stream_ptr(x.device))
    cuda_lib.check("msau_maxpool2", code)
    flat_maxpool2_cuda.launches += 1
    return y


flat_maxpool2_cuda.launches = 0


def _flat_maxpool2(x):
    return (flat_maxpool2_cuda if on_cuda("flat_maxpool2", x)
            else flat_maxpool2_plain)(x)


def flat_maxpool2(x: torch.Tensor) -> torch.Tensor:
    """2x2 stride-2 TF-SAME max pool: [N, C, H, W] -> [N, C, ceil(H/2),
    ceil(W/2)]."""
    return forward_only(_flat_maxpool2, {}, x)


# ---- K1 / K3: conv with the fused epilogue ------------------------------

def flat_conv2d_plain(a: torch.Tensor, b: Optional[torch.Tensor],
                      w: torch.Tensor, bias: torch.Tensor, *,
                      dilation: int = 1, act: Optional[str] = None,
                      lrn_size: int = 0, alpha: float = 1e-4,
                      beta: float = 0.75, lrn_k: float = 1.0) -> torch.Tensor:
    """act(conv([a; b], w) + bias), then LRN over the output channels, in
    f32 from the activation-dtype operands; the result in ``a``'s dtype."""
    x = a if b is None else torch.cat([a, b], dim=1)
    kh, kw = w.shape[-2:]
    ph, pw = same_padding(kh, dilation), same_padding(kw, dilation)
    xf = F.pad(x.float(), (pw[0], pw[1], ph[0], ph[1]))
    y = F.conv2d(xf, w.to(x.dtype).float(), bias.float(), dilation=dilation)
    y = apply_act(y, act_code(act))
    if lrn_size:
        y = local_response_norm(y, lrn_size, alpha, beta, lrn_k)
    return y.to(x.dtype)


def _conv_launch(name: str, a, b, w, bias, dilation, act, lrn_size, alpha,
                 beta, lrn_k) -> torch.Tensor:
    cuda_lib.require_cuda(f"{name} input", a, DTYPES, 4)
    n, ca, h, wd = a.shape
    cb = 0
    if b is not None:
        cuda_lib.require_cuda(f"{name} input b", b, a.dtype, 4)
        if b.device != a.device or b.shape[0] != n or b.shape[2:] != a.shape[2:]:
            raise ValueError(f"{name}: inputs {tuple(a.shape)} and "
                             f"{tuple(b.shape)} do not concat on channels")
        cb = b.shape[1]
    cout, cin, kh, kw = w.shape
    if cin != ca + cb or bias.shape != (cout,):
        raise ValueError(f"{name}: weight {tuple(w.shape)} / bias "
                         f"{tuple(bias.shape)} do not fit {ca} + {cb} inputs")
    if lrn_size and cout > 32:
        raise ValueError(f"{name}: the fused LRN holds at most 32 channels, "
                         f"got {cout}")
    w, bias = cast_params(name, a, w, bias)
    y = torch.empty((n, cout, h, wd), dtype=a.dtype, device=a.device)
    code = cuda_lib.library().msau_flat_conv2d(
        a.data_ptr(), None if b is None else b.data_ptr(), w.data_ptr(),
        bias.data_ptr(), y.data_ptr(), n, ca, cb, h, wd, cout, kh, kw,
        dilation, same_padding(kh, dilation)[0], same_padding(kw, dilation)[0],
        act_code(act), int(lrn_size or 0), alpha, beta, lrn_k, is_bf16(a),
        cuda_lib.stream_ptr(a.device))
    cuda_lib.check("msau_flat_conv2d", code)
    return y


def flat_conv2d_cuda(a, b, w, bias, *, dilation=1, act=None, lrn_size=0,
                     alpha=1e-4, beta=0.75, lrn_k=1.0) -> torch.Tensor:
    """Launch the conv kernel; ``.launches`` counts calls."""
    y = _conv_launch("flat_conv2d", a, b, w, bias, dilation, act, lrn_size,
                     alpha, beta, lrn_k)
    flat_conv2d_cuda.launches += 1
    return y


flat_conv2d_cuda.launches = 0


def _flat_conv2d(a, b, w, bias, **kw):
    fn = flat_conv2d_cuda if on_cuda("flat_conv2d", a) else flat_conv2d_plain
    return fn(a, b, w, bias, **kw)


def flat_conv2d(x, w: torch.Tensor, bias: torch.Tensor, *, dilation: int = 1,
                act: Optional[str] = None, lrn_size: int = 0,
                alpha: float = 1e-4, beta: float = 0.75,
                lrn_k: float = 1.0) -> torch.Tensor:
    """Stride-1 TF-SAME conv + bias -> act -> LRN (size ``lrn_size``, 0 for
    none).  ``x`` is [N, Cin, H, W] or a pair (a, b) read as their channel
    concat; ``w`` is [Cout, Cin, KH, KW]."""
    a, b = x if isinstance(x, tuple) else (x, None)
    return forward_only(_flat_conv2d, dict(dilation=dilation, act=act,
                                           lrn_size=lrn_size, alpha=alpha,
                                           beta=beta, lrn_k=lrn_k),
                        a, b, w, bias)


def concat_conv1x1_plain(a, b, w, bias, *, act=None) -> torch.Tensor:
    return flat_conv2d_plain(a, b, w, bias, act=act)


def concat_conv1x1_cuda(a, b, w, bias, *, act=None) -> torch.Tensor:
    """Launch the conv kernel as the two-input 1x1 coupling conv;
    ``.launches`` counts calls."""
    if tuple(w.shape[-2:]) != (1, 1):
        raise ValueError(f"concat_conv1x1: weight {tuple(w.shape)} is not 1x1")
    y = _conv_launch("concat_conv1x1", a, b, w, bias, 1, act, 0, 0.0, 0.0, 0.0)
    concat_conv1x1_cuda.launches += 1
    return y


concat_conv1x1_cuda.launches = 0


def _concat_conv1x1(a, b, w, bias, *, act):
    fn = (concat_conv1x1_cuda if on_cuda("concat_conv1x1", a)
          else concat_conv1x1_plain)
    return fn(a, b, w, bias, act=act)


def concat_conv1x1(a: torch.Tensor, b: torch.Tensor, w: torch.Tensor,
                   bias: torch.Tensor, act: Optional[str] = None) -> torch.Tensor:
    """act(W [a; b] + bias) with a 1x1 ``w`` [Cout, Ca + Cb, 1, 1]."""
    return forward_only(_concat_conv1x1, {"act": act}, a, b, w, bias)


# ---- K6: stride-2 transposed conv ---------------------------------------

def _check_deconv(x: torch.Tensor, w: torch.Tensor, target_hw) -> None:
    k = w.shape[-1]
    if w.shape[-2] != k or k % 2 == 0:
        raise ValueError(f"flat_deconv2: kernel {tuple(w.shape[-2:])} must be "
                         "square and odd")
    h, wd = x.shape[-2:]
    if (target_hw[0] not in (2 * h - 1, 2 * h)
            or target_hw[1] not in (2 * wd - 1, 2 * wd)):
        raise ValueError(f"flat_deconv2: target {tuple(target_hw)} "
                         f"unreachable from {(h, wd)} with stride 2")


def flat_deconv2_plain(x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor,
                       target_hw: Tuple[int, int]) -> torch.Tensor:
    """torch ConvTranspose2d(stride 2, padding K/2) to exactly
    ``target_hw``, f32 from the activation-dtype operands."""
    _check_deconv(x, w, target_hw)
    h, wd = x.shape[-2:]
    op = (target_hw[0] - (2 * h - 1), target_hw[1] - (2 * wd - 1))
    y = F.conv_transpose2d(x.float(), w.to(x.dtype).float(), bias.float(),
                           stride=2, padding=w.shape[-1] // 2,
                           output_padding=op)
    return y.to(x.dtype)


def flat_deconv2_cuda(x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor,
                      target_hw: Tuple[int, int]) -> torch.Tensor:
    """Launch the deconv kernel; ``.launches`` counts calls."""
    cuda_lib.require_cuda("flat_deconv2", x, DTYPES, 4)
    _check_deconv(x, w, target_hw)
    n, cin, h, wd = x.shape
    if w.shape[0] != cin or bias.shape != (w.shape[1],):
        raise ValueError(f"flat_deconv2: weight {tuple(w.shape)} / bias "
                         f"{tuple(bias.shape)} do not fit {cin} inputs")
    cout, k = w.shape[1], w.shape[-1]
    w, bias = cast_params("flat_deconv2", x, w, bias)
    ho, wo = target_hw
    y = torch.empty((n, cout, ho, wo), dtype=x.dtype, device=x.device)
    code = cuda_lib.library().msau_flat_deconv2(
        x.data_ptr(), w.data_ptr(), bias.data_ptr(), y.data_ptr(), n, cin, h,
        wd, cout, k, ho, wo, is_bf16(x), cuda_lib.stream_ptr(x.device))
    cuda_lib.check("msau_flat_deconv2", code)
    flat_deconv2_cuda.launches += 1
    return y


flat_deconv2_cuda.launches = 0


def _flat_deconv2(x, w, bias, *, target_hw):
    fn = flat_deconv2_cuda if on_cuda("flat_deconv2", x) else flat_deconv2_plain
    return fn(x, w, bias, target_hw)


def flat_deconv2(x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor,
                 target_hw: Tuple[int, int]) -> torch.Tensor:
    """Stride-2 transposed conv of [N, Cin, H, W] with torch's weight
    [Cin, Cout, K, K] (odd K) to [N, Cout, *target_hw], target in {2H-1,
    2H} x {2W-1, 2W}."""
    return forward_only(_flat_deconv2, {"target_hw": tuple(target_hw)},
                        x, w, bias)
