"""Ops of the flat-layout scales (``flat_scales > 0``) on NCHW, forward and
backward.

Port of ``msau_tpu/ops/flatconv.py``.  The JAX package runs the shallow
U-Net scales on a TPU-only body-flat layout (W on lanes, guard blocks, pad
columns, per-scale geometries, VMEM gates, insert matrices, cin chunking);
none of that carries over.  The port's tensors stay compact NCHW, and each
op's CUDA kernel covers every fallback branch the JAX package takes (odd
sizes, wide cin, geometries without an aligned tiling), so any H, W runs.

  op / its backward   kernel                TPU kernel it replaces
  to_nchw             csrc/layout.cu        _to_body_kernel (backward: a
                                            permute, as in JAX)
  flat_maxpool2       csrc/pool.cu          _mp_fwd_kernel
    backward          csrc/pool.cu          _mp_bwd_kernel
  flat_conv2d         csrc/flatconv.cu      _fwd_kernel
    stage 1 (g0, dw, db)  csrc/flatconv_bwd.cu  _epi_bwd_kernel, _dw_kernel
    dx                csrc/flatconv.cu      _fwd_kernel as the transposed
                                            conv (split outputs)
  concat_conv1x1      csrc/flatconv.cu      _cc_fwd_kernel (KH = KW = 1)
    backward          csrc/concat1x1_bwd.cu _cc_bwd_kernel (one pass: da,
                                            db, dw, dbias; wider couplings:
                                            stage 1 and dx as above)
  flat_deconv2        csrc/deconv.cu        _dc_fwd_kernel, _ups_fwd_kernel
    backward          csrc/deconv_bwd.cu    _dc_dx_kernel, _dc_dw_kernel,
                                            _ups_bwd_kernel

A CUDA tensor launches the kernel (the ``*_cuda`` wrappers, each counting
its launches in ``.launches``; those of csrc/flatconv.cu count the f32
launches that ran on the tensor cores in ``.tc_launches`` too); a CPU
tensor takes the ``*_plain`` version.
Activations are f32 or bf16; weights are cast to the activation dtype,
biases are added in f32, and every op accumulates and runs its epilogue in
f32.  Each op is a ``torch.autograd.Function`` whose backward follows the
JAX package's rounding: the incoming cotangent is cast to the activation
dtype, a cotangent that feeds a conv or a weight gradient is rounded to it,
and weight and bias gradients are f32 sums returned in the parameter's
dtype.  A backward computes only the gradients autograd asks for, but the
coupling conv's, whose one pass computes all four, as the TPU kernel's
does.
"""

from __future__ import annotations

import functools
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from msau_tpu_torch.ops import cuda_lib
from msau_tpu_torch.ops.precision import wide, wide_dtype

DTYPES = (torch.float32, torch.bfloat16)
ACT_CODES = {None: 0, "relu": 1, "elu": 2}


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


def act_grad(a: torch.Tensor, code: int) -> torch.Tensor:
    """d act(a) / da from the preactivation (jax.nn.elu's: exp(a) below 0)."""
    if code == 1:
        return (a > 0).to(a.dtype)
    if code == 2:
        return torch.where(a > 0, torch.ones((), dtype=a.dtype),
                           torch.exp(torch.clamp(a, max=0.0)))
    return torch.ones_like(a)


def same_padding(k: int, dilation: int = 1) -> Tuple[int, int]:
    """TF-SAME (lo, hi) padding of a stride-1 conv; extra pixel at hi."""
    total = (k - 1) * dilation
    return total // 2, total - total // 2


def _lrn_band(c: int, size: int, like: torch.Tensor) -> torch.Tensor:
    """band[ci, co] = 1 iff ci lies in co's window [co - size//2,
    co + (size-1)//2] (torch clamping), in ``like``'s dtype and device."""
    ci = torch.arange(c, device=like.device)
    return ((ci[:, None] >= ci[None, :] - size // 2)
            & (ci[:, None] <= ci[None, :] + (size - 1) // 2)).to(like.dtype)


def local_response_norm(x: torch.Tensor, size: int, alpha: float = 1e-4,
                        beta: float = 0.75, k: float = 1.0) -> torch.Tensor:
    """torch.nn.LocalResponseNorm semantics over the channel axis (dim 1).

    The windowed channel sum is one contraction with a [C, C] band matrix,
    in f32 whatever the input dtype (F.local_response_norm's avg_pool3d has
    no bf16 CPU kernel)."""
    xf = wide(x)
    win = torch.einsum("nchw,cd->ndhw", xf * xf, _lrn_band(x.shape[1], size,
                                                           xf))
    return (xf / torch.pow(k + (alpha / size) * win, beta)).to(x.dtype)


def on_cuda(name: str, t: torch.Tensor) -> bool:
    if t.device.type not in ("cuda", "cpu"):
        raise ValueError(f"{name}: unsupported device {t.device}")
    return t.device.type == "cuda"


def is_bf16(t: torch.Tensor) -> int:
    return int(t.dtype == torch.bfloat16)


def ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


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


def partial_scratch(stride: int, device) -> torch.Tensor:
    """The f32 per-block rows a weight-gradient kernel sums across blocks."""
    return torch.empty(cuda_lib.PARTIAL_BLOCKS * stride, dtype=torch.float32,
                       device=device)


def _grad(t: Optional[torch.Tensor], like: torch.Tensor, needed: bool):
    return t.to(like.dtype) if needed and t is not None else None


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


class _ToNCHW(torch.autograd.Function):
    """Backward: the permute back (the JAX package's is a transpose too)."""

    @staticmethod
    def forward(ctx, x, dtype):
        ctx.in_dtype = x.dtype
        fn = to_nchw_cuda if on_cuda("to_nchw", x) else to_nchw_plain
        return fn(x, dtype)

    @staticmethod
    def backward(ctx, g):
        if not ctx.needs_input_grad[0]:
            return None, None
        return g.permute(0, 2, 3, 1).to(ctx.in_dtype), None


def to_nchw(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """NHWC [N, H, W, C] -> contiguous NCHW [N, C, H, W] in ``dtype``."""
    return _ToNCHW.apply(x, dtype)


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


def flat_maxpool2_bwd_plain(x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """The JAX package's pool gradient for each size: even H and W route g
    to one element of the window (the column with the larger row-pair max,
    a tie to the even column; then the lower row only if strictly larger);
    an odd H or W splits g evenly over the elements equal to the max."""
    n, c, h, w = x.shape
    ho, wo = (h + 1) // 2, (w + 1) // 2
    xp = F.pad(wide(x), (0, w % 2, 0, h % 2), value=float("-inf"))
    v = xp.reshape(n, c, ho, 2, wo, 2)
    v00, v01, v10, v11 = v[:, :, :, 0, :, 0], v[:, :, :, 0, :, 1], \
        v[:, :, :, 1, :, 0], v[:, :, :, 1, :, 1]
    gf = wide(g.to(x.dtype))
    zero = torch.zeros((), dtype=gf.dtype, device=x.device)
    if h % 2 == 0 and w % 2 == 0:
        col0 = torch.maximum(v00, v10) >= torch.maximum(v01, v11)
        up0, up1 = v00 >= v10, v01 >= v11
        d = [torch.where(col0 & up0, gf, zero), torch.where(~col0 & up1, gf, zero),
             torch.where(col0 & ~up0, gf, zero),
             torch.where(~col0 & ~up1, gf, zero)]
    else:
        m = torch.maximum(torch.maximum(v00, v01), torch.maximum(v10, v11))
        eq = [t == m for t in (v00, v01, v10, v11)]
        share = gf / sum(e.float() for e in eq)
        d = [torch.where(e, share, zero) for e in eq]
    dx = torch.stack(d, -1).reshape(n, c, ho, wo, 2, 2).permute(0, 1, 2, 4, 3, 5)
    return dx.reshape(n, c, 2 * ho, 2 * wo)[:, :, :h, :w].to(x.dtype)


def flat_maxpool2_bwd_cuda(x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """Launch the pool backward kernel; ``.launches`` counts calls."""
    cuda_lib.require_cuda("flat_maxpool2_bwd", x, DTYPES, 4)
    n, c, h, w = x.shape
    if g.shape != (n, c, (h + 1) // 2, (w + 1) // 2):
        raise ValueError(f"flat_maxpool2_bwd: cotangent {tuple(g.shape)} for "
                         f"input {tuple(x.shape)}")
    g = g.to(x.dtype).contiguous()
    dx = torch.empty_like(x)
    code = cuda_lib.library().msau_maxpool2_bwd(
        x.data_ptr(), g.data_ptr(), dx.data_ptr(), n * c, h, w, is_bf16(x),
        cuda_lib.stream_ptr(x.device))
    cuda_lib.check("msau_maxpool2_bwd", code)
    flat_maxpool2_bwd_cuda.launches += 1
    return dx


flat_maxpool2_bwd_cuda.launches = 0


class _FlatMaxPool2(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        cuda = on_cuda("flat_maxpool2", x)
        return (flat_maxpool2_cuda if cuda else flat_maxpool2_plain)(x)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        if not ctx.needs_input_grad[0]:
            return None
        fn = (flat_maxpool2_bwd_cuda if on_cuda("flat_maxpool2", x)
              else flat_maxpool2_bwd_plain)
        return fn(x, g)


def flat_maxpool2(x: torch.Tensor) -> torch.Tensor:
    """2x2 stride-2 TF-SAME max pool: [N, C, H, W] -> [N, C, ceil(H/2),
    ceil(W/2)]."""
    return _FlatMaxPool2.apply(x)


# ---- K1 / K3: conv with the fused epilogue ------------------------------

def conv_pads(w: torch.Tensor, dilation: int):
    """TF-SAME ((top, bottom), (left, right)) of a stride-1 conv."""
    kh, kw = w.shape[-2:]
    return same_padding(kh, dilation), same_padding(kw, dilation)


def _check_conv(name: str, a, b, w, bias) -> int:
    cuda_lib.require_cuda(f"{name} input", a, DTYPES, 4)
    cb = 0
    if b is not None:
        cuda_lib.require_cuda(f"{name} input b", b, a.dtype, 4)
        if (b.device != a.device or b.shape[0] != a.shape[0]
                or b.shape[2:] != a.shape[2:]):
            raise ValueError(f"{name}: inputs {tuple(a.shape)} and "
                             f"{tuple(b.shape)} do not concat on channels")
        cb = b.shape[1]
    cout, cin = w.shape[:2]
    if cin != a.shape[1] + cb or bias.shape != (cout,):
        raise ValueError(f"{name}: weight {tuple(w.shape)} / bias "
                         f"{tuple(bias.shape)} do not fit {a.shape[1]} + {cb} "
                         "inputs")
    return cb


def flat_conv2d_plain(a: torch.Tensor, b: Optional[torch.Tensor],
                      w: torch.Tensor, bias: torch.Tensor, *,
                      dilation: int = 1, act: Optional[str] = None,
                      lrn_size: int = 0, alpha: float = 1e-4,
                      beta: float = 0.75, lrn_k: float = 1.0) -> torch.Tensor:
    """act(conv([a; b], w) + bias), then LRN over the output channels, in
    f32 from the activation-dtype operands; the result in ``a``'s dtype."""
    x = a if b is None else torch.cat([a, b], dim=1)
    (pt, pb), (pl, pr) = conv_pads(w, dilation)
    xf = F.pad(wide(x), (pl, pr, pt, pb))
    y = F.conv2d(xf, wide(w.to(x.dtype)), wide(bias), dilation=dilation)
    y = apply_act(y, act_code(act))
    if lrn_size:
        y = local_response_norm(y, lrn_size, alpha, beta, lrn_k)
    return y.to(x.dtype)


@functools.lru_cache(maxsize=None)
def tensor_core_shape(ca: int, cb: int, cout: int, kh: int, kw: int,
                      dilation: int, pleft: int, bf16: int) -> bool:
    """Whether msau_flat_conv2d runs this shape in f32 on the tensor cores
    (three bf16 parts of each operand; csrc/conv_fast.cuh)."""
    return bool(cuda_lib.library().msau_flat_conv_tc(
        ca, cb, cout, kh, kw, dilation, pleft, bf16))


def _conv_launch(wrapper, name, a, b, w, bias, dilation, pads, act, lrn_size,
                 alpha, beta, lrn_k, couts: Optional[Sequence[int]] = None):
    """One msau_flat_conv2d launch, counted in ``wrapper``'s ``launches``
    and, in f32 on the tensor cores, ``tc_launches``; ``couts`` splits the
    output channels over one or two tensors (returned as a tuple when
    given)."""
    cb = _check_conv(name, a, b, w, bias)
    n, ca, h, wd = a.shape
    cout, _, kh, kw = w.shape
    split = tuple(couts) if couts is not None else (cout,)
    if sum(split) != cout or len(split) > 2:
        raise ValueError(f"{name}: output split {split} of {cout} channels")
    w, bias = cast_params(name, a, w, bias)
    ys = [torch.empty((n, c, h, wd), dtype=a.dtype, device=a.device)
          for c in split]
    code = cuda_lib.library().msau_flat_conv2d(
        a.data_ptr(), ptr(b), w.data_ptr(), bias.data_ptr(), ys[0].data_ptr(),
        ptr(ys[1]) if len(ys) > 1 else None, n, ca, cb, h, wd, cout, split[0],
        kh, kw, dilation, pads[0], pads[1], act_code(act), int(lrn_size or 0),
        alpha, beta, lrn_k, is_bf16(a), cuda_lib.stream_ptr(a.device))
    cuda_lib.check("msau_flat_conv2d", code)
    wrapper.launches += 1
    wrapper.tc_launches += tensor_core_shape(ca, cb, cout, kh, kw, dilation,
                                             pads[1], is_bf16(a))
    return tuple(ys) if couts is not None else ys[0]


def flat_conv2d_cuda(a, b, w, bias, *, dilation=1, act=None, lrn_size=0,
                     alpha=1e-4, beta=0.75, lrn_k=1.0) -> torch.Tensor:
    """Launch the conv kernel; ``.launches`` counts calls, ``.tc_launches``
    those in f32 on the tensor cores."""
    (pt, _), (pl, _) = conv_pads(w, dilation)
    return _conv_launch(flat_conv2d_cuda, "flat_conv2d", a, b, w, bias,
                        dilation, (pt, pl), act, lrn_size, alpha, beta, lrn_k)


flat_conv2d_cuda.launches = 0
flat_conv2d_cuda.tc_launches = 0


def concat_conv1x1_plain(a, b, w, bias, *, act=None) -> torch.Tensor:
    return flat_conv2d_plain(a, b, w, bias, act=act)


def concat_conv1x1_cuda(a, b, w, bias, *, act=None) -> torch.Tensor:
    """Launch the conv kernel as the two-input 1x1 coupling conv;
    ``.launches`` counts calls, ``.tc_launches`` those in f32 on the tensor
    cores."""
    if tuple(w.shape[-2:]) != (1, 1):
        raise ValueError(f"concat_conv1x1: weight {tuple(w.shape)} is not 1x1")
    return _conv_launch(concat_conv1x1_cuda, "concat_conv1x1", a, b, w, bias,
                        1, (0, 0), act, 0, 0.0, 0.0, 0.0)


concat_conv1x1_cuda.launches = 0
concat_conv1x1_cuda.tc_launches = 0


def _epilogue_grad(a: torch.Tensor, g: torch.Tensor, code: int, size: int,
                   alpha: float, beta: float, k: float) -> torch.Tensor:
    """d loss / d preactivation of act -> LRN, f32 (see csrc/flatconv_bwd.cu
    for the formula): the window sums are band-matrix contractions, the
    backward's over the band's transpose (the mirror window)."""
    y1 = apply_act(a, code)
    if size:
        band = _lrn_band(a.shape[1], size, a)
        s = alpha / size
        t = k + s * torch.einsum("nchw,cd->ndhw", y1 * y1, band)
        r = torch.pow(t, -beta)
        mu = torch.einsum("ndhw,cd->nchw", g * y1 * (r / t), band)
        g = g * r - (2.0 * beta * s) * y1 * mu
    return g * act_grad(a, code)


def flat_conv_bwd_plain(a, b, w, bias, g, *, dilation=1, act=None,
                        lrn_size=0, alpha=1e-4, beta=0.75, lrn_k=1.0):
    """Stage 1 of the conv backward -> (g0 or None, dw f32 [Cout, Cin, KH,
    KW], db f32 [Cout]).  g0 (the preactivation's cotangent, in the
    activation dtype) exists when there is an act or LRN; else g0 = g.  dw
    sums the rounded g0, db the f32 one."""
    x = a if b is None else torch.cat([a, b], dim=1)
    dt = x.dtype
    (pt, pb), (pl, pr) = conv_pads(w, dilation)
    xf = F.pad(wide(x), (pl, pr, pt, pb))
    wf = wide(w.to(dt))
    gf = wide(g.to(dt))
    code = act_code(act)
    g0 = None
    if code or lrn_size:
        pre = F.conv2d(xf, wf, wide(bias), dilation=dilation)
        gf = _epilogue_grad(pre, gf, code, lrn_size, alpha, beta, lrn_k)
        g0 = gf.to(dt)
    dw = torch.nn.grad.conv2d_weight(xf, wf.shape, gf if g0 is None
                                     else wide(g0), dilation=dilation)
    return g0, dw, gf.sum((0, 2, 3))


def flat_conv_bwd_cuda(a, b, w, bias, g, *, dilation=1, act=None,
                       lrn_size=0, alpha=1e-4, beta=0.75, lrn_k=1.0):
    """Launch the conv backward's stage-1 kernel (see
    ``flat_conv_bwd_plain``); ``.launches`` counts calls."""
    cb = _check_conv("flat_conv_bwd", a, b, w, bias)
    cuda_lib.require_cuda("flat_conv_bwd cotangent", g, a.dtype, 4)
    n, ca, h, wd = a.shape
    cout, cin, kh, kw = w.shape
    if g.shape != (n, cout, h, wd):
        raise ValueError(f"flat_conv_bwd: cotangent {tuple(g.shape)}")
    (pt, _), (pl, _) = conv_pads(w, dilation)
    w, bias = cast_params("flat_conv_bwd", a, w, bias)
    code_act = act_code(act)
    g0 = torch.empty_like(g) if (code_act or lrn_size) else None
    stride = cout * cin * kh * kw + cout
    out = torch.empty(stride, dtype=torch.float32, device=a.device)
    code = cuda_lib.library().msau_flat_conv_bwd(
        a.data_ptr(), ptr(b), w.data_ptr(), bias.data_ptr(), g.data_ptr(),
        ptr(g0), partial_scratch(stride, a.device).data_ptr(), out.data_ptr(),
        n, ca, cb, h, wd, cout, kh, kw, dilation, pt, pl, code_act,
        int(lrn_size or 0), alpha, beta, lrn_k, is_bf16(a),
        cuda_lib.stream_ptr(a.device))
    cuda_lib.check("msau_flat_conv_bwd", code)
    flat_conv_bwd_cuda.launches += 1
    return g0, out[:-cout].view(cout, cin, kh, kw), out[-cout:]


flat_conv_bwd_cuda.launches = 0


def _dx_taps(w: torch.Tensor, dtype) -> torch.Tensor:
    """The transposed conv's weight: in/out channels swapped, taps flipped."""
    return w.to(dtype).transpose(0, 1).flip(2, 3).contiguous()


def _dx_pads(w: torch.Tensor, dilation: int):
    (pt, pb), (pl, pr) = conv_pads(w, dilation)
    kh, kw = w.shape[-2:]
    return (((kh - 1) * dilation - pt, (kh - 1) * dilation - pb),
            ((kw - 1) * dilation - pl, (kw - 1) * dilation - pr))


def flat_conv_dx_plain(g0: torch.Tensor, w: torch.Tensor,
                       couts: Sequence[int], *,
                       dilation: int = 1) -> Tuple[torch.Tensor, ...]:
    """The input's cotangent, the transposed conv of g0 (padding (K-1) d - p
    per side), split into the inputs' channel counts ``couts``."""
    (pt, pb), (pl, pr) = _dx_pads(w, dilation)
    y = F.conv2d(F.pad(wide(g0), (pl, pr, pt, pb)),
                 wide(_dx_taps(w, g0.dtype)), dilation=dilation)
    return tuple(t.to(g0.dtype) for t in y.split(list(couts), dim=1))


def flat_conv_dx_cuda(g0, w, couts, *, dilation=1):
    """Launch the conv kernel as the transposed conv of g0 with split
    outputs; ``.launches`` counts calls, ``.tc_launches`` those in f32 on
    the tensor cores."""
    (pt, _), (pl, _) = _dx_pads(w, dilation)
    wt = _dx_taps(w, g0.dtype)
    zero = torch.zeros(wt.shape[0], dtype=torch.float32, device=g0.device)
    return _conv_launch(flat_conv_dx_cuda, "flat_conv_dx", g0, None, wt, zero,
                        dilation, (pt, pl), None, 0, 0.0, 0.0, 0.0, couts=couts)


flat_conv_dx_cuda.launches = 0
flat_conv_dx_cuda.tc_launches = 0


class _FlatConv(torch.autograd.Function):
    """y = flat_conv2d of [a; b] with the fused epilogue (``opts``); the
    backward runs stage 1 (g0, dw, db) and the dx conv."""

    @staticmethod
    def forward(ctx, opts, a, b, w, bias):
        ctx.opts = opts
        ctx.save_for_backward(a, b, w, bias)
        fn = flat_conv2d_cuda if on_cuda("flat_conv2d", a) else flat_conv2d_plain
        return fn(a, b, w, bias, **opts)

    @staticmethod
    def backward(ctx, g):
        a, b, w, bias = ctx.saved_tensors
        opts = dict(ctx.opts)
        need_a, need_b, need_w, need_bias = ctx.needs_input_grad[1:]
        need_x = need_a or need_b
        cuda = on_cuda("flat_conv2d", a)
        dilation = opts.pop("dilation", 1)
        g = g.to(a.dtype).contiguous()
        epi = act_code(opts.get("act")) or opts.get("lrn_size")
        g0 = dw = db = None
        if need_w or need_bias or (epi and need_x):
            stage1 = flat_conv_bwd_cuda if cuda else flat_conv_bwd_plain
            g0, dw, db = stage1(a, b, w, bias, g, dilation=dilation, **opts)
        da = dbb = None
        if need_x:
            couts = (a.shape[1],) if b is None else (a.shape[1], b.shape[1])
            dx = flat_conv_dx_cuda if cuda else flat_conv_dx_plain
            parts = dx(g if g0 is None else g0, w, couts, dilation=dilation)
            da = parts[0] if need_a else None
            dbb = parts[1] if b is not None and need_b else None
        return (None, da, dbb, _grad(dw, w, need_w),
                _grad(db, bias, need_bias))


def flat_conv2d(x, w: torch.Tensor, bias: torch.Tensor, *, dilation: int = 1,
                act: Optional[str] = None, lrn_size: int = 0,
                alpha: float = 1e-4, beta: float = 0.75,
                lrn_k: float = 1.0) -> torch.Tensor:
    """Stride-1 TF-SAME conv + bias -> act -> LRN (size ``lrn_size``, 0 for
    none).  ``x`` is [N, Cin, H, W] or a pair (a, b) read as their channel
    concat; ``w`` is [Cout, Cin, KH, KW]."""
    a, b = x if isinstance(x, tuple) else (x, None)
    return _FlatConv.apply(dict(
        dilation=dilation, act=act, lrn_size=lrn_size, alpha=alpha, beta=beta,
        lrn_k=lrn_k), a, b, w, bias)


def concat_conv1x1_bwd_plain(a, b, w, bias, g, *, act=None):
    """The coupling conv's backward -> (da, db in the activation dtype, dw
    f32 [Cout, Ca + Cb, 1, 1], dbias f32 [Cout]): g0 = g act'(W [a; b] +
    bias) in f32, rounded to the activation dtype for da, db and dw; dbias
    sums the f32 g0."""
    dt, ca = a.dtype, a.shape[1]
    w2 = wide(w.to(dt).reshape(w.shape[0], -1))
    x = wide(torch.cat([a, b], dim=1))
    g0 = wide(g.to(dt))
    code = act_code(act)
    if code:   # Wa a + Wb b + bias, the two sums then the bias, as in JAX
        z = (torch.einsum("oc,nchw->nohw", w2[:, :ca], x[:, :ca])
             + torch.einsum("oc,nchw->nohw", w2[:, ca:], x[:, ca:])
             + wide(bias)[:, None, None])
        g0 = g0 * act_grad(z, code)
    gc = wide(g0.to(dt))
    dx = torch.einsum("oc,nohw->nchw", w2, gc).to(dt)
    dw = torch.einsum("nohw,nchw->oc", gc, x).reshape(w.shape)
    return (dx[:, :ca].contiguous(), dx[:, ca:].contiguous(), dw,
            g0.sum((0, 2, 3)))


def concat_conv1x1_bwd_split(a, b, w, bias, g, *, act=None):
    """The coupling conv's backward in two launches of the general kernels:
    conv stage 1 (g0, dw, dbias), then the dx conv of g0 split into da and
    db; ``concat_conv1x1_bwd_cuda`` takes it for couplings wider than its
    one pass takes."""
    g0, dw, dbias = flat_conv_bwd_cuda(a, b, w, bias, g, act=act)
    da, db = flat_conv_dx_cuda(g if g0 is None else g0, w,
                               (a.shape[1], b.shape[1]))
    return da, db, dw, dbias


def concat_conv1x1_bwd_cuda(a, b, w, bias, g, *, act=None):
    """Launch the coupling conv's one-pass backward kernel (see
    ``concat_conv1x1_bwd_plain``); ``.launches`` counts its launches.
    Channel counts that kernel does not take (``fits``: in f32 about 32 +
    32 -> 32, in bf16 a and b padded to 8 each and at most 64 together, at
    most 32 out) go to ``concat_conv1x1_bwd_split``."""
    if b is None or tuple(w.shape[-2:]) != (1, 1):
        raise ValueError("concat_conv1x1_bwd: two inputs and a 1x1 weight, "
                         f"got weight {tuple(w.shape)}")
    cb = _check_conv("concat_conv1x1_bwd", a, b, w, bias)
    cuda_lib.require_cuda("concat_conv1x1_bwd cotangent", g, a.dtype, 4)
    n, ca, h, wd = a.shape
    cout = w.shape[0]
    if g.shape != (n, cout, h, wd):
        raise ValueError(f"concat_conv1x1_bwd: cotangent {tuple(g.shape)}")
    lib = cuda_lib.library()
    if not lib.msau_concat_conv1x1_bwd_fits(ca, cb, cout, is_bf16(a)):
        return concat_conv1x1_bwd_split(a, b, w, bias, g, act=act)
    w, bias = cast_params("concat_conv1x1_bwd", a, w, bias)
    da, db = torch.empty_like(a), torch.empty_like(b)
    stride = cout * (ca + cb) + cout
    out = torch.empty(stride, dtype=torch.float32, device=a.device)
    code = lib.msau_concat_conv1x1_bwd(
        a.data_ptr(), b.data_ptr(), w.data_ptr(), bias.data_ptr(),
        g.data_ptr(), da.data_ptr(), db.data_ptr(),
        partial_scratch(stride, a.device).data_ptr(), out.data_ptr(), n, ca,
        cb, h, wd, cout, act_code(act), is_bf16(a),
        cuda_lib.stream_ptr(a.device))
    cuda_lib.check("msau_concat_conv1x1_bwd", code)
    concat_conv1x1_bwd_cuda.launches += 1
    return da, db, out[:-cout].view(cout, ca + cb, 1, 1), out[-cout:]


concat_conv1x1_bwd_cuda.launches = 0


class _ConcatConv1x1(torch.autograd.Function):
    """The coupling conv; its backward computes da, db, dw and dbias
    together (``concat_conv1x1_bwd_cuda``)."""

    @staticmethod
    def forward(ctx, a, b, w, bias, act):
        ctx.act = act
        ctx.save_for_backward(a, b, w, bias)
        fn = (concat_conv1x1_cuda if on_cuda("concat_conv1x1", a)
              else concat_conv1x1_plain)
        return fn(a, b, w, bias, act=act)

    @staticmethod
    def backward(ctx, g):
        a, b, w, bias = ctx.saved_tensors
        need_a, need_b, need_w, need_bias = ctx.needs_input_grad[:4]
        fn = (concat_conv1x1_bwd_cuda if on_cuda("concat_conv1x1", a)
              else concat_conv1x1_bwd_plain)
        da, db, dw, dbias = fn(a, b, w, bias, g.to(a.dtype).contiguous(),
                               act=ctx.act)
        return (da if need_a else None, db if need_b else None,
                _grad(dw, w, need_w), _grad(dbias, bias, need_bias), None)


def concat_conv1x1(a: torch.Tensor, b: torch.Tensor, w: torch.Tensor,
                   bias: torch.Tensor, act: Optional[str] = None) -> torch.Tensor:
    """act(W [a; b] + bias) with a 1x1 ``w`` [Cout, Ca + Cb, 1, 1].  Its
    backward is one kernel launch where ``concat_conv1x1_bwd_cuda``'s one
    pass takes the channel counts, else the two general kernels."""
    return _ConcatConv1x1.apply(a, b, w, bias, act)


# ---- K6: stride-2 transposed conv ---------------------------------------

def _check_deconv(x_shape, w_shape, target_hw) -> None:
    k = w_shape[-1]
    if w_shape[-2] != k or k % 2 == 0:
        raise ValueError(f"flat_deconv2: kernel {tuple(w_shape[-2:])} must be "
                         "square and odd")
    h, wd = x_shape[-2:]
    if (target_hw[0] not in (2 * h - 1, 2 * h)
            or target_hw[1] not in (2 * wd - 1, 2 * wd)):
        raise ValueError(f"flat_deconv2: target {tuple(target_hw)} "
                         f"unreachable from {(h, wd)} with stride 2")


def flat_deconv2_plain(x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor,
                       target_hw: Tuple[int, int]) -> torch.Tensor:
    """torch ConvTranspose2d(stride 2, padding K/2) to exactly
    ``target_hw``, f32 from the activation-dtype operands."""
    _check_deconv(x.shape, w.shape, target_hw)
    h, wd = x.shape[-2:]
    op = (target_hw[0] - (2 * h - 1), target_hw[1] - (2 * wd - 1))
    y = F.conv_transpose2d(wide(x), wide(w.to(x.dtype)), wide(bias),
                           stride=2, padding=w.shape[-1] // 2,
                           output_padding=op)
    return y.to(x.dtype)


def flat_deconv2_cuda(x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor,
                      target_hw: Tuple[int, int]) -> torch.Tensor:
    """Launch the deconv kernel; ``.launches`` counts calls."""
    cuda_lib.require_cuda("flat_deconv2", x, DTYPES, 4)
    _check_deconv(x.shape, w.shape, target_hw)
    n, cin, h, wd = x.shape
    if w.shape[0] != cin or bias.shape != (w.shape[1],):
        raise ValueError(f"flat_deconv2: weight {tuple(w.shape)} / bias "
                         f"{tuple(bias.shape)} do not fit {cin} inputs")
    cout, k = w.shape[1], w.shape[-1]
    w, bias = cast_params("flat_deconv2", x, w, bias)
    if w.data_ptr() % 16:   # the bf16 kernel stages w in 16-byte copies
        w = w.clone()
    ho, wo = target_hw
    y = torch.empty((n, cout, ho, wo), dtype=x.dtype, device=x.device)
    code = cuda_lib.library().msau_flat_deconv2(
        x.data_ptr(), w.data_ptr(), bias.data_ptr(), y.data_ptr(), n, cin, h,
        wd, cout, k, ho, wo, is_bf16(x), cuda_lib.stream_ptr(x.device))
    cuda_lib.check("msau_flat_deconv2", code)
    flat_deconv2_cuda.launches += 1
    return y


flat_deconv2_cuda.launches = 0


def _deconv_g_padded(g: torch.Tensor, k: int, hw) -> torch.Tensor:
    """g padded so that input pixel (m, j) reads rows 2m .. 2m + K - 1 of it
    (g row 2m - K/2 + ky): a stride-2 VALID conv then gives exactly [H, W]."""
    p = k // 2
    h, wd = hw
    ho, wo = g.shape[-2:]
    return F.pad(wide(g), (p, 2 * wd - 1 + p - wo, p, 2 * h - 1 + p - ho))


def flat_deconv2_dx_plain(g: torch.Tensor, w: torch.Tensor,
                          input_hw: Tuple[int, int]) -> torch.Tensor:
    """dx[ci][m][j] = sum w[ci][co][ky][kx] g[co][2m-p+ky][2j-p+kx]: the
    stride-2 conv of g, in g's dtype."""
    gp = _deconv_g_padded(g, w.shape[-1], input_hw)
    return F.conv2d(gp, wide(w.to(g.dtype)), stride=2).to(g.dtype)


def flat_deconv2_dw_plain(x: torch.Tensor, g: torch.Tensor,
                          w_shape) -> torch.Tensor:
    """dw[ci][co][ky][kx] = sum x[ci][m][j] g[co][2m-p+ky][2j-p+kx], f32."""
    gp = _deconv_g_padded(g.to(x.dtype), w_shape[-1], x.shape[-2:])
    return torch.nn.grad.conv2d_weight(gp, w_shape, wide(x), stride=2)


def _check_deconv_bwd(name, x_shape, g, w_shape):
    cuda_lib.require_cuda(name, g, DTYPES, 4)
    n, cin, h, wd = x_shape
    if w_shape[0] != cin or tuple(g.shape[:2]) != (n, w_shape[1]):
        raise ValueError(f"{name}: cotangent {tuple(g.shape)} / weight "
                         f"{tuple(w_shape)} for input {tuple(x_shape)}")
    _check_deconv(x_shape, w_shape, g.shape[-2:])


def flat_deconv2_dx_cuda(g: torch.Tensor, w: torch.Tensor,
                         input_hw: Tuple[int, int]) -> torch.Tensor:
    """Launch the deconv dx kernel; ``.launches`` counts calls."""
    n, cout, ho, wo = g.shape
    cin, k = w.shape[0], w.shape[-1]
    _check_deconv_bwd("flat_deconv2_dx", (n, cin, *input_hw), g, w.shape)
    w = w.to(g.dtype).contiguous()
    dx = torch.empty((n, cin, *input_hw), dtype=g.dtype, device=g.device)
    code = cuda_lib.library().msau_flat_deconv2_dx(
        g.data_ptr(), w.data_ptr(), dx.data_ptr(), n, cin, input_hw[0],
        input_hw[1], cout, k, ho, wo, is_bf16(g), cuda_lib.stream_ptr(g.device))
    cuda_lib.check("msau_flat_deconv2_dx", code)
    flat_deconv2_dx_cuda.launches += 1
    return dx


flat_deconv2_dx_cuda.launches = 0


def flat_deconv2_dw_cuda(x: torch.Tensor, g: torch.Tensor,
                         w_shape) -> torch.Tensor:
    """Launch the deconv dw kernel (f32 [Cin, Cout, K, K]); ``.launches``
    counts calls."""
    cuda_lib.require_cuda("flat_deconv2_dw input", x, DTYPES, 4)
    cuda_lib.require_cuda("flat_deconv2_dw cotangent", g, x.dtype, 4)
    w_shape = tuple(w_shape)
    n, cin, h, wd = x.shape
    _check_deconv_bwd("flat_deconv2_dw", x.shape, g, w_shape)
    cout, k = w_shape[1], w_shape[-1]
    # each block's partial row holds its sums tile by tile: channels
    # padded to the tiles (16 input x 8 output channels at most)
    stride = -(-cin // 16) * 16 * -(-cout // 8) * 8 * k * k
    dw = torch.empty(w_shape, dtype=torch.float32, device=x.device)
    code = cuda_lib.library().msau_flat_deconv2_dw(
        x.data_ptr(), g.data_ptr(), partial_scratch(stride, x.device).data_ptr(),
        dw.data_ptr(), n, cin, h, wd, cout, k, g.shape[2], g.shape[3],
        is_bf16(x), cuda_lib.stream_ptr(x.device))
    cuda_lib.check("msau_flat_deconv2_dw", code)
    flat_deconv2_dw_cuda.launches += 1
    return dw


flat_deconv2_dw_cuda.launches = 0


class _FlatDeconv2(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, bias, target_hw):
        ctx.save_for_backward(x, w)
        cuda = on_cuda("flat_deconv2", x)
        return (flat_deconv2_cuda if cuda else flat_deconv2_plain)(
            x, w, bias, target_hw)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        need_x, need_w, need_b = ctx.needs_input_grad[:3]
        cuda = on_cuda("flat_deconv2", x)
        g = g.to(x.dtype).contiguous()
        dx = dw = db = None
        if need_x:
            fn = flat_deconv2_dx_cuda if cuda else flat_deconv2_dx_plain
            dx = fn(g, w, tuple(x.shape[-2:]))
        if need_w:
            fn = flat_deconv2_dw_cuda if cuda else flat_deconv2_dw_plain
            dw = fn(x, g, w.shape).to(w.dtype)
        if need_b:
            db = g.sum((0, 2, 3), dtype=wide_dtype(g))
        return dx, dw, db, None


def flat_deconv2(x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor,
                 target_hw: Tuple[int, int]) -> torch.Tensor:
    """Stride-2 transposed conv of [N, Cin, H, W] with torch's weight
    [Cin, Cout, K, K] (odd K) to [N, Cout, *target_hw], target in {2H-1,
    2H} x {2W-1, 2W}."""
    return _FlatDeconv2.apply(x, w, bias, tuple(target_hw))
