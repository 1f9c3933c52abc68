"""Fused residual block of the flat-layout scales on NCHW, forward and
backward.

Port of ``msau_tpu/ops/flatres.py``: the reference
``MultiConvResidualBlock`` at res_depth 2 with 3x3 convs and Cin = Cout,

    y = act(conv2(act(conv1(relu(x)) + b1)) + b2 + x),

in one kernel each way: ``csrc/flatres.cu`` (replacing the TPU kernels
``_fwd_kernel`` / ``_fwd_kernel_al``) and ``csrc/flatres_bwd.cu``
(``_bwd_kernel`` / ``_bwd_kernel_al``: it recomputes the block over a
4-pixel halo and emits dx, dw1, db1, dw2, db2).  The conv1 output is
rounded to the activation dtype, as the TPU kernel's VMEM scratch is, and
is 0 outside the image (SAME padding for conv2), so no gradient flows into
conv1 there.  A CUDA tensor launches the kernels (``flat_res_block_cuda``,
``flat_res_block_bwd_cuda``, whose ``.launches`` count calls); a CPU
tensor takes the ``*_plain`` versions.  Other channel counts, depths or
filter sizes run the block as flat convs
(``models.layers.MultiConvResidualBlock``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from msau_tpu_torch.ops import cuda_lib
from msau_tpu_torch.ops.flatconv import (
    DTYPES,
    act_code,
    act_grad,
    apply_act,
    cast_params,
    is_bf16,
    on_cuda,
    partial_scratch,
)
from msau_tpu_torch.ops.precision import wide

# channel counts the kernels are instantiated for (weights and tiles live in
# shared memory, csrc/res_block.cuh: at 32 channels the forward takes 108 KB
# in bf16 and 185 KB in f32, the backward 200 KB and 181 KB)
FUSED_CHANNELS = (4, 8, 16, 32)


def _res_act(act: str) -> int:
    code = act_code(act)
    if code == 0:
        raise ValueError("flat_res_block: the activation must be relu or elu")
    return code


def flat_res_block_plain(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor,
                         w2: torch.Tensor, b2: torch.Tensor,
                         act: str) -> torch.Tensor:
    """The fused block's arithmetic in torch ops: f32 convs from the
    activation-dtype operands, conv1's output rounded to that dtype."""
    code, dt = _res_act(act), x.dtype
    h0 = wide(F.relu(x))
    u = F.conv2d(h0, wide(w1.to(dt)), wide(b1), padding=1)
    h1 = wide(apply_act(u, code).to(dt))
    y = F.conv2d(h1, wide(w2.to(dt)), wide(b2), padding=1) + wide(x)
    return apply_act(y, code).to(dt)


def flat_res_block_cuda(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor,
                        w2: torch.Tensor, b2: torch.Tensor,
                        act: str) -> torch.Tensor:
    """Launch the fused block kernel; ``.launches`` counts calls."""
    _check_res("flat_res_block", x, w1, b1, w2, b2)
    n, c, h, w = x.shape
    w1, b1, w2, b2 = cast_params("flat_res_block", x, w1, b1, w2, b2)
    y = torch.empty_like(x)
    code = cuda_lib.library().msau_flat_res_block(
        x.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(),
        b2.data_ptr(), y.data_ptr(), n, c, h, w, _res_act(act), is_bf16(x),
        cuda_lib.stream_ptr(x.device))
    cuda_lib.check("msau_flat_res_block", code)
    flat_res_block_cuda.launches += 1
    return y


flat_res_block_cuda.launches = 0


def _check_res(name, x, w1, b1, w2, b2) -> None:
    cuda_lib.require_cuda(name, x, DTYPES, 4)
    c = x.shape[1]
    if c not in FUSED_CHANNELS:
        raise ValueError(f"{name}: {c} channels, the kernel takes "
                         f"{FUSED_CHANNELS}")
    for wt, bt in ((w1, b1), (w2, b2)):
        if wt.shape != (c, c, 3, 3) or bt.shape != (c,):
            raise ValueError(f"{name}: weight {tuple(wt.shape)} / bias "
                             f"{tuple(bt.shape)} for {c} channels")


def flat_res_block_bwd_plain(x, w1, b1, w2, b2, g, act):
    """-> (dx in x's dtype, dw1, db1, dw2, db2 f32), with the rounding of
    csrc/flatres_bwd.cu: g, h1 and the cotangents feeding a conv or a
    weight gradient in x's dtype, the residual term and db in f32."""
    code, dt = _res_act(act), x.dtype
    rnd = lambda t: wide(t.to(dt))
    xf, w1f, w2f = wide(x), rnd(w1), rnd(w2)
    h0 = F.relu(xf)
    u = F.conv2d(h0, w1f, wide(b1), padding=1)
    h1 = rnd(apply_act(u, code))
    v = F.conv2d(h1, w2f, wide(b2), padding=1) + xf
    gv2 = rnd(g) * act_grad(v, code)
    gu = F.conv_transpose2d(rnd(gv2), w2f, padding=1) * act_grad(u, code)
    dx = F.conv_transpose2d(rnd(gu), w1f, padding=1) * (xf > 0) + gv2
    dw1 = torch.nn.grad.conv2d_weight(h0, w1.shape, rnd(gu), padding=1)
    dw2 = torch.nn.grad.conv2d_weight(h1, w2.shape, rnd(gv2), padding=1)
    return (dx.to(dt), dw1, gu.sum((0, 2, 3)), dw2, gv2.sum((0, 2, 3)))


def flat_res_block_bwd_cuda(x, w1, b1, w2, b2, g, act):
    """Launch the fused block's backward kernel (see
    ``flat_res_block_bwd_plain``); ``.launches`` counts calls."""
    _check_res("flat_res_block_bwd", x, w1, b1, w2, b2)
    cuda_lib.require_cuda("flat_res_block_bwd cotangent", g, x.dtype, 4)
    if g.shape != x.shape:
        raise ValueError(f"flat_res_block_bwd: cotangent {tuple(g.shape)}")
    n, c, h, w = x.shape
    w1, b1, w2, b2 = cast_params("flat_res_block_bwd", x, w1, b1, w2, b2)
    dx = torch.empty_like(x)
    stride = 2 * (9 * c * c + c)
    out = torch.empty(stride, dtype=torch.float32, device=x.device)
    code = cuda_lib.library().msau_flat_res_block_bwd(
        x.data_ptr(), g.data_ptr(), w1.data_ptr(), b1.data_ptr(),
        w2.data_ptr(), b2.data_ptr(), dx.data_ptr(),
        partial_scratch(stride, x.device).data_ptr(), out.data_ptr(), n, c,
        h, w, _res_act(act), is_bf16(x), cuda_lib.stream_ptr(x.device))
    cuda_lib.check("msau_flat_res_block_bwd", code)
    flat_res_block_bwd_cuda.launches += 1
    k = 9 * c * c
    return (dx, out[:k].view(c, c, 3, 3), out[k:k + c],
            out[k + c:2 * k + c].view(c, c, 3, 3), out[2 * k + c:])


flat_res_block_bwd_cuda.launches = 0


class _FlatResBlock(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w1, b1, w2, b2, act):
        ctx.act = act
        ctx.save_for_backward(x, w1, b1, w2, b2)
        fn = (flat_res_block_cuda if on_cuda("flat_res_block", x)
              else flat_res_block_plain)
        return fn(x, w1, b1, w2, b2, act)

    @staticmethod
    def backward(ctx, g):
        saved = ctx.saved_tensors
        x = saved[0]
        if not any(ctx.needs_input_grad[:5]):
            return (None,) * 6
        fn = (flat_res_block_bwd_cuda if on_cuda("flat_res_block", x)
              else flat_res_block_bwd_plain)
        grads = fn(*saved, g.to(x.dtype).contiguous(), ctx.act)
        return tuple(gr.to(t.dtype) if need else None for gr, t, need in
                     zip(grads, saved, ctx.needs_input_grad[:5])) + (None,)


def flat_res_block(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor,
                   w2: torch.Tensor, b2: torch.Tensor, act: str) -> torch.Tensor:
    """x [N, C, H, W]; w1, w2 [C, C, 3, 3] (OIHW); b1, b2 [C]."""
    return _FlatResBlock.apply(x, w1, b1, w2, b2, act)
