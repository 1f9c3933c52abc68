"""Fused residual block of the flat-layout scales on NCHW.

Port of the forward of ``msau_tpu/ops/flatres.py``: the reference
``MultiConvResidualBlock`` at res_depth 2 with 3x3 convs and Cin = Cout,

    y = act(conv2(act(conv1(relu(x)) + b1)) + b2 + x),

in one kernel (``csrc/flatres.cu``, replacing the TPU kernels
``_fwd_kernel`` / ``_fwd_kernel_al``).  The conv1 output is rounded to the
activation dtype, as the TPU kernel's VMEM scratch is, and is 0 outside the
image (SAME padding for conv2).  A CUDA tensor launches the kernel
(``flat_res_block_cuda``, whose ``.launches`` counts calls); a CPU tensor
takes ``flat_res_block_plain``.  Other channel counts, depths or filter
sizes run the block as flat convs (``models.layers.MultiConvResidualBlock``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from msau_tpu_torch.ops import cuda_lib
from msau_tpu_torch.ops.flatconv import (
    DTYPES,
    act_code,
    apply_act,
    cast_params,
    forward_only,
    is_bf16,
    on_cuda,
)

# channel counts the kernel is instantiated for (its weights and tiles live
# in shared memory: 32 channels take 172.5 KB)
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
    h0 = F.relu(x).float()
    u = F.conv2d(h0, w1.to(dt).float(), b1.float(), padding=1)
    h1 = apply_act(u, code).to(dt).float()
    y = F.conv2d(h1, w2.to(dt).float(), b2.float(), padding=1) + x.float()
    return apply_act(y, code).to(dt)


def flat_res_block_cuda(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor,
                        w2: torch.Tensor, b2: torch.Tensor,
                        act: str) -> torch.Tensor:
    """Launch the fused block kernel; ``.launches`` counts calls."""
    cuda_lib.require_cuda("flat_res_block", x, DTYPES, 4)
    n, c, h, w = x.shape
    if c not in FUSED_CHANNELS:
        raise ValueError(f"flat_res_block: {c} channels, the kernel takes "
                         f"{FUSED_CHANNELS}")
    for wt, bt in ((w1, b1), (w2, b2)):
        if wt.shape != (c, c, 3, 3) or bt.shape != (c,):
            raise ValueError(f"flat_res_block: weight {tuple(wt.shape)} / bias "
                             f"{tuple(bt.shape)} for {c} channels")
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


def _flat_res_block(x, w1, b1, w2, b2, *, act):
    fn = (flat_res_block_cuda if on_cuda("flat_res_block", x)
          else flat_res_block_plain)
    return fn(x, w1, b1, w2, b2, act)


def flat_res_block(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor,
                   w2: torch.Tensor, b2: torch.Tensor, act: str) -> torch.Tensor:
    """x [N, C, H, W]; w1, w2 [C, C, 3, 3] (OIHW); b1, b2 [C]."""
    return forward_only(_flat_res_block, {"act": act}, x, w1, b1, w2, b2)
