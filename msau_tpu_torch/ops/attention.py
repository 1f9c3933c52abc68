"""Reference-semantics attention for the MSAU deepest-scale block.

With flattened spatial tokens, A = softmax_rows(g fᵀ) and out = Aᵀ h — the
softmax runs over the *output* axis and the sum over the *input* axis (the
transpose of standard attention), with no 1/√d scaling.

``resident_attention`` is the entry point: a CUDA tensor launches the
hand-written forward kernel (``csrc/attention.cu``, the port of the TPU
kernel ``msau_tpu/ops/pallas_attn.py:_res_fwd_kernel``); a CPU tensor takes
``resident_attention_plain``, the einsum form of
``msau_tpu.models.attention.self_attention_xla``.  Forward only: serving
needs no gradient.
"""

from __future__ import annotations

from typing import Tuple

import torch

from msau_tpu_torch.ops import cuda_lib

# (Cb, C) pairs the kernel is instantiated for: the model's projections
# have Cb = max(C // 8, 1)
KERNEL_WIDTHS = ((1, 8), (2, 16), (4, 32), (8, 64), (16, 128))


def resident_attention_plain(f: torch.Tensor, g: torch.Tensor,
                             h: torch.Tensor) -> torch.Tensor:
    """f, g: [N, T, Cb]; h: [N, T, C] -> [N, T, C] in h's dtype, computed in
    f32: out_j = sum_i h_i softmax_j(g_i . f_j)."""
    f32 = torch.float32
    s = torch.einsum("nic,njc->nij", g.to(f32), f.to(f32))
    beta = torch.softmax(s, dim=-1)
    return torch.einsum("nij,nic->njc", beta, h.to(f32)).to(h.dtype)


def _i_splits(n: int, t: int, c: int, device: torch.device) -> int:
    """How many contiguous i ranges the accumulation pass splits into:
    enough blocks for about four per SM (each block owns 64 output rows),
    at most 16 and at most one per i tile (64 rows, 32 when C >= 128).
    More resident warps hide the shared-memory latency: at T = 4096 on the
    H100 the whole kernel took 0.52 / 0.28 / 0.20 / 0.157 / 0.152 ms with 1 / 2 /
    4 / 8 / 12 splits (CUDA events, H100 80GB HBM3 at 700 W)."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    row_blocks = n * -(-t // 64)
    tiles = -(-t // (32 if c >= 128 else 64))
    return max(1, min(16, tiles, -(-4 * sms // row_blocks)))


def resident_attention_cuda(
    f: torch.Tensor, g: torch.Tensor, h: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Launch the kernel (stats, accumulate, combine) -> (out, m, l), where
    m, l ([N, T] f32)
    are each query row's score max and sum-exp.
    ``resident_attention_cuda.launches`` counts calls."""
    dtypes = (torch.float32, torch.bfloat16)
    for name, t in (("f", f), ("g", g), ("h", h)):
        cuda_lib.require_cuda(f"resident_attention {name}", t, dtypes, 3)
    if not (f.dtype == g.dtype == h.dtype):
        raise ValueError("resident_attention: f, g, h must share a dtype")
    if not (f.device == g.device == h.device):
        raise ValueError("resident_attention: f, g, h on different devices")
    n, t, cb = f.shape
    c = h.shape[-1]
    if g.shape != f.shape or h.shape[:2] != (n, t):
        raise ValueError(f"resident_attention: shapes f {tuple(f.shape)} "
                         f"g {tuple(g.shape)} h {tuple(h.shape)}")
    if (cb, c) not in KERNEL_WIDTHS:
        raise ValueError(f"resident_attention: (Cb, C) = {(cb, c)} not in "
                         f"{KERNEL_WIDTHS}")
    out = torch.empty_like(h)
    m = torch.empty((n, t), dtype=torch.float32, device=f.device)
    l = torch.empty((n, t), dtype=torch.float32, device=f.device)
    splits = _i_splits(n, t, c, f.device)
    partial = torch.empty((splits, n, t, c), dtype=torch.float32,
                          device=f.device)
    code = cuda_lib.library().msau_resident_attention_fwd(
        f.data_ptr(), g.data_ptr(), h.data_ptr(), out.data_ptr(),
        m.data_ptr(), l.data_ptr(), partial.data_ptr(), splits, n, t, cb, c,
        int(f.dtype == torch.bfloat16), cuda_lib.stream_ptr(f.device))
    cuda_lib.check("msau_resident_attention_fwd", code)
    resident_attention_cuda.launches += 1
    return out, m, l


resident_attention_cuda.launches = 0


def resident_attention(f: torch.Tensor, g: torch.Tensor,
                       h: torch.Tensor) -> torch.Tensor:
    """A = softmax_rows(g fᵀ), out = Aᵀ h; the device of ``f`` picks the
    implementation."""
    if f.device.type == "cuda":
        return resident_attention_cuda(f, g, h)[0]
    if f.device.type != "cpu":
        raise ValueError(f"resident_attention: unsupported device {f.device}")
    return resident_attention_plain(f, g, h)
