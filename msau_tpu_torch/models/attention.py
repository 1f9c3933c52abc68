"""Self-attention applied at the deepest U-Net scale (port of
``msau_tpu.models.attention``).

Semantics mirror the reference SAGAN-style block:

    f = Conv1x1(x) -> C/8 channels,  g = Conv1x1(x) -> C/8,  h = Conv1x1(x) -> C
    s[i, j] = <g_i, f_j>  over flattened spatial positions
    out_j   = sum_i h_i * softmax_j(s)[i, j]      (transposed accumulation)
    y       = out + x                              (residual)

There is no 1/sqrt(d) scaling and no output projection.  The product runs in
one of two autograd ops of ``ops.attention``, picked by ``impl`` and the
token count as the JAX block picks: ``resident_attention`` (whole rows at
once, output in the activation's dtype) or ``fused_attention`` (streamed,
for grids of 8192 tokens and more, f32 output).  Each launches its CUDA
kernels (forward and backward) on a card and takes its plain version on the
CPU.
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn

from msau_tpu_torch.models.layers import Conv
from msau_tpu_torch.ops.attention import fused_attention, resident_attention

# token count from which "auto" takes the streaming op: 1024^2 pages put
# 16384 tokens at the deepest scale (``_PALLAS_MIN_TOKENS`` in the JAX block)
STREAMING_MIN_TOKENS = 8192
IMPLS = ("auto", "resident", "pallas", "xla")


def add_timing_signal_2d(x: torch.Tensor, min_timescale: float = 1.0,
                         max_timescale: float = 1.0e3) -> torch.Tensor:
    """2-D sinusoidal positional encoding added channel-wise to NHWC ``x``:
    channels split between H and W, each getting sin/cos pairs over a
    geometric timescale ladder (Tensor2Tensor formulation)."""
    n, h, w, c = x.shape
    num_ts = c // 4
    if num_ts == 0:
        return x
    log_inc = math.log(max_timescale / min_timescale) / max(num_ts - 1, 1)
    inv_ts = min_timescale * torch.exp(
        -log_inc * torch.arange(num_ts, dtype=torch.float32, device=x.device))
    out = x
    for dim, length in ((0, h), (1, w)):
        pos = torch.arange(length, dtype=torch.float32, device=x.device)
        scaled = pos[:, None] * inv_ts[None, :]
        signal = torch.cat([torch.sin(scaled), torch.cos(scaled)], dim=1)
        prepad = dim * 2 * num_ts
        postpad = c - (dim + 1) * 2 * num_ts
        signal = torch.nn.functional.pad(signal, (prepad, postpad))
        shape = [1, 1, 1, c]
        shape[dim + 1] = length
        out = out + signal.reshape(shape)
    return out


class SelfAttentionBlock(nn.Module):
    """SAGAN-style residual self-attention over the flattened 2-D grid;
    NCHW in and out.

    ``impl`` (``ModelConfig.attention_impl``) picks the op as the JAX block
    does: "auto" and "resident" take ``resident_attention`` below
    ``STREAMING_MIN_TOKENS`` tokens and the streaming ``fused_attention``
    from there on; "pallas" takes the streaming op at any size.  "xla"
    names the JAX package's einsum, a library path the port does not have
    on a card: it dispatches like "auto", and the einsum form stays what it
    is here, the resident op's plain version on the CPU.  The JAX block's
    ``T % 256`` and TPU-backend gates are TPU tactics and are not ported:
    both ops take any T.
    """

    def __init__(self, input_channels: int, num_heads: int = 8,
                 impl: str = "auto", *, gen: torch.Generator):
        super().__init__()
        if impl not in IMPLS:
            raise ValueError(f"attention impl {impl!r} not in {IMPLS}")
        self.impl = impl
        c = input_channels
        cb = max(c // num_heads, 1)
        # flax nn.Conv default kernel init (lecun_normal) and zero bias
        proj = dict(gen=gen, bias_mean=0.0, bias_std=0.0, lecun=True)
        self.f = Conv(c, cb, (1, 1), **proj)
        self.g = Conv(c, cb, (1, 1), **proj)
        self.h = Conv(c, c, (1, 1), **proj)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        n, c, hh, ww = x.shape

        def tokens(t):  # [N, C', H, W] -> [N, T, C']
            return t.permute(0, 2, 3, 1).reshape(n, hh * ww, -1).contiguous()

        f, g, h = tokens(self.f(x)), tokens(self.g(x)), tokens(self.h(x))
        if self.impl == "pallas" or hh * ww >= STREAMING_MIN_TOKENS:
            # the streaming op returns f32 whatever x's dtype; the residual
            # is added in f32, as the JAX block adds it, and the sum is
            # cast to the activation's dtype once, here, where flax casts
            # it at the next layer's input: the layers after this one
            # follow their input's dtype and would otherwise all run in f32
            o = fused_attention(f, g, h).reshape(n, hh, ww, c)
            return (o.permute(0, 3, 1, 2) + x).to(x.dtype)
        o = resident_attention(f, g, h)
        return o.reshape(n, hh, ww, c).permute(0, 3, 1, 2) + x
