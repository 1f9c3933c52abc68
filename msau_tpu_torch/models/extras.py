"""Optional model components (port of ``msau_tpu.models.extras``): sparse
(masked) conv, CSPN affinity propagation, separable row / column LSTM.

* ``SparseConv``: conv over masked inputs normalised by the per-window
  count of valid pixels, the validity mask max-pooled forward.
* ``affinity_propagate``: 8-gate guided propagation, per gate ``out =
  (g / sum g) x + sum_{3x3, centre 0}(g x) / sum g``, the elementwise max
  over gates (pairwise, in gate order, as ``functools.reduce(jnp.maximum)``
  splits a tie), optional sparse-anchor re-blending, ``num_layers`` times;
  the gates' ``|g|`` passes gradient 1 at 0, as ``jnp.abs``.
* ``SeparableRNNBlock``: a row LSTM then a column LSTM over the feature
  map; each runs one cell forward and over the flipped sequence and sums
  the two (one weight set: not ``nn.LSTM(bidirectional=True)``, which has
  two).  ``identity=True`` reproduces the reference's stub.

Layout is NCHW.  Parameter names follow the flax tree: ``SparseConv``'s
``Conv_0.weight`` and ``bias``; each LSTM cell's input kernels ``ii``,
``if``, ``ig``, ``io`` (no bias, as flax's cell) and hidden kernels ``hi``,
``hf``, ``hg``, ``ho`` with biases.  The cell runs as ``torch.lstm`` (cuDNN
on a card) with its weights packed at each call and a zero input bias that
is not a parameter.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from msau_tpu_torch.models.layers import (
    Conv,
    _normal,
    same_padding_strided,
    tf_conv_std,
)
from msau_tpu_torch.ops.flatconv import same_padding


def _pad_same(x: torch.Tensor, kernel_size: Tuple[int, int],
              strides: Tuple[int, int], value: float = 0.0) -> torch.Tensor:
    ph = same_padding_strided(x.shape[-2], kernel_size[0], 1, strides[0])
    pw = same_padding_strided(x.shape[-1], kernel_size[1], 1, strides[1])
    return F.pad(x, (pw[0], pw[1], ph[0], ph[1]), value=value)


class SparseConv(nn.Module):
    """Masked conv: ``out = conv(x m) / count(m) + b``; returns (out, the
    mask max-pooled forward).  ``mask`` [N, 1, H, W] defaults to the pixels
    whose channels are not all zero."""

    def __init__(self, cin: int, features: int, kernel_size=(3, 3),
                 strides=(1, 1), *, gen: torch.Generator):
        super().__init__()
        kh, kw = kernel_size
        self.kernel_size, self.strides = tuple(kernel_size), tuple(strides)
        self.Conv_0 = Conv(cin, features, self.kernel_size, gen,
                           weight_std=tf_conv_std(kh, kw, cin, features),
                           use_bias=False)
        self.bias = nn.Parameter(_normal((features,), 1e-5, gen, 0.0))

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None):
        if mask is None:
            mask = (x.abs().sum(1, keepdim=True) > 0).to(x.dtype)
        feats = self.Conv_0(x * mask, stride=self.strides)
        ones = torch.ones((1, 1) + self.kernel_size, dtype=mask.dtype,
                          device=mask.device)
        count = F.conv2d(_pad_same(mask, self.kernel_size, self.strides),
                         ones, stride=self.strides)
        norm = torch.where(count > 0, 1.0 / count, torch.zeros_like(count))
        out = feats * norm + self.bias.to(feats.dtype)[:, None, None]
        new_mask = F.max_pool2d(
            _pad_same(mask, self.kernel_size, self.strides, float("-inf")),
            self.kernel_size, self.strides)
        return out, new_mask


def _sum_conv(x: torch.Tensor, ksize: int, center_zero: bool) -> torch.Tensor:
    """ksize x ksize ones (the centre 0 if ``center_zero``) SAME conv of
    each channel of [N, G, H, W] on its own."""
    g = x.shape[1]
    k = torch.ones((g, 1, ksize, ksize), dtype=x.dtype, device=x.device)
    if center_zero:
        k[:, :, (ksize - 1) // 2, (ksize - 1) // 2] = 0.0
    lo, hi = same_padding(ksize)
    return F.conv2d(F.pad(x, (lo, hi, lo, hi)), k, groups=g)


def affinity_propagate(
    guidance: torch.Tensor,                 # [N, G, H, W] gate maps (G = 8)
    blur: torch.Tensor,                     # [N, 1, H, W] map to refine
    sparse: Optional[torch.Tensor] = None,  # [N, 1, H, W] anchors or None
    ksize: int = 3,
    num_layers: int = 8,
) -> torch.Tensor:
    # |g| with jnp.abs's gradient at 0 (1, where torch.abs gives 0)
    gates = torch.where(guidance >= 0, guidance, -guidance)
    if sparse is not None:
        smask = torch.sign(sparse.abs())
        result = (1 - smask) * blur + smask * sparse
    else:
        smask = None
        result = blur
    # every gate's weight sum is the same each layer
    wsum = _sum_conv(gates, ksize, center_zero=False)
    wsum = torch.where(wsum == 0, 1e-8, wsum)
    for _ in range(num_layers):
        neigh = _sum_conv(gates * result, ksize, center_zero=True)
        outs = (gates / wsum) * result + neigh / wsum
        result = functools.reduce(torch.maximum, outs.unbind(1))[:, None]
        if smask is not None:
            result = (1 - smask) * result + smask * sparse
    return result


class Dense(nn.Module):
    """flax ``nn.Dense`` parameters in torch's layout: ``weight`` [out, in]
    (the flax kernel transposed), ``bias`` [out] or none."""

    def __init__(self, weight: torch.Tensor, use_bias: bool):
        super().__init__()
        self.weight = nn.Parameter(weight)
        self.bias = (nn.Parameter(torch.zeros(weight.shape[0])) if use_bias
                     else None)


GATES = ("i", "f", "g", "o")   # flax's and torch's gate order


class LSTMCell(nn.Module):
    """flax ``OptimizedLSTMCell`` parameters: input kernels ``i{gate}``
    (lecun normal, no bias), hidden kernels ``h{gate}`` (orthogonal, zero
    bias)."""

    def __init__(self, cin: int, features: int, *, gen: torch.Generator):
        super().__init__()
        std = (1.0 / cin) ** 0.5 / 0.87962566103423978   # truncated at 2 std
        for gate in GATES:
            w = torch.empty(features, cin)
            nn.init.trunc_normal_(w, std=std, a=-2 * std, b=2 * std,
                                  generator=gen)
            self.add_module(f"i{gate}", Dense(w, use_bias=False))
        for gate in GATES:
            w = torch.empty(features, features)
            nn.init.orthogonal_(w, generator=gen)
            self.add_module(f"h{gate}", Dense(w, use_bias=True))
        self.features = features

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """[B, T, Cin] -> [B, T, F], zero initial carry, in the promoted
        dtype of ``x`` and the parameters (f32 under a bf16 model)."""
        hidden = [getattr(self, f"h{g}") for g in GATES]
        w_ih = torch.cat([getattr(self, f"i{g}").weight for g in GATES])
        w_hh = torch.cat([d.weight for d in hidden])
        b_hh = torch.cat([d.bias for d in hidden])
        x = x.to(torch.promote_types(x.dtype, w_ih.dtype))
        h0 = x.new_zeros((1, x.shape[0], self.features))
        out, _, _ = torch.lstm(
            x, (h0, h0), [w_ih, w_hh, torch.zeros_like(b_hh), b_hh],
            True, 1, 0.0, torch.is_grad_enabled(), False, True)
        return out


class SeparableRNNBlock(nn.Module):
    """Row LSTM then column LSTM across the feature map, each run forward
    and over the flipped sequence with one cell, the two summed."""

    def __init__(self, features: int, identity: bool = True, *,
                 gen: torch.Generator):
        super().__init__()
        self.identity = identity
        self.features = features
        if not identity:
            self.row_cell = LSTMCell(features, features, gen=gen)
            self.col_cell = LSTMCell(features, features, gen=gen)

    @staticmethod
    def _both_ways(cell: LSTMCell, seq: torch.Tensor) -> torch.Tensor:
        return cell(seq) + cell(seq.flip(1)).flip(1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """[N, features, H, W] -> [N, features, H, W]."""
        if self.identity:
            return x
        n, c, h, w = x.shape
        f = self.features
        xh = self._both_ways(self.row_cell,
                             x.permute(0, 2, 3, 1).reshape(n * h, w, c))
        xh = xh.reshape(n, h, w, f)
        xv = self._both_ways(self.col_cell,
                             xh.permute(0, 2, 1, 3).reshape(n * w, h, f))
        return xv.reshape(n, w, h, f).permute(0, 3, 2, 1)
