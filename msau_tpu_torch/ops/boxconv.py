"""Learnable box convolution (port of ``msau_tpu.ops.boxconv``).

Each (channel, box) pair learns a rectangle (y_min, y_max, x_min, x_max)
and outputs the area-normalised average of the input over that rectangle
translated to every pixel.  The box sum comes from a 2-D exclusive prefix
sum sampled at the four corners with a linear blend, which factorises into
two banded 1-D sampling matrices: one product over columns, one over rows.
Autodiff through the blend weights gives the boundary-integral gradients to
the box coordinates, as in the JAX package; the products are plain
``torch.einsum`` (the JAX package runs them in XLA, not in Pallas).

Layout is NCHW: ``box_conv2d`` maps [N, C, H, W] to [N, C*B, H, W] with
output channel ``c * B + b``.

Every clip is ``torch.minimum`` / ``torch.maximum``, never ``torch.clamp``:
at a tie those split the gradient 0.5 / 0.5 as ``jnp.clip``,
``jnp.minimum`` and ``jnp.maximum`` do, where ``torch.clamp`` passes all of
it.  So coordinate gradients agree where a box sits on +-``max_h`` or where
``y_min == y_max``.

Dtype: as in the JAX package, the integral image is a ``cumsum`` in the
input's dtype (bf16 under a bf16 model) and the f32 bands promote both
products to f32, so the output is f32 whatever the input.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F


def integral_image(x: torch.Tensor) -> torch.Tensor:
    """Exclusive 2-D prefix sum over (H, W): ``out[..., i, j]`` = sum of
    ``x[..., :i, :j]``.  [N, C, H, W] -> [N, C, H+1, W+1]."""
    ii = torch.cumsum(torch.cumsum(x, dim=2), dim=3)
    return F.pad(ii, (1, 0, 1, 0))


def _clip(d: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    # jnp.clip's gradient: 0.5 at either bound.  The bounds are filled on
    # d's device (a Python float through new_tensor would be a copy from
    # the host, which waits for the card)
    return torch.minimum(torch.maximum(d, d.new_full((), lo)),
                         d.new_full((), hi))


def _corner_band(d: torch.Tensor, n_out: int, n_pad: int, pad: int) -> torch.Tensor:
    """Banded 1-D sampling matrices for offsets ``d`` [...] -> [..., n_out,
    n_pad]: ``(M @ v)[i]`` = linear-blend sample of ``v`` at ``i + d``, the
    offset clamped to [-pad, pad - 1] (the integral plane's support)."""
    d = _clip(d, -pad, pad - 1)
    d0 = torch.floor(d)
    f = (d - d0)[..., None, None]
    idx = d0.to(torch.int64)[..., None, None] + pad
    # k[i, p] = p - i: the tap of output i at padded position p
    k = (torch.arange(n_pad, device=d.device)[None, :]
         - torch.arange(n_out, device=d.device)[:, None])
    return torch.where(k == idx, 1.0 - f, 0.0) + torch.where(k == idx + 1, f, 0.0)


def _ordered(lo: torch.Tensor, hi: torch.Tensor, bound: int) -> torch.Tensor:
    """[2, C, B]: the lower and the upper coordinate, clipped to +-bound."""
    return _clip(torch.stack([torch.minimum(lo, hi), torch.maximum(lo, hi)]),
                 -bound, bound)


def box_conv2d(
    x: torch.Tensor,        # [N, C, H, W]
    y_min: torch.Tensor,    # [C, B] float box coordinates (pixels, signed)
    y_max: torch.Tensor,
    x_min: torch.Tensor,
    x_max: torch.Tensor,
    *,
    max_h: int,
    max_w: int,
    normalize: bool = True,
) -> torch.Tensor:
    """Box-filter responses -> [N, C*B, H, W] in f32 (output channel
    ``c * B + b``).  Coordinates are ordered and clipped to +-``max_h`` /
    +-``max_w`` in the forward pass; samples past the image see zeros above
    and to the left and the full sums below and to the right."""
    n, c, h, w = x.shape
    b = y_min.shape[1]
    ys = _ordered(y_min, y_max, max_h)          # y1, y2
    xs = _ordered(x_min, x_max, max_w)          # x1, x2

    pad = max(max_h, max_w) + 2
    # the exclusive prefix already holds the zero row and column at the top
    # and left; edge padding replicates them there and the full sums at the
    # bottom and right
    ii_p = F.pad(integral_image(x), (pad, pad, pad, pad), mode="replicate")
    hp, wp = ii_p.shape[-2:]

    # R = blend(y2 + 1) - blend(y1) over rows, C likewise over columns:
    # both corners of an axis in one band call
    rows = _corner_band(torch.stack([ys[1] + 1.0, ys[0]]), h, hp, pad)
    cols = _corner_band(torch.stack([xs[1] + 1.0, xs[0]]), w, wp, pad)
    rmat = rows[0] - rows[1]                    # [C, B, h, Hp]
    cmat = cols[0] - cols[1]                    # [C, B, w, Wp]
    if normalize:
        area = (ys[1] - ys[0] + 1.0) * (xs[1] - xs[0] + 1.0)
        area = torch.maximum(area, area.new_full((), 1.0))
        rmat = rmat / area[:, :, None, None]
    ii_p = ii_p.to(torch.promote_types(ii_p.dtype, cmat.dtype))
    t = torch.einsum("ncpq,cbjq->ncbpj", ii_p, cmat)   # [N, C, B, Hp, w]
    out = torch.einsum("ncbpj,cbip->ncbij", t, rmat)   # [N, C, B, h, w]
    return out.reshape(n, c * b, h, w)


class BoxConv2d(nn.Module):
    """Learnable per-(channel, box) rectangles: ``ybox`` and ``xbox`` are
    [2, C, B] (min and max stacked), drawn as a centre ~ U(-max/4, max/4)
    and a half-size ~ U(1, max/2) from ``gen``."""

    def __init__(self, channels: int, num_boxes: int, max_h: int, max_w: int,
                 normalize: bool = True, *, gen: torch.Generator):
        super().__init__()
        self.max_h, self.max_w, self.normalize = max_h, max_w, normalize

        def init_minmax(max_dim):
            shape = (channels, num_boxes)
            lo = max_dim / 4.0
            center = torch.rand(shape, generator=gen) * (2 * lo) - lo
            half = torch.rand(shape, generator=gen) * (max_dim / 2.0 - 1.0) + 1.0
            return nn.Parameter(torch.stack([center - half, center + half]))

        self.ybox = init_minmax(max_h)
        self.xbox = init_minmax(max_w)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return box_conv2d(x, self.ybox[0], self.ybox[1], self.xbox[0],
                          self.xbox[1], max_h=self.max_h, max_w=self.max_w,
                          normalize=self.normalize)
