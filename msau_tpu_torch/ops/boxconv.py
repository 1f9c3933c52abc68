"""Learnable box convolution (port of ``msau_tpu.ops.boxconv``).

Each (channel, box) pair learns a rectangle (y_min, y_max, x_min, x_max)
and outputs the area-normalised average of the input over that rectangle
translated to every pixel.  The box sum comes from a 2-D exclusive prefix
sum sampled at the four corners with a linear blend.

``box_conv`` is the entry point, on the raw [2, C, B] coordinate
parameters.  A CUDA tensor, f32 or bf16, launches the hand-written
kernels through ``BoxConv``, a ``torch.autograd.Function``
(``csrc/boxconv.cu``: the filter from tile-local f32 integral images in
shared memory, one launch forward; its backward, the input's and the
coordinates' gradients with the ties below, one launch); a CUDA tensor of
another dtype is refused.  A CPU tensor takes the plain version,
``box_conv2d``, and its gradients by autograd.  No TPU kernel is
replaced: the JAX package computes the filter in XLA.

``box_conv2d`` is the JAX package's formulation: the prefix sum sampled
by two banded 1-D sampling matrices, one product over columns, one over
rows.  Autodiff through the blend weights gives the boundary-integral
gradients to the box coordinates, as in the JAX package; the products are
plain ``torch.einsum``.

Layout is NCHW: [N, C, H, W] -> [N, C*B, H, W] with output channel
``c * B + b``.

Every clip is ``torch.minimum`` / ``torch.maximum``, never ``torch.clamp``:
at a tie those split the gradient 0.5 / 0.5 as ``jnp.clip``,
``jnp.minimum`` and ``jnp.maximum`` do, where ``torch.clamp`` passes all of
it.  So coordinate gradients agree where a box sits on +-``max_h`` or where
``y_min == y_max``; the kernels apply the same rules.

Dtype: as in the JAX package, ``box_conv2d``'s integral image is a
``cumsum`` in the input's dtype (bf16 under a bf16 model) and the f32
bands promote both products to f32, so the output is f32 whatever the
input.  The kernels read a bf16 input and sum it in f32 (nearer the exact
filter than the bf16 ``cumsum``), return f32 and give dx in the input's
dtype.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from msau_tpu_torch.ops import cuda_lib


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


def _check(name: str, x: torch.Tensor, ybox: torch.Tensor,
           xbox: torch.Tensor, max_h: int, max_w: int) -> Tuple[int, ...]:
    cuda_lib.require_cuda(f"{name} x", x, (torch.float32, torch.bfloat16), 4)
    for label, t in (("ybox", ybox), ("xbox", xbox)):
        cuda_lib.require_cuda(f"{name} {label}", t, torch.float32, 3)
        if t.device != x.device:
            raise ValueError(f"{name}: {label} on {t.device}, x on {x.device}")
    n, c, h, w = x.shape
    if ybox.shape != xbox.shape or ybox.shape[:2] != (2, c):
        raise ValueError(f"{name}: ybox {tuple(ybox.shape)} / xbox "
                         f"{tuple(xbox.shape)} must be [2, {c}, B]")
    b = ybox.shape[2]
    if not cuda_lib.library().msau_box_conv_smem(n, c, b, h, w, max_h, max_w):
        raise ValueError(f"{name}: the kernels do not take x {tuple(x.shape)}, "
                         f"{b} boxes, max {max_h} x {max_w} (at most 8 boxes; "
                         "a tile's halo region must fit shared memory)")
    return n, c, b, h, w


def box_conv_fwd_cuda(x: torch.Tensor, ybox: torch.Tensor, xbox: torch.Tensor,
                      *, max_h: int, max_w: int,
                      normalize: bool = True) -> torch.Tensor:
    """Launch the forward kernel: x [N, C, H, W] f32 or bf16, ybox / xbox
    [2, C, B] f32 (raw: min and max as stored) -> [N, C*B, H, W] f32.
    ``.launches`` counts calls."""
    n, c, b, h, w = _check("box_conv_fwd", x, ybox, xbox, max_h, max_w)
    out = torch.empty((n, c * b, h, w), dtype=torch.float32, device=x.device)
    code = cuda_lib.library().msau_box_conv_fwd(
        x.data_ptr(), ybox.data_ptr(), xbox.data_ptr(), out.data_ptr(), n, c,
        b, h, w, max_h, max_w, int(normalize), int(x.dtype == torch.bfloat16),
        cuda_lib.stream_ptr(x.device))
    cuda_lib.check("msau_box_conv_fwd", code)
    box_conv_fwd_cuda.launches += 1
    return out


box_conv_fwd_cuda.launches = 0

# device -> int32 tickets of the backward's last-block sums, one a channel;
# every launch leaves them zero
_TICKETS = {}


def _tickets(device: torch.device, c: int) -> torch.Tensor:
    t = _TICKETS.get(device)
    if t is None or t.numel() < c:
        t = _TICKETS[device] = torch.zeros(max(c, 1024), dtype=torch.int32,
                                           device=device)
    return t


def box_conv_bwd_cuda(x: torch.Tensor, ybox: torch.Tensor, xbox: torch.Tensor,
                      g: torch.Tensor, *, max_h: int, max_w: int,
                      normalize: bool = True
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Launch the backward kernel on the cotangent ``g`` [N, C*B, H, W] f32
    -> (dx in x's dtype, dybox, dxbox), the gradients of the raw
    coordinates with the plain version's tie rules; one launch, no float
    atomics.  ``.launches`` counts calls."""
    n, c, b, h, w = _check("box_conv_bwd", x, ybox, xbox, max_h, max_w)
    cuda_lib.require_cuda("box_conv_bwd g", g, torch.float32, 4)
    if g.shape != (n, c * b, h, w) or g.device != x.device:
        raise ValueError(f"box_conv_bwd: g {tuple(g.shape)} must be "
                         f"[{n}, {c * b}, {h}, {w}] on {x.device}")
    lib = cuda_lib.library()
    tiles = lib.msau_box_conv_tiles(n, c, b, h, w)
    partial = torch.empty(c * b * 5 * n * tiles, dtype=torch.float32,
                          device=x.device)
    dx = torch.empty_like(x)
    dybox, dxbox = torch.empty_like(ybox), torch.empty_like(xbox)
    code = lib.msau_box_conv_bwd(
        x.data_ptr(), ybox.data_ptr(), xbox.data_ptr(), g.data_ptr(),
        dx.data_ptr(), dybox.data_ptr(), dxbox.data_ptr(), partial.data_ptr(),
        _tickets(x.device, c).data_ptr(), n, c, b, h, w, max_h, max_w,
        int(normalize), int(x.dtype == torch.bfloat16),
        cuda_lib.stream_ptr(x.device))
    cuda_lib.check("msau_box_conv_bwd", code)
    box_conv_bwd_cuda.launches += 1
    return dx, dybox, dxbox


box_conv_bwd_cuda.launches = 0


def box_conv_plain(x: torch.Tensor, ybox: torch.Tensor, xbox: torch.Tensor,
                   *, max_h: int, max_w: int,
                   normalize: bool = True) -> torch.Tensor:
    """``box_conv2d`` on the raw [2, C, B] coordinates."""
    return box_conv2d(x, ybox[0], ybox[1], xbox[0], xbox[1], max_h=max_h,
                      max_w=max_w, normalize=normalize)


def box_conv_bwd_plain(x, ybox, xbox, g, *, max_h, max_w, normalize=True):
    """(dx, dybox, dxbox) of ``box_conv_plain`` by autograd: what the
    backward kernel is held to."""
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_() for t in (x, ybox, xbox)]
        out = box_conv_plain(*leaves, max_h=max_h, max_w=max_w,
                             normalize=normalize)
        return torch.autograd.grad(out, leaves, g)


class BoxConv(torch.autograd.Function):
    """The box filter's kernels on the raw coordinates, with the gradients
    to the input and to both coordinate tensors."""

    @staticmethod
    def forward(ctx, x, ybox, xbox, max_h, max_w, normalize):
        x, ybox, xbox = (t.contiguous() for t in (x, ybox, xbox))
        ctx.save_for_backward(x, ybox, xbox)
        ctx.opts = dict(max_h=max_h, max_w=max_w, normalize=normalize)
        return box_conv_fwd_cuda(x, ybox, xbox, **ctx.opts)

    @staticmethod
    def backward(ctx, g):
        x, ybox, xbox = ctx.saved_tensors
        grads = box_conv_bwd_cuda(x, ybox, xbox, g.contiguous(), **ctx.opts)
        return (*grads, None, None, None)


def box_conv(x: torch.Tensor, ybox: torch.Tensor, xbox: torch.Tensor, *,
             max_h: int, max_w: int, normalize: bool = True) -> torch.Tensor:
    """Box-filter responses of x [N, C, H, W] for the raw coordinates
    ybox / xbox [2, C, B] (min and max stacked) -> [N, C*B, H, W] f32: the
    kernels on a CUDA tensor (f32 or bf16; the coordinates taken in f32),
    ``box_conv2d`` on a CPU one."""
    if x.device.type != "cuda":
        return box_conv_plain(x, ybox, xbox, max_h=max_h, max_w=max_w,
                              normalize=normalize)
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"box_conv: the kernels take f32 or bf16, not "
                         f"{x.dtype}")
    return BoxConv.apply(x, ybox.float(), xbox.float(), max_h, max_w,
                         normalize)


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
        return box_conv(x, self.ybox, self.xbox, max_h=self.max_h,
                        max_w=self.max_w, normalize=self.normalize)
