"""Layer library: conv / dilated conv / deconv blocks with TF-SAME semantics.

Port of ``msau_tpu.models.layers`` (NHWC flax) as NCHW ``nn.Module``s.
Module and parameter names follow the flax tree (``Conv_0``,
``ConvBnLrnDrop_{i}``, ...), so ``utils.transplant`` maps one to the other
by name alone.

* TF-SAME padding is explicit (``F.pad``): for an even kernel, such as the
  4x4 end conv, the extra pixel goes bottom/right; a dilated kernel pads by
  its effective size.
* Initialization follows the reference TF scheme: weight ~ N(0,
  sqrt(2/(kh*kw*cin+cout))), bias ~ N(0.1, 1e-5), drawn from an explicit
  ``torch.Generator``.
* LRN is torch.nn.LocalResponseNorm with size == n_features: window
  [c - size//2, c + (size-1)//2], scaled by alpha/size.
* ``use_bn`` and ``keep_prob`` (the conv layers, not the deconv, as in
  JAX): conv -> BatchNorm -> act -> LRN -> dropout.  The BatchNorm is
  flax's (``BatchNorm``), the dropout draws its mask from an explicit
  ``torch.Generator`` and is the identity in eval mode.
* A flat layer of a model at ``spatial_shards > 1`` runs on H-shards
  (``shards``, a ``parallel.spatial.SpatialShards`` that ``MSAUNet`` sets):
  every op with a vertical reach runs its kernel on the shards extended
  by that many rows of their neighbours, then drops them.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from msau_tpu_torch.ops.flatconv import (
    concat_conv1x1,
    conv_pads,
    flat_conv2d,
    flat_deconv2,
    local_response_norm,
    same_padding,
)
from msau_tpu_torch.ops.flatres import FUSED_CHANNELS, flat_res_block
from msau_tpu_torch.ops.precision import wide


def tf_conv_std(kh: int, kw: int, cin: int, cout: int) -> float:
    """stddev = sqrt(2 / (kh*kw*cin + cout)) — reference initOpt=0."""
    return (2.0 / (kh * kw * cin + cout)) ** 0.5


def _normal(shape, std: float, gen: torch.Generator, mean: float = 0.0):
    return torch.randn(shape, generator=gen) * std + mean


def get_activation(name: Optional[str]) -> Optional[Callable]:
    if name is None or name == "none":
        return None
    return {
        "relu": F.relu,
        "elu": F.elu,
        # jax.nn.gelu defaults to the tanh approximation
        "gelu": lambda x: F.gelu(x, approximate="tanh"),
        "identity": lambda x: x,
    }[name]


class Conv(nn.Module):
    """Conv2d parameters (``weight`` OIHW, ``bias``) with TF-SAME forward;
    the counterpart of flax ``nn.Conv``."""

    def __init__(self, cin: int, cout: int, kernel_size: Tuple[int, int],
                 gen: torch.Generator, *, weight_std: Optional[float] = None,
                 bias_mean: float = 0.1, bias_std: float = 1e-5,
                 lecun: bool = False, use_bias: bool = True):
        super().__init__()
        kh, kw = kernel_size
        shape = (cout, cin, kh, kw)
        if lecun:
            # flax default kernel_init: lecun_normal = variance_scaling(1,
            # fan_in, truncated_normal), truncated at 2 std
            std = (1.0 / (cin * kh * kw)) ** 0.5 / 0.87962566103423978
            w = torch.empty(shape)
            nn.init.trunc_normal_(w, std=std, a=-2 * std, b=2 * std,
                                  generator=gen)
        else:
            w = _normal(shape, weight_std if weight_std is not None
                        else tf_conv_std(kh, kw, cin, cout), gen)
        self.weight = nn.Parameter(w)
        self.bias = (nn.Parameter(_normal((cout,), bias_std, gen, bias_mean))
                     if use_bias else None)

    def forward(self, x: torch.Tensor, dilation: int = 1,
                stride: Tuple[int, int] = (1, 1)) -> torch.Tensor:
        """Computes in ``x``'s dtype: the parameters are cast at use, as
        flax ``nn.Conv(dtype=...)`` does (f32 parameters, bf16 compute)."""
        kh, kw = self.weight.shape[-2:]
        ph = same_padding_strided(x.shape[-2], kh, dilation, stride[0])
        pw = same_padding_strided(x.shape[-1], kw, dilation, stride[1])
        if ph != (0, 0) or pw != (0, 0):
            x = F.pad(x, (pw[0], pw[1], ph[0], ph[1]))
        bias = None if self.bias is None else self.bias.to(x.dtype)
        return F.conv2d(x, self.weight.to(x.dtype), bias, stride=stride,
                        dilation=dilation)


def same_padding_strided(n: int, k: int, dilation: int, stride: int):
    """TF-SAME (lo, hi) padding of a size-``n`` axis: ceil(n / stride)
    outputs, the extra pixel at hi."""
    if stride == 1:
        return same_padding(k, dilation)
    total = max((-(-n // stride) - 1) * stride + (k - 1) * dilation + 1 - n, 0)
    return total // 2, total - total // 2


class BatchNorm(nn.Module):
    """flax ``nn.BatchNorm`` over the channels (dim 1) of NCHW: in train
    mode the batch's statistics over N, H and W in f32, the variance
    E[x^2] - E[x]^2 clipped at 0 (biased), and the running averages
    ``ra = 0.99 ra + 0.01 batch`` (the same variance); in eval mode the
    running averages.  y = (x - mean) * rsqrt(var + eps) * scale + bias in
    f32, returned in x's dtype.  Parameters ``scale`` and ``bias``,
    buffers ``mean`` and ``var`` (flax's ``batch_stats``)."""

    def __init__(self, channels: int, momentum: float = 0.99,
                 epsilon: float = 1e-5):
        super().__init__()
        self.momentum, self.epsilon = momentum, epsilon
        self.scale = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("mean", torch.zeros(channels))
        self.register_buffer("var", torch.ones(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = wide(x)
        if self.training:
            mean = xf.mean((0, 2, 3))
            var = torch.clamp((xf * xf).mean((0, 2, 3)) - mean * mean, min=0.0)
            with torch.no_grad():
                m = self.momentum
                self.mean.copy_(m * self.mean + (1.0 - m) * mean)
                self.var.copy_(m * self.var + (1.0 - m) * var)
        else:
            mean, var = self.mean, self.var
        mul = torch.rsqrt(var + self.epsilon) * self.scale
        y = (xf - mean[:, None, None]) * mul[:, None, None] \
            + self.bias[:, None, None]
        return y.to(x.dtype)


def dropout(x: torch.Tensor, keep_prob: float,
            gen: Optional[torch.Generator]) -> torch.Tensor:
    """flax ``nn.Dropout(rate=1 - keep_prob)`` in train mode: each element
    kept with probability ``keep_prob`` and scaled by 1 / keep_prob, else
    0; the mask drawn from ``gen`` on its own device, so a generator gives
    the same mask whatever device ``x`` is on."""
    if gen is None:
        raise ValueError("dropout in train mode needs a generator "
                         "(dropout_gen=)")
    keep = torch.rand(x.shape, generator=gen, device=gen.device) < keep_prob
    return torch.where(keep.to(x.device), x / keep_prob,
                       torch.zeros((), dtype=x.dtype, device=x.device))


def _sharded(shards) -> bool:
    return shards is not None and shards.active


class ConvBnLrnDrop(nn.Module):
    """TF-SAME conv (``strides``, default 1) -> optional BatchNorm
    (``use_bn``) -> act -> LRN -> dropout (``keep_prob`` < 1, train mode,
    mask from ``dropout_gen``) (reference ``Conv2dBnLrnDrop``).

    ``flat`` (a scale below ``flat_scales``) runs the conv, act and LRN as
    one flat-layout op (``ops.flatconv``), then the dropout: a pair of
    inputs (a, b), taken as their channel concat, then never materializes
    it, and a 1x1 conv of a pair is the concat 1x1 coupling op.  A flat
    layer has no BatchNorm (ValueError; the JAX package asserts)."""

    shards = None   # a SpatialShards, set by MSAUNet at spatial_shards > 1

    def __init__(self, cin: int, features: int, kernel_size=(3, 3),
                 activation: Optional[str] = "relu", use_lrn: bool = False,
                 *, gen: torch.Generator, rate: int = 1, flat: bool = False,
                 strides: Tuple[int, int] = (1, 1), use_bn: bool = False,
                 keep_prob: float = 1.0,
                 dropout_gen: Optional[torch.Generator] = None):
        super().__init__()
        if flat and tuple(strides) != (1, 1):
            raise ValueError(f"the flat conv has stride 1, not {strides}")
        if flat and use_bn:
            raise ValueError("a flat layer has no BatchNorm (use_bn)")
        self.Conv_0 = Conv(cin, features, tuple(kernel_size), gen)
        if use_bn:
            self.BatchNorm_0 = BatchNorm(features)
        self.strides = tuple(strides)
        self.activation = activation
        self.use_lrn = use_lrn
        self.use_bn = use_bn
        self.keep_prob = keep_prob
        self.dropout_gen = dropout_gen
        self.rate = rate
        self.features = features
        self.flat = flat

    def _drop(self, y: torch.Tensor) -> torch.Tensor:
        if self.keep_prob < 1.0 and self.training:
            return dropout(y, self.keep_prob, self.dropout_gen)
        return y

    def _flat(self, x) -> torch.Tensor:
        w, b = self.Conv_0.weight, self.Conv_0.bias
        if (isinstance(x, tuple) and tuple(w.shape[-2:]) == (1, 1)
                and not self.use_lrn):
            return concat_conv1x1(*x, w, b, act=self.activation)
        opts = dict(dilation=self.rate, act=self.activation,
                    lrn_size=self.features if self.use_lrn else 0)
        (top, bottom), _ = conv_pads(w, self.rate)
        if _sharded(self.shards) and top + bottom:
            xs = x if isinstance(x, tuple) else (x,)
            return self.shards.halo(
                lambda *t: flat_conv2d(t if len(t) > 1 else t[0], w, b,
                                       **opts), xs, top, bottom)
        return flat_conv2d(x, w, b, **opts)

    def forward(self, x) -> torch.Tensor:
        """``x``: [N, C, H, W] or a pair of them concatenated on channels."""
        if self.flat:
            return self._drop(self._flat(x))
        if isinstance(x, tuple):
            x = torch.cat(x, dim=1)
        y = self.Conv_0(x, dilation=self.rate, stride=self.strides)
        if self.use_bn:
            y = self.BatchNorm_0(y)
        act = get_activation(self.activation)
        if act is not None:
            y = act(y)
        if self.use_lrn:
            y = local_response_norm(y, size=self.features)
        return self._drop(y)


class DilConvBnLrnDrop(ConvBnLrnDrop):
    """Dilated (atrous) conv at ``rate``; LRN on by default (reference
    ``DilConv2dBnLrnDrop``)."""

    def __init__(self, cin: int, features: int, kernel_size=(3, 3),
                 rate: int = 1, activation: Optional[str] = "relu",
                 use_lrn: bool = True, *, gen: torch.Generator,
                 flat: bool = False, use_bn: bool = False,
                 keep_prob: float = 1.0,
                 dropout_gen: Optional[torch.Generator] = None):
        super().__init__(cin, features, kernel_size, activation, use_lrn,
                         gen=gen, rate=rate, flat=flat, use_bn=use_bn,
                         keep_prob=keep_prob, dropout_gen=dropout_gen)


class DeconvBnLrnDrop(nn.Module):
    """Stride-2 transposed conv resized to an exact target spatial shape:
    torch ``ConvTranspose2d(stride=s, padding=k//2)`` with
    ``output_padding = target - base`` per dim (reference
    ``Deconv2DBnLrnDrop``).  ``weight`` is torch's [in, out, kh, kw]; the
    flax kernel is its spatial flip in HWIO (``utils.transplant``).
    ``flat`` runs the transposed conv as the flat-layout op
    (``ops.flatconv.flat_deconv2``, stride 2); on H-shards its input gains
    one row of each neighbour (the 3x3 kernel's reach at stride 2), and
    the output drops their two rows each side."""

    shards = None

    def __init__(self, cin: int, features: int, kernel_size=(3, 3),
                 stride: int = 2, activation: Optional[str] = None,
                 use_lrn: bool = False, *, gen: torch.Generator,
                 flat: bool = False):
        super().__init__()
        if flat and stride != 2:
            raise ValueError(f"the flat deconv has stride 2, not {stride}")
        kh, kw = kernel_size
        # reference stddev uses kernel_shape=[kh, kw, out, in]
        std = tf_conv_std(kh, kw, features, cin)
        self.weight = nn.Parameter(_normal((cin, features, kh, kw), std, gen))
        self.bias = nn.Parameter(_normal((features,), 1e-5, gen, 0.1))
        self.stride = stride
        self.activation = activation
        self.use_lrn = use_lrn
        self.features = features
        self.flat = flat

    def forward(self, x: torch.Tensor, target_hw: Tuple[int, int]) -> torch.Tensor:
        if self.flat and _sharded(self.shards):
            hs, th = x.shape[-2], target_hw[0]
            if th != 2 * hs:
                raise ValueError(f"a sharded deconv doubles its rows: "
                                 f"{hs} -> {th}")
            r = (self.weight.shape[-2] // 2 + 1) // 2
            y = self.shards.halo(
                lambda t: flat_deconv2(t, self.weight, self.bias,
                                       (2 * t.shape[-2], target_hw[1])),
                (x,), r, r, scale=2)
        elif self.flat:
            y = flat_deconv2(x, self.weight, self.bias, target_hw)
        else:
            kh, kw = self.weight.shape[-2:]
            s = self.stride
            ph, pw = kh // 2, kw // 2
            h, w = x.shape[-2:]
            oph = target_hw[0] - ((h - 1) * s - 2 * ph + kh)
            opw = target_hw[1] - ((w - 1) * s - 2 * pw + kw)
            if not (0 <= oph < s and 0 <= opw < s):
                raise ValueError(f"target {tuple(target_hw)} unreachable from "
                                 f"{(h, w)} with stride {s}")
            # parameters cast to the activation dtype at use, as in Conv
            y = F.conv_transpose2d(x, self.weight.to(x.dtype),
                                   self.bias.to(x.dtype), stride=s,
                                   padding=(ph, pw), output_padding=(oph, opw))
        act = get_activation(self.activation)
        if act is not None:
            y = act(y)
        if self.use_lrn:
            y = local_response_norm(y, size=self.features)
        return y


class MultiConvResidualBlock(nn.Module):
    """relu(x) -> res_depth convs (last without activation) -> +x -> act
    (reference ``MultiConvResidualBlock``).  ``flat`` runs the flagship
    shape (depth 2, 3x3, relu or elu, a channel count the kernel takes) as
    one fused op (``ops.flatres``) and any other, or any on H-shards (the
    fused kernel would zero conv1 only outside the extended rows), as flat
    convs."""

    shards = None

    def __init__(self, channels: int, res_depth: int, filter_size: int,
                 activation: str = "relu", *, gen: torch.Generator,
                 flat: bool = False):
        super().__init__()
        self.res_depth = res_depth
        self.activation = activation
        self.fused = (flat and res_depth == 2 and filter_size == 3
                      and activation in ("relu", "elu")
                      and channels in FUSED_CHANNELS)
        k = (filter_size, filter_size)
        for i in range(res_depth):
            act = activation if i < res_depth - 1 else None
            self.add_module(f"ConvBnLrnDrop_{i}", ConvBnLrnDrop(
                channels, channels, k, activation=act, gen=gen, flat=flat))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.fused and not _sharded(self.shards):
            c1, c2 = self.ConvBnLrnDrop_0.Conv_0, self.ConvBnLrnDrop_1.Conv_0
            return flat_res_block(x, c1.weight, c1.bias, c2.weight, c2.bias,
                                  self.activation)
        y = F.relu(x)
        for i in range(self.res_depth):
            y = getattr(self, f"ConvBnLrnDrop_{i}")(y)
        y = y + x
        act = get_activation(self.activation)
        return act(y) if act is not None else y


def maxpool_same(x: torch.Tensor, k: int) -> torch.Tensor:
    """TF-SAME k x k / stride k max pool: odd sizes pad bottom/right with
    -inf, which is what ceil_mode's partial last window computes."""
    return F.max_pool2d(x, kernel_size=k, stride=k, ceil_mode=True)


class DownSampleResNet(nn.Module):
    """Residual conv stack -> SAME max pool -> 4x4 class conv at
    ``aux_stride`` (reference ``DownSampleResNet``; the guidance network of
    the CSPN path)."""

    def __init__(self, channel_in: int, channel_out: int, filter_size: int = 3,
                 res_depth: int = 3, pool_size: int = 2,
                 activation: str = "relu", aux_stride: int = 2, *,
                 gen: torch.Generator):
        super().__init__()
        self.res_depth = res_depth
        self.pool_size = pool_size
        self.activation = activation
        k = (filter_size, filter_size)
        for i in range(res_depth):
            act = activation if i < res_depth - 1 else None
            self.add_module(f"ConvBnLrnDrop_{i}", ConvBnLrnDrop(
                channel_in, channel_in, k, activation=act, gen=gen))
        self.add_module(f"ConvBnLrnDrop_{res_depth}", ConvBnLrnDrop(
            channel_in, channel_out, (4, 4), activation="relu", gen=gen,
            strides=(aux_stride, aux_stride)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        orig = x
        for i in range(self.res_depth):
            x = getattr(self, f"ConvBnLrnDrop_{i}")(x)
        x = x + orig
        act = get_activation(self.activation)
        x = act(x) if act is not None else x
        x = maxpool_same(x, self.pool_size)
        return getattr(self, f"ConvBnLrnDrop_{self.res_depth}")(x)
