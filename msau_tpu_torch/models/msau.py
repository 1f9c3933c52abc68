"""Multi-Stage Attention U-Net (MSAU) in PyTorch — port of
``msau_tpu.models.msau``.

  * ``num_blocks`` coupled attention U-Net stages.  Stage 0 takes the
    chargrid; stages 1..n take the previous stage's n_class map.
  * Down tower, per scale: dilated conv at rate 2**scale + LRN -> residual
    block -> (stages > 0) concat with the previous stage's down activation
    and a 1x1 coupling conv -> self-attention at the deepest scale -> SAME
    maxpool.  The attention output goes to the NEXT stage's coupling, while
    the up tower gets the pre-attention tensor.
  * Up tower, per scale: deconv to the exact skip shape -> concat skip ->
    KxK merge conv -> residual block -> (stages > 0) 1x1 coupling with the
    previous stage's up activation.
  * Optional bottleneck refinements of the deepest tensor the up tower
    takes (``models.extras``): ``use_lstm``, a row and a column LSTM, in
    every stage; ``use_spn``, CSPN affinity propagation guided by the
    second-deepest scale, in the last stage only.
  * A 4x4 ``end_conv`` maps feat_root -> n_class per stage; stage n-2's
    output is the auxiliary logits head.
  * ``model="msau_box"`` (``models.msau_box``) puts box convolutions in
    every residual block; its wrapper holds the network at ``net.bmsau``.

Modules work in NCHW; the public forward takes NHWC input and returns
``(probs, logits, aux)`` like ``MSAUWrapper``, NHWC or NCHW
(``logits_layout``).  Module names follow the flax tree
(``net.block_{b}.down.dil_conv_{l}.Conv_0``, ...).

``spatial_shards`` = sp > 1 (at fs > 0) cuts each image's rows into sp
blocks on the flat scales, as the JAX package's ``FlatGeom.sp``: the
batch axis carries sp*N shard-major entries there, each flat op with a
vertical reach takes halo rows from the neighbouring blocks
(``parallel.spatial.SpatialShards``), the residual blocks run as two flat
convs, the deep scales (attention) see the merged image, and the logits
merge back.  Under a spatial process group (``set_spatial_group``, as the
Trainer sets it on a mesh with a ``spatial`` axis) a rank holds one block
instead, its halos come from the ranks above and below, and the deep
scales run on the image gathered from the group (every scale, at fs 0).

``flat_scales`` = fs > 0 runs the scales below fs, and the end convs,
through the flat-layout ops (``ops.flatconv``, ``ops.flatres``: hand-written
CUDA kernels on a card, forward and backward) as the JAX package runs them
through its Pallas kernels; the deepest scale keeps
torch convs and the attention op.  The tensors stay NCHW at every
scale and the parameter tree is the same for every fs.

Compute dtype follows flax's ``dtype=``: the input is cast to
``config.dtype`` and every layer casts its (f32) parameters to the
activation's dtype at use, so a bf16 config trains f32 parameters with bf16
activations; logits come out in f32.  "float64" (parameters cast to
float64 too, ``model.double()``) runs the plain versions on the CPU with no
f32 rounding: the exact reference a float32 step is held to.  ``remat`` recomputes each U-Net stage
in the backward (``torch.utils.checkpoint``, as ``nn.remat(UNetBlock)``).
``attention_impl`` picks the deepest scale's attention op as in the JAX
package (``models.attention.SelfAttentionBlock``): the resident op below
8192 tokens and the streaming op from there on ("auto"), or the streaming
op at any size ("pallas").
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import torch
import torch.nn as nn
from torch.utils.checkpoint import checkpoint

from msau_tpu_torch.config import ModelConfig
from msau_tpu_torch.models.attention import SelfAttentionBlock
from msau_tpu_torch.models.extras import SeparableRNNBlock, affinity_propagate
from msau_tpu_torch.models.layers import (
    ConvBnLrnDrop,
    DeconvBnLrnDrop,
    DilConvBnLrnDrop,
    DownSampleResNet,
    MultiConvResidualBlock,
    maxpool_same,
)
from msau_tpu_torch.models.msau_box import BMSAUNet, MultiBoxConvBlock
from msau_tpu_torch.ops.flatconv import flat_maxpool2, same_padding, to_nchw
from msau_tpu_torch.ops.precision import wide
from msau_tpu_torch.parallel.spatial import SpatialShards


def check_supported(cfg: ModelConfig) -> None:
    """Raise ValueError for configurations the model does not define."""
    if not 0 <= cfg.flat_scales <= cfg.scale_space_num - 1:
        raise ValueError(
            f"flat_scales {cfg.flat_scales} out of [0, scale_space_num - 1]: "
            "the deepest (attention) scale is never flat")
    if cfg.flat_scales > 0 and cfg.pool_size != 2:
        raise ValueError("flat_scales > 0 needs pool_size 2 (the flat pool "
                         "and deconv are 2x2, stride 2)")
    if cfg.flat_scales > 0 and (cfg.model == "msau_box" or cfg.use_spn):
        raise ValueError("flat_scales > 0 needs the conv residual blocks and "
                         "no use_spn: the flat layout has no box or CSPN "
                         "block")


def check_shard_rows(cfg: ModelConfig, h: int, sp: int) -> None:
    """ValueError where an image of ``h`` rows does not cut into ``sp``
    blocks at every flat scale (h divisible by sp * 2**flat_scales), or a
    block at a flat scale has fewer rows than the largest vertical reach
    there (the dilated conv's 2**s, the end conv's 2 below, ...)."""
    fs, k = cfg.flat_scales, cfg.filter_size
    if h % (sp * 2 ** fs):
        raise ValueError(f"H={h} is not divisible by spatial_shards * "
                         f"2**flat_scales = {sp * 2 ** fs}")
    for s in range(fs):
        rows = h // (sp * 2 ** s)
        reach = max(same_padding(k, cfg.pool_size ** s) + same_padding(k)
                    + ((1, 2) if s == 0 else (1,)))
        if rows < reach:
            raise ValueError(f"a shard at flat scale {s} has {rows} rows, "
                             f"fewer than the reach {reach} of its convs")


DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
          "float64": torch.float64}


def _make_res_block(cfg: ModelConfig, variant: str, channels: int,
                    gen: torch.Generator, flat: bool) -> nn.Module:
    """The residual block of a scale: dense convs, or box convs for the
    "box" variant (never flat: ``check_supported``)."""
    if variant == "box":
        return MultiBoxConvBlock(
            channels, cfg.num_box_convs, cfg.num_box_per_channel,
            cfg.max_box_size, cfg.activation_name, gen=gen)
    return MultiConvResidualBlock(channels, cfg.res_depth, cfg.filter_size,
                                  cfg.activation_name, gen=gen, flat=flat)


class DownSamplingUNetBlock(nn.Module):
    def __init__(self, cfg: ModelConfig, cin: int, coupled: bool,
                 gen: torch.Generator, variant: str = "conv"):
        super().__init__()
        self.cfg = cfg
        self.coupled = coupled
        S, k, pool = cfg.scale_space_num, cfg.filter_size, cfg.pool_size
        feats, c_in = cfg.feat_root, cin
        for layer in range(S):
            flat = layer < cfg.flat_scales
            self.add_module(f"dil_conv_{layer}", DilConvBnLrnDrop(
                c_in, feats, (k, k), rate=pool ** layer, activation=None,
                use_lrn=cfg.use_lrn, gen=gen, flat=flat))
            self.add_module(f"res_block_{layer}", _make_res_block(
                cfg, variant, feats, gen, flat))
            if coupled:
                self.add_module(f"couple_conv_{layer}", ConvBnLrnDrop(
                    2 * feats, feats, (1, 1), activation=cfg.activation_name,
                    gen=gen, flat=flat))
            if layer == S - 1:
                self.add_module(f"attention_{layer}",
                                SelfAttentionBlock(
                                    feats, impl=cfg.attention_impl, gen=gen))
            c_in = feats
            feats *= pool

    shards = None   # the MSAUNet's SpatialShards

    def forward(self, x: torch.Tensor, prev: Optional[List[torch.Tensor]]):
        S = self.cfg.scale_space_num
        dw_h_convs: List[torch.Tensor] = []
        for layer in range(S):
            if layer == self.cfg.flat_scales and layer and self.shards.active:
                x = self.shards.merge(x)   # the deep scales see the image
            y = getattr(self, f"dil_conv_{layer}")(x)
            y = getattr(self, f"res_block_{layer}")(y)
            if self.coupled:
                y = getattr(self, f"couple_conv_{layer}")((prev[layer], y))
            if layer == S - 1:
                dw_h_convs.append(getattr(self, f"attention_{layer}")(y))
                x = y
            else:
                dw_h_convs.append(y)
                x = (flat_maxpool2(y) if layer < self.cfg.flat_scales
                     else maxpool_same(y, self.cfg.pool_size))
        return dw_h_convs, x


class UpSamplingUNetBlock(nn.Module):
    def __init__(self, cfg: ModelConfig, coupled: bool, gen: torch.Generator,
                 variant: str = "conv"):
        super().__init__()
        self.cfg = cfg
        self.coupled = coupled
        k, pool = cfg.filter_size, cfg.pool_size
        for layer in range(cfg.scale_space_num - 2, -1, -1):
            feats = cfg.feat_root * pool ** layer
            flat = layer < cfg.flat_scales
            self.add_module(f"deconv_{layer}", DeconvBnLrnDrop(
                feats * pool, feats, (k, k), stride=pool, gen=gen, flat=flat))
            self.add_module(f"merge_conv_{layer}", ConvBnLrnDrop(
                2 * feats, feats, (k, k), activation=None, gen=gen,
                flat=flat))
            self.add_module(f"res_block_{layer}", _make_res_block(
                cfg, variant, feats, gen, flat))
            if coupled:
                self.add_module(f"couple_conv_{layer}", ConvBnLrnDrop(
                    2 * feats, feats, (1, 1), activation=cfg.activation_name,
                    gen=gen, flat=flat))

    shards = None   # the MSAUNet's SpatialShards

    def forward(self, dw_h_convs, x, prev: Optional[List[torch.Tensor]]):
        up_h_convs: List[Optional[torch.Tensor]] = [None] * (
            self.cfg.scale_space_num - 1)
        for layer in range(self.cfg.scale_space_num - 2, -1, -1):
            if layer == self.cfg.flat_scales - 1 and self.shards.active:
                x = self.shards.split(x)   # back onto the flat scales' shards
            skip = dw_h_convs[layer]
            y = getattr(self, f"deconv_{layer}")(x, tuple(skip.shape[-2:]))
            y = getattr(self, f"merge_conv_{layer}")((skip, y))
            y = getattr(self, f"res_block_{layer}")(y)
            if self.coupled:
                y = getattr(self, f"couple_conv_{layer}")((prev[layer], y))
            up_h_convs[layer] = y
            x = y
        return x, up_h_convs


class UNetBlock(nn.Module):
    def __init__(self, cfg: ModelConfig, cin: int, coupled: bool,
                 gen: torch.Generator, variant: str = "conv",
                 use_spn: bool = False):
        super().__init__()
        S, pool = cfg.scale_space_num, cfg.pool_size
        self.down = DownSamplingUNetBlock(cfg, cin, coupled, gen, variant)
        if cfg.use_lstm:
            self.lstm = SeparableRNNBlock(cfg.feat_root * pool ** (S - 1),
                                          identity=False, gen=gen)
        if use_spn:
            # aux_stride 1 keeps the guidance at the deepest map's size
            self.spn_guidance = DownSampleResNet(
                cfg.feat_root * pool ** (S - 2), 8, cfg.filter_size,
                cfg.res_depth, pool, cfg.activation_name, aux_stride=1,
                gen=gen)
        self.up = UpSamplingUNetBlock(cfg, coupled, gen, variant)

    def forward(self, x, prev_dw=None, prev_up=None):
        dw_h_convs, deepest = self.down(x, prev_dw)
        dtype = deepest.dtype
        if hasattr(self, "lstm"):
            deepest = self.lstm(deepest)
        if hasattr(self, "spn_guidance"):
            gh, gw = deepest.shape[-2:]
            guidance = self.spn_guidance(dw_h_convs[-2])[:, :, :gh, :gw]
            deepest = deepest + affinity_propagate(
                guidance, deepest.mean(1, keepdim=True))
        # the LSTM computes in its f32 parameters' dtype; the up tower's
        # first layer takes the stage's dtype, as flax's ``dtype=`` casts
        out, up_h_convs = self.up(dw_h_convs, deepest.to(dtype), prev_up)
        return out, dw_h_convs, up_h_convs


class MSAUNet(nn.Module):
    """num_blocks coupled U-Net stages + per-stage 4x4 end convs; NCHW in,
    NCHW f32 (logits, aux_logits) out."""

    def __init__(self, cfg: ModelConfig, gen: torch.Generator,
                 block_variant: str = "conv"):
        super().__init__()
        check_supported(cfg)
        self.cfg = cfg
        # sp applies to the flat scales (as FlatGeom.sp); set_group may
        # put every scale of an fs=0 model on a spatial group
        self.shards = SpatialShards(cfg.spatial_shards if cfg.flat_scales
                                    else 1)
        for b in range(cfg.num_blocks):
            cin = cfg.img_channels if b == 0 else cfg.n_class
            # SPN only on the last stage (reference model/model.py:365-368)
            self.add_module(f"block_{b}", UNetBlock(
                cfg, cin, b > 0, gen, block_variant,
                use_spn=cfg.use_spn and b == cfg.num_blocks - 1))
            self.add_module(f"end_conv_{b}", ConvBnLrnDrop(
                cfg.feat_root, cfg.n_class, (4, 4), activation=None, gen=gen,
                flat=cfg.flat_scales > 0))
        for m in self.modules():
            if hasattr(type(m), "shards") and m is not self:
                m.shards = self.shards

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        cfg = self.cfg
        sh = self.shards
        if sh.active:
            ranks = sh.shards if sh.group is not None else 1
            check_shard_rows(cfg, x.shape[-2] * ranks, sh.shards)
            x = sh.enter(x)
            if not cfg.flat_scales:
                x = sh.merge(x)
        prev_dw = prev_up = None
        logits_aux = None
        out = x
        remat = cfg.remat and torch.is_grad_enabled()
        for b in range(cfg.num_blocks):
            block = getattr(self, f"block_{b}")
            if remat:
                out, prev_dw, prev_up = checkpoint(
                    block, out, prev_dw, prev_up, use_reentrant=False)
            else:
                out, prev_dw, prev_up = block(out, prev_dw, prev_up)
            out = getattr(self, f"end_conv_{b}")(out)
            if b == cfg.num_blocks - 2:
                logits_aux = out
        if sh.active:
            out = sh.leave(out if cfg.flat_scales else sh.split(out))
            if logits_aux is not None:
                logits_aux = sh.leave(logits_aux if cfg.flat_scales
                                      else sh.split(logits_aux))
        logits = wide(out)
        return logits, (logits if logits_aux is None else wide(logits_aux))


class MSAUWrapper(nn.Module):
    """Adds the final activation head; ``forward`` takes NHWC ``x`` and
    returns ``(probs, logits, aux_logits)``.  Parameters are drawn in f32
    from ``generator`` (a ``torch.Generator``), always on the CPU, so a
    seed gives the same weights on every device."""

    def __init__(self, config: ModelConfig, generator: torch.Generator):
        super().__init__()
        self.config = config
        self.net = (BMSAUNet(config, generator) if config.model == "msau_box"
                    else MSAUNet(config, generator))

    def set_spatial_group(self, group) -> None:
        """Run on one block of rows per rank of the process group ``group``
        (the rank's input is its block: ``parallel.shard_batch``; every
        scale of a model with no flat scale runs on the image gathered from
        the group), or on whole images again (None)."""
        net = self.net.bmsau if isinstance(self.net, BMSAUNet) else self.net
        net.shards.set_group(group)

    @property
    def compute_dtype(self) -> torch.dtype:
        return DTYPES[self.config.dtype]

    def forward(self, x: torch.Tensor, logits_layout: str = "NHWC"):
        """``logits_layout`` "NHWC", "NCHW" (f32 logits and probs in that
        layout; NCHW is the network's own, with no transpose) or "BODY":
        channel-major [N, C, H*W], the port's counterpart of the JAX
        package's body-flat [N, C, LB] logits, which the train step's fused
        loss reads."""
        if logits_layout not in ("NHWC", "NCHW", "BODY"):
            raise ValueError(f"unknown logits_layout {logits_layout!r}")
        if self.config.flat_scales > 0:
            xc = to_nchw(x.contiguous(), self.compute_dtype)
        else:
            xc = x.permute(0, 3, 1, 2).to(self.compute_dtype)
        logits, aux = self.net(xc)
        caxis = 1
        if logits_layout == "BODY":
            logits = logits.flatten(2)
            aux = aux.flatten(2)
        elif logits_layout == "NHWC":
            logits = logits.permute(0, 2, 3, 1)
            aux = aux.permute(0, 2, 3, 1)
            caxis = -1
        final_act = self.config.final_act
        if final_act == "softmax":
            probs = torch.softmax(logits, dim=caxis)
        elif final_act == "sigmoid":
            probs = torch.sigmoid(logits)
        else:
            probs = logits
        return probs, logits, aux


def build_model(config: ModelConfig, generator: torch.Generator) -> MSAUWrapper:
    return MSAUWrapper(config, generator)
