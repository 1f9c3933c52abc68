"""Box-convolution MSAU variant (port of ``msau_tpu.models.msau_box``).

The MSAU's topology with every residual block replaced by a
``MultiBoxConvBlock``: ``num_convs`` x [``BoxConv2d`` (C -> C*B box
responses) -> 1x1 conv (C*B -> C)] inside a residual connection.  The box
filters are ``ops.boxconv.box_conv`` (hand-written kernels on a card; the
JAX package computes them in XLA), each in a span ``msau.box_conv``.
``BMSAUNet`` holds the network as ``bmsau``, so its parameters sit at
``net.bmsau.block_{b}...`` as in the flax tree.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from msau_tpu_torch.config import ModelConfig
from msau_tpu_torch.models.layers import ConvBnLrnDrop, get_activation
from msau_tpu_torch.ops.boxconv import BoxConv2d
from msau_tpu_torch.utils.profiling import trace


class MultiBoxConvBlock(nn.Module):
    """relu(x) -> num_convs x [BoxConv -> 1x1 conv] -> +x -> activation."""

    def __init__(self, channels: int, num_convs: int, num_boxes: int,
                 max_box_size: int, activation: str = "relu", *,
                 gen: torch.Generator):
        super().__init__()
        self.num_convs = num_convs
        self.activation = activation
        for i in range(num_convs):
            self.add_module(f"box_conv_{i}", BoxConv2d(
                channels, num_boxes, max_box_size, max_box_size, gen=gen))
            act = activation if i < num_convs - 1 else None
            self.add_module(f"proj_conv_{i}", ConvBnLrnDrop(
                channels * num_boxes, channels, (1, 1), activation=act,
                gen=gen))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.relu(x)
        for i in range(self.num_convs):
            # the box responses are f32; the 1x1 conv computes in the
            # block's dtype, as flax's ``dtype=`` casts its input
            with trace("msau.box_conv"):
                y = getattr(self, f"box_conv_{i}")(y)
            y = y.to(x.dtype)
            y = getattr(self, f"proj_conv_{i}")(y)
        y = y + x
        act = get_activation(self.activation)
        return act(y) if act is not None else y


class BMSAUNet(nn.Module):
    """MSAU topology with box-conv residual blocks; NCHW in, NCHW f32
    (logits, aux_logits) out."""

    def __init__(self, cfg: ModelConfig, gen: torch.Generator):
        super().__init__()
        from msau_tpu_torch.models.msau import MSAUNet  # a module cycle

        self.bmsau = MSAUNet(cfg, gen, block_variant="box")

    def forward(self, x: torch.Tensor):
        return self.bmsau(x)
