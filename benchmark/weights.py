"""Initial weights of an MSAU, made by the benchmark from the seed.

One normal draw on the device for all parameters, then each leaf scaled as
the reference initialises it (``model/layers``, initOpt 0): conv weights
N(0, sqrt(2 / (kh kw cin + cout))), transposed-conv weights [in, out, kh,
kw] with (out, in) in that formula's places, biases N(0.1, 1e-5); the
attention's 1x1 projections lecun-normal (std sqrt(1 / cin)) with zero
biases.  The program and the reference get the same tensors.
"""

from __future__ import annotations

import math
from typing import Dict, Sequence, Tuple

import torch


def _scale(name: str, shape: Tuple[int, ...]) -> Tuple[float, float]:
    """(std, mean) of a leaf by its layer name and shape."""
    attention = ".attention_" in name
    if name.endswith(".bias"):
        return (0.0, 0.0) if attention else (1e-5, 0.1)
    if attention:
        return math.sqrt(1.0 / math.prod(shape[1:])), 0.0
    if ".deconv_" in name:
        cin, cout, kh, kw = shape
    else:
        cout, cin, kh, kw = shape
    return math.sqrt(2.0 / (kh * kw * cin + cout)), 0.0


def make_params(shapes: Sequence[Tuple[str, Tuple[int, ...]]],
                gen: torch.Generator) -> Dict[str, torch.Tensor]:
    """{name: f32 tensor on ``gen``'s device} for (name, shape) pairs."""
    total = sum(math.prod(s) for _, s in shapes)
    flat = torch.randn(total, generator=gen, device=gen.device)
    out, off = {}, 0
    for name, shape in shapes:
        size = math.prod(shape)
        std, mean = _scale(name, tuple(shape))
        out[name] = (flat[off:off + size] * std + mean).view(shape)
        off += size
    return out
