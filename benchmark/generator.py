"""The one traffic generator: training batches drawn from the seed by the
parameters of a traffic file (``benchmark/traffic/<name>.json``).

A batch is the structured chargrid batch of the repository's synthetic
data (``make_structured_batch``): Gaussian noise of std ``noise`` on every
input channel, and ``rects`` rectangles per image, each of a class c drawn
from 1 ... n_class - 1, labelled c and adding 1 to input channel
c % channels, so the labels are recoverable from the input and the masked
loss falls.  The rectangles come from a numpy generator seeded with the
seed; the noise is drawn on the device, in one call per batch, from the
benchmark's device generator.  Every seed gives the same shapes.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch


def structured_batches(traffic: dict, model: dict, seed: int,
                       gen: torch.Generator) -> List[Dict[str, torch.Tensor]]:
    """``traffic["pool"]`` distinct batches {"input": [N, H, W, C] f32,
    "label": [N, H, W] int32} on ``gen``'s device."""
    n, hh, ww = traffic["batch"], traffic["height"], traffic["width"]
    ch, ncls = model["img_channels"], model["n_class"]
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(traffic["pool"]):
        x = torch.randn((n, hh, ww, ch), generator=gen, device=gen.device)
        x.mul_(traffic["noise"])
        label = np.zeros((n, hh, ww), np.int32)
        for b in range(n):
            for _ in range(traffic["rects"]):
                c = int(rng.integers(1, ncls))
                rh = int(rng.integers(max(hh // 16, 2), max(hh // 4, 3)))
                rw = int(rng.integers(max(ww // 16, 2), max(ww // 4, 3)))
                y0 = int(rng.integers(0, hh - rh))
                x0 = int(rng.integers(0, ww - rw))
                label[b, y0:y0 + rh, x0:x0 + rw] = c
                x[b, y0:y0 + rh, x0:x0 + rw, c % ch] += 1.0
        out.append({"input": x,
                    "label": torch.from_numpy(label).to(gen.device)})
    return out
