"""Seeded state dicts in the layout of the original PyTorch MSAU, for
testing and driving the checkpoint migration
(``utils.transplant.torch_state_dict_to_flax``) without the reference's
code; shared by the tests and ``chip_smoke.py``.  The serve and train
paths never build one.

The layout is the reference ``MSAUWrapper``'s: ``msau_net.blocks.{b}...``
and ``msau_net.end_convs.{b}...`` keys, each a ``.weight`` with its
``.bias``; conv weights ``[out, in, kh, kw]``, ``ConvTranspose2d`` weights
``[in, out, kh, kw]``.  The keys are the inverse of the migration's rules
applied to the port's parameter names (which are the flax tree's), so a
migrated dict has the model's tree by construction of those rules; values
are drawn from a numpy Generator with PyTorch's default conv init
(uniform in +-1/sqrt(fan_in), fan_in from dimension 1 times the kernel
area).
"""

from __future__ import annotations

import re
from typing import Dict, List, Tuple

import numpy as np
import torch

from msau_tpu_torch.config import ModelConfig
from msau_tpu_torch.utils.transplant import _PREFIX, _RULES


def _inverse_rules() -> List[Tuple[re.Pattern, str]]:
    """(regex over a flax path below ``block_{b}``, reference key suffix
    with ``{}`` for each of the rule's groups), one per rule."""
    out = []
    for pat, template, _ in _RULES:
        rx = re.escape(template)
        rx = re.sub(r"\\\{\d\\\}", "([^/]+)", rx)
        rx = rx.replace(r"\{deepest\}", r"\d+")
        suffix = re.sub(r"\((?:\\d\+|\[fgh\])\)", "{}", pat.pattern)
        out.append((re.compile(rx + "$"), suffix.replace("\\.", ".").rstrip("$")))
    return out


def reference_key(port_name: str) -> str:
    """The reference key of one of the port's parameter names
    (``net.block_0.down.dil_conv_0.Conv_0.weight`` ->
    ``msau_net.blocks.0.downsamplingblock.conv1s.0.conv.weight``)."""
    parts = port_name.split(".")
    if parts[0] != "net" or parts[-1] not in ("weight", "bias"):
        raise KeyError(f"no reference key for {port_name}")
    leaf, top = parts[-1], parts[1]
    end = re.fullmatch(r"end_conv_(\d+)", top)
    if end and parts[2:-1] == ["Conv_0"]:
        return f"{_PREFIX}end_convs.{end.group(1)}.custom_conv.{leaf}"
    blk = re.fullmatch(r"block_(\d+)", top)
    if blk:
        path = "/".join(parts[2:-1])
        for rx, suffix in _inverse_rules():
            m = rx.match(path)
            if m:
                return (f"{_PREFIX}blocks.{blk.group(1)}."
                        f"{suffix.format(*m.groups())}.{leaf}")
    raise KeyError(f"no reference key for {port_name}")


def reference_state_dict(config: ModelConfig, seed: int = 0
                         ) -> Dict[str, np.ndarray]:
    """A seeded reference-layout state dict (f32 numpy) for ``config``; the
    shapes are the port's model's (its torch layouts are the reference's:
    OIHW convs, ``[in, out, kh, kw]`` deconvs)."""
    from msau_tpu_torch.models.msau import build_model

    model = build_model(config, torch.Generator().manual_seed(0))
    shapes = {reference_key(name): tuple(p.shape)
              for name, p in model.named_parameters()}
    rng = np.random.default_rng(seed)
    sd = {}
    for key in sorted(shapes):
        if not key.endswith(".weight"):
            continue
        stem = key[:-len(".weight")]
        w_shape = shapes[key]
        bound = 1.0 / np.sqrt(w_shape[1] * int(np.prod(w_shape[2:])))
        sd[key] = rng.uniform(-bound, bound, w_shape).astype(np.float32)
        sd[stem + ".bias"] = rng.uniform(
            -bound, bound, shapes[stem + ".bias"]).astype(np.float32)
    return sd
