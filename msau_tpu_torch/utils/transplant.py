"""flax <-> torch weight bridge for the MSAU model.

The port's modules carry the flax tree's names, so a parameter path maps
one to one: ``net/block_0/down/dil_conv_0/Conv_0/kernel`` is
``net.block_0.down.dil_conv_0.Conv_0.weight``.  Only layouts change:

  * conv kernel HWIO ``[kh, kw, in, out]`` <-> torch OIHW ``[out, in, kh, kw]``;
  * deconv kernel (``deconv_{l}``): flax stores it HWIO in correlation
    orientation, the spatial flip of torch's transposed-conv weight
    ``[in, out, kh, kw]``;
  * dense kernel (the LSTM cells' gates) ``[in, out]`` <-> torch
    ``[out, in]``;
  * the box convolution's ``ybox`` / ``xbox`` ``[2, C, B]`` keep their
    name and layout;
  * a BatchNorm's ``scale`` and ``bias`` are parameters on both sides,
    and flax's ``batch_stats`` collection (``mean``, ``var``) maps onto
    the module's buffers of those names.

The flax side is a nested dict of numpy arrays, with or without the outer
``{"params": ...}`` (and ``"batch_stats"`` beside it); the torch side is a
state_dict of tensors.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

BOX_LEAVES = ("ybox", "xbox")
SAME_LEAVES = ("bias", "scale") + BOX_LEAVES   # kept as they are
STAT_LEAVES = ("mean", "var")                  # flax's batch_stats


def _flatten(tree: Mapping, prefix=()) -> Dict[tuple, np.ndarray]:
    out = {}
    for k, v in tree.items():
        if isinstance(v, Mapping):
            out.update(_flatten(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = np.asarray(v)
    return out


def _is_deconv(path) -> bool:
    return len(path) >= 2 and path[-2].startswith("deconv_")


def flax_to_torch(params_np: Mapping) -> Dict[str, torch.Tensor]:
    """flax parameter tree (numpy leaves; with its ``batch_stats`` when the
    variables are given whole) -> torch state_dict."""
    tree = params_np.get("params", params_np)
    sd = {}
    for path, v in _flatten(params_np.get("batch_stats", {})).items():
        if path[-1] not in STAT_LEAVES:
            raise KeyError(f"unexpected flax statistic {'/'.join(path)}")
        sd[".".join(path)] = torch.from_numpy(np.array(v, dtype=np.float32))
    for path, v in _flatten(tree).items():
        leaf = path[-1]
        if leaf == "kernel":
            if v.ndim == 2:
                w = v.T
            elif _is_deconv(path):
                w = np.flip(v, (0, 1)).transpose(2, 3, 0, 1)
            else:
                w = v.transpose(3, 2, 0, 1)
            name = "weight"
        elif leaf in SAME_LEAVES:
            w, name = v, leaf
        else:
            raise KeyError(f"unexpected flax leaf {'/'.join(path)}")
        key = ".".join(path[:-1] + (name,))
        sd[key] = torch.from_numpy(np.array(w, dtype=np.float32, order="C"))
    return sd


def torch_to_flax(state_dict: Mapping[str, torch.Tensor]) -> Dict:
    """torch state_dict -> ``{"params": {...}}`` with numpy leaves, and
    ``"batch_stats"`` where it holds BatchNorm buffers."""
    params: Dict = {}
    stats: Dict = {}
    for key, t in state_dict.items():
        parts = key.split(".")
        v = t.detach().to("cpu", torch.float32).numpy()
        if parts[-1] in STAT_LEAVES:
            node = stats
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = np.ascontiguousarray(v)
            continue
        if parts[-1] == "weight":
            if v.ndim == 2:
                v = v.T
            elif _is_deconv(parts):
                v = np.flip(v.transpose(2, 3, 0, 1), (0, 1))
            else:
                v = v.transpose(2, 3, 1, 0)
            leaf = "kernel"
        elif parts[-1] in SAME_LEAVES:
            leaf = parts[-1]
        else:
            raise KeyError(f"unexpected torch parameter {key}")
        node = params
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[leaf] = np.ascontiguousarray(v)
    return {"params": params, **({"batch_stats": stats} if stats else {})}
