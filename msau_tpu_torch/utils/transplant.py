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

``torch_state_dict_to_flax`` migrates a checkpoint of the original PyTorch
MSAU (its ``MSAUWrapper`` state_dict, ``msau_net.blocks.{b}...`` keys,
converted to numpy) into the flax tree, exactly as the JAX package's
``utils/transplant.py`` does: conv weights ``[out, in, kh, kw]`` -> HWIO,
``ConvTranspose2d`` weights ``[in, out, kh, kw]`` -> the spatially flipped
HWIO kernel.  Serve the result with ``KVModel.load(params=...)``, which
takes a flax tree through ``flax_to_torch``.
"""

from __future__ import annotations

import re
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


# ---------------------------------------------------------------------------
# migration of the original PyTorch MSAU's checkpoints (numpy only)
# ---------------------------------------------------------------------------
_PREFIX = "msau_net."

# reference key pattern (suffix after "msau_net.blocks.{b}.") -> flax path
# template relative to "net/block_{b}".  {l}=scale layer, {r}=res conv index.
_RULES = [
    (re.compile(r"downsamplingblock\.conv1s\.(\d+)\.conv$"),
     "down/dil_conv_{0}/Conv_0", "conv"),
    (re.compile(r"downsamplingblock\.conv_res_list\.(\d+)\.conv_res_list\.(\d+)\.custom_conv$"),
     "down/res_block_{0}/ConvBnLrnDrop_{1}/Conv_0", "conv"),
    (re.compile(r"downsamplingblock\.conv1_1s\.(\d+)\.custom_conv$"),
     "down/couple_conv_{0}/Conv_0", "conv"),
    (re.compile(r"downsamplingblock\.layer_attentions\.attention_block\.([fgh])\.conv$"),
     "down/attention_{deepest}/{0}", "conv"),
    (re.compile(r"upsamplingblock\.deconvs\.(\d+)\.conv$"),
     "up/deconv_{0}", "deconv"),
    (re.compile(r"upsamplingblock\.conv1s\.(\d+)\.custom_conv$"),
     "up/merge_conv_{0}/Conv_0", "conv"),
    (re.compile(r"upsamplingblock\.conv_res_list\.(\d+)\.conv_res_list\.(\d+)\.custom_conv$"),
     "up/res_block_{0}/ConvBnLrnDrop_{1}/Conv_0", "conv"),
    (re.compile(r"upsamplingblock\.conv1_1s\.(\d+)\.custom_conv$"),
     "up/couple_conv_{0}/Conv_0", "conv"),
]

_BLOCK_RE = re.compile(r"^blocks\.(\d+)\.(.*)$")
_END_RE = re.compile(r"^end_convs\.(\d+)\.custom_conv$")


def _conv_kernel(w: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(w.transpose(2, 3, 1, 0))


def _deconv_kernel(w: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(np.flip(w, (2, 3)).transpose(2, 3, 0, 1))


def _insert(tree: Dict, path: str, leaf_name: str, value: np.ndarray) -> None:
    node = tree
    for part in path.split("/"):
        node = node.setdefault(part, {})
    node[leaf_name] = value


def torch_state_dict_to_flax(
    state_dict: Mapping[str, np.ndarray], scale_space_num: int
) -> Dict:
    """Build ``{"params": {...}}`` for MSAUWrapper from a reference
    state_dict converted to numpy (``{k: v.numpy() for k, v in
    sd.items()}``).

    ``scale_space_num`` determines the deepest layer index (the attention
    module's flax name, ``attention_{S-1}``).  Raises ``KeyError`` on a
    reference key no rule knows and on reference parameters left
    unconverted.
    """
    deepest = scale_space_num - 1
    params: Dict = {"net": {}}
    matched = set()
    for key, value in state_dict.items():
        if not key.startswith(_PREFIX) or not key.endswith(".weight"):
            continue
        stem = key[len(_PREFIX):-len(".weight")]
        bias_key = _PREFIX + stem + ".bias"
        bias = np.asarray(state_dict[bias_key], np.float32)
        w = np.asarray(value, np.float32)

        end = _END_RE.match(stem)
        if end:
            _insert(params["net"], f"end_conv_{end.group(1)}/Conv_0",
                    "kernel", _conv_kernel(w))
            _insert(params["net"], f"end_conv_{end.group(1)}/Conv_0",
                    "bias", bias)
            matched.update((key, bias_key))
            continue

        blk = _BLOCK_RE.match(stem)
        if not blk:
            raise KeyError(f"unrecognized reference key: {key}")
        block_id, rest = blk.group(1), blk.group(2)
        for pat, template, kind in _RULES:
            m = pat.match(rest)
            if not m:
                continue
            path = template
            for i, g in enumerate(m.groups()):
                path = path.replace("{%d}" % i, g)
            path = path.replace("{deepest}", str(deepest))
            full = f"block_{block_id}/{path}"
            kern = _conv_kernel(w) if kind == "conv" else _deconv_kernel(w)
            _insert(params["net"], full, "kernel", kern)
            _insert(params["net"], full, "bias", bias)
            matched.update((key, bias_key))
            break
        else:
            raise KeyError(f"unrecognized reference key: {key}")

    leftovers = [k for k in state_dict if k.startswith(_PREFIX) and k not in matched]
    if leftovers:
        raise KeyError(f"unconverted reference parameters: {leftovers}")
    return {"params": params}
