"""Checkpoint files shared by training and serving: ``write_state`` (behind
``Trainer.save`` and ``utils.io.save_checkpoint``) writes
``<dir>/train_state.pt`` holding ``{"step", "params", "opt_state"}``;
``read_state`` (behind ``Trainer.restore`` and ``utils.io.load_checkpoint``)
loads one into a template state; ``KVModel.load(model_weight=)`` reads its
parameters back (``read_params``)."""

from __future__ import annotations

import os
from typing import Any, Mapping

import torch

CHECKPOINT_FILE = "train_state.pt"


def _to_cpu(tree: Any) -> Any:
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu()
    if isinstance(tree, Mapping):
        return {k: _to_cpu(v) for k, v in tree.items()}
    return tree


def write_state(path: str, state) -> str:
    """Write ``state`` (``step``, ``params``, ``opt_state``: a TrainState)
    to ``path/train_state.pt``, tensors on the CPU; the directory is
    created and the file replaced atomically.  Returns the file's path."""
    os.makedirs(path, exist_ok=True)
    blob = {"step": state.step, "params": _to_cpu(state.params),
            "opt_state": _to_cpu(state.opt_state)}
    dst = os.path.join(path, CHECKPOINT_FILE)
    tmp = f"{dst}.{os.getpid()}.tmp"
    torch.save(blob, tmp)
    os.replace(tmp, dst)
    return dst


def _check_like(saved: Any, like: Any, where: str) -> None:
    """Raise unless ``saved`` has ``like``'s structure: the same keys at
    every level and tensors of the same shapes."""
    if isinstance(like, Mapping):
        if not isinstance(saved, Mapping) or set(saved) != set(like):
            got = set(saved) if isinstance(saved, Mapping) else type(saved)
            raise ValueError(f"checkpoint {where}: keys {got} differ from "
                             f"the template's {set(like)}")
        for k in like:
            _check_like(saved[k], like[k], f"{where}/{k}")
    elif isinstance(like, torch.Tensor):
        if not isinstance(saved, torch.Tensor) or saved.shape != like.shape:
            got = saved.shape if isinstance(saved, torch.Tensor) else type(saved)
            raise ValueError(f"checkpoint {where}: {got} differs from the "
                             f"template's {like.shape}")


def _fill(like: Any, saved: Any) -> Any:
    """``saved``'s values in ``like``'s tensors (in place: device and dtype
    stay the template's); other leaves are taken as saved."""
    if isinstance(like, Mapping):
        for k in like:
            like[k] = _fill(like[k], saved[k])
        return like
    if isinstance(like, torch.Tensor):
        with torch.no_grad():
            like.copy_(saved)
        return like
    return saved


def read_state(path: str, template):
    """Load ``path/train_state.pt`` (or the file ``path``) into
    ``template``, a TrainState, in place: every tensor keeps the
    template's device and dtype (its parameters stay the model's own).
    Raises ``ValueError`` on a key or a shape that differs from the
    template's, before anything is written.  Returns the template."""
    if os.path.isdir(path):
        path = os.path.join(path, CHECKPOINT_FILE)
    blob = torch.load(path, map_location="cpu", weights_only=True)
    for part in ("params", "opt_state"):
        _check_like(blob.get(part), getattr(template, part), part)
    _fill(template.params, blob["params"])
    _fill(template.opt_state, blob["opt_state"])
    template.step = blob["step"]
    return template


def read_params(path: str) -> Mapping:
    """The parameters saved at ``path``: a file holding a state dict (or a
    flax tree), or a ``Trainer.save`` checkpoint (its directory or its
    ``train_state.pt``), whose ``"params"`` are taken."""
    if os.path.isdir(path):
        path = os.path.join(path, CHECKPOINT_FILE)
    blob = torch.load(path, map_location="cpu")
    if isinstance(blob, Mapping) and {"params", "opt_state"} <= set(blob):
        return blob["params"]
    return blob
