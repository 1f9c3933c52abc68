"""Checkpoint files shared by training and serving: ``Trainer.save``
writes ``<dir>/train_state.pt`` holding ``{"step", "params", "opt_state"}``;
``KVModel.load(model_weight=)`` reads its parameters back."""

from __future__ import annotations

import os
from typing import Mapping

import torch

CHECKPOINT_FILE = "train_state.pt"


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
