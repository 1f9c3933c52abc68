"""Optimizer chain of ``msau_tpu.train.optimizer``, written out in torch.

The JAX package chains optax transforms: ``clip_by_global_norm`` ->
``add_decayed_weights`` -> ``adam`` | ``rmsprop`` | ``sgd(momentum)``, with a
constant or staircase learning rate.  ``Optimizer`` applies the same chain
with optax's formulas, which differ from ``torch.optim``'s defaults:

  * clip: g * max_norm / norm only when norm >= max_norm (no epsilon);
  * Adam: mu_hat / (sqrt(nu_hat) + eps), eps 1e-8 outside the root, bias
    corrected by 1 - b**t formed in f32;
  * RMSprop: decay 0.9, g / sqrt(nu + eps) with eps *inside* the root, no
    centring, nu starting at 0;
  * momentum: trace = g + m * trace, update = -lr * trace;
  * the schedule reads the update count before the update (lr(0) first).

The state is a dict of per-parameter buffers keyed like the parameters
plus the update count (a host int, so no step reads the card).  Parameters
and buffers are updated in place (``torch._foreach_*``): no second copy of
the model is made.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Union

import numpy as np
import torch

from msau_tpu_torch.config import TrainConfig

Schedule = Callable[[int], float]


def staircase_schedule(
    base_lr: float,
    decay_rate: float = 0.95,
    decay_every_epochs: int = 10,
    steps_per_epoch: int = 1024,
) -> Schedule:
    """lr(step) = base * decay_rate ** (epoch // decay_every_epochs)."""

    def schedule(step: int) -> float:
        epoch = step // steps_per_epoch
        return base_lr * decay_rate ** (epoch // decay_every_epochs)

    return schedule


def global_norm(tensors) -> torch.Tensor:
    """sqrt of the sum of squares of every element (a 0-d tensor)."""
    return torch.linalg.vector_norm(torch.stack(torch._foreach_norm(tensors)))


class Optimizer:
    """clip_by_global_norm -> add_decayed_weights -> adam | rmsprop |
    momentum, over a dict of f32 parameters."""

    BUFFERS = {"adam": ("mu", "nu"), "rmsprop": ("nu",), "momentum": ("trace",)}

    def __init__(self, name: str, learning_rate: Union[float, Schedule], *,
                 clip_norm: float = 0.0, weight_decay: float = 0.0,
                 momentum: float = 0.9):
        if name not in self.BUFFERS:
            raise ValueError(f"unknown optimizer {name!r}")
        self.name = name
        self.lr = learning_rate if callable(learning_rate) else (
            lambda _step, lr=learning_rate: lr)
        self.clip_norm = clip_norm
        self.weight_decay = weight_decay
        self.momentum = momentum

    def init(self, params: Dict[str, torch.Tensor]) -> Dict:
        state = {"count": 0}
        for buf in self.BUFFERS[self.name]:
            state[buf] = {k: torch.zeros_like(p) for k, p in params.items()}
        return state

    @torch.no_grad()
    def update(self, grads: Dict[str, torch.Tensor], state: Dict,
               params: Dict[str, torch.Tensor]) -> torch.Tensor:
        """Apply one update to ``params`` and ``state`` in place (``grads``
        is consumed); returns the raw gradients' global norm."""
        names = list(params)
        p = [params[k] for k in names]
        g = [grads[k] for k in names]
        norm = global_norm(g)
        if self.clip_norm and self.clip_norm > 0:
            coef = torch.where(norm < self.clip_norm, torch.ones_like(norm),
                               self.clip_norm / norm)
            torch._foreach_mul_(g, coef)
        if self.weight_decay and self.weight_decay > 0:
            torch._foreach_add_(g, p, alpha=self.weight_decay)
        count = state["count"]
        lr = self.lr(count)
        if self.name == "adam":
            b1, b2, eps = 0.9, 0.999, 1e-8
            mu = [state["mu"][k] for k in names]
            nu = [state["nu"][k] for k in names]
            torch._foreach_mul_(mu, b1)
            torch._foreach_add_(mu, g, alpha=1 - b1)
            torch._foreach_mul_(nu, b2)
            torch._foreach_addcmul_(nu, g, g, value=1 - b2)
            # optax forms 1 - b**t in f32: at small t that rounding is
            # ~1e-5 of the correction, so it is kept
            t = np.float32(count + 1)
            bc1 = float(np.float32(1) - np.float32(b1) ** t)
            bc2 = float(np.float32(1) - np.float32(b2) ** t)
            denom = torch._foreach_div(nu, bc2)
            torch._foreach_sqrt_(denom)
            torch._foreach_add_(denom, eps)
            upd = torch._foreach_div(mu, bc1)
            torch._foreach_div_(upd, denom)
        elif self.name == "rmsprop":
            decay, eps = 0.9, 1e-8
            nu = [state["nu"][k] for k in names]
            torch._foreach_mul_(nu, decay)
            torch._foreach_addcmul_(nu, g, g, value=1 - decay)
            denom = torch._foreach_add(nu, eps)
            torch._foreach_sqrt_(denom)
            upd = torch._foreach_div(g, denom)
        else:
            upd = [state["trace"][k] for k in names]
            torch._foreach_mul_(upd, self.momentum)
            torch._foreach_add_(upd, g)
        torch._foreach_add_(p, upd, alpha=-lr)
        state["count"] = count + 1
        return norm


def make_optimizer(cfg: TrainConfig,
                   steps_per_epoch: Optional[int] = None) -> Optimizer:
    """The optimizer ``cfg`` names, as ``msau_tpu.train.make_optimizer``."""
    steps_per_epoch = steps_per_epoch or cfg.batch_steps_per_epoch
    if cfg.lr_decay_staircase:
        lr = staircase_schedule(cfg.learning_rate, cfg.lr_decay_rate,
                                cfg.lr_decay_every_epochs, steps_per_epoch)
    else:
        lr = cfg.learning_rate
    name = cfg.optimizer.lower()
    return Optimizer("adam" if name not in ("momentum", "rmsprop") else name,
                     lr, clip_norm=cfg.grad_clip_norm,
                     weight_decay=cfg.weight_decay, momentum=cfg.momentum)
