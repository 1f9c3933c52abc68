"""Training cells: a closed loop of training steps of the port.

Set-up makes the weights and a pool of distinct batches on the device from
the seed, builds the port's training step (``train/trainer.py:
make_train_step``: the MSAU forward, masked CE, backward, clip and Adam
update) around them, and drives its first three steps through the same
call the window makes, on three distinct batches (``first_steps``: each
step's loss, the first step's gradient, the change after the three).  The
window then cycles the pool, each unit one step; it ends in a fetch of the
loss and one parameter element.  After the window the program is freed
and the plain reference (``ReferenceTrainer``) is driven through the same
``first_steps`` from the same weights and batches.
"""

from __future__ import annotations

import dataclasses
import gc
import time
from typing import Dict, List, Optional

import torch

from benchmark import check, counts, generator, weights
from benchmark.reference import msau as ref

FIRST_STEPS = 3


class PortTrainer:
    """The system under test: the port's training step on ``params0``."""

    def __init__(self, config: dict, device: torch.device,
                 params0: Dict[str, torch.Tensor]):
        from msau_tpu_torch.config import ModelConfig, TrainConfig
        from msau_tpu_torch.models.msau import build_model
        from msau_tpu_torch.train.optimizer import make_optimizer
        from msau_tpu_torch.train.trainer import TrainState, make_train_step

        m, t = config["model"], config["train"]
        mc = dataclasses.replace(ModelConfig.from_model_kwargs(m),
                                 use_lrn=m["use_lrn"], **config["program"])
        self.model = build_model(mc, torch.Generator().manual_seed(0)).to(device)
        params = dict(self.model.named_parameters())
        if {k: tuple(v.shape) for k, v in params.items()} != {
                k: tuple(v.shape) for k, v in params0.items()}:
            raise ValueError("the port's parameters are not the reference's")
        with torch.no_grad():
            for k, p in params.items():
                p.copy_(params0[k])
        tc = TrainConfig(optimizer=t["optimizer"],
                         learning_rate=t["learning_rate"],
                         lr_decay_staircase=False,
                         grad_clip_norm=t["grad_clip_norm"],
                         masked_loss=True, loss_aux_weight=t["aux_weight"])
        self.optimizer = make_optimizer(tc)
        self.state = TrainState.create(self.model, self.optimizer)
        self._step = make_train_step(self.model, self.optimizer, masked=True,
                                     aux_weight=t["aux_weight"])
        self.names = list(params0)
        self.clip_norm = t["grad_clip_norm"]
        self.loss: Optional[torch.Tensor] = None

    def step(self, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        self.state, self.metrics = self._step(self.state, batch)
        self.loss = self.metrics["loss"]
        return self.loss

    def first_grad_norms(self) -> torch.Tensor:
        """After one step: the gradient the optimizer chain received, worked
        out from Adam's state: mu / (1 - b1) is the clipped gradient, which
        the raw global norm the step reports scales back."""
        mu = self.state.opt_state["mu"]
        unclip = max(1.0, float(self.metrics["grad_norm"]) / self.clip_norm
                     if self.clip_norm else 1.0)
        return ref.leaf_norms([mu[k] / (1 - ref.ADAM_B1) * unclip
                               for k in self.names])

    def change_norms(self, params0) -> torch.Tensor:
        p = self.state.params
        return ref.leaf_norms([p[k].detach() - params0[k] for k in self.names])

    def sync(self) -> None:
        """Fetch the last loss and one parameter element."""
        float(self.loss)
        float(next(iter(self.state.params.values())).detach().reshape(-1)[0])

    def counters_reset(self) -> None:
        from msau_tpu_torch import ops
        ops.reset_launch_counts()

    def counters(self) -> Dict[str, int]:
        from msau_tpu_torch import ops
        return {**ops.launch_counts(), **ops.general_launch_counts()}


class ReferenceTrainer:
    """The plain reference (``reference/msau.py``) behind the program's
    interface; with ``tf32`` it is the control."""

    def __init__(self, config: dict, device: torch.device,
                 params0: Dict[str, torch.Tensor], tf32: bool = False):
        self.model_cfg = config["model"]
        self.ar = ref.Arith(tf32)
        self.names = list(params0)
        self.params = [params0[k].clone().requires_grad_(True)
                       for k in self.names]
        t = config["train"]
        self.opt = ref.Adam(t["learning_rate"], t["grad_clip_norm"])
        self.first = None
        self.loss = None

    def step(self, batch):
        p = dict(zip(self.names, self.params))
        loss = ref.loss_fn(p, self.model_cfg, batch, self.ar)
        grads = list(torch.autograd.grad(loss, self.params,
                                         materialize_grads=True))
        self.loss = loss.detach()
        del loss, p
        if self.first is None:
            self.first = ref.leaf_norms(grads)
        self.opt.update(self.params, self.opt.clip(grads))
        return self.loss

    def first_grad_norms(self):
        return self.first

    def change_norms(self, params0):
        return ref.leaf_norms([q.detach() - params0[k]
                               for k, q in zip(self.names, self.params)])

    def sync(self):
        float(self.loss)

    def counters_reset(self):
        pass

    def counters(self):
        return {}


def first_steps(trainer, pool: List[dict],
                params0: Dict[str, torch.Tensor]) -> dict:
    """Drive ``trainer`` through ``FIRST_STEPS`` steps on the pool's first
    batches and read what ``check`` compares: each step's loss, every
    leaf's norm of the first step's gradient (read before the second step)
    and of the change the steps made."""
    losses = []
    for i in range(FIRST_STEPS):
        losses.append(trainer.step(pool[i]))
        if i == 0:
            grad = trainer.first_grad_norms()
    change = trainer.change_norms(params0)
    return {"names": list(params0), "loss": [float(x) for x in losses],
            "grad_norm": grad.cpu().tolist(),
            "change_norm": change.cpu().tolist()}


class TrainCell:
    """One run of a training cell.  ``program``: a factory (config,
    device, params0) -> trainer, the port's by default."""

    def __init__(self, config: dict, traffic: dict, seed: int,
                 device: torch.device, program=PortTrainer):
        self.config, self.traffic = config, traffic
        self.seed, self.device = seed, device
        self.program_factory = program

    def setup(self) -> None:
        """Weights, inputs, the program and its first steps; the seconds of
        each go to ``setup_phases``."""
        model = self.config["model"]
        t0 = time.perf_counter()
        gen = torch.Generator(self.device).manual_seed(self.seed)
        self.params0 = weights.make_params(ref.param_shapes(model), gen)
        self.pool = generator.structured_batches(self.traffic, model,
                                                 self.seed, gen)
        if len(self.pool) < FIRST_STEPS:
            raise ValueError(f"a pool of {len(self.pool)} batches: the first "
                             f"{FIRST_STEPS} steps need distinct ones")
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        t1 = time.perf_counter()
        self.program = self.program_factory(self.config, self.device,
                                            self.params0)
        t2 = time.perf_counter()
        self.readings = first_steps(self.program, self.pool, self.params0)
        self.setup_phases = {"inputs": t1 - t0, "program": t2 - t1,
                             "first_steps": time.perf_counter() - t2}
        self.next_batch = FIRST_STEPS

    def unit(self, _i: int = 0) -> None:
        """One training step on the next batch of the pool."""
        self.program.step(self.pool[self.next_batch % len(self.pool)])
        self.next_batch += 1

    def sync(self) -> None:
        self.program.sync()

    def counters_reset(self) -> None:
        self.program.counters_reset()

    def counters(self) -> Dict[str, int]:
        return self.program.counters()

    def work(self) -> dict:
        """What one unit does, counted from shapes."""
        t, model = self.traffic, self.config["model"]
        n, h, w = t["batch"], t["height"], t["width"]
        return {"images": n, "flops": counts.msau_flops(model, n, h, w),
                "attention": counts.attention_shape(model, n, h, w)}

    def free(self) -> None:
        """Drop the program's state; the inputs stay for the reference."""
        self.program = None
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def reference(self) -> dict:
        """The reference's readings from the same weights and batches."""
        return first_steps(ReferenceTrainer(self.config, self.device,
                                            self.params0),
                           self.pool, self.params0)

    def check(self):
        self.ref_readings = self.reference()
        return check.gaps(self.readings, self.ref_readings)


Cell = TrainCell
