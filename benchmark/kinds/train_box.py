"""Training cells of the box-convolution MSAU (BMSAU): ``kinds.train``'s
closed loop of the port's training steps, with the box model's weights,
plain reference and counts.

Set-up draws every leaf but the box coordinates with ``weights.
make_params`` (one normal draw on the device), then each box's coordinate
pairs from the same seeded device generator as ``BoxConv2d`` draws them:
a centre ~ U(-max/4, max/4) and a half-size ~ U(1, max/2), y before x.
The program is the port's ``PortTrainer`` (``build_model`` ->
``make_train_step``); the reference, ``reference/bmsau.py`` driven through
the same ``first_steps``, forms each step image by image.

The cell measures the port's box-convolution kernels: a port without them
(no ``box_conv_fwd`` and ``box_conv_bwd`` in ``ops.KERNEL_WRAPPERS``) is
refused before its model is built (``BoxPortTrainer``).  Its box
convolutions would run the banded einsum formulation, whose f32 sums of
whole-plane integral images give box coordinate gradients past the cell's
``grad_gap`` limit on some seeds, as far from the reference as the TF32
control, at a peak of about 69 GiB of device memory.
"""

from __future__ import annotations

import time
from typing import Dict

import torch

from benchmark import box_counts, counts, generator, weights
from benchmark.kinds import train
from benchmark.reference import bmsau as bref


def make_params(model: dict, gen: torch.Generator) -> Dict[str, torch.Tensor]:
    """{name: f32 tensor on ``gen``'s device} in the reference's order."""
    shapes = bref.param_shapes(model)
    out = weights.make_params([(k, s) for k, s in shapes
                               if not bref.is_box_leaf(k)], gen)
    m = float(model["max_box_sizes"])
    for k, s in shapes:
        if bref.is_box_leaf(k):
            center = (torch.rand(s[1:], generator=gen, device=gen.device)
                      * (m / 2.0) - m / 4.0)
            half = (torch.rand(s[1:], generator=gen, device=gen.device)
                    * (m / 2.0 - 1.0) + 1.0)
            out[k] = torch.stack([center - half, center + half])
    return {k: out[k] for k, _ in shapes}


BOX_KERNELS = ("box_conv_fwd", "box_conv_bwd")


class BoxPortTrainer(train.PortTrainer):
    """The port's training step; raises ``RuntimeError`` where the port
    has no box-convolution kernels."""

    def __init__(self, config: dict, device: torch.device,
                 params0: Dict[str, torch.Tensor]):
        from msau_tpu_torch import ops

        missing = [k for k in BOX_KERNELS if k not in ops.KERNEL_WRAPPERS]
        if missing:
            raise RuntimeError(
                "this cell measures the port's box-convolution kernels, and "
                f"the port has no {', '.join(missing)} in "
                "ops.KERNEL_WRAPPERS: nothing is measured")
        super().__init__(config, device, params0)


class BoxReferenceTrainer(train.ReferenceTrainer):
    """The plain BMSAU reference behind the program's interface, each step
    formed image by image; with ``tf32`` it is the control."""

    def step(self, batch):
        p = dict(zip(self.names, self.params))
        loss, grads = bref.loss_and_grads(p, self.model_cfg, batch, self.ar,
                                          train.ref.attention)
        self.loss = loss
        if self.first is None:
            self.first = train.ref.leaf_norms(grads)
        self.opt.update(self.params, self.opt.clip(grads))
        return self.loss


class BoxTrainCell(train.TrainCell):
    """One run of a BMSAU training cell; ``program`` as in
    ``train.TrainCell``, ``BoxPortTrainer`` by default."""

    reference_trainer = BoxReferenceTrainer

    def __init__(self, config: dict, traffic: dict, seed: int,
                 device: torch.device, program=BoxPortTrainer):
        super().__init__(config, traffic, seed, device, program=program)

    def setup(self) -> None:
        model = self.config["model"]
        t0 = time.perf_counter()
        gen = torch.Generator(self.device).manual_seed(self.seed)
        self.params0 = make_params(model, gen)
        self.pool = generator.structured_batches(self.traffic, model,
                                                 self.seed, gen)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        t1 = time.perf_counter()
        self.program = self.program_factory(self.config, self.device,
                                            self.params0)
        t2 = time.perf_counter()
        self.readings = train.first_steps(self.program, self.pool, self.params0)
        self.setup_phases = {"inputs": t1 - t0, "program": t2 - t1,
                             "first_steps": time.perf_counter() - t2}
        self.next_batch = train.FIRST_STEPS

    def work(self) -> dict:
        """What one unit does, counted from shapes; ``box``: the shape of
        every box convolution of a step."""
        t, model = self.traffic, self.config["model"]
        n, h, w = t["batch"], t["height"], t["width"]
        return {"images": n, "flops": box_counts.bmsau_flops(model, n, h, w),
                "attention": counts.attention_shape(model, n, h, w),
                "box": box_counts.box_calls(model, n, h, w)}

    def reference(self) -> dict:
        return train.first_steps(
            self.reference_trainer(self.config, self.device, self.params0),
            self.pool, self.params0)


Cell = BoxTrainCell
