"""Training loop of the port: train / eval steps, the fit loop, checkpoints
(port of ``msau_tpu.train.trainer``, at every ``flat_scales``, on one
device or one rank of a mesh).

The state's parameters are the model's own ``nn.Parameter``s, updated in
place by the optimizer (PyTorch is eager and has no donation: in-place
updates are what keeps one copy of the weights).  The step computes the
loss on the network's channel-major logits [N, C, H*W] (``logits_layout=
"BODY"``, as the JAX step does at ``flat_scales > 0``), so the masked loss
takes the fused CE op (``ops.ce_loss``); the deepest-scale attention runs
its autograd op (``ops.attention``) and the flat scales (``flat_scales >
0``) their ops' backward (``ops.flatconv``, ``ops.flatres``): on a card
all of them are hand-written CUDA kernels.  Metrics stay on the device:
nothing in a step waits for it.

Checkpoints are ``torch.save`` files holding the full train state (step,
parameters and optimizer buffers), so a restore resumes training exactly.

Under a mesh (``parallel.make_mesh``: one process per device) every rank
holds the whole model and its slice of the global batch
(``parallel.shard_batch``): a block of images on the ``data`` axis and,
with a ``spatial`` axis, a block of rows (the model's halos and deep
scales then come from the spatial group).  The losses divide each rank's
sums by counts summed over the world, the gradients are summed over the
world in one flat buffer in the parameters' fixed order, and so are the
metrics: every rank applies the same update to the same bits and reads
the global loss.
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

from msau_tpu_torch.config import ModelConfig, TrainConfig
from msau_tpu_torch.models.msau import MSAUWrapper, build_model
from msau_tpu_torch.parallel import sharding as psh
from msau_tpu_torch.train.loss import masked_cross_entropy, unet_loss
from msau_tpu_torch.train.optimizer import Optimizer, make_optimizer
from msau_tpu_torch.utils.checkpoint import read_state, write_state
from msau_tpu_torch.utils.profiling import trace, trace_allocs


@dataclasses.dataclass
class TrainState:
    """step: updates done; params: the model's parameters by name;
    opt_state: the optimizer's buffers and update count."""

    step: int
    params: Dict[str, torch.Tensor]
    opt_state: Dict[str, Any]

    @classmethod
    def create(cls, model: torch.nn.Module, optimizer: Optimizer) -> "TrainState":
        params = dict(model.named_parameters())
        return cls(step=0, params=params, opt_state=optimizer.init(params))


def _loss(model: MSAUWrapper, batch, masked: bool, aux_weight: float,
          sum_ranks=None):
    """The step's loss and metrics on the network's channel-major logits
    [N, C, H*W]: the masked loss takes the fused CE op.  ``sum_ranks``
    makes the counts global (``train.loss``)."""
    _, logits, aux = model(batch["input"], logits_layout="BODY")
    n = logits.shape[0]
    labels = batch["label"].reshape(n, -1)
    valid = batch.get("valid")
    valid = None if valid is None else valid.reshape(n, -1)
    if masked:
        return masked_cross_entropy(logits, aux, labels, valid, channel_axis=1,
                                    sum_ranks=sum_ranks)
    return unet_loss(logits, labels, aux_logits=aux, valid=valid,
                     aux_weight=aux_weight, channel_axis=1,
                     sum_ranks=sum_ranks)


def _summed_metrics(metrics: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Each rank's share of the metrics -> the global metrics."""
    return dict(zip(metrics, psh.sum_flat(list(metrics.values()))))


def make_loss_and_grad(model: MSAUWrapper, *, masked: bool = True,
                       aux_weight: float = 0.5,
                       sum_ranks: Optional[Callable] = None) -> Callable:
    """batch -> (loss, metrics, grads by parameter name); the value and
    gradient of the step's loss at the model's current parameters
    (``jax.value_and_grad(loss_fn, has_aux=True)``).

    batch: {"input": [N, H, W, C], "label": [N, H, W] int, "valid":
    [N, H, W] bool (optional)}.  ``sum_ranks`` (``parallel.sharding.
    sum_over_ranks``, on a mesh): the counts, the gradients (one flat
    buffer) and the metrics are summed over the ranks.
    """
    names, params = zip(*model.named_parameters())

    def loss_and_grad(batch):
        with trace("msau.forward"):
            loss, metrics = _loss(model, batch, masked, aux_weight, sum_ranks)
        # the last stage's attention feeds only a next stage, which does
        # not exist: its parameters get zero gradients, as under jax.grad;
        # the span is the host's wait while autograd's device thread
        # enqueues the backward
        with trace("msau.backward"):
            grads = torch.autograd.grad(loss, params, materialize_grads=True)
        metrics = {k: v.detach() for k, v in metrics.items()}
        if sum_ranks is not None:
            grads = psh.sum_flat(grads)
            metrics = _summed_metrics(metrics)
            loss = metrics["loss"]
        return loss.detach(), metrics, dict(zip(names, grads))

    return loss_and_grad


def make_train_step(model: MSAUWrapper, optimizer: Optimizer, *,
                    masked: bool = True, aux_weight: float = 0.5,
                    donate: bool = True,
                    sum_ranks: Optional[Callable] = None) -> Callable:
    """(state, batch) -> (state, metrics) with metrics["grad_norm"] the raw
    gradients' global norm.  ``state.params`` must be the model's own
    parameters (``TrainState.create``); they and ``state.opt_state`` are
    updated in place.  ``donate`` is a TPU knob, accepted and ignored;
    ``sum_ranks`` as in ``make_loss_and_grad``.

    While a torch profiler records, the step opens the spans
    ``msau.train_step`` (counting the allocator's device calls) and, in
    it, ``msau.forward``, ``msau.backward`` and ``msau.update``
    (``utils.profiling.trace``)."""
    del donate
    loss_and_grad = make_loss_and_grad(model, masked=masked,
                                       aux_weight=aux_weight,
                                       sum_ranks=sum_ranks)
    first = next(model.parameters())

    def step(state: TrainState, batch) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        with trace_allocs("msau.train_step", first):
            _, metrics, grads = loss_and_grad(batch)
            with trace("msau.update"):
                metrics["grad_norm"] = optimizer.update(
                    grads, state.opt_state, state.params)
        state.step += 1
        return state, metrics

    return step


def make_eval_step(model: MSAUWrapper, *, masked: bool = True,
                   sum_ranks: Optional[Callable] = None) -> Callable:
    """(params, batch) -> metrics, with no gradient; ``params`` are the
    model's own parameters (the state's), which the forward reads;
    ``sum_ranks``: the global metrics of a mesh."""

    @torch.no_grad()
    def step(params: Dict[str, torch.Tensor], batch) -> Dict[str, torch.Tensor]:
        if next(iter(params.values())) is not next(model.parameters()):
            raise ValueError("eval step: params are not the model's own")
        metrics = _loss(model, batch, masked, 0.5, sum_ranks)[1]
        return metrics if sum_ranks is None else _summed_metrics(metrics)

    return step


class Trainer:
    """Host loop around the step on one device, or on this rank's device of
    ``mesh``.

    ``data_provider`` exposes ``next_data(split)`` returning a batch dict of
    numpy arrays (None when exhausted) and optionally ``size_val``, the
    protocol of the reference generators.  ``device`` is required: the
    trainer never picks one.  ``mesh`` (``parallel.make_mesh``, axes
    ``data`` and optionally ``spatial``): every rank builds the same
    Trainer and feeds it the same global batches; ``put_batch`` keeps the
    rank's slice, and ``fit`` logs and writes checkpoints on rank 0 only.
    A flat model on a spatial axis of more than one rank needs
    ``spatial_shards`` equal to its size (ValueError).
    ``TrainConfig``'s ``matmul_precision``, ``donate_state`` and mesh
    fields are TPU knobs, accepted and ignored (f32 stays full f32: TF32
    is off, see ``msau_tpu_torch/__init__.py``).
    """

    def __init__(self, model_config: ModelConfig,
                 train_config: Optional[TrainConfig] = None, mesh=None, *,
                 device):
        sp = 1 if mesh is None else psh.axis_size(mesh, "spatial")
        if (sp > 1 and model_config.flat_scales > 0
                and model_config.spatial_shards != sp):
            # the per-shard rows and the entry split must be the mesh's
            raise ValueError(
                "flat_scales > 0 on a spatial-sharded mesh requires "
                f"model_config.spatial_shards == mesh spatial size ({sp}); "
                f"got {model_config.spatial_shards}")
        self.model_config = model_config
        self.cfg = train_config or TrainConfig()
        self.device = torch.device(device)
        self.mesh = mesh
        self.model = build_model(
            model_config, torch.Generator().manual_seed(self.cfg.seed)
        ).to(self.device)
        if mesh is not None:
            self.model.set_spatial_group(psh.axis_group(mesh, "spatial"))
        self.optimizer = make_optimizer(self.cfg)
        self._make_steps()
        self.state: Optional[TrainState] = None

    def _make_steps(self) -> None:
        sum_ranks = None if self.mesh is None else psh.sum_over_ranks
        self.train_step = make_train_step(
            self.model, self.optimizer, masked=self.cfg.masked_loss,
            aux_weight=self.cfg.loss_aux_weight, sum_ranks=sum_ranks)
        self.eval_step = make_eval_step(self.model, masked=self.cfg.masked_loss,
                                        sum_ranks=sum_ranks)

    # ------------------------------------------------------------------
    def init_state(self, sample_input: np.ndarray,
                   seed: Optional[int] = None) -> TrainState:
        """Fresh f32 parameters drawn from ``seed`` (default ``cfg.seed``)
        on the CPU, so a seed gives the same weights on every device, and a
        fresh optimizer state.  ``sample_input`` [N, H, W, C] is checked
        against the model's input channels.  On a mesh, every rank then
        takes rank 0's parameters."""
        seed = self.cfg.seed if seed is None else seed
        if np.shape(sample_input)[-1] != self.model_config.img_channels:
            raise ValueError(f"sample input has {np.shape(sample_input)[-1]} "
                             f"channels, the model "
                             f"{self.model_config.img_channels}")
        fresh = build_model(self.model_config, torch.Generator().manual_seed(seed))
        self.model.load_state_dict(fresh.state_dict())
        if self.mesh is not None:
            psh.broadcast_flat(list(self.model.parameters()))
        self.state = TrainState.create(self.model, self.optimizer)
        return self.state

    def put_batch(self, batch: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
        """The batch on the device; on a mesh, this rank's slice of it."""
        if self.mesh is not None:
            return psh.shard_batch(batch, self.mesh, device=self.device)
        return {k: torch.as_tensor(np.asarray(v)).to(self.device)
                for k, v in batch.items()}

    # ------------------------------------------------------------------
    def fit(
        self,
        data_provider,
        output_path: Optional[str] = None,
        epochs: Optional[int] = None,
        batch_steps_per_epoch: Optional[int] = None,
        restore_path: Optional[str] = None,
        log_fn: Callable[[str], None] = print,
        log_dir: Optional[str] = None,
    ) -> Dict[str, list]:
        """Queue-fed training with a per-epoch validation sweep and
        best-val-loss checkpoints (reference Trainer.train contract).
        ``log_dir``: per-epoch train and val scalars go to
        ``log_dir/metrics.jsonl`` (``utils.profiling.MetricsLogger``).  On
        a mesh every rank steps and only rank 0 logs, writes metrics and
        checkpoints."""
        epochs = epochs if epochs is not None else self.cfg.epochs
        steps = batch_steps_per_epoch or self.cfg.batch_steps_per_epoch
        if steps != self.cfg.batch_steps_per_epoch and self.cfg.lr_decay_staircase:
            # the staircase decays by epoch: an overridden epoch length must
            # reach the schedule; the state's layout is unchanged
            self.optimizer = make_optimizer(self.cfg, steps_per_epoch=steps)
            self._make_steps()
        if restore_path:
            self.restore(restore_path)
        if self.state is None:
            raise RuntimeError("call init_state() first")

        if self.mesh is not None and torch.distributed.get_rank() != 0:
            log_fn = lambda _msg: None   # rank 0 logs and checkpoints
            output_path = log_dir = None
        metrics_logger = None
        if log_dir:
            from msau_tpu_torch.utils.profiling import MetricsLogger

            metrics_logger = MetricsLogger(log_dir)

        history = {"train_loss": [], "val_loss": [], "train_acc": [], "val_acc": []}
        best_val = float("inf")
        next_batch = data_provider.next_data("train")
        for epoch in range(epochs):
            t0 = time.time()
            agg: Dict[str, torch.Tensor] = {}
            n_steps = 0
            if next_batch is None:  # retry once per epoch
                next_batch = data_provider.next_data("train")
            for _ in range(steps):
                batch = next_batch
                if batch is None:
                    break
                self.state, metrics = self.train_step(self.state,
                                                      self.put_batch(batch))
                n_steps += 1
                # the next batch is made while the card runs this step;
                # metrics stay on the device until the epoch ends
                next_batch = data_provider.next_data("train")
                for k, v in metrics.items():
                    agg[k] = agg[k] + v if k in agg else v
            if n_steps == 0:
                log_fn("No training data available; stopping.")
                break
            train_loss = float(agg.get("loss", 0.0)) / n_steps
            train_acc = float(agg.get("accuracy", 0.0)) / n_steps
            history["train_loss"].append(train_loss)
            history["train_acc"].append(train_acc)
            log_fn(f"TRAIN epoch {epoch + 1}: loss={train_loss:.6f} "
                   f"acc={train_acc:.6f} time={time.time() - t0:.2f}s")
            if metrics_logger:
                metrics_logger.log(
                    self.state.step,
                    {"train/loss": train_loss, "train/accuracy": train_acc,
                     "epoch": epoch + 1},
                )

            val_size = getattr(data_provider, "size_val", 0)
            if val_size:
                vagg: Dict[str, float] = {}
                vn = 0
                for _ in range(val_size):
                    batch = data_provider.next_data("val")
                    if batch is None:
                        break
                    metrics = self.eval_step(self.state.params,
                                             self.put_batch(batch))
                    vn += 1
                    for k, v in metrics.items():
                        vagg[k] = vagg.get(k, 0.0) + float(v)
                if vn:
                    val_loss = vagg.get("loss", 0.0) / vn
                    val_acc = vagg.get("accuracy", 0.0) / vn
                    history["val_loss"].append(val_loss)
                    history["val_acc"].append(val_acc)
                    log_fn(f"VAL   epoch {epoch + 1}: loss={val_loss:.6f} "
                           f"acc={val_acc:.6f}")
                    if metrics_logger:
                        metrics_logger.log(
                            self.state.step,
                            {"val/loss": val_loss, "val/accuracy": val_acc},
                        )
                    if output_path and (
                        val_loss < best_val
                        or (epoch + 1) % self.cfg.checkpoint_every_epochs == 0
                    ):
                        best_val = min(best_val, val_loss)
                        self.save(os.path.join(output_path, f"model{epoch + 1}"))
            elif output_path and (epoch + 1) % self.cfg.checkpoint_every_epochs == 0:
                self.save(os.path.join(output_path, f"model{epoch + 1}"))
        if metrics_logger:
            metrics_logger.close()
        self.wait_for_checkpoints()
        return history

    # ------------------------------------------------------------------
    # checkpoints: torch.save of the full train state, written synchronously
    # ------------------------------------------------------------------
    def save(self, path: str, wait: bool = False) -> None:
        """Write the train state to ``path/train_state.pt``
        (``utils.checkpoint.write_state``: the directory is created, the
        file replaced atomically).  The write is synchronous, so ``wait``
        has nothing to wait for."""
        del wait
        write_state(path, self.state)

    def wait_for_checkpoints(self) -> None:
        """Checkpoints are written synchronously: nothing is pending."""

    def restore(self, path: str) -> TrainState:
        """Load a ``save``d state into the current one, in place (the
        model's parameters stay the state's; ``utils.checkpoint.read_state``
        raises on a key or shape that differs)."""
        if self.state is None:
            raise RuntimeError("init_state() before restore, for structure")
        return read_state(path, self.state)
