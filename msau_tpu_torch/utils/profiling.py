"""Tracing / profiling / metrics logging (port of ``msau_tpu.utils.profiling``).

The reference has only wall-clock prints (trainer.py:99,148) and optional
TensorBoardX scalars.  Here:

* ``StepTimer`` — wall-clock + EMA step timing with a device-sync option
  (an actual device->host fetch of one element).
* ``trace`` — context manager around ``torch.profiler.record_function``
  annotations (a no-op where the annotation cannot be opened).
* ``capture_trace`` — a ``torch.profiler`` run over a block, its trace
  written under ``log_dir`` (``trace.json``, Chrome trace format).
* ``MetricsLogger`` — JSONL scalar logging (always available) with
  optional TensorBoard event writing when a writer lib is importable.

The JAX module's ``start_server`` (a live profiler server) has no torch
counterpart and is not ported.
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from typing import Any, Dict, Optional

import numpy as np
import torch


def _first_tensor(tree: Any) -> Optional[torch.Tensor]:
    """The first tensor leaf of a nested dict / list / tuple, dict keys in
    sorted order (``jax.tree_util.tree_leaves``'s order)."""
    if isinstance(tree, torch.Tensor):
        return tree
    if isinstance(tree, dict):
        tree = [tree[k] for k in sorted(tree)]
    if isinstance(tree, (list, tuple)):
        for item in tree:
            leaf = _first_tensor(item)
            if leaf is not None:
                return leaf
    return None


class StepTimer:
    def __init__(self, ema: float = 0.9):
        self.ema = ema
        self.avg: Optional[float] = None
        self._t0: Optional[float] = None

    def start(self) -> None:
        self._t0 = time.perf_counter()

    def stop(self, sync_on: Any = None) -> float:
        """Returns the step seconds; pass an output tensor (or a tree of
        them) as ``sync_on`` to force real completion via a device->host
        fetch of one element of its first tensor."""
        if sync_on is not None:
            leaf = _first_tensor(sync_on)
            if leaf is not None:
                leaf.detach().reshape(-1)[:1].cpu()
        dt = time.perf_counter() - (self._t0 or time.perf_counter())
        self.avg = dt if self.avg is None else self.ema * self.avg + (1 - self.ema) * dt
        return dt


@contextlib.contextmanager
def trace(name: str, **kwargs):
    """``torch.profiler.record_function`` wrapper (no-op when the
    annotation cannot be opened); keyword arguments go into its record."""
    try:
        rec = torch.profiler.record_function(
            name, json.dumps(kwargs, default=str) if kwargs else None)
        rec.__enter__()
    except Exception:
        rec = None
    try:
        yield
    finally:
        if rec is not None:
            rec.__exit__(None, None, None)


@contextlib.contextmanager
def capture_trace(log_dir: str):
    """Profile the block (CPU, and the card's kernels when one is there)
    and write the trace to ``log_dir/trace.json``."""
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(log_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    prof = profile(activities=activities)
    prof.__enter__()
    try:
        yield log_dir
    finally:
        prof.__exit__(None, None, None)
        prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


class MetricsLogger:
    """JSONL scalars + optional TensorBoard events."""

    def __init__(self, log_dir: str, tensorboard: bool = True):
        os.makedirs(log_dir, exist_ok=True)
        self._f = open(os.path.join(log_dir, "metrics.jsonl"), "a")
        self._tb = None
        if tensorboard:
            try:  # pragma: no cover - optional dep
                from torch.utils.tensorboard import SummaryWriter

                self._tb = SummaryWriter(log_dir)
            except Exception:
                self._tb = None

    def log(self, step: int, metrics: Dict[str, Any]) -> None:
        row = {"step": int(step)}
        for k, v in metrics.items():
            try:
                row[k] = float(v)
            except (TypeError, ValueError):
                continue
        self._f.write(json.dumps(row) + "\n")
        self._f.flush()
        if self._tb is not None:
            for k, v in row.items():
                if k != "step":
                    self._tb.add_scalar(k, v, step)

    def log_image(self, step: int, name: str, image) -> Optional[str]:
        """Write an image (numpy HxW[xC] or PIL) as PNG under log_dir —
        the io_utils.log_matrix TensorBoard-image analog."""
        try:
            from PIL import Image

            if not hasattr(image, "save"):
                arr = np.asarray(image)
                if arr.dtype != np.uint8:
                    lo, hi = float(arr.min()), float(arr.max())
                    arr = ((arr - lo) / (hi - lo + 1e-9) * 255).astype(np.uint8)
                image = Image.fromarray(arr)
            path = os.path.join(
                os.path.dirname(self._f.name), f"{name.replace('/', '_')}_{step}.png"
            )
            image.save(path)
            return path
        except Exception:
            return None

    def close(self) -> None:
        self._f.close()
        if self._tb is not None:
            self._tb.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False
