"""Tracing / profiling / metrics logging (port of ``msau_tpu.utils.profiling``).

The reference has only wall-clock prints (trainer.py:99,148) and optional
TensorBoardX scalars.  Here:

* ``StepTimer`` — wall-clock + EMA step timing with a device-sync option
  (an actual device->host fetch of one element).
* ``trace`` — a span: on exactly while a torch profiler records, it opens
  a ``torch.profiler.record_function`` (on the profiler's clock, beside the
  kernels) and adds its call and host time to a process-wide registry
  (``span_totals``); ``trace_allocs`` also counts the caching allocator's
  device calls over the span (``counter_totals``).  With no profiler a
  span is one check.
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
from typing import Any, Dict, List, Optional, Tuple

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


# span name -> [calls, host ns]; counter name -> value.  Filled only while
# a profiler records, so a process that profiles one window holds that
# window alone.
_SPANS: Dict[str, List[int]] = {}
_COUNTERS: Dict[str, int] = {}
_recording = torch.autograd._profiler_enabled


def span_totals() -> Dict[str, Tuple[int, float]]:
    """{span name: (calls, host seconds)} of the spans closed while a
    profiler recorded."""
    return {k: (calls, ns * 1e-9) for k, (calls, ns) in _SPANS.items()}


def counter_totals() -> Dict[str, int]:
    """{counter name: value} added while a profiler recorded."""
    return dict(_COUNTERS)


def reset_spans() -> None:
    """Clear the spans' and the counters' totals."""
    _SPANS.clear()
    _COUNTERS.clear()


class trace:
    """A span over a block.  While a torch profiler records
    (``torch.autograd._profiler_enabled()``), it opens
    ``torch.profiler.record_function(name)``, keyword arguments in its
    record, and adds one call and its host nanoseconds to
    ``span_totals()[name]``; otherwise it checks that and does nothing
    else."""

    __slots__ = ("name", "kwargs", "_rec", "_t0")

    def __init__(self, name: str, **kwargs):
        self.name = name
        self.kwargs = kwargs
        self._rec = None

    def __enter__(self) -> None:
        if _recording():
            self._rec = torch.profiler.record_function(
                self.name,
                json.dumps(self.kwargs, default=str) if self.kwargs else None)
            self._rec.__enter__()
            self._t0 = time.perf_counter_ns()

    def __exit__(self, *exc) -> None:
        if self._rec is not None:
            ns = time.perf_counter_ns() - self._t0
            self._rec.__exit__(*exc)
            self._rec = None
            total = _SPANS.setdefault(self.name, [0, 0])
            total[0] += 1
            total[1] += ns


def _device_allocs(device: torch.device) -> int:
    # ``memory_stats``'s own numbers, without its flattening of every
    # statistic into one dict (83-178 us a call on an H100 machine's
    # host, the nested dict 14)
    stats = torch.cuda.memory_stats_as_nested_dict(device)
    return stats["num_device_alloc"] + stats["num_device_free"]


class trace_allocs(trace):
    """``trace`` that, on a CUDA ``tensor``'s device, also adds the caching
    allocator's device calls (``cudaMalloc`` + ``cudaFree``, which waits
    for the device) over the span to ``counter_totals()["allocator_calls"]``.
    The allocator's statistics are read outside the span's record and
    clock."""

    __slots__ = ("tensor", "_n0")

    def __init__(self, name: str, tensor: torch.Tensor, **kwargs):
        trace.__init__(self, name, **kwargs)
        self.tensor = tensor

    def __enter__(self) -> None:
        if _recording():
            device = self.tensor.device
            self._n0 = _device_allocs(device) if device.type == "cuda" else None
            trace.__enter__(self)

    def __exit__(self, *exc) -> None:
        if self._rec is not None:
            trace.__exit__(self, *exc)
            if self._n0 is not None:
                n = _device_allocs(self.tensor.device) - self._n0
                _COUNTERS["allocator_calls"] = (
                    _COUNTERS.get("allocator_calls", 0) + n)


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
