"""Prefetching input pipeline with a deterministic, leak-free lifecycle.

Port of ``msau_tpu.data.pipeline``.  Replaces the reference's thread/queue
producers (data_generator/data_generator_funsd.py:161-174,
data_generator_text.py) and fixes their lifecycle bugs:
`restart_val_runner` leaked threads blocked on `q.put` with a stale stop
event.  Here every worker drains via a sentinel-checked bounded queue,
`stop_all()` joins all threads, and the provider is a context manager.

Division of labor: workers do only host-side geometry (JSON -> box
programs, numpy) and never touch the device; the consumer thread uploads
the programs, paints them and augments the example on ``device`` (the
paint kernel and the warps of ``data.augment``), then fetches the example
back as numpy, as the JAX provider does.

Protocol: ``next_data(split)`` returns a batch dict of numpy arrays with a
leading batch axis (or None), and ``size_val`` is exposed: drop-in for
``msau_tpu_torch.train.Trainer.fit``.  ``timings`` keeps, for the latest
examples, the worker's host ms, the consumer's wall ms from the upload to
the last warp (paint + augment, with the host draws between the launches)
and the ms of the fetch back to the host.
"""

from __future__ import annotations

import collections
import queue
import threading
import time
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from msau_tpu_torch.config import DataConfig
from msau_tpu_torch.data.augment import (
    augment_example,
    rotated_canvas,
    sample_rotation,
)
from msau_tpu_torch.data.charset import Charset
from msau_tpu_torch.data.pages import Page, load_funsd_page, load_label_json_page
from msau_tpu_torch.data.rasterize import (
    assemble_chargrid_input,
    build_chargrid_programs,
    pad_to_bucket,
    round_up,
    upload_programs,
)
from msau_tpu_torch.ops.paint import paint_boxes

_SENTINEL = object()


def _load_page(path: str) -> Page:
    if path.endswith(".json"):
        import json

        with open(path, encoding="utf-8") as f:
            head = json.load(f)
        if "form" in head:
            return load_funsd_page(path)
        return load_label_json_page(path)
    raise ValueError(f"unsupported input: {path}")


class _StreamClock:
    """Wall ms between ``start`` and ``stop`` as the device's stream sees
    it: CUDA events on a card (they span every launch between them and
    the host work that delays those launches, not device time alone), the
    host clock on the CPU.  ``stop`` waits for the work."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"

    def start(self) -> None:
        if self.cuda:
            self._a = torch.cuda.Event(enable_timing=True)
            self._b = torch.cuda.Event(enable_timing=True)
            self._a.record()
        else:
            self._t = time.perf_counter()

    def stop(self) -> float:
        if self.cuda:
            self._b.record()
            self._b.synchronize()
            return self._a.elapsed_time(self._b)
        return (time.perf_counter() - self._t) * 1e3


class ChargridProvider:
    """Threaded provider of rasterized chargrid batches painted and
    augmented on ``device``.  ``seed`` seeds the workers' draws (by
    default each worker seeds from a hash of its name, which Python
    randomises per process); with one worker a split, providers of the
    same seed then yield the same sequence in every process."""

    def __init__(
        self,
        train_paths: Optional[Sequence[str]],
        val_paths: Optional[Sequence[str]],
        charset: Charset,
        config: Optional[DataConfig] = None,
        page_loader: Callable[[str], Page] = _load_page,
        label_to_class: Optional[Callable[[Page], Page]] = None,
        *,
        device,
        seed: Optional[int] = None,
    ):
        self.cfg = config or DataConfig()
        self.charset = charset
        self.page_loader = page_loader
        self.label_to_class = label_to_class
        self.device = torch.device(device)
        self.seed = seed
        self.train_paths = list(train_paths or [])
        self.val_paths = list(val_paths or [])
        self.size_train = len(self.train_paths)
        self.size_val = len(self.val_paths)
        self.timings: collections.deque = collections.deque(maxlen=4096)
        self._stop = threading.Event()
        self._threads: List[threading.Thread] = []
        self._queues: Dict[str, queue.Queue] = {}
        self._aug_rng = np.random.default_rng(20260816)
        if self.train_paths:
            self._queues["train"] = self._start_workers(
                self.train_paths, "train", self.cfg.num_workers, train=True
            )
        if self.val_paths:
            self._queues["val"] = self._start_workers(
                self.val_paths, "val", max(self.cfg.num_workers // 2, 1), train=False
            )

    # ------------------------------------------------------------------
    def _start_workers(self, paths, split, n_workers, train: bool) -> queue.Queue:
        q: queue.Queue = queue.Queue(maxsize=max(self.cfg.prefetch, 1) * 4)
        for wid in range(n_workers):
            t = threading.Thread(
                target=self._worker,
                args=(q, list(paths), split, wid, train),
                daemon=True,
                name=f"chargrid-{split}-{wid}",
            )
            t.start()
            self._threads.append(t)
        return q

    def _worker(self, q, paths, split, wid, train):
        if self.seed is None:
            rng = np.random.default_rng(hash((split, wid)) % (2**31))
        else:   # the same draws in every process
            rng = np.random.default_rng([self.seed, wid, int(split == "val")])
        order = list(range(len(paths)))
        while not self._stop.is_set():
            if self.cfg.shuffle and train:
                rng.shuffle(order)
            for idx in order:
                if self._stop.is_set():
                    return
                t0 = time.perf_counter()
                try:
                    item = self._prepare(paths[idx], rng, train)
                    item = item + ((time.perf_counter() - t0) * 1e3,)
                except Exception as e:  # malformed page: skip, keep serving
                    item = ("error", paths[idx], repr(e))
                while not self._stop.is_set():
                    try:
                        q.put(item, timeout=0.2)
                        break
                    except queue.Full:
                        continue

    def _prepare(self, path, rng, train):
        page = self.page_loader(path)
        if self.label_to_class is not None:
            page = self.label_to_class(page)
        scale_min = self.cfg.scale_min if train else self.cfg.scale_val
        scale_max = self.cfg.scale_max if train else self.cfg.scale_val
        progs = build_chargrid_programs(
            page,
            self.charset,
            scale_min=scale_min,
            scale_max=scale_max,
            text_err=self.cfg.text_err if train else 0.0,
            label_style="underline",
            rng=rng,
        )
        return ("ok", progs)

    # ------------------------------------------------------------------
    def next_data(self, split: str = "train"):
        train = split != "val"
        q = self._queues.get("val" if split == "val" else "train")
        if q is None:
            return None
        for _ in range(16):  # skip over malformed-page placeholders
            item = q.get()
            if item is _SENTINEL:
                return None
            if item[0] == "ok":
                out = self._assemble(item[1], train=train)
                self.timings[-1]["host_ms"] = item[2]
                return out
        return None

    def _assemble(self, progs, train: bool = True):
        """Upload, paint x4 and (when training) augment on the device, then
        fetch as numpy [1, ...] arrays; appends this example's assemble
        and fetch ms to ``timings``."""
        cfg = self.cfg
        do_aug = train and (
            cfg.affine or cfg.elastic or cfg.rotate or cfg.rotate_mod90
        )
        h0, w0 = progs.height, progs.width
        angle, rot90_k = (None, 0)
        if do_aug:
            angle, rot90_k = sample_rotation(
                self._aug_rng, rotate=cfg.rotate, rotate_mod90=cfg.rotate_mod90
            )
        if angle is not None:
            # size the bucket for the rotated bounding box up front so the
            # warp renders at a static shape (no post-rotation re-padding)
            rh, rw = rotated_canvas(h0, w0, angle)
            hb, wb = pad_to_bucket(max(h0, rh), max(w0, rw), cfg.buckets)
        else:
            hb, wb = pad_to_bucket(h0, w0, cfg.buckets)
        cap = min(round_up(max(len(progs.char.values), 1), 512), cfg.max_chars)
        lcap = round_up(max(len(progs.line_mask.values), 1), 128)
        clock = _StreamClock(self.device)
        clock.start()
        cb, cv, sb, sv, lb, lv, ab, av = upload_programs(
            [progs.char.padded(cap), progs.char_sep.padded(cap),
             progs.line_mask.padded(lcap), progs.label.padded(lcap)],
            self.device)
        inp = assemble_chargrid_input(cb, cv, sb, sv, lb, lv, hb, wb,
                                      self.charset.n_token)
        label = paint_boxes(ab, av, hb, wb)
        rows = torch.arange(hb, device=self.device)[:, None]
        cols = torch.arange(wb, device=self.device)[None, :]
        valid = (rows < h0) & (cols < w0)
        if do_aug:
            inp, label, valid = augment_example(
                inp, label, valid, cfg.n_classes, self._aug_rng,
                affine=cfg.affine, affine_value=cfg.affine_value,
                elastic=cfg.elastic,
                elastic_value_x=cfg.elastic_value_x,
                elastic_value_y=cfg.elastic_value_y,
                rotate_angle=angle, rot90_k=rot90_k,
                page_hw=(h0, w0), out_hw=(hb, wb),
            )
        assemble_ms = clock.stop()
        t0 = time.perf_counter()
        out = {
            "input": inp.cpu().numpy()[None],
            "label": label.cpu().numpy()[None],
            "valid": valid.cpu().numpy()[None],
        }
        self.timings.append({"assemble_ms": assemble_ms,
                             "fetch_ms": (time.perf_counter() - t0) * 1e3})
        return out

    # ------------------------------------------------------------------
    def stop_all(self) -> None:
        """Stop and join every worker (no leaked threads)."""
        self._stop.set()
        for t in self._threads:
            t.join(timeout=5)
        self._threads = []

    def restart_val_runner(self) -> None:
        """Reference-API shim: our val workers cycle continuously, nothing
        to restart (the reference leaked threads here)."""

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.stop_all()
        return False


class BatchingProvider:
    """Group same-bucket bs=1 batches from an inner provider into bs=N
    global batches.

    The reference trains at batch 1 (train_chargrid_funsd_msau.py:44); a
    larger batch needs a single static shape, so items are stashed per
    bucket shape and emitted once a full group of ``batch_size``
    accumulates.  ``max_pulls`` bounds the wait when the stream ends
    mid-group (leftovers are dropped, like drop_last batching).
    """

    def __init__(self, inner, batch_size: int, max_pulls: int = 256):
        if batch_size < 1:
            raise ValueError(f"batch_size {batch_size} < 1")
        self.inner = inner
        self.batch_size = batch_size
        self.max_pulls = max_pulls
        self._stash: Dict[str, Dict[tuple, list]] = {}

    @property
    def size_val(self) -> int:
        return getattr(self.inner, "size_val", 0) // self.batch_size

    @property
    def size_train(self) -> int:
        return getattr(self.inner, "size_train", 0) // self.batch_size

    def next_data(self, split: str = "train"):
        if self.batch_size == 1:
            return self.inner.next_data(split)
        stash = self._stash.setdefault(split, {})
        for _ in range(self.max_pulls):
            item = self.inner.next_data(split)
            if item is None:
                return None
            key = tuple(item["input"].shape)
            group = stash.setdefault(key, [])
            group.append(item)
            if len(group) == self.batch_size:
                stash.pop(key)
                return {
                    k: np.concatenate([it[k] for it in group])
                    for k in group[0]
                }
        return None

    def stop_all(self) -> None:
        if hasattr(self.inner, "stop_all"):
            self.inner.stop_all()

    def restart_val_runner(self) -> None:
        """Reference-API shim: our val workers cycle continuously, nothing
        to restart (the reference leaked threads here)."""

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.stop_all()
        return False
