"""The traced window: torch.profiler over a few units of work, reduced to
what the per-layer readers and the result's ``breakdown`` take.

Device time comes from the profiler's trace (kernels, copies and sets on
the card); the window is the span of the ``bench.window`` annotation on
the same timeline, from the first unit's launch to the closing fetch.
Kernels are sorted into families by their demangled names.
"""

from __future__ import annotations

import bisect
import json
import os
import tempfile
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Tuple

# the program's kernels by their CUDA function names as the profiler
# demangles them (templates in anonymous namespaces; the attention's
# general kernels and partial combine in msau::attn, the weight-gradient
# partial sums in msau), then cuDNN and cuBLAS by the usual parts of their
# names; the first family that matches takes a kernel, the rest are
# "other torch ops"
_OURS = "(anonymous namespace)::"
FAMILIES: Tuple[Tuple[str, Tuple[str, ...]], ...] = (
    ("flat conv stage 1", (_OURS + "conv_bwd_kernel<",
                           _OURS + "conv_bwd_fast_kernel<")),
    ("flat conv fwd and dx", (_OURS + "conv_kernel<",
                              _OURS + "conv_fast_kernel<",
                              _OURS + "conv_lrn_wide_kernel<")),
    ("flat concat 1x1 bwd", (_OURS + "concat1x1_bwd",)),
    ("flat res block bwd", (_OURS + "res_block_bwd_kernel<",)),
    ("flat res block fwd", (_OURS + "res_block_kernel<",)),
    ("flat deconv dx / dw", (_OURS + "deconv2_dx", _OURS + "deconv2_dw_")),
    ("flat deconv fwd", (_OURS + "deconv2_f32_kernel<",
                         _OURS + "deconv2_bf16_kernel<",
                         _OURS + "deconv2_general_kernel<")),
    ("flat pool, entry layout", (_OURS + "maxpool2_kernel<",
                                 _OURS + "maxpool2_bwd_kernel<",
                                 _OURS + "maxpool2_bwd_vec_kernel<",
                                 _OURS + "nhwc_to_nchw_kernel<")),
    ("flat weight-gradient partial sums", ("msau::sum_partials_kernel",)),
    ("attention", (_OURS + "stats_kernel<", _OURS + "accum_kernel<",
                   _OURS + "rows_kernel<", "msau::attn::")),
    ("masked CE", (_OURS + "fwd_kernel<", _OURS + "bwd_kernel<",
                   _OURS + "combine_kernel(")),
    ("cuDNN / GEMM", ("cudnn", "xmma", "cutlass", "gemm", "conv2d", "wgrad",
                      "dgrad", "winograd", "implicit", "convolve", "fft")),
)
FLAT = tuple(f for f, _ in FAMILIES if f.startswith("flat "))
OTHER = "other torch ops"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
WINDOW = "bench.window"


def family(name: str) -> str:
    return next((f for f, keys in FAMILIES if any(k in name for k in keys)),
                OTHER)


@dataclass
class Trace:
    """A traced window of ``units`` units of work; times in seconds."""

    units: int
    window_s: float
    busy_s: float
    kernels: List[Tuple[str, float]] = field(default_factory=list)
    families_s: Dict[str, float] = field(default_factory=dict)
    device_ops: List[Tuple[str, float]] = field(default_factory=list)
    idle_gaps: List[Tuple[str, float]] = field(default_factory=list)

    def breakdown(self) -> dict:
        return {"device_ops": [list(x) for x in self.device_ops],
                "idle_gaps": [list(x) for x in self.idle_gaps]}


def _union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[Tuple[float, float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], b))
        else:
            out.append((a, b))
    return out


def _innermost(ops: List[Tuple[float, float, str]], starts: List[float],
               t: float) -> str:
    """Name of the host op in progress at time ``t``: of the ops that span
    it, the one that started last (ops nest), looked for among the 2000
    that started last before ``t``."""
    i = bisect.bisect_right(starts, t)
    for a, b, name in reversed(ops[max(0, i - 2000):i]):
        if t < b:
            return name
    return "host outside any op"


def reduce(events: List[dict], units: int, top: int = 10) -> Trace:
    """Chrome-trace events of one traced window -> ``Trace``."""
    win = next(e for e in events if e.get("name") == WINDOW
               and e.get("cat") == "user_annotation")
    w0, w1 = float(win["ts"]), float(win["ts"]) + float(win["dur"])
    dev, kernels, names = [], [], {}
    host = []
    for e in events:
        if e.get("ph") != "X":
            continue
        cat, ts, dur = e.get("cat"), float(e.get("ts", 0)), float(e.get("dur", 0))
        if cat in DEVICE_CATS:
            a, b = max(ts, w0), min(ts + dur, w1)
            if b <= a:
                continue
            dev.append((a, b))
            names[e["name"]] = names.get(e["name"], 0.0) + (b - a) * 1e-6
            if cat == "kernel":
                kernels.append((e["name"], (b - a) * 1e-6))
        elif cat == "cpu_op" and e.get("tid") == win.get("tid"):
            host.append((ts, ts + dur, e["name"]))
    busy = _union(dev)
    fams: Dict[str, float] = {}
    for name, s in kernels:
        f = family(name)
        fams[f] = fams.get(f, 0.0) + s
    host.sort(key=lambda o: (o[0], -o[1]))   # a parent before its children
    starts = [a for a, _, _ in host]
    gaps: Dict[str, float] = {}
    edge = w0
    for a, b in busy + [(w1, w1)]:
        if a > edge:
            label = _innermost(host, starts, edge)
            gaps[label] = gaps.get(label, 0.0) + (a - edge) * 1e-6
        edge = max(edge, b)
    by_time = lambda d: sorted(d.items(), key=lambda kv: -kv[1])[:top]
    return Trace(units=units, window_s=(w1 - w0) * 1e-6,
                 busy_s=sum(b - a for a, b in busy) * 1e-6,
                 kernels=kernels, families_s=fams,
                 device_ops=[(n[:200], s) for n, s in by_time(names)],
                 idle_gaps=[(n[:200], s) for n, s in by_time(gaps)])


def traced_window(unit: Callable[[int], None], units: int,
                  sync: Callable[[], None], cuda: bool) -> Trace:
    """Profile ``units`` calls of ``unit`` ended by ``sync``."""
    from torch.profiler import ProfilerActivity, profile, record_function

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    sync()
    with profile(activities=acts) as prof:
        with record_function(WINDOW):
            for i in range(units):
                unit(i)
            sync()
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.unlink(path)
    return reduce(events, units)
