"""Run one cell of the benchmark once and print its result line.

Everything is found by name from ``BENCHMARK.json`` at the checkout's root:

* the cell (``workloads``) names a configuration, whose ``file`` holds its
  sizes, and a traffic mix, ``benchmark/traffic/<traffic>.json``, whose
  ``kind`` names the module that drives it, ``benchmark/kinds/<kind>.py``;
* ``benchmark/workloads/<cell>.json`` holds the cell's correctness limits;
* every metric, end-to-end or per layer, is read by
  ``benchmark/metrics/<metric>.py``: ``read(ctx)`` returns a number, or
  None where it finds nothing to read, and the metric is then left out.

So a configuration, a traffic mix, a cell or a metric is added by adding
files and entries; no file here changes.

A run: set-up (weights, inputs, the program, its first steps: counted in
``setup_s`` from the process's start; what it left behind then frozen out
of the garbage collector's full passes), then the window: ``--seconds`` of
units of work ended by a fetch (``--trace 0``), or a traced window of the
traffic's ``trace_units`` units under torch.profiler (``--trace 1``).
Then the peak memory is read, the program is freed and the plain
reference decides ``correct``.
"""

from __future__ import annotations

import argparse
import gc
import importlib
import importlib.util
import json
import math
import os
import sys
import time
import types
from pathlib import Path
from typing import Callable, Dict, List

from benchmark import check
from benchmark.trace import traced_window

FORBIDDEN = ("jax", "jaxlib", "flax", "msau_tpu")


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def reader(root: Path, name: str) -> Callable:
    """``read`` of ``benchmark/metrics/<name>.py`` under ``root``."""
    path = root / "benchmark" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "benchmark_metric_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def load_cell(root: Path, spec: dict, name: str):
    """(cell entry, configuration, traffic, limits) of the cell ``name``."""
    cell = next(w for w in spec["workloads"] if w["name"] == name)
    entry = next(c for c in spec["configs"] if c["name"] == cell["config"])
    config = load_json(root / entry["file"])
    traffic = load_json(root / "benchmark" / "traffic"
                        / f"{cell['traffic']}.json")
    limits = load_json(root / "benchmark" / "workloads"
                       / f"{name}.json")["limits"]
    return cell, config, traffic, limits


def metrics_of(spec: dict, cell: str, traced: bool) -> List[dict]:
    """The cell's end-to-end metrics, or with ``traced`` its per-layer
    ones."""
    group = spec["per_layer"] if traced else spec["end_to_end"]
    return [m for m in group if cell in m.get("workloads", [cell])]


def loaded_forbidden() -> List[str]:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def parse(argv) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def _number(x: float):
    """``x``, or its name where JSON has no number for it (inf, nan)."""
    return x if math.isfinite(x) else str(x)


def _fail(msg: str) -> int:
    print(f"benchmark: {msg}", file=sys.stderr, flush=True)
    return 2


def run(root: Path, argv, t0: float, device=None, program=None) -> int:
    """One run; returns the exit code.  ``device`` None: the card, which
    must be there (a test passes the CPU).  ``program``: a stand-in for
    the system under test (tests and calibration)."""
    args = parse(argv)
    spec = load_json(root / "BENCHMARK.json")
    if args.workload not in {w["name"] for w in spec["workloads"]}:
        return _fail(f"no workload {args.workload!r}")
    cell, config, traffic, limits = load_cell(root, spec, args.workload)
    # any kernel cache the program may come to keep stays in the checkout,
    # at a fixed path (its own library is built into build/msau_tpu_torch)
    build = root / "build" / "benchmark"
    for var in ("TRITON_CACHE_DIR", "TORCH_EXTENSIONS_DIR",
                "TORCHINDUCTOR_CACHE_DIR"):
        os.environ[var] = str(build / var.lower())

    import torch

    if device is None:
        if not torch.cuda.is_available():
            return _fail("no CUDA device: nothing is measured")
        if torch.cuda.device_count() < cell["chips"]:
            return _fail(f"{torch.cuda.device_count()} CUDA devices, the "
                         f"cell needs {cell['chips']}")
        device = torch.device("cuda", 0)
    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.init()
    t_imported = time.perf_counter()
    kind = importlib.import_module(f"benchmark.kinds.{traffic['kind']}")
    opts = {} if program is None else {"program": program}
    runner = kind.Cell(config, traffic, args.seed, device, **opts)
    runner.setup()
    runner.sync()
    # the objects of the imports and the set-up are moved out of the
    # collector's reach for the window: a full pass over them stalls the
    # host for a tenth of a second, at a point the count of allocations
    # sets, and whether it fell inside a window would move that run's
    # rate; what the window allocates is collected as ever
    gc.collect()
    gc.freeze()
    phases = {"start": t_imported - t0, **getattr(runner, "setup_phases", {})}
    ctx = types.SimpleNamespace(work=runner.work(), trace=None, counters=None)
    if args.trace:
        runner.counters_reset()
        ctx.trace = traced_window(runner.unit, traffic["trace_units"],
                                  runner.sync, cuda)
        ctx.units, ctx.window_s = ctx.trace.units, ctx.trace.window_s
        ctx.counters = {k: v / ctx.units for k, v in runner.counters().items()}
    else:
        t_start = time.perf_counter()
        ctx.setup_s = t_start - t0
        deadline = t_start + args.seconds
        units = 0
        while units == 0 or time.perf_counter() < deadline:
            runner.unit(units)
            units += 1
        runner.sync()
        ctx.units, ctx.window_s = units, time.perf_counter() - t_start
    gc.unfreeze()
    ctx.memory_peak_bytes = (torch.cuda.max_memory_allocated(device)
                             if cuda else 0)
    runner.free()
    values, where = runner.check()
    correct = check.verdict(values, limits)

    bad = loaded_forbidden()
    if bad:
        return _fail(f"the run loaded {', '.join(bad)}: no result")
    metrics: Dict[str, dict] = {}
    for m in metrics_of(spec, cell["name"], bool(args.trace)):
        value = reader(root, m["name"])(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu" if cuda else device.type,
           "kind": torch.cuda.get_device_name(device) if cuda else device.type,
           "count": cell["chips"], "memory_peak_bytes": ctx.memory_peak_bytes}
    result = {"correct": correct, "attempted": ctx.units, "failed": 0,
              "metrics": metrics, "device": dev}
    if ctx.trace is not None:
        dev["busy_s"] = ctx.trace.busy_s
        dev["window_s"] = ctx.trace.window_s
        result["breakdown"] = ctx.trace.breakdown()
    result["checks"] = {n: {"value": _number(values[n]), "limit": limits[n]}
                        for n in limits}
    print("setup phases, s: " + ", ".join(f"{k} {v:.3f}"
                                          for k, v in phases.items()),
          file=sys.stderr)
    for n in limits:
        print(f"check {n} {values[n]!r} limit {limits[n]!r} "
              f"(worst: {where[n]})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0
