"""Readings the BMSAU cells' correctness limits are set from; not run by the
benchmark.

    python benchmark/calibrate_box.py --workload bmsau_train_512
        --first-seed <n> [--seeds 12] [--controls 3] [--faults 3]
        [--kinds sound,control,...] [--out <file.json>]

``calibrate.py``'s readings for a ``train_box`` cell, each on its own seed:
``sound``, ``control`` (the box reference with TF32 operands),
``half_batch``, ``stale_count`` and ``frozen`` as there, and two faults of
the box convolution:

* ``frozen_boxes``: the port with every box coordinate's gradient zeroed,
  so the boxes never move;
* ``bf16_integral``: the port's box convolutions taking their integral
  image in bf16 (the plain formulation on the input cast to bf16).
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if __name__ == "__main__":
    # the checkout's root in place of this script's folder, whose modules
    # (``trace``, ...) would otherwise shadow standard ones
    sys.path[0] = str(ROOT)

import torch  # noqa: E402

from benchmark import calibrate, check, harness  # noqa: E402
from benchmark.kinds import train, train_box  # noqa: E402
from benchmark.reference import bmsau as bref  # noqa: E402


class Control(train_box.BoxReferenceTrainer):
    """The box reference with TF32 operands in the program's place."""

    def __init__(self, config, device, params0):
        super().__init__(config, device, params0, tf32=True)


class FrozenBoxes(train.PortTrainer):
    """The port with the box coordinates' gradients zeroed."""

    def __init__(self, config, device, params0):
        super().__init__(config, device, params0)
        for name, p in self.model.named_parameters():
            if bref.is_box_leaf(name):
                p.register_hook(torch.zeros_like)


class Bf16Integral(train.PortTrainer):
    """The port whose box convolutions take a bf16 integral image."""

    def __init__(self, config, device, params0):
        super().__init__(config, device, params0)
        from msau_tpu_torch.ops import boxconv

        for m in self.model.modules():
            if isinstance(m, boxconv.BoxConv2d):
                m.forward = (lambda x, m=m: boxconv.box_conv_plain(
                    x.to(torch.bfloat16), m.ybox, m.xbox, max_h=m.max_h,
                    max_w=m.max_w, normalize=m.normalize))


PROGRAMS = {"sound": train.PortTrainer, "control": Control,
            "half_batch": calibrate.HalfBatch,
            "stale_count": calibrate.StaleCount, "frozen": calibrate.Frozen,
            "frozen_boxes": FrozenBoxes, "bf16_integral": Bf16Integral}


def reading(config, traffic, seed, device, program):
    cell = train_box.Cell(config, traffic, seed, device, program=program)
    t0 = time.perf_counter()
    cell.setup()
    cell.free()
    values, where = cell.check()
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    return {"seed": seed, "values": values, "where": where,
            "seconds": time.perf_counter() - t0, "peak_bytes": peak,
            "program": cell.readings, "reference": cell.ref_readings}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--first-seed", type=int, required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--controls", type=int, default=3)
    ap.add_argument("--faults", type=int, default=3)
    ap.add_argument("--kinds", default=",".join(PROGRAMS))
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("calibrate_box: no CUDA device", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    spec = harness.load_json(ROOT / "BENCHMARK.json")
    _, config, traffic, _ = harness.load_cell(ROOT, spec, args.workload)
    counts = {"sound": args.seeds, "control": args.controls,
              "frozen": min(args.faults, 1)}
    seed = args.first_seed
    out = {"workload": args.workload,
           "device": torch.cuda.get_device_name(device), "readings": {}}
    for kind in args.kinds.split(","):
        rows = []
        for _ in range(counts.get(kind, args.faults)):
            torch.cuda.reset_peak_memory_stats(device)
            try:
                rows.append(reading(config, traffic, seed, device,
                                    PROGRAMS[kind]))
            except torch.cuda.OutOfMemoryError as e:
                print(kind, seed, "out of memory:", str(e).splitlines()[0],
                      flush=True)
                seed += 1
                break
            print(kind, rows[-1]["seed"], json.dumps(rows[-1]["values"]),
                  json.dumps(rows[-1]["where"]),
                  f"peak {rows[-1]['peak_bytes'] / 2 ** 30:.3f} GiB",
                  f"{rows[-1]['seconds']:.1f} s", flush=True)
            seed += 1
        out["readings"][kind] = rows
    summary = {}
    for number in check.NUMBERS:
        s = {k: [r["values"][number] for r in rows]
             for k, rows in out["readings"].items() if rows}
        summary[number] = {f"{k}_{'max' if k == 'sound' else 'min'}":
                           (max(v) if k == "sound" else min(v))
                           for k, v in s.items()}
    out["summary"] = summary
    print(json.dumps(summary, indent=1))
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
