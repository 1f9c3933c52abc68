"""Readings the correctness limits are set from; not run by the benchmark.

    python benchmark/calibrate.py --workload <cell> --first-seed <n>
        [--seeds 12] [--controls 3] [--faults 3] [--out <file.json>]

For a training cell, at its own sizes on the card, each on its own seeds:

* ``sound``: the port's first three steps against the reference (the
  lower readings: the largest of these);
* ``control``: the reference computed with TF32 operands in the program's
  place (``Control``);
* ``half_batch``: the port fed half of each batch, its loss the mean over
  the rest;
* ``stale_count``: the port with Adam's step counter held at its first
  value, so every update after the first takes the wrong bias correction;
* ``frozen``: a step that leaves the state unchanged (it computes the loss
  and updates nothing).

Every reading is one run of the cell's set-up and check, without the
window.  Writes every reading and, per number, the largest sound reading
and the smallest reading of each fault.
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

from benchmark import check, harness  # noqa: E402
from benchmark.kinds import train  # noqa: E402


class HalfBatch(train.PortTrainer):
    """The port fed the first half of every batch."""

    def step(self, batch):
        return super().step({k: v[:v.shape[0] // 2] for k, v in batch.items()})


class StaleCount(train.PortTrainer):
    """Adam's state broken after the first step: its update counter is
    set back to 0 before every step."""

    def step(self, batch):
        self.state.opt_state["count"] = 0
        return super().step(batch)


class Control(train.ReferenceTrainer):
    """The reference with TF32 operands in the program's place."""

    def __init__(self, config, device, params0):
        super().__init__(config, device, params0, tf32=True)


class Frozen(train.PortTrainer):
    """A step that returns its state unchanged: the loss, no update."""

    def step(self, batch):
        with torch.no_grad():
            from msau_tpu_torch.train.trainer import _loss
            self.loss = _loss(self.model, batch, True, 0.5)[0]
        self.metrics = {"loss": self.loss, "grad_norm": torch.zeros(())}
        return self.loss


PROGRAMS = {"sound": train.PortTrainer, "control": Control,
            "half_batch": HalfBatch, "stale_count": StaleCount,
            "frozen": Frozen}


def reading(config, traffic, seed, device, program):
    cell = train.TrainCell(config, traffic, seed, device, program=program)
    t0 = time.perf_counter()
    cell.setup()
    cell.free()
    values, where = cell.check()
    return {"seed": seed, "values": values, "where": where,
            "seconds": time.perf_counter() - t0,
            "program": cell.readings, "reference": cell.ref_readings}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--first-seed", type=int, required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--controls", type=int, default=3)
    ap.add_argument("--faults", type=int, default=3)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("calibrate: no CUDA device", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    spec = harness.load_json(ROOT / "BENCHMARK.json")
    _, config, traffic, _ = harness.load_cell(ROOT, spec, args.workload)
    runs = {"sound": args.seeds, "control": args.controls,
            "half_batch": args.faults, "stale_count": args.faults,
            "frozen": min(args.faults, 1)}
    seed = args.first_seed
    out = {"workload": args.workload,
           "device": torch.cuda.get_device_name(device), "readings": {}}
    for kind, n in runs.items():
        rows = []
        for _ in range(n):
            rows.append(reading(config, traffic, seed, device, PROGRAMS[kind]))
            print(kind, rows[-1]["seed"], json.dumps(rows[-1]["values"]),
                  json.dumps(rows[-1]["where"]), flush=True)
            seed += 1
        out["readings"][kind] = rows
    summary = {}
    for number in check.NUMBERS:
        s = {k: [r["values"][number] for r in rows]
             for k, rows in out["readings"].items() if rows}
        summary[number] = {"sound_max": max(s["sound"]),
                           **{f"{k}_min": min(v) for k, v in s.items()
                              if k != "sound"}}
    out["summary"] = summary
    print(json.dumps(summary, indent=1))
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
