"""The held-out accuracy table of the port (twin of
``scripts/run_accuracy_matrix.py``).

Runs ``corpus_eval`` for four configurations x 5 model-init seeds on 40
train / 50 held-out pages, one fresh process a run, and appends each run's
record (``config``, ``seed``, ``wall_s``, then the run's JSON line, or
``error`` with the tail of its output) to a JSON-lines file, by default
``scripts/accuracy_matrix_torch.jsonl``.  Summarize it with
``python3 scripts/summarize_accuracy_matrix.py <file>``.

Run:  python -m msau_tpu_torch.tools.accuracy_matrix [out.jsonl] \\
          [--only flat3_bf16,nhwc_f32] [--device cuda]
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
DEFAULT_OUT = os.path.join(ROOT, "scripts", "accuracy_matrix_torch.jsonl")
CONFIGS = [
    ("nhwc_f32", ["--dtype", "f32", "--flat", "0"]),
    ("flat_bf16", ["--dtype", "bf16", "--flat", "2"]),
    ("bmsau_f32", ["--dtype", "f32", "--model", "msau_box"]),
    # the flagship's kernel path (flat_scales 3 under scale_space_num 4) on
    # the matrix's shared protocol: 2 blocks, 256^2 pages
    ("flat3_bf16", ["--dtype", "bf16", "--flat", "3", "--scales", "4"]),
]
SEEDS = [0, 1, 2, 3, 4]
TEST_PAGES = 50


def run_one(cmd):
    """One run in a fresh process -> (return code, its stdout and stderr
    interleaved)."""
    proc = subprocess.run(cmd, stdout=subprocess.PIPE,
                          stderr=subprocess.STDOUT, text=True, cwd=ROOT)
    return proc.returncode, proc.stdout


def parse_args(argv):
    out, only, device = DEFAULT_OUT, None, "cuda"
    rest = list(argv)
    while rest:
        a = rest.pop(0)
        if a == "--only":
            only = rest.pop(0).split(",")
        elif a == "--device":
            device = rest.pop(0)
        else:
            out = a
    return out, only, device


def main(argv=None, runner=run_one):
    """Run the table; ``runner(cmd) -> (rc, output)`` runs one command."""
    out, only, device = parse_args(sys.argv[1:] if argv is None else argv)
    configs = [c for c in CONFIGS if only is None or c[0] in only]
    records = []
    for name, extra in configs:
        for seed in SEEDS:
            t0 = time.time()
            cmd = [sys.executable, "-m", "msau_tpu_torch.tools.corpus_eval",
                   "--test_pages", str(TEST_PAGES), "--seed", str(seed),
                   "--device", device] + extra
            _, output = runner(cmd)
            line = None
            for ln in output.splitlines():
                if ln.startswith("{") and "field F1" in ln:
                    line = ln
            rec = {"config": name, "seed": seed,
                   "wall_s": round(time.time() - t0, 1)}
            if line:
                rec.update(json.loads(line))
            else:
                rec["error"] = output[-2000:]
            with open(out, "a") as f:
                f.write(json.dumps(rec) + "\n")
            records.append(rec)
            print(f"{name} seed {seed}: "
                  f"{rec.get('f1', 'ERR')} ({rec['wall_s']}s)", flush=True)
    return records


if __name__ == "__main__":
    main()
