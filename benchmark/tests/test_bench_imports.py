"""What the benchmark loads, and what it does on a machine with no card."""

import ast
import shutil
import subprocess
import sys
import types

import torch

from benchmark import harness
from conftest import ROOT

FORBIDDEN = ("jax", "jaxlib", "flax", "msau_tpu")

# load benchmark/run.py's modules and every module under benchmark/, then
# drive a whole CPU run of a cell on the tiny tree given as argv[1]
LOAD_AND_RUN = """
import importlib.util, sys, time, torch
from pathlib import Path
root = Path(sys.argv[1])
sys.path.insert(0, {repo!r})
for path in sorted(Path({repo!r}, "benchmark").rglob("*.py")):
    if "tests" in path.parts:
        continue
    name = "loaded_" + "_".join(path.relative_to({repo!r}).with_suffix("").parts)
    spec = importlib.util.spec_from_file_location(name, path)
    mod = sys.modules[name] = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
from benchmark.harness import run
rc = run(root, ["--workload", "default_train_512", "--seed", "4000000003",
                "--seconds", "0.5", "--trace", "0"], time.perf_counter(),
         device=torch.device("cpu"))
print("rc", rc)
print("TOP", " ".join(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def test_a_run_loads_neither_jax_nor_the_jax_package(tiny_root):
    proc = subprocess.run(
        [sys.executable, "-c", LOAD_AND_RUN.format(repo=str(ROOT)),
         str(tiny_root)], capture_output=True, text=True, cwd=tiny_root,
        timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    lines = proc.stdout.splitlines()
    assert "rc 0" in lines
    top = set(next(l for l in lines if l.startswith("TOP ")).split()[1:])
    # whole top-level names: the port, msau_tpu_torch, passes
    assert "msau_tpu_torch" in top
    assert not top & set(FORBIDDEN), top & set(FORBIDDEN)


def test_the_reference_imports_nothing_of_the_program():
    for path in (ROOT / "benchmark" / "reference").glob("*.py"):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            names = ([a.name for a in node.names]
                     if isinstance(node, ast.Import) else
                     [node.module or ""] if isinstance(node, ast.ImportFrom)
                     else [])
            for name in names:
                assert name.split(".")[0] in ("torch", "typing", "__future__",
                                              "math"), (path.name, name)
    code = ("import sys; sys.path.insert(0, %r); "
            "import benchmark.reference.msau; "
            "print(sorted({m.split('.')[0] for m in sys.modules}))" % str(ROOT))
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=300)
    top = proc.stdout
    assert proc.returncode == 0, proc.stderr
    for bad in ("'msau_tpu_torch'", "'msau_tpu'", "'jax'"):
        assert bad not in top


def test_no_card_no_result(tmp_path):
    """On a machine with no card the harness exits non-zero and prints no
    result; so it does from a directory holding only BENCHMARK.json and
    the benchmark's own files."""
    assert not torch.cuda.is_available()
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    for where in (ROOT, tmp_path):
        proc = subprocess.run(
            [sys.executable, "benchmark/run.py", "--workload",
             "default_train_512", "--seed", "5", "--seconds", "1", "--trace",
             "0"], capture_output=True, text=True, cwd=where, timeout=300)
        assert proc.returncode != 0
        assert proc.stdout.strip() == ""


def test_a_run_that_loaded_jax_prints_no_result(tiny_root, monkeypatch,
                                                capsys):
    monkeypatch.setitem(sys.modules, "jax", types.ModuleType("jax"))
    rc = harness.run(tiny_root, ["--workload", "default_train_512", "--seed",
                                 "9", "--seconds", "0.2", "--trace", "0"],
                     0.0, device=torch.device("cpu"))
    out, err = capsys.readouterr()
    assert rc != 0 and out == ""
    assert "jax" in err
