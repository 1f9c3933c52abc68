"""The harness on the CPU at a tiny size: metrics found by name, the
control and every fault a training cell can have come out not correct,
the trace reduction, and BENCHMARK.json against the benchmark contract."""

import json
import re

import pytest
import torch

from benchmark import calibrate, harness, trace
from conftest import ROOT

CELL = "default_train_512"


def _run(root, capsys, trace_=0, program=None, seed=4000000021, cell=CELL):
    rc = harness.run(root, ["--workload", cell, "--seed", str(seed),
                            "--seconds", "0.3", "--trace", str(trace_)],
                     0.0, device=torch.device("cpu"), program=program)
    out, err = capsys.readouterr()
    assert rc == 0, err[-2000:]
    return json.loads(out.strip().splitlines()[-1]), err


def _limits(root, cell=CELL):
    path = root / "benchmark" / "workloads" / f"{cell}.json"
    return json.loads(path.read_text())["limits"]


def test_a_metric_added_as_a_file_and_an_entry_is_reported(tiny_root, capsys):
    (tiny_root / "benchmark" / "metrics" / "dummy_units.py").write_text(
        "def read(ctx):\n    return float(ctx.units)\n")
    (tiny_root / "benchmark" / "metrics" / "dummy_none.py").write_text(
        "def read(ctx):\n    return None\n")
    spec = json.loads((tiny_root / "BENCHMARK.json").read_text())
    for name in ("dummy_units", "dummy_none"):
        spec["per_layer"].append({"name": name, "unit": "steps",
                                  "better": "higher", "source": "host_clock",
                                  "layer": "train step",
                                  "moves": "train_img_s"})
    (tiny_root / "BENCHMARK.json").write_text(json.dumps(spec))
    result, err = _run(tiny_root, capsys, trace_=1)
    assert result["metrics"]["dummy_units"] == {"value": 2.0, "unit": "steps"}
    # a reader that finds nothing leaves its metric out; with no card the
    # device readers find nothing
    assert set(result["metrics"]) == {"dummy_units"}
    assert list(result)[-1] == "checks"
    last = list(_limits(tiny_root))[-1]
    assert err.strip().splitlines()[-1].startswith(f"check {last} ")


def test_end_to_end_metrics_of_a_cpu_run(tiny_root, capsys):
    result, _ = _run(tiny_root, capsys)
    assert set(result["metrics"]) == {"train_img_s", "setup_s"}
    assert result["metrics"]["train_img_s"]["value"] > 0
    assert result["attempted"] >= 1 and result["failed"] == 0
    assert set(result["checks"]) == set(_limits(tiny_root))


@pytest.mark.parametrize("program", [calibrate.Frozen, calibrate.HalfBatch,
                                     calibrate.StaleCount, calibrate.Control],
                         ids=["frozen", "half_batch", "stale_count",
                              "control_tf32"])
def test_the_control_and_each_fault_are_not_correct(tiny_root, capsys,
                                                    program):
    """A whole run with the timed path broken underneath: a step that
    leaves the state unchanged, half of each batch left out (the mean over
    the rest), Adam's step counter held at its first value, or the
    reference in TF32 in the program's place."""
    result, _ = _run(tiny_root, capsys, program=program)
    assert result["correct"] is False
    assert any(c["value"] > c["limit"] for c in result["checks"].values())


def _events():
    """A chrome trace of two units: two kernels, a copy, a host op."""
    k = lambda name, ts, dur: {"ph": "X", "cat": "kernel", "name": name,
                               "ts": ts, "dur": dur}
    return [
        {"ph": "X", "cat": "user_annotation", "name": trace.WINDOW, "ts": 100,
         "dur": 100, "tid": 1},
        {"ph": "X", "cat": "cpu_op", "name": "aten::convolution", "ts": 100,
         "dur": 30, "tid": 1},
        {"ph": "X", "cat": "cpu_op", "name": "aten::add_", "ts": 170,
         "dur": 30, "tid": 1},
        k("void (anonymous namespace)::res_block_bwd_kernel<float, 8>(x)", 110,
          40),
        k("void msau::attn::combine_kernel<float>(x)", 140, 20),
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy DtoH", "ts": 180,
         "dur": 10},
        k("sm90_xmma_fprop_implicit_gemm_f32f32", 50, 20),   # before the window
    ]


def test_trace_reduction():
    tr = trace.reduce(_events(), units=2)
    assert tr.window_s == pytest.approx(100e-6)
    assert tr.busy_s == pytest.approx(60e-6)
    assert len(tr.kernels) == 2
    assert tr.families_s == pytest.approx({"flat res block bwd": 40e-6,
                                           "attention": 20e-6})
    # gaps: 100-110 in the conv, 160-180 outside any op, 190-200 in add_
    assert dict(tr.idle_gaps) == pytest.approx(
        {"aten::convolution": 10e-6, "host outside any op": 20e-6,
         "aten::add_": 10e-6})
    assert tr.device_ops[0][1] == pytest.approx(40e-6)


NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def _line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s \
        and "\t" not in s


def test_benchmark_json_keeps_the_contract():
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    assert set(spec) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert spec["paths"] == ["benchmark"]
    assert spec["command"] == ["python3", "benchmark/run.py"]
    assert 1 <= spec["run_seconds"] <= 51
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    used = {w["config"] for w in spec["workloads"]}
    files = set()
    for c in spec["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and _line(c["source"]) and _line(c["why"])
        assert c["file"].startswith("benchmark/") and c["file"] not in files
        files.add(c["file"])
        assert (ROOT / c["file"]).is_file() and c["name"] in used
        assert len(c["reduced"]) <= 16
    pairs = set()
    for w in spec["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["chips"] == 1 and _line(w["why"])
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        assert (ROOT / "benchmark" / "traffic" / f"{w['traffic']}.json").is_file()
        assert (ROOT / "benchmark" / "workloads" / f"{w['name']}.json").is_file()
    e2e = {m["name"]: m for m in spec["end_to_end"]}
    cells = {w["name"] for w in spec["workloads"]}
    assert e2e["setup_s"]["bound"] == 0.25
    names = set()
    for m in spec["end_to_end"] + spec["per_layer"]:
        assert NAME.match(m["name"]) and m["name"] not in names
        names.add(m["name"])
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert (ROOT / "benchmark" / "metrics" / f"{m['name']}.py").is_file()
        assert set(m.get("workloads", cells)) <= cells
    for m in spec["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in spec["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert m["moves"] in e2e and _line(m["layer"])
