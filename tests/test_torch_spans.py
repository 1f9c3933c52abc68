"""The spans of the port's training step (``utils.profiling.trace``,
opened in ``train/trainer.py:make_train_step``) on the CPU, with the tiny
model of ``test_torch_profiling.py``:

* off (no profiler): a step opens no ``record_function`` and checks the
  profiler once a span, and the registry stays empty;
* on (under ``torch.profiler``): each span counts its calls and host
  time, and lands in the exported trace as a ``user_annotation``, the
  phases nested in the step in order.
"""

import json

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from msau_tpu_torch.config import ModelConfig, TrainConfig
from msau_tpu_torch.train.trainer import Trainer
from msau_tpu_torch.utils import profiling

CFG = dict(img_channels=3, n_class=3, scale_space_num=2, res_depth=1,
           feat_root=2, num_blocks=1, final_act="softmax")
PHASES = ("msau.forward", "msau.backward", "msau.update")
SPANS = ("msau.train_step",) + PHASES


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread: the suite's other workers load every core."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _empty_registry():
    profiling.reset_spans()
    yield
    profiling.reset_spans()


@pytest.fixture
def trainer():
    tr = Trainer(ModelConfig(**CFG),
                 TrainConfig(optimizer="adam", learning_rate=1e-3),
                 device="cpu")
    tr.init_state(np.zeros((2, 8, 8, 3), np.float32))
    return tr


def _batch(tr, i):
    rng = np.random.default_rng(i)
    return tr.put_batch({
        "input": rng.random((2, 8, 8, 3)).astype(np.float32),
        "label": rng.integers(0, 3, (2, 8, 8)).astype(np.int32),
        "valid": np.ones((2, 8, 8), bool)})


def _steps(tr, n=2):
    for i in range(n):
        tr.state, metrics = tr.train_step(tr.state, _batch(tr, i))
    return metrics


def test_off_a_step_opens_no_record_and_checks_once_a_span(trainer,
                                                           monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("record_function opened with no profiler")

    checks = []

    def recording():
        checks.append(1)
        return False

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(profiling, "_recording", recording)
    metrics = _steps(trainer)
    assert np.isfinite(float(metrics["loss"]))
    assert trainer.state.step == 2
    assert len(checks) == 2 * len(SPANS)
    assert profiling.span_totals() == {}
    assert profiling.counter_totals() == {}


def test_off_a_span_passes_the_block_through(monkeypatch):
    monkeypatch.setattr(torch.profiler, "record_function", None)
    with profiling.trace("msau.forward", step=1) as got:
        pass
    assert got is None
    with pytest.raises(KeyError):
        with profiling.trace_allocs("msau.train_step", torch.zeros(1)):
            raise KeyError("x")
    assert profiling.span_totals() == {}


def test_on_spans_count_and_nest_in_the_trace(trainer, tmp_path):
    _steps(trainer, 1)    # the first step's lazy set-up stays untraced
    with profiling.capture_trace(str(tmp_path)):
        _steps(trainer)
    totals = profiling.span_totals()
    assert set(totals) == set(SPANS)
    assert all(totals[name][0] == 2 for name in SPANS)
    assert all(totals[name][1] > 0 for name in SPANS)
    assert sum(totals[p][1] for p in PHASES) <= totals["msau.train_step"][1]
    # no allocator counter on the CPU
    assert profiling.counter_totals() == {}

    events = json.loads((tmp_path / "trace.json").read_text())["traceEvents"]
    spans = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]),
                    e["name"]) for e in events
                   if e.get("cat") == "user_annotation"
                   and e.get("name", "").startswith("msau."))
    steps = [s for s in spans if s[2] == "msau.train_step"]
    assert len(steps) == 2
    for a, b, _ in steps:
        inside = [s for s in spans if a <= s[0] and s[1] <= b
                  and s[2] != "msau.train_step"]
        assert [s[2] for s in inside] == list(PHASES)
        assert all(x[1] <= y[0] for x, y in zip(inside, inside[1:]))


def test_on_reset_clears_and_totals_are_copies():
    with profile(activities=[ProfilerActivity.CPU]):
        with profiling.trace("msau.update"):
            pass
        with profiling.trace_allocs("msau.train_step", torch.zeros(1)):
            pass
    totals = profiling.span_totals()
    assert {k: v[0] for k, v in totals.items()} == {"msau.update": 1,
                                                    "msau.train_step": 1}
    totals.clear()
    assert len(profiling.span_totals()) == 2
    with profiling.trace("msau.update"):   # the profiler is off again
        pass
    assert profiling.span_totals()["msau.update"][0] == 1
    profiling.reset_spans()
    assert profiling.span_totals() == {} and profiling.counter_totals() == {}
