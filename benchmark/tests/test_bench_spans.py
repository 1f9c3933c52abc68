"""The readers of the program's spans and counter (``benchmark/spans.py``,
``metrics/host_*_ms.py``, ``metrics/allocator_calls_per_step.py``): None
with no kernels, with no program loaded, with a program that has no spans
or no step span; the total over the units otherwise."""

import sys
import types

import pytest

from benchmark import harness, spans
from conftest import ROOT

READERS = {"host_step_ms": ("msau.train_step", None),
           "host_fwd_ms": ("msau.forward", None),
           "host_bwd_ms": ("msau.backward", None),
           "host_update_ms": ("msau.update", None),
           "allocator_calls_per_step": (None, "allocator_calls")}
SPANS = {"msau.train_step": (4, 0.8), "msau.forward": (4, 0.2),
         "msau.backward": (4, 0.4), "msau.update": (4, 0.1)}
COUNTERS = {"allocator_calls": 12}


def _program(monkeypatch, span_totals=SPANS, counters=COUNTERS):
    """A stand-in for the program's profiling module, loaded."""
    mod = types.ModuleType(spans.PROFILING)
    if span_totals is not None:
        mod.span_totals = lambda: dict(span_totals)
        mod.counter_totals = lambda: dict(counters)
    monkeypatch.setitem(sys.modules, spans.PROFILING, mod)


def _ctx(kernels=(("k", 1e-3),), units=4):
    tr = None if kernels is None else types.SimpleNamespace(
        kernels=list(kernels))
    return types.SimpleNamespace(trace=tr, units=units)


@pytest.mark.parametrize("name", sorted(READERS))
def test_reader_gives_the_total_over_the_units(monkeypatch, name):
    _program(monkeypatch)
    span, counter = READERS[name]
    want = 1e3 * SPANS[span][1] / 4 if span else COUNTERS[counter] / 4
    assert harness.reader(ROOT, name)(_ctx()) == pytest.approx(want)


@pytest.mark.parametrize("name", sorted(READERS))
@pytest.mark.parametrize("case", ["no_trace", "no_kernels", "not_loaded",
                                  "no_span_api", "no_step_span"])
def test_reader_gives_none_with_nothing_to_read(monkeypatch, name, case):
    read = harness.reader(ROOT, name)
    if case == "not_loaded":
        monkeypatch.delitem(sys.modules, spans.PROFILING, raising=False)
    else:
        _program(monkeypatch, **{
            "no_span_api": dict(span_totals=None),
            "no_step_span": dict(span_totals={
                k: v for k, v in SPANS.items() if k != spans.STEP})}.get(
                    case, {}))
    ctx = _ctx(kernels={"no_trace": None, "no_kernels": ()}.get(
        case, (("k", 1e-3),)))
    assert read(ctx) is None


def test_a_counter_the_program_did_not_keep_reads_none(monkeypatch):
    """A step traced on the CPU counts no allocator calls."""
    _program(monkeypatch, counters={})
    assert harness.reader(ROOT, "allocator_calls_per_step")(_ctx()) is None
    assert harness.reader(ROOT, "host_step_ms")(_ctx()) == pytest.approx(200.0)
