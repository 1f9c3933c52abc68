"""The program's span and counter totals (``msau_tpu_torch.utils.profiling``)
for the per-layer readers.  The program fills them only while a profiler
records, and in a run of the harness only the traced window does, so they
are the window's.  Nothing here imports the program: a run that did not
load it, or a program without spans, reads nothing."""

from __future__ import annotations

import sys
from typing import Dict, Optional, Tuple

PROFILING = "msau_tpu_torch.utils.profiling"
STEP = "msau.train_step"


def totals() -> Optional[Tuple[Dict[str, tuple], Dict[str, int]]]:
    """(spans {name: (calls, host s)}, counters {name: value}) of the
    program, or None where they hold no training step's span."""
    mod = sys.modules.get(PROFILING)
    if mod is None or not hasattr(mod, "span_totals"):
        return None
    spans = mod.span_totals()
    if STEP not in spans:
        return None
    return spans, mod.counter_totals()


def per_unit(ctx, span: Optional[str] = None,
             counter: Optional[str] = None) -> Optional[float]:
    """Host ms a unit in ``span``, or ``counter``'s value a unit, of a
    traced window on the card; None with no kernels (no card) or no such
    total."""
    if ctx.trace is None or not ctx.trace.kernels:
        return None
    found = totals()
    if found is None:
        return None
    spans, counters = found
    if span is not None:
        return 1e3 * spans[span][1] / ctx.units if span in spans else None
    return counters[counter] / ctx.units if counter in counters else None
