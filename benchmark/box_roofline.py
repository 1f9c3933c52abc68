"""The box convolution's shares of its roofline, for the per-layer readers:
each call's bound (``box_counts.box_bound_ms``) summed over a step's calls
(the cell's shapes), over the kernel's device time a step, in %."""

from __future__ import annotations

from typing import Optional

from benchmark import box_counts

KERNEL = {"fwd": "msau::box::filter_fwd", "bwd": "msau::box::filter_bwd"}
COUNTER = {"fwd": "box_conv_fwd", "bwd": "box_conv_bwd"}


def share(ctx, kind: str) -> Optional[float]:
    """None with no trace, no counters, no box shapes, no such kernel, or
    launch counters that are not one a call of the step."""
    if ctx.trace is None or not ctx.counters or "box" not in ctx.work:
        return None
    calls = ctx.work["box"]
    if ctx.counters.get(COUNTER[kind]) != len(calls):
        return None
    device_s = sum(s for name, s in ctx.trace.kernels
                   if KERNEL[kind] in name) / ctx.units
    if device_s <= 0:
        return None
    bound_s = sum(box_counts.box_bound_ms(kind, c)[0] for c in calls) * 1e-3
    return 100.0 * bound_s / device_s
