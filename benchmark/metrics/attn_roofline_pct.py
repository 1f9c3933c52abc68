"""The attention's share of its roofline: the sum of each call's bound
(``counts.attention_bound_ms``, f32, at the f32 tensor-core peak), the
calls counted by the program's launch counters, over the attention
family's device time, in %."""

from benchmark import counts

CALLS = (("resident_attention_fwd", "fwd"), ("fused_attention_fwd", "fwd"),
         ("resident_attention_bwd", "bwd"), ("fused_attention_bwd", "bwd"))


def read(ctx):
    if ctx.trace is None or not ctx.counters or "attention" not in ctx.work:
        return None
    device_s = ctx.trace.families_s.get("attention", 0.0) / ctx.units
    n, t, cb, c = ctx.work["attention"]
    bound_s = sum(ctx.counters.get(name, 0.0)
                  * counts.attention_bound_ms(kind, n, t, cb, c)[0] * 1e-3
                  for name, kind in CALLS)
    if device_s <= 0 or bound_s <= 0:
        return None
    return 100.0 * bound_s / device_s
