"""The device's idle share of the traced segment: one minus the union of
its operations' intervals over the segment's length, from the profiler's
trace."""


def read(ctx):
    t = ctx.trace
    if t is None or t.window_s <= 0 or t.busy_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
