"""Device milliseconds per training step in the optimiser's kernels
(``ScalelessAdam``'s ``_foreach`` ops), from the profiler's trace of the
traced segment."""

from benchmark.kernel_names import is_adam


def read(ctx):
    t = ctx.trace
    if t is None or not t.steps:
        return None
    s = sum(sec for name, (sec, _) in t.by_name.items() if is_adam(name))
    return 1e3 * s / t.steps if s > 0 else None
