"""Device milliseconds per training step in PyTorch's own kernels: every
device operation that is not one of the program's hand-written kernels,
not a library's convolution or matrix product and not the optimiser's
(the elementwise, reduction, copy and indexing work of the models, the
losses and autograd), from the profiler's trace of the traced segment."""

from benchmark.kernel_names import is_adam, is_conv, is_gemm, is_port


def read(ctx):
    t = ctx.trace
    if t is None or not t.steps:
        return None
    s = sum(sec for name, (sec, _) in t.by_name.items()
            if not (is_port(name) or is_conv(name) or is_gemm(name) or is_adam(name)))
    return 1e3 * s / t.steps if s > 0 else None
