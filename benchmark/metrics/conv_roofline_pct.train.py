"""The convolutions' share of their roofline in a training step.  The work
is every convolution the step needs (forward, input and weight gradients)
and, since a 1x1 convolution may run as a matrix product whose name does
not tell it from a linear layer's, the linear layers' products too (under
0.2% of the operations): each at the larger of its operations over the
peak for the compute dtype and its bytes over the memory rate, from the
configuration's shapes (``benchmark/work/``, ``benchmark/roofline.py``).
The time is every kernel that computes a convolution or a matrix product
(the program's conv3x3 kernels, cuDNN's, cuBLAS's and CUTLASS's) in the
traced segment.  Whatever implements a convolution, the work counted stays
the same; work the step does beyond it there (the spectral norm's backward
recomputes its power iteration with small products) lowers the share."""

from benchmark.kernel_names import is_conv, is_gemm
from benchmark.roofline import least_seconds


def read(ctx):
    t = ctx.trace
    if t is None or not t.steps:
        return None
    spent = sum(sec for name, (sec, _) in t.by_name.items() if is_conv(name) or is_gemm(name))
    if spent <= 0:
        return None
    dtype = ctx.config["compute_dtype"]
    least = sum(least_seconds(w.flops, w.nbytes, dtype)
                for w in ctx.work.step_work(ctx.config, ctx.traffic))
    return 100.0 * least * t.steps / spent
