"""The attention's share of its roofline in a training cycle: the least
time of its products and bytes, forward and backward, as
``benchmark/work/`` counts them (the ``attn`` work of a cycle, nothing
recomputed, at the compute dtype's peak), over the device time of the
fused backends' kernels (``benchmark/attention_names.py``) in the traced
segment.  The program's backward takes the forward again, which lowers
the share."""

from benchmark.attention_names import is_attention
from benchmark.roofline import least_seconds


def read(ctx):
    t = ctx.trace
    if t is None or not t.steps:
        return None
    spent = sum(sec for name, (sec, _) in t.by_name.items() if is_attention(name))
    if spent <= 0:
        return None
    dtype = ctx.config["compute_dtype"]
    least = sum(least_seconds(w.flops, w.nbytes, dtype)
                for w in ctx.work.step_work(ctx.config, ctx.traffic) if w.kind == "attn")
    return 100.0 * least * t.steps / spent
