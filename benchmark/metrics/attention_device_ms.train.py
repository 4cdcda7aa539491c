"""Device milliseconds a training cycle in the attention op, forward and
backward (the backward takes the forward again, ``ops/attention.py``), from
the program's device spans ``attn.fwd`` and ``attn.bwd``, nested in the
cycle's phases; ``None`` where the program marks no attention."""

from benchmark.spans import device_ms

SPANS = ("attn.fwd", "attn.bwd")


def read(ctx):
    return device_ms(ctx.stats, SPANS)
