"""Device milliseconds a training step in autograd's backward passes
(the gradients of the generator's and the critic's steps), from the
program's device spans ``g.backward`` and ``d.backward``."""

from benchmark.spans import device_ms

SPANS = ("g.backward", "d.backward")


def read(ctx):
    return device_ms(ctx.stats, SPANS)
