"""Device milliseconds a training step between steps: from a step's last
device mark to the next step's first, the device's wait for the host
(the block's or iteration's preparation and the feed), from the
program's device span ``between``."""

from benchmark.spans import device_ms

SPANS = ("between",)


def read(ctx):
    return device_ms(ctx.stats, SPANS)
