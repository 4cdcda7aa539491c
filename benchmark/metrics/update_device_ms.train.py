"""Device milliseconds a training step in the updates: the mean over the
ranks, ``ScalelessAdam.apply_`` and what follows the last update to the
step's end (the state copies, the metrics), from the program's device
spans ``g.update`` and ``d.update``: the inside counterpart of
``adam_device_ms.train``, which counts the optimiser's kernels alone."""

from benchmark.spans import device_ms

SPANS = ("g.update", "d.update")


def read(ctx):
    return device_ms(ctx.stats, SPANS)
