"""Host milliseconds a training step of the trainer's host part before
its first launch: the rows of the steps, the key of the state's addresses
and the load of the block, from the program's host spans ``rows``, ``key``
and ``load`` (``CifarTrainer.step_scan``, ``PGGANTrainer.step``,
``train/graphs.py``)."""

from benchmark.spans import host_ms

SPANS = ("rows", "key", "load")


def read(ctx):
    return host_ms(ctx.stats, SPANS)
