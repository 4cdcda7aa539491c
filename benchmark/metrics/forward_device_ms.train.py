"""Device milliseconds a training step in the forward phases: the
generator's and the critic's input (the rows read, the index gather, the
dequantisation, ``z``, ``pool_to_stage``) and forward up to the gradients, from
the program's device spans ``g.input``, ``g.forward``, ``d.input``, ``d.forward``
(marked in ``train/cifar_loop.py`` and ``train/pggan_loop.py``)."""

from benchmark.spans import device_ms

SPANS = ("g.input", "g.forward", "d.input", "d.forward")


def read(ctx):
    return device_ms(ctx.stats, SPANS)
