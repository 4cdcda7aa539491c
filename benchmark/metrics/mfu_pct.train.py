"""The whole step's share of the card's peak: the model operations of a
step (the convolutions and linear layers, forward and backward, nothing
recomputed: ``benchmark/work/``) times the window's steps per second
(host clock, as ``train_imgs_per_s``), over the peak for the compute
dtype (``benchmark/roofline.py``)."""

from benchmark.roofline import PEAK_FLOPS


def read(ctx):
    if not ctx.steps or ctx.window_s <= 0:
        return None
    flops = sum(w.flops for w in ctx.work.step_work(ctx.config, ctx.traffic))
    return 100.0 * flops * ctx.steps / ctx.window_s / PEAK_FLOPS[ctx.config["compute_dtype"]]
