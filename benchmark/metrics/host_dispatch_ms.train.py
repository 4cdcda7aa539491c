"""Host milliseconds per training step of the program's own dispatch
(``CifarTrainer.step_scan``, ``PGGANTrainer.step`` with the app's feed):
the benchmark's span around each call, less the CUDA runtime's calls inside
it (where the host waits for room in the launch queue or for the device),
in the traced segment.  Host work that the device cannot hide shows as
idle device time and lower ``train_imgs_per_s``."""


def read(ctx):
    t = ctx.trace
    return 1e3 * t.host_s / t.steps if t is not None and t.steps and t.host_s > 0 else None
