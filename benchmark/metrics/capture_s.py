"""Host seconds of the capture of the window's CUDA graph: the warm-up
step, the full ``gc.collect()`` and the capture, from the program's own
counters (``CapturedStep.stats()``).  Part of ``setup_s``."""


def read(ctx):
    s = ctx.stats
    if not s or not s.get("captures"):
        return None
    return s["warm_up_s"] + s["gc_s"] + s["capture_s"]
