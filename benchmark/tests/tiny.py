"""Tiny sizes of the cells for the CPU tests: every width cut to 16, batch
4, a dataset of 64 images, blocks of 2 cycles, PGGAN up to stage 3."""


def overrides(dtype: str = "float32"):
    def apply(cfg, traffic):
        m = cfg["model"]
        for k in ("dim_g", "dim_d", "dim"):
            if k in m:
                m[k] = 16
        if "max_stage" in m:
            m["max_stage"] = 3
        cfg["batch_size"] = 4
        cfg["dataset"]["train_size"] = 64
        cfg["compute_dtype"] = dtype
        if "scan_block" in traffic:
            traffic["scan_block"] = 2
        if "stage" in traffic:
            traffic["stage"] = min(traffic["stage"], 3)
        traffic["trace_units"] = 1
    return apply

