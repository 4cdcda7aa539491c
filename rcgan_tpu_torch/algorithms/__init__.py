"""Loss graphs, ported from ``rcgan_tpu/algorithms``."""
