"""Data for the training cycle, ported from ``rcgan_tpu/data`` (numpy and torch only)."""
