"""Experiment apps of the port, ported from ``rcgan_tpu/apps`` (CIFAR-10 only)."""
