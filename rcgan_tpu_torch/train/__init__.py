"""The CIFAR-10 training cycle, ported from ``rcgan_tpu/train``."""
