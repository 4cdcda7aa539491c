"""Evaluations of the CIFAR app, ported from ``rcgan_tpu/evals`` (the stand-in
classifier, the inception score, the learned-confusion recovery)."""
