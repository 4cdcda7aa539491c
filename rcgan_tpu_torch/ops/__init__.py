"""Layer ops (NHWC activations, JAX parameter layouts)."""
