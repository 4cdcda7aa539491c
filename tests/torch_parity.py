"""Helpers shared by the port's parity tests (tests/test_torch_*.py): tiny
configurations, weight trees that both frameworks load, numpy batches, and
the CUDA implementations of the ops routed to CPU tensors."""

import sys

import numpy as np
import torch

from rcgan_tpu_torch.bridge import load_tree, to_jax_tree
from rcgan_tpu_torch.ops.kernels import conv_kernel, norm_kernel

# narrow widths, full 32x32 images: the CIFAR layer graph at test size
TINY = dict(dim_g=8, dim_d=16, embedding_dim=24)


def perturbed_trees(module: torch.nn.Module, seed: int):
    """``(params, state)`` of ``module`` as numpy trees, with every bias and
    cond-BN table moved off its constant init so they matter, loaded back
    into ``module``."""
    params, state = to_jax_tree(module)
    rs = np.random.RandomState(seed)
    for d in params.values():
        for var, a in d.items():
            if var in ("scale", "offset", "Biases", "b"):
                d[var] = (a + 0.3 * rs.randn(*a.shape)).astype(np.float32)
    load_tree(module, params, state, prefix="")
    return params, state


def make_batch(b: int, seed: int, vocab: int = 10, output_dim: int = 3072):
    """A numpy batch as ``disc_loss`` takes it, a noise ``z`` and an actual
    confusion matrix (rows sum to 1)."""
    rs = np.random.RandomState(seed)
    batch = {
        "real_data": rs.uniform(-1, 1, (b, output_dim)).astype(np.float32),
        "labels": rs.randint(0, vocab, b),
        "labels_random": rs.randint(0, vocab, b),
        "labels_biased": rs.randint(0, vocab, b),
        "labels_inv_weights": rs.uniform(-0.5, 1.5, (b, vocab)).astype(np.float32),
    }
    z = rs.randn(b, 128).astype(np.float32)
    c = rs.uniform(0.1, 1.0, (vocab, vocab)).astype(np.float32)
    return batch, z, c / c.sum(1, keepdims=True)


def to_torch(tree):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in tree.items()}


# the MNIST DCGAN at test size: narrow widths, 28x28 images
TINY_MNIST = dict(gf_dim=8, df_dim=8, gfc_dim=32, dfc_dim=32)


def mnist_batch(b: int, seed: int, y_dim: int = 10):
    """A numpy batch as ``mnist_losses`` takes it, ``z`` in U[-1, 1) and an
    actual confusion matrix (rows sum to 1)."""
    rs = np.random.RandomState(seed)
    batch = {"images": rs.rand(b, 28, 28, 1).astype(np.float32),
             "y_real": rs.randint(0, y_dim, b).astype(np.int32),
             "y_gen": rs.randint(0, y_dim, b).astype(np.int32),
             "y_fake": rs.randint(0, y_dim, b).astype(np.int32),
             "y_real_weights": rs.uniform(-0.5, 1.5, (b, y_dim)).astype(np.float32)}
    z = rs.uniform(-1, 1, (b, 100)).astype(np.float32)
    c = rs.uniform(0.1, 1.0, (y_dim, y_dim))
    return batch, z, (c / c.sum(1, keepdims=True)).astype(np.float32)


def perturb_mnist(params, state, seed: int):
    """Biases, BN gamma/beta and the moving statistics moved off their
    constant inits (in place) so that each of them matters."""
    rs = np.random.RandomState(seed)
    for d in params.values():
        for var, a in d.items():
            if var in ("biases", "bias", "gamma", "beta"):
                d[var] = (a + 0.3 * rs.randn(*a.shape)).astype(np.float32)
    for d in state.values():
        if "moving_mean" in d:
            d["moving_mean"] = (0.3 * rs.randn(*d["moving_mean"].shape)).astype(np.float32)
            d["moving_variance"] = rs.uniform(0.5, 2.0, d["moving_variance"].shape).astype(
                np.float32)
    return params, state


def _state_leaves(np_ts):
    """``{name: array}`` of every leaf of a bridge train state."""
    out = {"step": np.asarray(np_ts.step)}
    for g, d in np_ts.groups.items():
        out.update({f"{g}/{la}/{v}": a for la, vs in d.items() for v, a in vs.items()})
    out.update({f"state/{la}/{v}": a for la, vs in np_ts.state.items() for v, a in vs.items()})
    for g, (adam, _) in np_ts.opt_states.items():
        out[f"{g}/count"] = np.asarray(adam.count)
        for mom in ("mu", "nu"):
            tree = getattr(adam, mom)
            out.update({f"{g}/{mom}/{la}/{v}": a for la, vs in tree.items()
                        for v, a in vs.items()})
    return out


def assert_states_bit_equal(a, b, label: str):
    """Every leaf of two bridge train states bit-equal."""
    la, lb = _state_leaves(a), _state_leaves(b)
    assert la.keys() == lb.keys(), label
    for k in la:
        np.testing.assert_array_equal(la[k], lb[k], err_msg=f"{label} {k}")


def cuda_impls_on_cpu(monkeypatch, *ops: str) -> None:
    """Until the test ends, CPU and meta tensors reach the CUDA
    implementations of the ``rcgan`` ops named in ``ops`` (``"conv3x3"``,
    ``"cond_batchnorm"``), looked up at each call so that a test may patch
    the launches under them, as tensors on a card do: with
    ``runtime.on_cuda`` and the libraries mocked, a test drives the launch
    path on this machine.  The overriding ``torch.library.Library`` is held
    by ``monkeypatch``; its undo drops the last reference, and torch's
    finalizer takes the registrations back."""
    impls = {"conv3x3": lambda x, w: conv_kernel.conv3x3_cuda(x, w),
             "cond_batchnorm": lambda *a: norm_kernel.cond_batchnorm_cuda(*a)}
    lib = torch.library.Library("rcgan", "IMPL")
    for op in ops:
        for key in ("CPU", "Meta"):
            lib.impl(op, impls[op], key)
    monkeypatch.setattr(sys.modules[__name__], "_CUDA_IMPLS_ON_CPU", lib, raising=False)
