"""Helpers shared by the port's parity tests (tests/test_torch_*.py): tiny
configurations, weight trees that both frameworks load, numpy batches, the
CUDA implementations of the ops routed to CPU tensors, and a stand-in for
the ``torch.cuda`` calls of a CUDA graph's capture."""

import contextlib
import sys

import numpy as np
import torch

from rcgan_tpu_torch.bridge import load_tree, to_jax_tree
from rcgan_tpu_torch.ops import attention
from rcgan_tpu_torch.ops.kernels import (conv_kernel, dequant_kernel, norm_kernel,
                                         projection_kernel, resample_kernel, runtime, sn_kernel)

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
    ``"cond_batchnorm"``, ``"cond_batchnorm_backward"``, ``"sn_group"``, ``"projection_logits"``,
    ``"dequantize"``, ``"attention"``, ``"attention_backward"``,
    ``"mean_pool"``, ``"upsample2x"``), looked up at each call so that a
    test may patch the launches under them, as tensors on a card do: with
    ``runtime.on_cuda`` and the libraries mocked, a test drives the launch
    path on this machine.  The overriding ``torch.library.Library`` is held
    by ``monkeypatch``; its undo drops the last reference, and torch's
    finalizer takes the registrations back."""
    impls = {"conv3x3": lambda x, w: conv_kernel.conv3x3_cuda(x, w),
             "cond_batchnorm": lambda *a: norm_kernel.cond_batchnorm_cuda(*a),
             "cond_batchnorm_backward": lambda *a: norm_kernel.cond_batchnorm_backward_cuda(*a),
             "sn_group": lambda ws, us: sn_kernel.sn_group_cuda(ws, us),
             "projection_logits": lambda *a: projection_kernel.projection_logits_cuda(*a),
             "dequantize": lambda *a: dequant_kernel.dequantize_cuda(*a),
             "attention": lambda *a: attention.attention_cuda(*a),
             "attention_backward": lambda *a: attention.attention_backward_cuda(*a),
             "mean_pool": lambda *a: resample_kernel.mean_pool_cuda(*a),
             "upsample2x": lambda *a: resample_kernel.upsample2x_cuda(*a)}
    lib = torch.library.Library("rcgan", "IMPL")
    for op in ops:
        for key in ("CPU", "Meta"):
            lib.impl(op, impls[op], key)
    monkeypatch.setattr(sys.modules[__name__], "_CUDA_IMPLS_ON_CPU", lib, raising=False)


# ------------------------------------------- cycles against a reference
def _live(ref, g):
    """``(layer, var)`` of group ``g`` whose gradients are not rounding
    noise: Adam's first moment above 1e-4 of the group's largest (below, the
    steps are sign-like ±lr on either side)."""
    mu = ref.opt_states[g][0].mu
    group_max = max(np.abs(a).max() for d in mu.values() for a in d.values())
    return [(la, v) for la, vs in ref.groups[g].items() for v in vs
            if np.abs(mu[la][v]).max() > 1e-4 * group_max]


def deltas_off(np_ts, ref, init):
    """``{group: (off, live)}``: the elements of the live tensors of each
    group whose delta from ``init`` is outside JAX's tolerance (``rtol
    1e-4, atol 2e-3`` of the tensor's update scale) of ``ref``'s, and how
    many elements those tensors hold."""
    out = {}
    for g in ref.groups:
        n_live = n_off = 0
        for la, v in _live(ref, g):
            got, want, p0 = np_ts.groups[g][la][v], ref.groups[g][la][v], init.groups[g][la][v]
            d_want = want - p0
            scale = max(float(np.abs(d_want).max()), 1e-8)
            off = np.abs((got - p0) / scale - d_want / scale) > 2e-3 + 1e-4 * np.abs(
                d_want / scale)
            n_live, n_off = n_live + off.size, n_off + int(off.sum())
        out[g] = (n_off, n_live)
    return out


def assert_deltas_close(np_ts, ref, init, label, count=None, lr=2e-4, moments=True):
    """Parameter deltas from ``init``, SN ``u`` and Adam moments of the
    bridge train state ``np_ts`` against ``ref`` under JAX's tolerances
    (``tests/test_parallel.py:95-117``; the exemptions for Adam's sign-like
    first steps are in ``tests/test_torch_parallel_cifar.py``'s module doc):
    every element within 2·lr times ``count`` (the cycles; None: each
    group's own updates, from ``ref``'s Adam count), and the deltas of the
    live tensors within JAX's tolerance on at least 99.9% of each group's
    elements.  ``moments``: also each live tensor's Adam moments, every
    element within JAX's tolerance of the moment's scale (JAX's own test
    holds costs and deltas only)."""
    off = deltas_off(np_ts, ref, init)
    for g, ps in ref.groups.items():
        updates = int(ref.opt_states[g][0].count) if count is None else count
        for la, vs in ps.items():
            for v, want in vs.items():
                assert np.abs(np_ts.groups[g][la][v] - want).max() <= 2 * lr * updates, (
                    label, g, la, v)
        for la, v in _live(ref, g) if moments else ():
            for mom in ("mu", "nu"):
                m_want = getattr(ref.opt_states[g][0], mom)[la][v]
                m_got = getattr(np_ts.opt_states[g][0], mom)[la][v]
                s = max(float(np.abs(m_want).max()), 1e-30)
                np.testing.assert_allclose(m_got / s, m_want / s, rtol=1e-4, atol=2e-3,
                                           err_msg=f"{label} {mom} {g} {la}/{v}")
        assert off[g][0] <= 1e-3 * off[g][1], (label, g, *off[g])
        assert int(np_ts.opt_states[g][0].count) == int(ref.opt_states[g][0].count)
    for la, vs in ref.state.items():
        np.testing.assert_allclose(np_ts.state[la]["u"], vs["u"], rtol=1e-4, atol=1e-5,
                                   err_msg=f"{label} u {la}")


def jax_noise(key, b, n_critic, gen_mult, z_dim=128):
    """The noise JAX's ``_cycle`` draws from ``key`` for a global batch of
    ``b`` rows, by global row (``dequantize_chw_to_hwc_keys`` on the CPU)."""
    import jax
    import jax.numpy as jnp

    from rcgan_tpu.core.rng import example_keys, example_normal

    zg = example_normal(jax.random.fold_in(key, 1), gen_mult * b, z_dim)
    z, u = [], []
    for k in jax.random.split(jax.random.fold_in(key, 2), n_critic):
        kz, kq = jax.random.split(k)
        u.append(jax.vmap(lambda kk: jax.random.uniform(kk, (3072,), jnp.float32, 0.0,
                                                        1.0 / 128.0))(example_keys(kq, b)))
        z.append(example_normal(kz, b, z_dim))
    return {"zg": np.asarray(zg), "z": np.asarray(jnp.stack(z)), "u": np.asarray(jnp.stack(u))}


def out_bias(ts) -> float:
    """``D.Output/b`` of a bridge train state, as a float."""
    return float(np.asarray(ts.groups["disc"]["D.Output"]["b"]).ravel()[0])


def bridge_of(jts):
    """JAX's numpy TrainState in the bridge's layout."""
    from rcgan_tpu_torch.bridge import AdamMoments, NumpyTrainState

    opt = {g: (AdamMoments(count=s[0].count, mu=s[0].mu, nu=s[0].nu), None)
           for g, s in jts.opt_states.items()}
    return NumpyTrainState(groups=jts.groups, state=jts.state, opt_states=opt, step=jts.step)


# ------------------------------------------------------- stand-in capture
class StandIn:
    """The ``torch.cuda`` calls of a capture, on the host: a graph replays
    what its body "launched" during the capture (the ``device`` list), as a
    CUDA graph replays the kernels without calling their wrappers
    (:func:`install_stand_in` puts it in place of ``torch.cuda``'s)."""

    def __init__(self, device_log):
        self.log = device_log
        self.capturing = None  # the capture stream's handle while capturing

    def graph_cls(self):
        standin = self

        class Graph:
            def __init__(self):
                self.recorded = []

            def replay(self):
                standin.log.extend(self.recorded)

        return Graph

    @contextlib.contextmanager
    def graph(self, g, pool=None, stream=None, capture_error_mode="global"):
        assert capture_error_mode == "thread_local" and stream is not None
        start = len(self.log)
        self.capturing = stream.cuda_stream
        try:
            yield
        finally:
            self.capturing = None
            g.recorded = self.log[start:]  # what the capture "recorded" did not run
            del self.log[start:]


def install_stand_in(monkeypatch, standin: StandIn) -> None:
    """Until the test ends, the ``torch.cuda`` calls of a capture go to
    ``standin``, and the stream it captures is the one being recorded."""
    class Stream:
        made = 0

        def __init__(self, *a, **k):
            Stream.made += 1
            self.cuda_stream = 0x1000 + Stream.made

        def wait_stream(self, other):
            pass

    cuda = torch.cuda
    monkeypatch.setattr(cuda, "current_stream", lambda device=None: Stream())
    monkeypatch.setattr(cuda, "Stream", Stream)
    monkeypatch.setattr(cuda, "stream", lambda s: contextlib.nullcontext())
    monkeypatch.setattr(cuda, "device", lambda d: contextlib.nullcontext())
    monkeypatch.setattr(runtime, "_capturing_stream", lambda: standin.capturing)
    monkeypatch.setattr(cuda, "synchronize", lambda device=None: None)
    monkeypatch.setattr(cuda, "empty_cache", lambda: None)
    monkeypatch.setattr(cuda, "memory_reserved", lambda device=None: 0)
    monkeypatch.setattr(cuda, "CUDAGraph", standin.graph_cls())
    monkeypatch.setattr(cuda, "graph", standin.graph)
