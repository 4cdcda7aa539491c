"""The port's data path against the JAX package, on the CPU: dequantisation
(explicit noise against ``dequantize_chw_to_hwc_keys``, the plain version's
seeded noise, per-row determinism), the host-side seeds of a cycle, the
copied confusion-matrix code and the device-resident dataset.

The JAX dequantisation kernel (``dequantize_fused``) has no CPU lowering
(``pltpu.prng_*``), so JAX's reference here is the keyed jnp function its
cycle runs off the TPU; the Triton kernel is held against the plain
version on the card by ``chip_smoke.py``.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from rcgan_tpu.core.rng import example_keys
from rcgan_tpu.data import confusion as jconf
from rcgan_tpu.data.cifar10 import dequantize_chw_to_hwc_keys
from rcgan_tpu_torch.core import rng as trng
from rcgan_tpu_torch.data import confusion as tconf
from rcgan_tpu_torch.data.cifar10 import (dequantize_chw_to_hwc, dequantize_chw_to_hwc_seeded,
                                          device_dataset_of)
from rcgan_tpu_torch.ops.kernels import runtime

torch.set_num_threads(min(2, torch.get_num_threads()))


def _images(b, seed):
    return np.random.RandomState(seed).randint(0, 256, (b, 3072)).astype(np.uint8)


def _base_hwc(x):
    """The noise-free part, 2(x/256 − 0.5), in HWC order (float32, exact)."""
    base = 2.0 * (x.astype(np.float32) / 256.0 - 0.5)
    return base.reshape(len(x), 3, 32, 32).transpose(0, 2, 3, 1).reshape(len(x), 3072)


def test_explicit_noise_form_equals_jax_exactly():
    """JAX's per-example keyed noise u (the uniforms its cycle draws from
    ``example_keys``) handed to the port: the output is bit-equal to
    ``dequantize_chw_to_hwc_keys`` (the same float32 ops in the same order,
    then the same transpose)."""
    x = _images(6, 0)
    keys = example_keys(jax.random.key(3), 6)
    ref = np.asarray(dequantize_chw_to_hwc_keys(jnp.asarray(x, jnp.int32), keys))
    u = np.asarray(jax.vmap(lambda k: jax.random.uniform(k, (3072,), jnp.float32, 0.0,
                                                         1.0 / 128.0))(keys))
    for xt in (torch.from_numpy(x), torch.from_numpy(x.astype(np.int32))):
        out = dequantize_chw_to_hwc(xt, torch.from_numpy(u))
        assert out.dtype == torch.float32 and out.shape == (6, 3072)
        np.testing.assert_array_equal(out.numpy(), ref)


def noise_range_ok(out, base):
    """The range check of the dequantisation noise, from the float32 output:
    ``u ∈ [0, 1/128)`` strictly, where ``out = fl(base + u)``.  Where
    ``base`` is 0 (pixel 128) ``out`` is ``u`` itself, so ``out < 1/128``
    holds there strictly; elsewhere the float32 rounding of ``base + u`` may
    round up to ``base + 1/128`` (0.9921875 + (1/128 − 2⁻³¹) rounds to 1.0),
    so ``out − base ≤ 1/128`` and equality only where ``|base| ≥ 2⁻⁷``, where
    the sum's ulp is at least 2⁻³¹."""
    noise = out.astype(np.float64) - base.astype(np.float64)
    at_top = noise == 1.0 / 128
    return (noise.min() >= 0.0 and noise.max() <= 1.0 / 128
            and bool(np.all(np.abs(base[at_top]) >= 2.0 ** -7))
            and bool(np.all(noise[base == 0] < 1.0 / 128)))


def test_seeded_plain_noise_range_mean_and_histogram():
    """The seeded form on the CPU (the kernel's plain version, noise by
    torch.rand per row): the range check of :func:`noise_range_ok`, the
    mean within 2% of 1/256 and each of 16 bins within ±5% of flat over
    64 × 3072 samples (binomial σ ≈ 0.9% of a bin).  No launch is counted
    on the CPU."""
    x = _images(64, 1)
    seeds = torch.from_numpy(trng.example_seeds(11, 64))
    before = runtime.launch_counts()
    out = dequantize_chw_to_hwc_seeded(torch.from_numpy(x), seeds).numpy()
    assert runtime.launch_counts() == before
    base = _base_hwc(x)
    assert noise_range_ok(out, base) and (base == 0).sum() > 500
    noise = out - base
    assert abs(noise.mean() * 256 - 1.0) < 0.02
    hist = np.histogram(noise * 128, bins=16, range=(0.0, 1.0))[0]
    np.testing.assert_allclose(hist / hist.mean(), 1.0, atol=0.05)


def test_seeded_rows_do_not_depend_on_the_batch():
    """A row's output depends only on its own bytes and seed: the same seeds
    give bit-identical rows when the batch is permuted or sliced, and other
    seeds give other rows."""
    x = torch.from_numpy(_images(8, 2))
    seeds = torch.from_numpy(trng.example_seeds(5, 8))
    full = dequantize_chw_to_hwc_seeded(x, seeds)
    perm = torch.tensor([5, 0, 7, 2, 1, 6, 3, 4])
    assert torch.equal(dequantize_chw_to_hwc_seeded(x[perm], seeds[perm]), full[perm])
    assert torch.equal(dequantize_chw_to_hwc_seeded(x[3:6], seeds[3:6]), full[3:6])
    other = dequantize_chw_to_hwc_seeded(x, seeds + 1)
    assert all(not torch.equal(a, b) for a, b in zip(other, full))
    with pytest.raises(ValueError, match="uint8"):
        dequantize_chw_to_hwc_seeded(x.int(), seeds)
    with pytest.raises(ValueError, match="int32 seeds"):
        dequantize_chw_to_hwc_seeded(x, seeds.long())


def test_cycle_seeds_are_keyed_by_global_index_and_step():
    """Per-row dequantisation seeds are keyed by the global example index
    (a shard's rows equal the same rows of the whole batch), int32 in
    [0, 2³¹ − 1); a cycle's seeds are a pure function of its seed, and
    differ across seeds, critic steps and draws."""
    whole = trng.example_seeds(42, 16)
    assert whole.dtype == np.int32 and whole.min() >= 0
    np.testing.assert_array_equal(trng.example_seeds(42, 8, start=8), whole[8:])
    assert len(set(whole.tolist())) == 16
    a, b = trng.cycle_seeds(7, 5, 64), trng.cycle_seeds(7, 5, 64)
    assert a.g_z == b.g_z and a.d_z == b.d_z and np.array_equal(a.dequant, b.dequant)
    assert a.dequant.shape == (5, 64) and a.dequant.dtype == np.int32
    assert len({a.g_z, *a.d_z}) == 6
    assert len({tuple(r) for r in a.dequant.tolist()}) == 5
    c = trng.cycle_seeds(trng.fold_in(7, 1), 5, 64)
    assert c.g_z != a.g_z and not np.array_equal(c.dequant, a.dequant)
    z1, z2 = trng.example_normal(a.g_z, 3, 4, "cpu"), trng.example_normal(a.g_z, 3, 4, "cpu")
    assert torch.equal(z1, z2) and not torch.equal(z1, trng.example_normal(a.d_z[0], 3, 4, "cpu"))


@pytest.mark.parametrize("class_depend", [False, True])
def test_confusion_copy_matches_jax(class_depend):
    """The copied numpy functions give the JAX package's matrices, and the
    same labels from the same RandomState."""
    c, c_inv = tconf.build_confusion(0.6, 10, class_depend)
    jc, jc_inv = jconf.build_confusion(0.6, 10, class_depend)
    np.testing.assert_array_equal(c, jc)
    np.testing.assert_array_equal(c_inv, jc_inv)
    y = np.random.RandomState(0).randint(0, 10, 500)
    for real_match in (False, True):
        got = tconf.corrupt_dataset_numpy(np.random.RandomState(1), y, c, c_inv, real_match)
        want = jconf.corrupt_dataset_numpy(np.random.RandomState(1), y, jc, jc_inv, real_match)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)


def test_device_dataset_of_types_and_checks():
    """uint8 images and int32 labels stay as they are on the device (here
    the CPU); int images are narrowed when they hold uint8 values, and
    refused otherwise."""
    rs = np.random.RandomState(3)
    arrays = {"images": rs.randint(0, 256, (6, 3072)), "labels": rs.randint(0, 10, 6),
              "labels_random": rs.randint(0, 10, 6), "labels_biased": rs.randint(0, 10, 6),
              "labels_inv_weights": rs.rand(6, 10)}
    ds = device_dataset_of(arrays, "cpu")
    assert ds["images"].dtype == torch.uint8 and ds["labels_inv_weights"].dtype == torch.float32
    assert all(ds[k].dtype == torch.int32 for k in ("labels", "labels_random", "labels_biased"))
    np.testing.assert_array_equal(ds["images"].numpy(), arrays["images"])
    with pytest.raises(ValueError, match="uint8 values"):
        device_dataset_of(dict(arrays, images=arrays["images"] + 1), "cpu")
    with pytest.raises(ValueError, match="first dimension"):
        device_dataset_of(dict(arrays, labels=arrays["labels"][:5]), "cpu")
