"""The CIFAR app's data in the port against the JAX package, on the CPU:
the synthetic renderer bit for bit, ``load``'s label arrays from the native
engine (the label-stream repair), the engine's other draws, the prefetcher,
and the PNG writer against the JAX package's PIL-written grid."""

import io

import numpy as np
import pytest

from rcgan_tpu import native as jnative
from rcgan_tpu.data import cifar10 as jcifar
from rcgan_tpu.data.pipeline import Prefetcher as JaxPrefetcher
from rcgan_tpu.utils import images as jimages
from rcgan_tpu_torch import native
from rcgan_tpu_torch.data import cifar10 as tcifar
from rcgan_tpu_torch.data.confusion import build_confusion
from rcgan_tpu_torch.data.pipeline import Prefetcher
from rcgan_tpu_torch.utils import images as timages

SPLIT_KEYS = ("images", "labels", "labels_actual", "labels_random", "labels_biased",
              "labels_inv_weights")


@pytest.fixture(autouse=True)
def _no_synth_cache(monkeypatch):
    monkeypatch.setenv("RCGAN_SYNTH_CACHE", "0")


@pytest.mark.parametrize("seed,image_seed", [(0, None), (5, None), (0, 7)])
def test_synthetic_cifar_is_bit_equal_to_jax(seed, image_seed):
    """64 images (a chunk of 24 so that the per-chunk draws are covered) and
    their labels: the same bits and dtypes as the JAX renderer."""
    want = jcifar._render_synthetic_cifar(64, seed, chunk=24, image_seed=image_seed)
    got = tcifar.synthetic_cifar(64, seed, chunk=24, image_seed=image_seed)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)


def test_synthetic_cache_round_trip_is_bit_exact(tmp_path, monkeypatch):
    """A cached render is served bit for bit, from the port's own cache."""
    monkeypatch.setenv("RCGAN_SYNTH_CACHE", str(tmp_path))
    first = tcifar.synthetic_cifar(16, 3)
    assert len(list(tmp_path.glob("cifar_*.npz"))) == 1
    again = tcifar.synthetic_cifar(16, 3)
    for a, b in zip(first, again):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("noise_seed", [None, 5])
def test_load_gives_the_jax_labels_for_the_same_seed(noise_seed, tmp_path):
    """The label-stream repair: ``load`` (synthetic fallback) gives the JAX
    package's five label arrays, true labels and images, bit for bit, for
    both splits, with ``noise_seed`` defaulting to ``seed``."""
    kw = dict(seed=2, synthetic_train_size=96, synthetic_test_size=40, noise_seed=noise_seed)
    missing = str(tmp_path / "data")
    want = jcifar.load(missing, 0.6, **kw)
    got = tcifar.load(missing, 0.6, **kw)
    for g_split, w_split in zip(got, want):
        assert len(g_split) == len(w_split)
        for k in SPLIT_KEYS:
            g, w = getattr(g_split, k), getattr(w_split, k)
            assert g.dtype == w.dtype, k
            np.testing.assert_array_equal(g, w, err_msg=k)
    # the epoch protocol: contiguous batches, the partial one dropped
    batches = list(got[0].epoch(32))
    assert len(batches) == 3
    np.testing.assert_array_equal(batches[1][1], got[0].labels[32:64])
    assert set(got[0].arrays()) == set(tcifar.DATASET_KEYS)
    with pytest.raises(FileNotFoundError):
        tcifar.load(missing, 0.6, allow_synthetic=False)


def test_engine_draws_equal_jax_and_build_lands_in_the_port(tmp_path):
    """``corrupt_labels`` and ``shuffle_indices`` equal the JAX engine's;
    the library is built into ``rcgan_tpu_torch/_build`` keyed by the
    source's digest, never beside the source."""
    c, _ = build_confusion(0.7, 10)
    y = np.random.RandomState(0).randint(0, 10, 300).astype(np.int32)
    np.testing.assert_array_equal(native.corrupt_labels(9, y, c), jnative.corrupt_labels(9, y, c))
    np.testing.assert_array_equal(native.shuffle_indices(4, 100), jnative.shuffle_indices(4, 100))
    path = native.library_path()
    assert path.exists() and path.parent.name == "_build"
    assert path.parent.parent.name == "rcgan_tpu_torch"
    assert not list(path.parent.parent.glob("native/*.so"))


def test_engine_build_failure_raises(monkeypatch, tmp_path):
    """No fallback: a failed build raises instead of drawing another stream."""
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "b")
    monkeypatch.setattr(native, "GXX_FLAGS", ("-O3", "--no-such-flag"))
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        native.make_label_tuple(0, np.zeros(4, np.int32), np.eye(2), np.eye(2))


def test_prefetcher_yields_in_order_and_raises_the_producer_error():
    assert list(Prefetcher(iter(range(5)), depth=2)) == list(JaxPrefetcher(iter(range(5))))

    def bad():
        yield 1
        raise ValueError("producer")

    p = Prefetcher(bad())
    assert next(p) == 1
    with pytest.raises(ValueError, match="producer"):
        next(p)


def test_sample_grid_png_equals_jax(tmp_path):
    """``save_cifar_samples`` (zlib PNG) against the JAX package's (PIL): the
    same pixels; ``to_uint8_samples`` the same integers."""
    from PIL import Image

    x = np.random.RandomState(1).uniform(-1, 1, (16, 3072)).astype(np.float32)
    timages.save_cifar_samples(x, str(tmp_path / "t.png"))
    jimages.save_cifar_samples(x, str(tmp_path / "j.png"))
    got = np.asarray(Image.open(tmp_path / "t.png"))
    want = np.asarray(Image.open(tmp_path / "j.png"))
    assert got.shape == (128, 128, 3)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(timages.to_uint8_samples(x), jimages.to_uint8_samples(x))
    grey = np.arange(12, dtype=np.uint8).reshape(3, 4)
    np.testing.assert_array_equal(np.asarray(Image.open(io.BytesIO(timages.encode_png(grey)))),
                                  grey)
    with pytest.raises(ValueError, match="square"):
        timages.save_cifar_samples(x[:3], str(tmp_path / "x.png"))
