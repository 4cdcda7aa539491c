"""The port's Inception-v3 scorer against the JAX package's, on the CPU:
the whole graph against the committed golden file
(``tests/golden/inception_v3_golden.npz``: the same ``random_weights(0)``
and input as ``test_inception_v3.py::test_full_graph_golden_pin``);
``random_weights`` bit-equal to JAX's; ``preprocess`` against JAX's
``jax.image.resize``; conv + frozen BN against JAX's; the loader and
validator; ``make_logits_fn`` on the flat CIFAR layout; the CIFAR app
scoring with Inception-v3 where its weights lie in the data dir; and the
calibration CLI.
"""

import os
import pickle

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from rcgan_tpu.evals import inception_v3 as jiv3
from rcgan_tpu_torch.apps import cifar_app
from rcgan_tpu_torch.evals import calibrate_inception
from rcgan_tpu_torch.evals import classifier as tcls
from rcgan_tpu_torch.evals import inception_v3 as iv3

torch.set_num_threads(min(2, torch.get_num_threads()))

GOLDEN = os.path.join(os.path.dirname(__file__), "golden", "inception_v3_golden.npz")


def _params(seed=0):
    return {k: torch.from_numpy(v) for k, v in iv3.random_weights(seed).items()}


def test_full_graph_matches_the_golden_file():
    """Every block's shape, and its mean and std within the JAX test's
    tolerances (2e-3 relative, 1e-4 absolute), and the logits (2e-3, 5e-3)."""
    golden = dict(np.load(GOLDEN))
    x = np.random.RandomState(1).uniform(-2.0, 2.0, (2, 299, 299, 3)).astype(np.float32)
    with torch.no_grad():
        logits, blocks = iv3.inception_v3_blocks(_params(0), torch.from_numpy(x))
    names = {k[len("shape."):] for k in golden if k.startswith("shape.")}
    assert set(blocks) == names
    for name in sorted(names):
        v = blocks[name].numpy()
        assert tuple(v.shape) == tuple(golden[f"shape.{name}"]), name
        np.testing.assert_allclose(v.mean(), golden[f"mean.{name}"], rtol=2e-3, atol=1e-4,
                                   err_msg=name)
        np.testing.assert_allclose(v.std(), golden[f"std.{name}"], rtol=2e-3, atol=1e-4,
                                   err_msg=name)
    np.testing.assert_allclose(logits.numpy(), golden["logits"], rtol=2e-3, atol=5e-3)
    with torch.no_grad():
        again = iv3.inception_v3_logits(_params(0), torch.from_numpy(x))
    assert torch.equal(again, logits)


@pytest.mark.parametrize("seed", [0, 1])
def test_random_weights_are_jax_bits(seed):
    mine, want = iv3.random_weights(seed), jiv3.random_weights(seed)
    assert list(mine) == list(want) and iv3.weight_spec() == jiv3.weight_spec()
    for k in want:
        assert mine[k].dtype == want[k].dtype
        np.testing.assert_array_equal(mine[k], want[k], err_msg=k)


@pytest.mark.parametrize("size", [16, 32, 64, 128])
def test_preprocess_matches_jax_resize(size):
    """Bilinear to 299 with half-pixel centres and ImageNet normalisation,
    from each size the apps score (16 to 128 pixels): within 1e-5 of the
    values' scale."""
    x = np.random.RandomState(size).uniform(-1, 1, (2, size, size, 3)).astype(np.float32)
    want = np.asarray(jiv3.preprocess(jnp.asarray(x)))
    got = iv3.preprocess(torch.from_numpy(x)).numpy()
    assert got.shape == (2, 299, 299, 3)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("stride,padding", [(1, 0), (2, 1), (1, (0, 3)), (1, (1, 0))])
def test_conv_bn_matches_jax(stride, padding):
    """Conv (no bias) + frozen BN + ReLU as JAX's ``_conv_bn``, NHWC on both
    sides (the port runs NCHW inside), within 1e-5 of the scale."""
    rs = np.random.RandomState(0)
    x = rs.randn(2, 11, 11, 5).astype(np.float32)
    p = {"blk.conv.weight": rs.randn(7, 5, 3, 3).astype(np.float32),
         "blk.bn.weight": rs.rand(7).astype(np.float32) + 0.5,
         "blk.bn.bias": rs.randn(7).astype(np.float32),
         "blk.bn.running_mean": rs.randn(7).astype(np.float32),
         "blk.bn.running_var": rs.rand(7).astype(np.float32) + 0.5}
    want = np.asarray(jiv3._conv_bn({k: jnp.asarray(v) for k, v in p.items()}, "blk",
                                    jnp.asarray(x), stride=stride, padding=padding))
    got = iv3._conv_bn({k: torch.from_numpy(v) for k, v in p.items()}, "blk",
                       torch.from_numpy(x).permute(0, 3, 1, 2), stride=stride,
                       padding=padding).permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * np.abs(want).max())


def test_load_find_and_validate_weights(tmp_path):
    """The aux head and counters are dropped on load, float32 kept; the
    validator names missing keys and misshapen weights, as JAX's."""
    w = iv3.random_weights(0)
    w["AuxLogits.fc.weight"] = np.zeros((1000, 768), np.float32)
    w["Conv2d_1a_3x3.bn.num_batches_tracked"] = np.asarray(7)
    path = str(tmp_path / "inception_v3.npz")
    np.savez(path, **w)
    loaded = iv3.load_weights(path)
    assert set(loaded) == set(iv3.weight_spec())
    iv3.validate_weights(loaded)
    assert iv3.find_weights(str(tmp_path)) == path and iv3.find_weights(str(tmp_path / "x")) is None
    with open(tmp_path / "w.pkl", "wb") as f:
        pickle.dump(iv3.random_weights(1), f)
    assert set(iv3.load_weights(str(tmp_path / "w.pkl"))) == set(iv3.weight_spec())
    missing = dict(loaded)
    del missing["Mixed_7c.branch_pool.conv.weight"]
    with pytest.raises(ValueError, match="missing"):
        iv3.validate_weights(missing)
    bad = dict(loaded)
    bad["fc.weight"] = bad["fc.weight"][:, :100]
    with pytest.raises(ValueError, match="fc.weight"):
        iv3.validate_weights(bad)


def test_make_logits_fn_takes_the_flat_cifar_layout():
    """Flat ``[B, 3072]`` HWC samples and ``[B, 32, 32, 3]`` images give the
    same logits, those of the graph on the preprocessed images."""
    params = iv3.random_weights(1)
    fn = iv3.make_logits_fn(params, device="cpu")
    imgs = np.random.RandomState(3).uniform(-1, 1, (2, 32, 32, 3)).astype(np.float32)
    flat = fn(imgs.reshape(2, 3072))
    assert flat.shape == (2, 1000) and flat.dtype == torch.float32
    assert torch.equal(flat, fn(torch.from_numpy(imgs)))
    with torch.no_grad():
        want = iv3.inception_v3_logits(_params(1), iv3.preprocess(torch.from_numpy(imgs)))
    assert torch.equal(flat, want)


def test_cifar_app_scores_with_inception_v3_where_its_weights_lie(tmp_path, monkeypatch):
    """With ``inception_v3.npz`` in the data dir the app logs the
    Inception-v3 route and scores with its logits: the ``logits_fn`` it
    hands ``InceptionScore`` gives the 1000-way logits of the weights in
    the file (the estimator is cut to 10 samples here)."""
    monkeypatch.setenv("RCGAN_SYNTH_CACHE", str(tmp_path / "synth"))
    monkeypatch.setattr(cifar_app, "cifar_classifier",
                        lambda device: tcls.cifar_classifier(dim=8, device=device))
    data = tmp_path / "data"
    data.mkdir()
    np.savez(data / "inception_v3.npz", **iv3.random_weights(2))
    seen = {}

    class Small(cifar_app.InceptionScore):
        def __init__(self, sample_fn, logits_fn, batch, **kw):
            seen["logits_fn"] = logits_fn
            super().__init__(sample_fn, logits_fn, batch=5, **kw)

        def __call__(self, state, n):
            return super().__call__(state, n=10, splits=2)

    monkeypatch.setattr(cifar_app, "InceptionScore", Small)
    log_file = str(tmp_path / "log.txt")
    cifar_app.main(["--algorithm", "rcgan", "--alpha", "0.6", "--parent_dir", str(tmp_path),
                    "--expt_dir", "x", "--log_file", log_file, "--niters", "1",
                    "--inception_freq", "1", "--batch_size", "8", "--dim_g", "8",
                    "--dim_d", "16", "--embedding_dim", "12", "--n_critic", "2",
                    "--mesh_devices", "1", "--nomulti_gpu_multi_batch",
                    "--eval_train_size", "16", "--synthetic_train_size", "48",
                    "--compute_dtype", "float32", "--data_dir", str(data)], device="cpu")
    assert "inception scorer: Inception-v3 from" in open(log_file).read()
    imgs = torch.from_numpy(
        np.random.RandomState(5).uniform(-1, 1, (2, 32, 32, 3)).astype(np.float32))
    got = seen["logits_fn"](imgs)
    assert got.shape == (2, 1000)
    assert torch.equal(got, iv3.make_logits_fn(iv3.random_weights(2), device="cpu")(imgs))


def _cifar_batch(path, n, seed):
    rs = np.random.RandomState(seed)
    with open(path, "wb") as f:
        pickle.dump({b"data": rs.randint(0, 256, (n, 3072)).astype(np.uint8),
                     b"labels": list(rs.randint(0, 10, n))}, f)


def test_calibration_cli_scores_real_batches_with_inception_v3(tmp_path, capsys):
    """The CLI on a data dir with CIFAR-format batches and Inception-v3
    weights: it names the Inception-v3 scorer and scores whole batches
    (20 images in 2 splits), as JAX's."""
    for i, name in enumerate([f"data_batch_{k}" for k in range(1, 6)] + ["test_batch"]):
        _cifar_batch(tmp_path / name, 4, i)
    np.savez(tmp_path / "inception_v3.npz", **iv3.random_weights(0))
    mean, std, scorer = calibrate_inception.main(
        ["--data_dir", str(tmp_path), "--n", "20", "--batch", "10", "--splits", "2"],
        device="cpu")
    assert scorer.startswith("inception_v3") and np.isfinite(mean) and mean >= 1.0
    out = capsys.readouterr().out
    assert "real-data inception score over 20 images" in out and "WARNING" not in out
