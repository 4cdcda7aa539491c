"""The port's serving slice against the JAX package's, on the CPU: the same
weights and the same numpy latents through both ``Sampler``s and
``Coalescer``s; the port's HTTP server; the export script; import hygiene."""

import ast
import io
import json
import pathlib
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest

import jax
import torch
from PIL import Image

from rcgan_tpu import serving as jserving
from rcgan_tpu.algorithms.cifar import CifarAlgoConfig
from rcgan_tpu.data.confusion import one_coin_matrix
from rcgan_tpu.models.resnet_gan import ResnetGANConfig as JaxConfig
from rcgan_tpu.train.checkpoint import Checkpointer
from rcgan_tpu.train.cifar_loop import CifarTrainConfig, CifarTrainer
from rcgan_tpu_torch import serving as tserving
from rcgan_tpu_torch.bridge import generator_from_jax
from rcgan_tpu_torch.models.resnet_gan import ResnetGANConfig

torch.set_num_threads(min(2, torch.get_num_threads()))

_KW = dict(dim_g=8, dim_d=8, embedding_dim=12)
_ROOT = pathlib.Path(__file__).resolve().parents[1]
# float32 on both sides, sums in other orders through 7 convs and 7 cond-BNs
_ATOL = 1e-4


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    """(JAX sampler, port sampler, run dir) on the same weights: a tiny
    trainer's init with its G affine tables and biases perturbed, saved as
    an orbax checkpoint with the run's config.json beside it."""
    tr = CifarTrainer(JaxConfig(**_KW), CifarAlgoConfig(), CifarTrainConfig(),
                      one_coin_matrix(0.6, 10))
    ts = tr.init(jax.random.key(0), 4)
    rs = np.random.RandomState(0)
    groups = jax.tree_util.tree_map(np.asarray, ts.groups)
    for d in groups["gen"].values():
        for var, a in d.items():
            if var in ("scale", "offset", "Biases", "b"):
                d[var] = (a + 0.3 * rs.randn(*a.shape)).astype(np.float32)
    ts = ts.replace(groups=groups)
    run = tmp_path_factory.mktemp("run")
    Checkpointer(str(run / "checkpoint")).save(0, ts, wait=True)
    (run / "config.json").write_text(json.dumps(dict(_KW, algorithm="rcgan")))
    js = jserving.Sampler(tr, ts, "cifar", buckets=(2, 10))
    gen = generator_from_jax(jax.tree_util.tree_map(np.asarray, ts.params),
                             ResnetGANConfig(**_KW), device="cpu")
    return js, tserving.Sampler(gen, buckets=(2, 10)), run


def test_sample_with_z_matches_jax(pair):
    js, ts_, _ = pair
    rs = np.random.RandomState(1)
    for n in (2, 7, 13):  # exact bucket, padded, two passes (10 + 3 -> bucket 10)
        z = rs.randn(n, 128).astype(np.float32)
        labels = rs.randint(0, 10, n)
        ref = js.sample_with_z(z, labels)
        out = ts_.sample_with_z(z, labels)
        assert out.shape == ref.shape == (n, 32, 32, 3)
        np.testing.assert_allclose(out, ref, rtol=0, atol=_ATOL)


def test_coalescer_submit_matches_jax(pair):
    js, ts_, _ = pair
    jc, tc = jserving.Coalescer(js, max_wait_ms=1.0), tserving.Coalescer(ts_, max_wait_ms=1.0)
    try:
        for labels, seed in (([3, 7], 11), ([0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 5], 4)):
            np.testing.assert_allclose(tc.submit(labels, seed), jc.submit(labels, seed),
                                       rtol=0, atol=_ATOL)
        # a request's z is a function of its seed alone
        np.testing.assert_array_equal(tc.submit([3, 7], 11), tc.submit([3, 7], 11))
        with pytest.raises(ValueError, match="labels"):
            tc.submit([3, 10], 0)
    finally:
        jc.close()
        tc.close()


def test_coalescer_merges_concurrent_requests(pair):
    _, ts_, _ = pair
    mx = tserving.ServingMetrics()
    co = tserving.Coalescer(ts_, max_wait_ms=200.0, metrics=mx)
    try:
        barrier = threading.Barrier(4)
        outs = [None] * 4

        def client(i):
            barrier.wait(timeout=30)
            outs[i] = co.submit([i, i + 1], seed=i)

        threads = [threading.Thread(target=client, args=(i,)) for i in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
        assert all(o is not None and o.shape == (2, 32, 32, 3) for o in outs)
        snap = mx.snapshot()
        assert snap["batched_requests_total"] == 4
        assert snap["batches_total"] < 4 and snap["coalesced_batches_total"] >= 1
    finally:
        co.close()


def test_sample_draws_from_a_torch_generator(pair):
    _, ts_, _ = pair
    labels = [i % 10 for i in range(12)]
    a = ts_.sample(labels, torch.Generator().manual_seed(5))
    b = ts_.sample(labels, torch.Generator().manual_seed(5))
    assert a.shape == (12, 32, 32, 3) and np.abs(a).max() <= 1.0
    np.testing.assert_array_equal(a, b)
    assert ts_._bucket_for(2) == 2 and ts_._bucket_for(3) == 10


def test_png_grid_matches_jax_pixels():
    rs = np.random.RandomState(2)
    for shape in ((3, 8, 8, 3), (5, 4, 4, 3), (1, 32, 32, 3)):
        imgs = rs.rand(*shape).astype(np.float32)
        mine = np.asarray(Image.open(io.BytesIO(tserving._to_png_grid(imgs))))
        theirs = np.asarray(Image.open(io.BytesIO(jserving._to_png_grid(imgs))))
        np.testing.assert_array_equal(mine, theirs)


def _get(url, headers=None):
    req = urllib.request.Request(url, headers=headers or {})
    try:
        with urllib.request.urlopen(req, timeout=120) as r:
            return r.status, r.headers.get("Content-Type"), r.read()
    except urllib.error.HTTPError as e:
        return e.code, None, e.read()


def test_http_server(pair):
    _, ts_, _ = pair
    srv = tserving.make_server({"alpha": ts_, "beta": ts_}, port=0, auth_token="sekrit",
                               coalesce_wait_ms=1.0)
    base = f"http://127.0.0.1:{srv.server_address[1]}"
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    auth = {"Authorization": "Bearer sekrit"}
    try:
        assert _get(f"{base}/healthz")[::2] == (200, b"ok")
        assert _get(f"{base}/models")[0] == 401
        assert _get(f"{base}/sample?labels=1")[0] == 401
        assert json.loads(_get(f"{base}/models", auth)[2]) == ["alpha", "beta"]
        code, ctype, body = _get(f"{base}/sample?model=beta&labels=1,2,3&seed=5&token=sekrit")
        assert (code, ctype) == (200, "image/png")
        assert Image.open(io.BytesIO(body)).size == (64, 64)  # ceil(sqrt(3)) = 2 tiles a side
        code, _, body = _get(f"{base}/sample?n=16&seed=0", auth)
        assert code == 200 and Image.open(io.BytesIO(body)).size == (128, 128)
        for bad in ("labels=bogus", "n=0", "n=100000000", "labels=1,10", "labels=-1",
                    "labels=" + ",".join(["1"] * 1025)):
            assert _get(f"{base}/sample?{bad}", auth)[0] == 400, bad
        assert _get(f"{base}/sample?model=nope&labels=1", auth)[0] == 404
        assert _get(f"{base}/nothing", auth)[0] == 404
        text = _get(f"{base}/metrics", auth)[2].decode()
        assert 'rcgan_requests_total{model="beta"} 1' in text
        assert 'rcgan_samples_total{model="default"}' not in text
        assert 'rcgan_samples_total{model="alpha"} 16' in text
    finally:
        srv.shutdown()
        srv.server_close()
        t.join(timeout=10)


def test_export_script_and_from_checkpoint(pair, tmp_path):
    """orbax checkpoint -> scripts/export_generator_npz.py -> the port's
    Sampler.from_checkpoint gives the JAX sampler's images."""
    import importlib.util

    js, _, run = pair
    spec = importlib.util.spec_from_file_location(
        "export_generator_npz", _ROOT / "scripts" / "export_generator_npz.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    out = tmp_path / "export"
    mod.main(["--checkpoint_dir", str(run / "checkpoint"), "--out_dir", str(out)])
    assert (out / "generator.npz").exists()
    assert json.loads((out / "config.json").read_text())["dim_g"] == 8

    s = tserving.Sampler.from_checkpoint("cifar", str(out), buckets=(2, 10), device="cpu")
    assert s.cfg.dim_g == 8 and s.buckets == (2, 10)
    z = np.random.RandomState(3).randn(5, 128).astype(np.float32)
    np.testing.assert_allclose(s.sample_with_z(z, [0, 1, 2, 3, 4]),
                               js.sample_with_z(z, [0, 1, 2, 3, 4]), rtol=0, atol=_ATOL)

    png = tmp_path / "grid.png"
    tserving.main(["--model", "cifar", "--checkpoint_dir", str(out), "--device", "cpu",
                   "--n", "5", "--out", str(png)])
    assert Image.open(png).size == (64, 64)  # floor(sqrt(5)) = 2 tiles a side

    # the PGGAN sampler restores a PGGAN run's checkpoint; a CIFAR export has none
    with pytest.raises(FileNotFoundError, match="no checkpoint"):
        tserving.Sampler.from_checkpoint("pggan", str(out), device="cpu")
    # the MNIST sampler restores an MNIST run's checkpoint; a CIFAR export has none
    with pytest.raises(FileNotFoundError, match="no checkpoint"):
        tserving.Sampler.from_checkpoint("mnist", str(out), device="cpu")
    with pytest.raises(FileNotFoundError, match="generator.npz"):
        tserving.Sampler.from_checkpoint("cifar", str(tmp_path), device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            tserving.Sampler.from_checkpoint("cifar", str(out))  # the default is cuda


def _imported_modules(path: pathlib.Path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


def test_port_imports_neither_jax_nor_the_jax_package():
    files = sorted((_ROOT / "rcgan_tpu_torch").rglob("*.py")) + [_ROOT / "chip_smoke.py"]
    assert len(files) > 10
    walked = {f.relative_to(_ROOT).as_posix() for f in files}
    assert {f"rcgan_tpu_torch/{m}.py" for m in (
        "models/pggan", "train/pggan_loop", "apps/pggan_app", "evals/inception_v3",
        "evals/calibrate_inception", "serving", "parallel/__init__", "parallel/mesh",
        "parallel/gspmd", "train/graphs", "train/checkpoint")} <= walked
    bad = [(f.relative_to(_ROOT).as_posix(), m) for f in files for m in _imported_modules(f)
           if m.split(".")[0] in ("jax", "jaxlib", "rcgan_tpu", "flax", "optax", "orbax",
                                  "triton")]
    assert bad == []
