"""The port's AOT export of the sampler against the JAX package's, on the
CPU: ``Sampler.export_sampler`` writes one bucket's eager pass as a
``torch.export`` program, ``load_exported`` runs it.

For CIFAR, MNIST and PGGAN at tiny widths, on the same weights (bridged
from JAX) and the same latents and labels: JAX's ``export_sampler`` →
``load_exported`` against the port's artifact, and the artifact bit-equal
to the port's live ``sample_with_z``; the ``--export`` CLI on the port's
checkpoints of all three; a fresh process that loads and runs an artifact
with only ``rcgan_tpu_torch.ops.kernels`` imported; ``torch.library.opcheck``
on ``rcgan::conv3x3`` and ``rcgan::cond_batchnorm`` (schema and fake
tensors; autograd stays in ``Conv3x3Fn``/``CondBatchNormFn``, held by
``tests/test_torch_autograd_kernels.py``)."""

import contextlib
import io
import json
import pathlib
import subprocess
import sys

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from rcgan_tpu import serving as jserving
from rcgan_tpu.algorithms import mnist as jm
from rcgan_tpu.algorithms.cifar import CifarAlgoConfig as JaxCifarAlgoConfig
from rcgan_tpu.data.confusion import one_coin_matrix as jax_one_coin
from rcgan_tpu.models import dcgan as jd
from rcgan_tpu.models import pggan as jp
from rcgan_tpu.models import resnet_gan as jrg
from rcgan_tpu.train import cifar_loop as jcifar
from rcgan_tpu.train import mnist_loop as jmnist
from rcgan_tpu.train import pggan_loop as jpggan
from rcgan_tpu_torch import serving as tserving
from rcgan_tpu_torch.algorithms.cifar import CifarAlgoConfig
from rcgan_tpu_torch.algorithms.mnist import MnistAlgoConfig
from rcgan_tpu_torch.bridge import (generator_from_jax, mnist_train_state_from_jax,
                                    pggan_train_state_from_jax)
from rcgan_tpu_torch.data.confusion import one_coin_matrix
from rcgan_tpu_torch.exported import load_exported
from rcgan_tpu_torch.models import pggan as tp
from rcgan_tpu_torch.models.dcgan import DCGANConfig
from rcgan_tpu_torch.models.resnet_gan import Generator, ResnetGANConfig
from rcgan_tpu_torch.ops.kernels import conv_kernel, norm_kernel, runtime
from rcgan_tpu_torch.train.checkpoint import Checkpointer
from rcgan_tpu_torch.train.cifar_loop import CifarTrainConfig, CifarTrainer
from rcgan_tpu_torch.train.mnist_loop import MnistTrainConfig, MnistTrainer
from rcgan_tpu_torch.train.pggan_loop import PGGANTrainConfig, PGGANTrainer
from torch_parity import TINY_MNIST, mnist_batch, perturb_mnist

torch.set_num_threads(min(2, torch.get_num_threads()))

_ROOT = pathlib.Path(__file__).resolve().parents[1]
# float32 on both sides, sums in other orders (tests/test_torch_serving.py)
_ATOL = 1e-4
BUCKET = 6
CIFAR = dict(dim_g=8, dim_d=8, embedding_dim=12)
PGGAN = dict(z_dim=8, dim=8, max_stage=2)
PG_BASE = dict(dim_g=8, dim_d=8, embedding_dim=12, z_dim=8)
# the rcgan ops of one pass: CIFAR's 7 + 7, PGGAN's 2 convs and 2 cond-BNs a
# stage, MNIST's none
OPS = {"cifar": {"conv3x3": 7, "cond_batchnorm": 7},
       "mnist": {"conv3x3": 0, "cond_batchnorm": 0},
       "pggan": {"conv3x3": 4, "cond_batchnorm": 4}}


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _perturbed(groups, names):
    rs = np.random.RandomState(0)
    groups = _np(groups)
    for g in groups.values():
        for d in g.values():
            for var, a in d.items():
                if var in names:
                    d[var] = (a + 0.3 * rs.randn(*a.shape)).astype(np.float32)
    return jax.tree_util.tree_map(jnp.asarray, groups)


def _cifar_pair():
    tr = jcifar.CifarTrainer(jrg.ResnetGANConfig(**CIFAR), JaxCifarAlgoConfig(),
                             jcifar.CifarTrainConfig(), jax_one_coin(0.6, 10))
    ts = tr.init(jax.random.key(0), 4)
    ts = ts.replace(groups=_perturbed(ts.groups, ("scale", "offset", "Biases", "b")))
    gen = generator_from_jax(_np(ts.params), ResnetGANConfig(**CIFAR), device="cpu")
    return jserving.Sampler(tr, ts, "cifar", buckets=(BUCKET,)), gen


def _mnist_pair():
    cfg = dict(TINY_MNIST, z_dim=16, disc_type="projection")
    batch, _, c = mnist_batch(4, 0)
    jtr = jmnist.MnistTrainer(jd.DCGANConfig(**cfg), jm.MnistAlgoConfig(),
                              jmnist.MnistTrainConfig(), c)
    jts = jtr.init(jax.random.key(0), {k: jnp.asarray(v) for k, v in batch.items()})
    params, state = perturb_mnist(_np(jts.params), _np(jts.state), 0)
    groups = {g: {la: params[la] for la in d} for g, d in jts.groups.items()}
    jts = jts.replace(groups=jax.tree_util.tree_map(jnp.asarray, groups),
                      state=jax.tree_util.tree_map(jnp.asarray, state))
    ts = mnist_train_state_from_jax(_np(jts), DCGANConfig(**cfg), MnistAlgoConfig(),
                                    MnistTrainConfig(), device="cpu")
    return jserving.Sampler(jtr, jts, "mnist", buckets=(BUCKET,), z_dim=16), ts.gan.G


def _pggan_pair():
    jtr = jpggan.PGGANTrainer(jp.PGGANConfig(**PGGAN), jrg.ResnetGANConfig(**PG_BASE),
                              jpggan.PGGANTrainConfig())
    jts = jtr.init(jax.random.key(0), 4)
    jts = jts.replace(groups=_perturbed(jts.groups, ("scale", "offset", "Biases", "b", "gamma",
                                                     "beta")))
    tr = PGGANTrainer(tp.PGGANConfig(**PGGAN), ResnetGANConfig(**PG_BASE), PGGANTrainConfig(),
                      device="cpu")
    ts = pggan_train_state_from_jax(_np(jts), tr.cfg, tr.base, tr.tcfg, device="cpu")
    return jserving.Sampler(jtr, jts, "pggan", buckets=(BUCKET,), z_dim=8), ts.gan.G


PAIRS = {"cifar": _cifar_pair, "mnist": _mnist_pair, "pggan": _pggan_pair}


def _inputs(model: str, z_dim: int, n: int = BUCKET, seed: int = 1):
    rs = np.random.RandomState(seed)
    z = rs.uniform(-1, 1, (n, z_dim)) if model == "mnist" else rs.randn(n, z_dim)
    return z.astype(np.float32), rs.randint(0, 10, n)


def _rcgan_ops(path) -> dict:
    graph = torch.export.load(str(path)).graph
    return {op: sum(n.target is getattr(torch.ops.rcgan, op).default for n in graph.nodes)
            for op in ("conv3x3", "cond_batchnorm")}


@pytest.mark.parametrize("model", ["cifar", "mnist", "pggan"])
def test_exported_sampler_matches_jax_and_the_live_sampler(model, tmp_path):
    """The port's artifact against JAX's exported sampler on the same
    weights (1e-4), and bit-equal to the port's live ``sample_with_z``; the
    program holds one node per conv3x3 and cond-BN of the pass, and tracing
    launched nothing."""
    js, gen = PAIRS[model]()
    s = tserving.Sampler(gen, buckets=(2, BUCKET))
    runtime.reset_launch_counts()
    assert s.export_sampler(str(tmp_path / "port.pt2")) == BUCKET
    assert runtime.launch_counts() == dict.fromkeys(runtime.KERNELS, 0)
    assert _rcgan_ops(tmp_path / "port.pt2") == OPS[model]
    assert js.export_sampler(str(tmp_path / "jax.bin")) == BUCKET
    z, labels = _inputs(model, s.z_dim)
    fn = load_exported(str(tmp_path / "port.pt2"), device="cpu")
    assert fn.meta == {"model": model, "bucket": BUCKET, "z_dim": s.z_dim, "n_labels": 10}
    got = fn(z, labels)
    assert got.dtype == torch.float32 and got.device.type == "cpu"
    got = got.numpy()
    ref = np.asarray(jserving.load_exported(str(tmp_path / "jax.bin"))(z, labels))
    assert got.shape == ref.shape == {"cifar": (BUCKET, 32, 32, 3), "mnist": (BUCKET, 28, 28, 1),
                                      "pggan": (BUCKET, 16, 16, 3)}[model]
    np.testing.assert_allclose(got, ref, rtol=0, atol=_ATOL)
    np.testing.assert_array_equal(got, s.sample_with_z(z, labels))
    # tensors in, on the device the program runs on
    np.testing.assert_array_equal(fn(torch.from_numpy(z), torch.from_numpy(labels)).numpy(), got)


def test_exported_sampler_takes_a_smaller_bucket_and_refuses_bad_inputs(tmp_path):
    s = tserving.Sampler(Generator(ResnetGANConfig(**CIFAR), seed=0, device="cpu"),
                         buckets=(2, BUCKET))
    assert s.export_sampler(str(tmp_path / "b2.pt2"), bucket=2) == 2
    fn = load_exported(str(tmp_path / "b2.pt2"), device="cpu")
    z, labels = _inputs("cifar", 128, n=2, seed=3)
    np.testing.assert_array_equal(fn(z, labels).numpy(), s.sample_with_z(z, labels))
    with pytest.raises(ValueError, match=r"\[0, 10\)"):
        fn(z, np.array([3, 10]))
    with pytest.raises(ValueError, match="takes z \\[2, 128\\]"):
        fn(np.concatenate([z, z]), np.array([0, 1, 2, 3]))
    with pytest.raises(ValueError, match="ints"):
        fn(z, np.array([0.0, 1.0]))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            load_exported(str(tmp_path / "b2.pt2"))  # the default is the card


def _port_checkpoint(model: str, root: pathlib.Path) -> str:
    """A port run of ``model`` at tiny widths: its checkpoint directory,
    with the run's config.json one level up, as the apps lay them out."""
    run = root / model
    if model == "cifar":
        cfg = dict(CIFAR, algorithm="rcgan")
        tr = CifarTrainer(ResnetGANConfig(**cfg), CifarAlgoConfig(), CifarTrainConfig(),
                          one_coin_matrix(0.6, 10), device="cpu")
        ckpt = run / "checkpoint"
    elif model == "mnist":
        cfg = dict(TINY_MNIST, z_dim=16, algorithm="rcgan")
        tr = MnistTrainer(DCGANConfig(**{k: v for k, v in cfg.items() if k != "algorithm"}),
                          MnistAlgoConfig(), MnistTrainConfig(), np.eye(10, dtype=np.float32),
                          device="cpu")
        ckpt = run / "ckpt"
    else:
        cfg = PGGAN
        # the base as the app and the sampler build it from PGGANConfig
        tr = PGGANTrainer(tp.PGGANConfig(**PGGAN), ResnetGANConfig(dim_g=8, dim_d=8, z_dim=8),
                          PGGANTrainConfig(), device="cpu")
        ckpt = run / "ckpt"
    Checkpointer(str(ckpt)).save(0, tr.init(), wait=True)
    (run / "config.json").write_text(json.dumps(cfg))
    return str(ckpt)


@pytest.mark.parametrize("model", ["cifar", "mnist", "pggan"])
def test_export_cli_writes_the_largest_bucket(model, tmp_path):
    """``python -m rcgan_tpu_torch.serving --model M --checkpoint_dir D
    --export F`` writes bucket 100 and says so; the artifact gives the
    checkpoint's live sampler's images bit for bit."""
    ckpt = _port_checkpoint(model, tmp_path)
    path = str(tmp_path / f"{model}.pt2")
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        tserving.main(["--model", model, "--checkpoint_dir", ckpt, "--device", "cpu",
                       "--export", path])
    assert out.getvalue().strip() == f"exported bucket-100 sampler to {path}"
    s = tserving.Sampler.from_checkpoint(model, ckpt, device="cpu")
    z, labels = _inputs(model, s.z_dim, n=100)
    fn = load_exported(path, device="cpu")
    np.testing.assert_array_equal(fn(z, labels).numpy(), s.sample_with_z(z, labels))


_LOADER = """
import sys
import numpy as np
import rcgan_tpu_torch.ops.kernels
from rcgan_tpu_torch.exported import load_exported
fn = load_exported(sys.argv[1], device="cpu")
d = np.load(sys.argv[2])
np.save(sys.argv[3], fn(d["z"], d["labels"]).numpy())
bad = sorted(m for m in sys.modules
             if m.startswith(("rcgan_tpu_torch.models", "rcgan_tpu_torch.serving", "jax",
                              "rcgan_tpu.")))
print(",".join(bad))
"""


def test_artifact_loads_with_only_the_kernels_package_imported(tmp_path):
    """A fresh interpreter that imports ``rcgan_tpu_torch.ops.kernels`` and
    the loader runs the artifact to the live sampler's bits; no module of
    ``rcgan_tpu_torch.models`` (nor serving, nor JAX) was imported."""
    s = tserving.Sampler(Generator(ResnetGANConfig(**CIFAR), seed=0, device="cpu"),
                         buckets=(BUCKET,))
    s.export_sampler(str(tmp_path / "c.pt2"))
    z, labels = _inputs("cifar", 128, seed=5)
    np.savez(tmp_path / "in.npz", z=z, labels=labels)
    proc = subprocess.run([sys.executable, "-c", _LOADER, str(tmp_path / "c.pt2"),
                           str(tmp_path / "in.npz"), str(tmp_path / "out.npy")],
                          capture_output=True, text=True, cwd=str(_ROOT), timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == ""
    np.testing.assert_array_equal(np.load(tmp_path / "out.npy"), s.sample_with_z(z, labels))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ops_pass_opcheck(dtype):
    """Schema and fake implementation of both ops, on the CPU, for float32
    and bf16 inputs (cond-BN with and without its ReLU, int64 and int32
    labels)."""
    gen = torch.Generator().manual_seed(0)
    utils = ("test_schema", "test_faketensor")
    x = torch.randn(2, 6, 6, 8, generator=gen).to(dtype)
    w = torch.randn(3, 3, 8, 16, generator=gen).to(dtype)
    torch.library.opcheck(conv_kernel.conv3x3_op, (x, w), test_utils=utils)
    xs = torch.randn(4, 9, 16, generator=gen).to(dtype)
    scale, offset = torch.randn(10, 16, generator=gen), torch.randn(10, 16, generator=gen)
    for labels, relu in ((torch.tensor([0, 3, 9, 3]), True),
                         (torch.tensor([1, 1, 2, 5], dtype=torch.int32), False)):
        torch.library.opcheck(norm_kernel.cond_batchnorm_op,
                              (xs, labels, scale, offset, 1e-5, relu), test_utils=utils)
        out, moments = norm_kernel.cond_batchnorm_op(xs, labels, scale, offset, 1e-5, relu)
        torch.testing.assert_close(out, norm_kernel.cond_batchnorm_plain(
            xs, labels, scale, offset, 1e-5, relu), rtol=0, atol=0)
        assert moments.dtype == torch.float32 and moments.shape == (2, 16)
        torch.testing.assert_close(moments, torch.stack(norm_kernel._moments_plain(xs, 1e-5)),
                                   rtol=0, atol=0)
