"""Two properties of the port's entry points, on the CPU: the float32 policy
(every entry point that chooses float32 turns TF32 off, whichever is built
first; bfloat16 ones leave the flags alone) and ``example_normal`` (``z``
keyed per example: a row does not depend on the batch it is drawn in).
"""

import numpy as np
import pytest

import torch

from rcgan_tpu_torch.algorithms.cifar import CifarAlgoConfig, CifarGAN
from rcgan_tpu_torch.core import rng as trng
from rcgan_tpu_torch.core.module import float32_policy
from rcgan_tpu_torch.data.confusion import build_confusion
from rcgan_tpu_torch.entry import EntryForward
from rcgan_tpu_torch.models.resnet_gan import Generator, ResnetGANConfig
from rcgan_tpu_torch.serving import Sampler
from rcgan_tpu_torch.train.cifar_loop import CifarTrainConfig, CifarTrainer
from torch_parity import TINY

torch.set_num_threads(min(2, torch.get_num_threads()))

CFG = ResnetGANConfig(**TINY)


def _build(kind: str, dtype: torch.dtype):
    if kind == "Sampler":  # serving is float32 throughout
        return Sampler(Generator(CFG, device="cpu"))
    if kind == "EntryForward":
        return EntryForward(CFG, device="cpu", compute_dtype=dtype)
    if kind == "CifarGAN":
        return CifarGAN(CFG, CifarAlgoConfig(), device="cpu", compute_dtype=dtype)
    return CifarTrainer(CFG, CifarAlgoConfig(), CifarTrainConfig(), build_confusion(0.6)[0],
                        "cpu", dtype)


@pytest.fixture
def tf32_on():
    """Both TF32 flags on for the test (cuDNN's is on by default), restored
    afterwards."""
    old = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = True
    yield
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = old


# ---------------------------------------------------------- float32 policy
@pytest.mark.parametrize("kind", ["Sampler", "EntryForward", "CifarGAN", "CifarTrainer"])
def test_float32_entry_points_turn_tf32_off(kind, tf32_on):
    """Each float32 entry point, built first in a process where TF32 is on,
    leaves both flags False: float32 on the card is float32 throughout, as
    the CPU parity tests hold it to JAX at ``highest``."""
    _build(kind, torch.float32)
    assert not torch.backends.cudnn.allow_tf32
    assert not torch.backends.cuda.matmul.allow_tf32


@pytest.mark.parametrize("kind", ["EntryForward", "CifarGAN", "CifarTrainer"])
def test_bfloat16_entry_points_leave_the_tf32_flags_alone(kind, tf32_on):
    _build(kind, torch.bfloat16)
    assert torch.backends.cudnn.allow_tf32 and torch.backends.cuda.matmul.allow_tf32


def test_float32_policy_is_the_one_switch(tf32_on):
    float32_policy(torch.bfloat16)
    assert torch.backends.cudnn.allow_tf32 and torch.backends.cuda.matmul.allow_tf32
    float32_policy(torch.float32)
    assert not (torch.backends.cudnn.allow_tf32 or torch.backends.cuda.matmul.allow_tf32)
    import rcgan_tpu_torch.serving as serving
    assert not hasattr(serving, "pin_float32")  # no second switch beside it


# ------------------------------------------------------------ example_normal
def test_example_normal_rows_do_not_depend_on_the_batch():
    """Rows [k, k + m) of a draw of n equal a draw of m from ``first_index``
    k, bit for bit; a draw is a pure function of its seed; other seeds give
    other rows; float32 [n, dim]."""
    whole = trng.example_normal(42, 64, 128, "cpu")
    assert whole.shape == (64, 128) and whole.dtype == torch.float32
    for k, m in ((0, 8), (8, 16), (40, 24), (63, 1)):
        assert torch.equal(trng.example_normal(42, m, 128, "cpu", first_index=k), whole[k:k + m])
    assert torch.equal(trng.example_normal(42, 64, 128, "cpu"), whole)
    other = trng.example_normal(43, 64, 128, "cpu")
    assert bool((other != whole).any(dim=1).all())
    # a narrower draw shares its columns' hashes: column j depends on (seed, row, j) only
    assert torch.equal(trng.example_normal(42, 64, 32, "cpu"), whole[:, :32])


def test_example_bits_match_the_numpy_hash():
    """The device's integer ops (int64, arithmetic shifts masked into
    logical ones) give splitmix64's bits as numpy's uint64 computes them."""
    got = trng.example_bits(5, 7, 3, "cpu", first_index=2).numpy().astype(np.uint64)
    base = trng._mix(np.array([5], np.uint64))
    rows = trng._mix(trng._mix(np.arange(2, 9, dtype=np.uint64)) ^ base)
    want = trng._mix(rows[:, None] ^ trng._mix(np.arange(3, dtype=np.uint64))[None, :])
    np.testing.assert_array_equal(got, want)
    big = trng.example_bits((1 << 63) + 12345, 2, 2, "cpu", first_index=(1 << 40))
    assert big.dtype == torch.int64 and len(set(big.flatten().tolist())) == 4


def test_example_normal_is_standard_normal():
    """10⁵ values: mean within 4 standard errors of 0 (4/sqrt(n) = 0.013),
    variance within 0.02 of 1, skewness and excess kurtosis within 0.05, a
    16-bin histogram over [-4, 4] within 5 standard errors of the normal's
    bin probabilities, no value beyond Box-Muller's reach with a 32-bit
    uniform (6.7), rows and columns uncorrelated (|r| < 0.02)."""
    z = trng.example_normal(7, 1000, 100, "cpu").double()
    flat = z.flatten()
    n = flat.numel()
    assert bool(torch.isfinite(flat).all()) and flat.abs().max().item() < 6.7
    assert abs(flat.mean().item()) < 4 / n ** 0.5
    assert abs(flat.var().item() - 1.0) < 0.02
    assert abs((flat ** 3).mean().item()) < 0.05
    assert abs((flat ** 4).mean().item() - 3.0) < 0.05
    edges = torch.linspace(-4, 4, 17, dtype=torch.float64)
    cdf = 0.5 * (1 + torch.erf(edges / 2 ** 0.5))
    prob = cdf[1:] - cdf[:-1]
    hist = torch.histc(flat, bins=16, min=-4, max=4) / n
    assert bool(((hist - prob).abs() <= 5 * torch.sqrt(prob * (1 - prob) / n)).all())
    assert abs(torch.corrcoef(torch.stack([z[:-1].flatten(), z[1:].flatten()]))[0, 1].item()) < 0.02
    assert abs(torch.corrcoef(torch.stack([z[:, :-1].flatten(),
                                           z[:, 1:].flatten()]))[0, 1].item()) < 0.02


def test_the_cycle_draws_z_per_example(monkeypatch):
    """``CifarTrainer.step`` without injected noise draws both ``z`` with
    ``example_normal`` in its device-base form (``example_normal_from``, the
    seed's ``seed_base`` read from the cycle's block, so that a CUDA graph
    replays it with each cycle's seed): the G step's at ``gen_bs_multiple *
    B`` rows, each critic step's at ``B``, each from its own seed of the
    cycle."""
    draws = []
    real = trng.example_normal_from
    monkeypatch.setattr(trng, "example_normal_from",
                        lambda base, n, dim, first_index=0:
                        draws.append((int(base), n, dim, first_index))
                        or real(base, n, dim, first_index))
    tcfg = CifarTrainConfig(n_critic=2, gen_bs_multiple=2)
    tr = CifarTrainer(CFG, CifarAlgoConfig(), tcfg, build_confusion(0.6)[0], "cpu")
    ts = tr.init(0)
    rs = np.random.RandomState(0)
    d = {"images": rs.randint(0, 256, (2, 4, 3072)).astype(np.uint8),
         "labels": rs.randint(0, 10, (2, 4)), "labels_random": rs.randint(0, 10, (2, 4)),
         "labels_biased": rs.randint(0, 10, (2, 4)),
         "labels_inv_weights": rs.uniform(-0.5, 1.5, (2, 4, 10)).astype(np.float32)}
    g = {"random": rs.randint(0, 10, 8), "biased": rs.randint(0, 10, 8)}
    tr.step(ts, d, g, 1, 9)
    seeds = trng.cycle_seeds(9, 2, 4)
    base = trng.seed_base
    assert draws == [(base(seeds.g_z), 8, CFG.z_dim, 0), (base(seeds.d_z[0]), 4, CFG.z_dim, 0),
                     (base(seeds.d_z[1]), 4, CFG.z_dim, 0)]
