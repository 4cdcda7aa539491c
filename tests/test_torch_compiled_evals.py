"""The evals' programs (``train/graphs.py``), which the card captures, on
the CPU at tiny widths: the CIFAR dev cost's scan, one body over index
rows, against JAX's ``eval_disc_cost`` per batch with JAX's noise and
bit-equal to the loop it replaced; the Inception score over device seed
bases against JAX's estimator on the probabilities of the per-batch loop
it replaced, its program kept across calls, and the real-data score
through the block; label recovery's
block form and the classifier's train step bit-equal to the eager loops
they replaced; the trainers' and the classifier's passes per batch shape;
a program's body that calls another's pass (a stand-in capture); and every
new owner refusing graphs off the card.  CUDA graphs exist only on the
card (``chip_smoke.py`` phase 14)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from rcgan_tpu.evals import inception as jinc
from rcgan_tpu_torch.bridge import to_jax_train_state
from rcgan_tpu_torch.core import rng
from rcgan_tpu_torch.core.module import sn_updates
from rcgan_tpu_torch.data.cifar10 import (dequantize_chw_to_hwc, dequantize_chw_to_hwc_seeded,
                                          device_dataset_of)
from rcgan_tpu_torch.evals import classifier as tcls
from rcgan_tpu_torch.evals import inception as tinc
from rcgan_tpu_torch.evals import recover as trecover
from rcgan_tpu_torch.models import dcgan
from rcgan_tpu_torch.models.resnet_gan import sample as resnet_sample
from rcgan_tpu_torch.ops.kernels import runtime
from rcgan_tpu_torch.train import graphs
from rcgan_tpu_torch.train.state import ScalelessAdam
from test_torch_app_train import B, _dataset, _host_batches, _jax_state, _jax_trainer, _trainer
from torch_parity import TINY_MNIST, StandIn, install_stand_in, perturbed_trees

torch.set_num_threads(min(2, torch.get_num_threads()))


# ---------------------------------------------------------------- dev cost
def _old_dev_cost(tr, ts, sb, seed, noise):
    """The dev cost of one batch as the eager loop computed it: the seeds
    drawn from their ints on the host."""
    cfg = tr.cfg
    b = sb["labels"].shape[0]
    if noise is not None:
        real = dequantize_chw_to_hwc(sb["images"], torch.as_tensor(noise["u"]), cfg.img_size,
                                     cfg.img_dim)
        z = torch.as_tensor(noise["z"])
    else:
        seeds = torch.from_numpy(rng.example_seeds(rng.fold_in(seed, 1), b))
        real = dequantize_chw_to_hwc_seeded(sb["images"], seeds, cfg.img_size, cfg.img_dim)
        z = rng.example_normal(rng.fold_in(seed, 0), b, cfg.z_dim, "cpu")
    with torch.no_grad(), sn_updates(ts.gan, False):
        return ts.gan.disc_loss(dict(sb, real_data=real), z, tr.confusion_actual)["disc_cost"]


@pytest.mark.parametrize("alg", ["rcgan", "rcgan-u"])
def test_dev_cost_scan_rows_match_jax_and_the_loop_they_replace(alg):
    """Three index batches of a resident split, weights perturbed and ``u``
    moved by a cycle: each row's cost, with JAX's own noise injected, within
    1e-4·(1 + |cost|) of JAX's ``eval_disc_cost`` on that batch and key
    (the keys ``eval_disc_cost_scan`` splits), the mean within that of
    JAX's scan and equal to the rows' mean; with and without the noise,
    every row bit-equal to the eager loop the body replaced, and
    ``eval_disc_cost`` on an uploaded batch to that loop too; no state
    moves; two scans share one program."""
    tr = _trainer(alg)
    ts = tr.init(seed=3)
    perturbed_trees(ts.gan, 3)
    d, g = _host_batches(1)
    ts, _ = tr.step(ts, d, g, 1, seed=5)
    jts = _jax_state(to_jax_train_state(ts))
    ds_np = _dataset(16, 2)
    ds = device_dataset_of(ds_np, "cpu")
    idx = np.arange(12, dtype=np.int32).reshape(3, B)[:, ::-1].copy()
    key = jax.random.key(7)
    keys = jax.random.split(key, 3)
    zs, us = [], []
    for k in keys:
        kq, kz = jax.random.split(k)
        us.append(np.asarray(jax.random.uniform(kq, (B, 3072), jnp.float32, 0.0, 1.0 / 128.0)))
        zs.append(np.asarray(jax.random.normal(kz, (B, 128), jnp.float32)))
    noise = {"z": np.stack(zs), "u": np.stack(us)}
    jtr = _jax_trainer(alg)
    jds = {k: jnp.asarray(v) for k, v in ds_np.items()}
    want = [float(jtr.eval_disc_cost(jts, {kk: jnp.take(v, jnp.asarray(idx[i]), axis=0)
                                          for kk, v in jds.items()}, keys[i]))
            for i in range(3)]
    want_mean = float(jtr.eval_disc_cost_scan(jts, jds, jnp.asarray(idx), key))
    before = to_jax_train_state(ts)
    mean = tr.eval_disc_cost_scan(ts, ds, idx, seed=0, noise=noise)
    rows = tr.dev_program.read(3)["cost"]
    for i in range(3):
        assert abs(float(rows[i]) - want[i]) <= 1e-4 * (1 + abs(want[i])), i
    assert abs(float(mean) - want_mean) <= 1e-4 * (1 + abs(want_mean))
    assert torch.equal(mean, rows.mean())
    for with_noise in (True, False):
        nz = noise if with_noise else None
        got = tr.eval_disc_cost_scan(ts, ds, idx, seed=9, noise=nz)
        rows = tr.dev_program.read(3)["cost"]
        old = []
        for i in range(3):
            sb = tr._batch_to_device({k: v[torch.from_numpy(idx[i]).long()]
                                      for k, v in ds.items()})
            old.append(_old_dev_cost(tr, ts, sb, rng.fold_in(9, i),
                                     None if nz is None else {"z": nz["z"][i], "u": nz["u"][i]}))
        assert torch.equal(rows, torch.stack(old)) and torch.equal(got, torch.stack(old).mean())
        batch = {k: v[idx[0]] for k, v in ds_np.items()}
        one = tr.eval_disc_cost(ts, batch, 4, None if nz is None else
                                {"z": nz["z"][0], "u": nz["u"][0]})
        assert one.shape == () and torch.equal(one, _old_dev_cost(
            tr, ts, tr._batch_to_device(batch), 4,
            None if nz is None else {"z": nz["z"][0], "u": nz["u"][0]}))
    for a, b in zip(jax.tree_util.tree_leaves(before),
                    jax.tree_util.tree_leaves(to_jax_train_state(ts))):
        np.testing.assert_array_equal(a, b)


def test_dev_cost_row_packs_the_batch_and_its_seeds():
    """An index row carries the indices, the seed base of ``fold_in(seed,
    0)`` for ``z`` and the dequantisation seeds of ``fold_in(seed, 1)``; a
    row with noise carries ``z`` and ``u`` instead."""
    tr = _trainer("rcgan")
    idx = np.array([3, 1, 2, 0])
    row = tr._dev_cost_row({"index": idx}, 17, None)
    assert row["index"] is idx and int(row["z_base"]) == rng.seed_base(rng.fold_in(17, 0))
    assert np.array_equal(row["q_seeds"], rng.example_seeds(rng.fold_in(17, 1), 4))
    z, u = np.zeros((4, 128), np.float32), np.zeros((4, 3072), np.float32)
    row = tr._dev_cost_row({"index": idx}, 17, {"z": z, "u": u})
    assert set(row) == {"index", "z", "u"}


# ------------------------------------------------------------ the samplers
def test_trainers_sample_one_pass_per_batch_size():
    """The CIFAR and MNIST trainers' ``sample``: equal to the model's pass on
    the same inputs bit for bit, one program per batch size, each result a
    tensor of its own."""
    tr = _trainer("rcgan")
    ts = tr.init(seed=1)
    rs = np.random.RandomState(2)
    outs = []
    for b in (2, 5, 2):
        z = rs.randn(b, 128).astype(np.float32)
        labels = rs.randint(0, 10, b)
        got = tr.sample(ts, z, labels)
        assert torch.equal(got, resnet_sample(ts.gan.G, torch.from_numpy(z),
                                              torch.from_numpy(labels).long()))
        outs.append((got, got.clone()))
    assert all(torch.equal(a, b) for a, b in outs) and len(tr._samples.programs) == 2

    from rcgan_tpu_torch.algorithms.mnist import MnistAlgoConfig
    from rcgan_tpu_torch.data.confusion import build_confusion
    from rcgan_tpu_torch.models.dcgan import DCGANConfig
    from rcgan_tpu_torch.train.mnist_loop import MnistTrainConfig, MnistTrainer

    mtr = MnistTrainer(DCGANConfig(**TINY_MNIST), MnistAlgoConfig(), MnistTrainConfig(),
                       build_confusion(0.3)[0], device="cpu")
    mts = mtr.init(0)
    for b in (3, 4):
        z = rs.uniform(-1, 1, (b, 100)).astype(np.float32)
        y = np.eye(10, dtype=np.float32)[rs.randint(0, 10, b)]
        got = mtr.sample(mts, z, y)
        assert torch.equal(got, dcgan.sample(mts.gan.G, torch.from_numpy(z), torch.from_numpy(y)))
    assert len(mtr._samples.programs) == 2


# --------------------------------------------------------------- inception
def _gen_and_classifier():
    tr = _trainer("rcgan")
    ts = tr.init(seed=4)
    perturbed_trees(ts.gan, 4)
    cls = tcls.cifar_classifier(dim=8, device="cpu")
    cls.init(5)
    return tr, ts, cls


def test_inception_score_on_device_seeds_equals_jax_on_the_loops_probabilities():
    """The score of 6 batches of 4 samples: ``sample_fn`` reads the batch's
    seeds from the device (``batch_seeds``) and draws ``z`` and the labels
    as the per-batch loop drew them from the ints ``fold_in(seed, i)`` and
    ``fold_in(that, 1)``; the loop's probabilities scored by JAX's
    ``preds_to_score`` give the port's score exactly.  The real-data score
    through the block equals JAX's estimator on the loop's probabilities."""
    tr, ts, cls = _gen_and_classifier()

    def sample_fn(seeds, b):
        z = rng.example_normal_from(seeds[0], b, 128)
        labels = torch.remainder(rng.example_bits_from(seeds[1], b, 1)[:, 0], 10)
        return tr.sample(ts, z, labels).reshape(-1, 32, 32, 3)

    state = list(ts.gan.G.state_dict().values()) + list(cls.net.state_dict().values())
    got = tinc.InceptionScore(sample_fn, cls.logits, batch=4, device="cpu")(state, n=24, splits=3,
                                                                          seed=13)
    probs = []
    for i in range(6):
        s = rng.fold_in(13, i)
        z = rng.example_normal(s, 4, 128, "cpu")
        labels = torch.remainder(rng.example_bits(rng.fold_in(s, 1), 4, 1, "cpu")[:, 0], 10)
        imgs = resnet_sample(ts.gan.G, z, labels).reshape(-1, 32, 32, 3)
        with torch.no_grad():
            probs.append(torch.softmax(cls.net(imgs).float(), dim=-1))
    assert got == jinc.preds_to_score(torch.cat(probs).numpy(), 3)
    assert all(np.isfinite(got))
    imgs = np.random.RandomState(6).uniform(-1, 1, (10, 32, 32, 3)).astype(np.float32)
    real = tinc.real_data_score(imgs, cls.logits, batch=4, splits=2, device="cpu")
    with torch.no_grad():
        p = [torch.softmax(cls.net(torch.from_numpy(imgs[i:i + 4])).float(), -1)
             for i in (0, 4)]
    assert real == jinc.preds_to_score(torch.cat(p).numpy(), 2)


# ---------------------------------------------------------------- recovery
def _old_recover(sampler, images, y_actual, cfg, z, y_logits):
    """The eager loop that the block form replaced."""
    b, y_dim = cfg.batch_size, cfg.y_dim
    hard_y = torch.eye(y_dim, dtype=torch.float32).repeat(b, 1)
    imgs = images.float()[:, None]
    mses, zero_ones = [], []
    for _ in range(cfg.epochs):
        z.requires_grad_(True)
        y_logits.requires_grad_(True)
        gen = sampler(z, hard_y).float().reshape((b, y_dim) + tuple(imgs.shape[2:]))
        sq = torch.mean((imgs - gen) ** 2, dim=(-1, -2, -3))
        loss = torch.mean(torch.sum(sq * torch.softmax(y_logits, dim=-1), dim=-1))
        gz, gy = torch.autograd.grad(loss, (z, y_logits))
        with torch.no_grad():
            z = z - cfg.learning_rate * gz
            y_logits = y_logits - cfg.learning_rate * gy
            mses.append(loss.detach())
            zero_ones.append((y_logits.argmax(-1) != y_actual).float().mean())
    return torch.stack(mses), torch.stack(zero_ones), z, y_logits


def test_recovery_block_form_is_bit_equal_to_the_eager_loop():
    """Six steps through a tiny MNIST generator (BN in inference mode,
    weights frozen) from the seeded initial values: the mse and zero-one
    trajectories, the final softmax, ``z`` and the labels bit-equal to the
    loop the block form replaced; the caller's ``init`` arrays are not
    written."""
    gen = dcgan.Generator(dcgan.DCGANConfig(**TINY_MNIST), 0)
    for p in gen.parameters():
        p.requires_grad_(False)
    cfg = trecover.RecoverConfig(batch_size=4, epochs=6)
    rs = np.random.RandomState(2)
    images = torch.from_numpy(rs.rand(4, 28, 28, 1).astype(np.float32))
    y_actual = torch.from_numpy(rs.randint(0, 10, 4))

    def sampler(z, y):
        return gen(z, y, train=False)

    rec, met = trecover.recover_labels(sampler, images, y_actual, cfg, seed=3)
    z0, y0 = trecover.initial_values(cfg, 3, "cpu")
    mse, zo, z, y_logits = _old_recover(sampler, images, y_actual, cfg, z0, y0)
    assert np.array_equal(met["mse"], mse.numpy()) and np.array_equal(met["zero_one"], zo.numpy())
    assert np.array_equal(met["z_recover"], z.numpy())
    assert np.array_equal(met["y_recover"], torch.softmax(y_logits, -1).numpy())
    assert np.array_equal(rec, y_logits.argmax(-1).numpy())
    assert met["program"]["captures"] == 0 and met["program"]["replays"] == 0
    init = tuple(t.numpy().copy() for t in trecover.initial_values(cfg, 3, "cpu"))
    kept = tuple(a.copy() for a in init)
    _, met2 = trecover.recover_labels(sampler, images, y_actual, cfg, init=init)
    assert all(np.array_equal(a, b) for a, b in zip(init, kept))
    assert np.array_equal(met2["mse"], met["mse"])


# -------------------------------------------------------------- classifier
def _old_train(cls, x, y, epochs, batch_size, lr):
    """The eager train loop that the block form replaced."""
    params = list(cls.net.parameters())
    opt = ScalelessAdam(0.9, 0.999)
    state = opt.init(params)
    acc = 0.0
    rs = np.random.RandomState(0)
    for _ in range(epochs):
        perm = rs.permutation(len(x))
        for i in range(0, len(x) - batch_size + 1, batch_size):
            idx = perm[i: i + batch_size]
            xb = torch.from_numpy(np.asarray(x[idx], np.float32))
            yb = torch.from_numpy(np.asarray(y[idx], np.int64))
            logits = cls.net(xb)
            grads = torch.autograd.grad(F.cross_entropy(logits, yb), params)
            opt.update_(params, grads, state, lr)
            acc = (logits.argmax(-1) == yb).float().mean()
    return float(acc)


@pytest.mark.parametrize("model", ["cifar", "mnist"])
def test_classifier_train_step_is_bit_equal_to_the_eager_loop(model):
    """Two epochs of ``RandomState(0)``'s shuffles at batch 8 (a ragged tail
    left out): every parameter and the last batch's accuracy bit-equal to
    the loop the block form replaced; one program, its graph freed."""
    make = (lambda: tcls.cifar_classifier(dim=8, device="cpu")) if model == "cifar" else \
        (lambda: tcls.mnist_classifier(device="cpu"))
    a, b = make(), make()
    a.init(7)
    b.init(7)
    rs = np.random.RandomState(1)
    shape = (32, 32, 3) if model == "cifar" else (28, 28, 1)
    x = rs.uniform(-1, 1, (27,) + shape).astype(np.float32)
    y = rs.randint(0, 10, 27)
    acc_a = a.train(7, x, y, epochs=2, batch_size=8, lr=3e-3)
    acc_b = _old_train(b, x, y, 2, 8, 3e-3)
    assert acc_a == acc_b
    for (n, p), (_, q) in zip(a.net.named_parameters(), b.net.named_parameters()):
        assert torch.equal(p, q), n
    st = a.train_program.captured.stats()
    assert st["captures"] == 0 and a.train_program.captured._graph is None


def test_classifier_logits_one_pass_per_batch_shape():
    """``logits`` and ``predict`` (batches of 5 over 12 images: shapes 5 and
    2) equal the net on the same inputs bit for bit, one program per shape,
    numpy or tensors in."""
    cls = tcls.cifar_classifier(dim=8, device="cpu")
    cls.init(2)
    x = np.random.RandomState(0).uniform(-1, 1, (12, 32, 32, 3)).astype(np.float32)
    with torch.no_grad():
        want = cls.net(torch.from_numpy(x)).float()
    assert torch.equal(cls.logits(x), want) and torch.equal(cls.logits(torch.from_numpy(x)), want)
    assert np.array_equal(cls.predict(x, batch_size=5), want.argmax(-1).numpy())
    assert sorted(s for _, ((_, s),) in cls._logits.programs) == [
        (2, 32, 32, 3), (5, 32, 32, 3), (12, 32, 32, 3)]


# ------------------------------------------- a pass inside another program
def test_a_pass_inside_a_programs_capture_runs_in_its_body(monkeypatch):
    """A stand-in capture (``test_torch_compiled_graphs``): a program whose
    body calls another owner's pass runs that pass inline at its warm-up and
    its capture (the pass makes no program of its own), records the pass's
    launches once per replay, and replays once per later row."""
    standin = StandIn([])
    install_stand_in(monkeypatch, standin)

    def inner_body(inputs, held):
        runtime.count_launch("cond_bn")
        return inputs["x"] * 2

    inner = graphs.Passes(inner_body, {"x": torch.float32}, "cpu", capture=False)
    seen = []

    def outer_body(blk, state):
        seen.append(graphs.inside_program())
        out = inner({"x": blk.row("x")}, None)
        blk.advance()
        return out

    prog = graphs.Program(outer_body, {"x": torch.float32}, "cpu", capture=False)
    prog.captured.capture, prog.captured.device = True, torch.device("cuda")
    runtime.reset_launch_counts()
    prog.run([{"x": np.full(3, float(i), np.float32)} for i in range(4)])
    assert seen == [True, True] and inner.programs == {}
    assert prog.captured.captures == 1 and prog.captured.replays == 3
    assert runtime.launch_counts()["cond_bn"] == 4
    assert not graphs.inside_program()


def test_inception_score_keeps_its_program_across_calls(monkeypatch):
    """Under a stand-in capture: the second score of a state replays the
    first score's graph for every batch (one capture, the warm-up batch
    then replays), and a state that moved is captured again, as are more
    batches than the block holds."""
    install_stand_in(monkeypatch, StandIn([]))
    scorer = tinc.InceptionScore(lambda s, b: torch.zeros(b, 4), lambda x: x, batch=2,
                                 device="cpu")
    captured = scorer.program.captured
    captured.capture, captured.device = True, torch.device("cuda")
    w = torch.zeros(3)
    scorer([w], n=8, splits=2)
    scorer([w], n=8, splits=2, seed=1)
    assert (captured.captures, captured.replays) == (1, 7)
    scorer([torch.zeros(3)], n=8, splits=2)
    assert (captured.captures, captured.replays) == (2, 10)
    scorer([w], n=10, splits=2)
    assert (captured.captures, captured.replays) == (3, 14)


# ------------------------------------------------------ graphs off the card
def _off_card_owners():
    return {
        "EvalClassifier": lambda: tcls.cifar_classifier(dim=8, device="cpu", graphs=True),
        "mnist_classifier": lambda: tcls.mnist_classifier(device="cpu", graphs=True),
        "inception_score": lambda: tinc.InceptionScore(
            lambda s, b: torch.zeros(b, 4), lambda x: x, batch=2, device="cpu", graphs=True),
        "real_data_score": lambda: tinc.real_data_score(
            np.zeros((4, 4), np.float32), lambda x: x, batch=2, device="cpu", graphs=True),
        "recover_labels": lambda: trecover.recover_labels(
            lambda z, y: z, torch.zeros(2, 28, 28, 1), torch.zeros(2, dtype=torch.int64),
            trecover.RecoverConfig(batch_size=2, epochs=1), graphs=True),
        "CifarTrainer": lambda: _trainer_with_graphs(),
    }


def _trainer_with_graphs():
    from rcgan_tpu_torch.algorithms.cifar import CifarAlgoConfig
    from rcgan_tpu_torch.data.confusion import build_confusion
    from rcgan_tpu_torch.models.resnet_gan import ResnetGANConfig
    from rcgan_tpu_torch.train.cifar_loop import CifarTrainConfig, CifarTrainer

    return CifarTrainer(ResnetGANConfig(dim_g=8, dim_d=16, embedding_dim=24), CifarAlgoConfig(),
                        CifarTrainConfig(), build_confusion(0.6)[0], "cpu", graphs=True)


@pytest.mark.parametrize("owner", sorted(_off_card_owners()))
def test_graphs_off_the_card_raise(owner):
    with pytest.raises(ValueError, match="CUDA graphs need a CUDA device"):
        _off_card_owners()[owner]()
