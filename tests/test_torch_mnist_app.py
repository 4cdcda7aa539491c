"""The MNIST app's pieces in the port against the JAX package's, on the
CPU: the data (``synthetic_digits`` and ``load_mnist``'s arrays bit-equal
to JAX's, RCGAN+y's re-noising and its schedule), label recovery from
JAX's initial ``(z, y_logits)``, the flags on the recipes' command lines,
the GIF writer, the MNIST ``Sampler``, and the app itself end to end at a
tiny width (run dir, checkpoint, restore, recovery), with ``--mesh_devices``
above 1 refused.
"""

import io
import json
import os
import re
from pathlib import Path

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch
from PIL import Image, ImageSequence

from rcgan_tpu import config as jconfig
from rcgan_tpu import serving as jserving
from rcgan_tpu.algorithms import mnist as jm
from rcgan_tpu.data import mnist as jdata
from rcgan_tpu.evals import recover as jrecover
from rcgan_tpu.models import dcgan as jd
from rcgan_tpu.train import mnist_loop as jloop
from rcgan_tpu.train.checkpoint import Checkpointer as JaxCheckpointer
from rcgan_tpu.utils import visualize as jvis
from rcgan_tpu_torch import config as tconfig
from rcgan_tpu_torch import serving as tserving
from rcgan_tpu_torch.algorithms.mnist import MnistAlgoConfig
from rcgan_tpu_torch.apps import mnist_app
from rcgan_tpu_torch.bridge import mnist_train_state_from_jax
from rcgan_tpu_torch.data import mnist as tdata
from rcgan_tpu_torch.data.confusion import one_coin_matrix
from rcgan_tpu_torch.evals import recover as trecover
from rcgan_tpu_torch.models.dcgan import DCGANConfig
from rcgan_tpu_torch.train.checkpoint import Checkpointer, state_payload
from rcgan_tpu_torch.train.mnist_loop import MnistTrainConfig, MnistTrainer
from rcgan_tpu_torch.utils import visualize as tvis
from torch_parity import TINY_MNIST, mnist_batch, perturb_mnist

torch.set_num_threads(min(2, torch.get_num_threads()))

_ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module", autouse=True)
def _synth_cache(tmp_path_factory):
    """One on-disk cache of the 70 000 synthetic digits for the module (both
    frameworks' renders land there, under their own keys)."""
    old = os.environ.get("RCGAN_SYNTH_CACHE")
    os.environ["RCGAN_SYNTH_CACHE"] = str(tmp_path_factory.mktemp("synth"))
    yield
    if old is None:
        os.environ.pop("RCGAN_SYNTH_CACHE")
    else:
        os.environ["RCGAN_SYNTH_CACHE"] = old


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


# --------------------------------------------------------------------- data
def test_synthetic_digits_are_bit_equal_to_jax():
    x, y = tdata.synthetic_digits(n=300, seed=3)
    jx, jy = jdata.synthetic_digits(n=300, seed=3)
    assert x.dtype == np.uint8 and x.shape == (300, 28, 28, 1)
    np.testing.assert_array_equal(x, jx)
    np.testing.assert_array_equal(y, jy)


@pytest.mark.parametrize("seed", [547, 11])
def test_load_mnist_is_bit_equal_to_jax(seed):
    """The synthetic split (no idx files in the data dir): the images, the
    true labels and the four label arrays the native engine draws from
    ``seed + 1``, with and without ``real_match`` and ``class_depend``."""
    for real_match in (False, True):
        for class_depend in (False, True):
            args = ("/nonexistent", 0.3, class_depend, real_match)
            got = tdata.load_mnist(*args, seed=seed)
            want = jdata.load_mnist(*args, seed=seed)
            assert len(got) == 70000
            for f in ("x", "y_actual", "y_real", "y_gen", "y_fake", "y_real_weights",
                      "confusion", "confusion_inv"):
                a, b = getattr(got, f), getattr(want, f)
                assert a.dtype == b.dtype, f
                np.testing.assert_array_equal(a, b, err_msg=f"{f} {real_match} {class_depend}")
            if real_match:
                np.testing.assert_array_equal(got.y_gen, got.y_real)
    with pytest.raises(FileNotFoundError):
        tdata.load_mnist("/nonexistent", 0.3, allow_synthetic=False)


def test_renoise_and_noise_schedule_equal_jax():
    data = tdata.load_mnist("/nonexistent", 0.3)
    jdat = jdata.load_mnist("/nonexistent", 0.3)
    for epoch in (0, 31, 50, 90):
        rel = tdata.noise_schedule_alpha(epoch, 0.3, 0.25, 30, 80)
        assert rel == jdata.noise_schedule_alpha(epoch, 0.3, 0.25, 30, 80)
        c = one_coin_matrix(rel, 10)
        got = tdata.renoise_labels(np.random.RandomState(epoch), data, c)
        want = jdata.renoise_labels(np.random.RandomState(epoch), jdat, c)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
    assert tdata.noise_schedule_alpha(5, 0.6, 0.3, 30, 80) == jdata.noise_schedule_alpha(
        5, 0.6, 0.3, 30, 80)
    with pytest.raises(ValueError, match="0.9"):
        tdata.noise_schedule_alpha(0, 0.3, 0.95, 30, 80)


# ----------------------------------------------------------------- recovery
def _jax_trainer_state(seed=0, z_dim=100):
    """A JAX MNIST trainer (rcgan-u with the perm classifier, projection D,
    tiny widths) and its state with the BN moving statistics perturbed."""
    cfg = jd.DCGANConfig(**TINY_MNIST, z_dim=z_dim, disc_type="projection")
    acfg = jm.MnistAlgoConfig(algorithm="rcgan", estimate_confuse=True, perm_regularizer=True)
    batch, _, c = mnist_batch(4, seed)
    jtr = jloop.MnistTrainer(cfg, acfg, jloop.MnistTrainConfig(), c)
    jts = jtr.init(jax.random.key(seed), {k: jnp.asarray(v) for k, v in batch.items()})
    params, state = perturb_mnist(_np(jts.params), _np(jts.state), seed)
    groups = {g: {la: params[la] for la in d} for g, d in jts.groups.items()}
    jts = jts.replace(groups=jax.tree_util.tree_map(jnp.asarray, groups),
                      state=jax.tree_util.tree_map(jnp.asarray, state))
    tcfg = MnistTrainConfig()
    ts = mnist_train_state_from_jax(
        _np(jts), DCGANConfig(**TINY_MNIST, z_dim=z_dim, disc_type="projection"),
        MnistAlgoConfig(algorithm="rcgan", estimate_confuse=True, perm_regularizer=True), tcfg,
        device="cpu")
    return jtr, jts, ts


def test_recover_labels_matches_jax_from_its_initial_values():
    """Three SGD steps at the reference's lr 5e2 through G in eval mode from
    JAX's own initial ``(z, y_logits)``: the loss and zero-one trajectories,
    the final softmax and z, the accuracy; then the wrong-image panel from
    the same inputs."""
    jtr, jts, ts = _jax_trainer_state()
    b = 8
    cfg = jrecover.RecoverConfig(batch_size=b, epochs=3)
    rs = np.random.RandomState(0)
    images = rs.rand(b, 28, 28, 1).astype(np.float32)
    y_actual = rs.randint(0, 10, b)
    rng = jax.random.key(7)
    _, jmet = jrecover.recover_labels(lambda z, y: jtr.sample(jts, z, y), jnp.asarray(images),
                                      jnp.asarray(y_actual), cfg, rng)
    # JAX's initial values, drawn as its recover_labels draws them
    k1, k2 = jax.random.split(rng)
    lim_y, lim_z = np.sqrt(6.0 / (b + 10)), np.sqrt(6.0 / (b * 10 + 100))
    y0 = np.asarray(jax.random.uniform(k1, (b, 10), jnp.float32, -lim_y, lim_y))
    z0 = np.asarray(jax.random.uniform(k2, (b * 10, 100), jnp.float32, -lim_z, lim_z))
    tcfg = trecover.RecoverConfig(batch_size=b, epochs=3)
    for p in ts.gan.parameters():
        p.requires_grad_(False)
    _, met = trecover.recover_labels(lambda z, y: ts.gan.G(z, y, train=False),
                                     torch.from_numpy(images), torch.from_numpy(y_actual),
                                     tcfg, init=(z0, y0))
    for k in ("mse", "y_recover", "z_recover"):
        want = np.asarray(jmet[k])
        np.testing.assert_allclose(met[k], want, rtol=0, atol=1e-4 * np.abs(want).max(),
                                   err_msg=k)
    np.testing.assert_array_equal(met["zero_one"], np.asarray(jmet["zero_one"]))
    assert met["accuracy"] == jmet["accuracy"]
    # the port's own initial values: Glorot-uniform ranges, one row per example
    z, y = trecover.initial_values(tcfg, 7, "cpu")
    assert z.shape == (b * 10, 100) and float(z.abs().max()) <= lim_z
    assert y.shape == (b, 10) and float(y.abs().max()) <= lim_y

    def sampler_np(z, y):
        return jtr.sample(jts, jnp.asarray(z), jnp.asarray(y))

    panel = trecover.render_wrong_image_diagnostics(
        lambda z, y: ts.gan.G(torch.from_numpy(z), torch.from_numpy(y), train=False).numpy(),
        images, y_actual, met["y_recover"], met["z_recover"], os.devnull, n_wrong=4)
    np.testing.assert_allclose(panel, _jax_panel(sampler_np, images, y_actual, met), rtol=0,
                               atol=1e-5)


def _jax_panel(sampler, images, y_actual, met):
    """JAX's panel array (its PNG goes to a scratch buffer)."""
    import tempfile

    with tempfile.TemporaryDirectory() as d:
        return jrecover.render_wrong_image_diagnostics(
            sampler, images, y_actual, met["y_recover"], met["z_recover"],
            os.path.join(d, "panel.png"), n_wrong=4)


def test_recover_labels_draws_nothing_on_the_host_per_step():
    """The port's trajectories stay on the device until the end: one array
    per metric, one value per step."""
    _, _, ts = _jax_trainer_state()
    cfg = trecover.RecoverConfig(batch_size=4, epochs=5)
    rs = np.random.RandomState(1)
    rec, met = trecover.recover_labels(lambda z, y: ts.gan.G(z, y, train=False),
                                       torch.from_numpy(rs.rand(4, 28, 28, 1).astype(np.float32)),
                                       torch.from_numpy(rs.randint(0, 10, 4)), cfg)
    assert rec.shape == (4,) and met["mse"].shape == (5,) and met["zero_one"].shape == (5,)
    assert np.allclose(met["y_recover"].sum(-1), 1.0, atol=1e-6)
    with pytest.raises(ValueError, match="wants 4 images"):
        trecover.recover_labels(lambda z, y: z, torch.zeros(3, 28, 28, 1),
                                torch.zeros(3, dtype=torch.int64), cfg)


# -------------------------------------------------------------------- flags
def _recipe_argv(script: Path):
    """The argv a recipe script passes to ``mnist_main.py``, its shell
    variables substituted."""
    text = script.read_text()
    env = dict(re.findall(r"^(\w+)='?([^'\n]*)'?$", text, re.M))
    cmd = text.split("mnist_main.py", 1)[1].split("|&")[0].replace("\\\n", " ")
    cmd = re.sub(r"\$\{(\w+)\}", lambda m: env[m.group(1)], cmd)
    return [a.strip('"') for a in cmd.split()]


@pytest.mark.parametrize("recipe", ["rcgan", "rcganu", "rcgany", "ambient", "biased",
                                    "unbiased"])
def test_mnist_flags_parse_the_recipes_as_jax(recipe):
    argv = _recipe_argv(_ROOT / "scripts" / f"run_{recipe}.sh")
    assert "--algorithm" in argv
    got = vars(tconfig.parse(tconfig.mnist_flags(), argv))
    want = vars(jconfig.parse(jconfig.mnist_flags(), argv))
    assert got == want
    if recipe == "rcganu":
        assert got["perm_regularizer"] is True and got["aux_classifier"] is True


def test_mnist_flags_defaults_equal_jax():
    assert vars(tconfig.parse(tconfig.mnist_flags(), [])) == vars(
        jconfig.parse(jconfig.mnist_flags(), []))
    archived = (_ROOT / "docs/runs/mnist_rcgan_100ep/command.txt").read_text().split()[1:]
    assert vars(tconfig.parse(tconfig.mnist_flags(), archived)) == vars(
        jconfig.parse(jconfig.mnist_flags(), archived))


# ---------------------------------------------------------------------- GIF
def _gif_frames(path):
    with Image.open(path) as im:
        return [np.asarray(f.convert("L")) for f in ImageSequence.Iterator(im)], im.info


def test_gif_decodes_to_jax_frames(tmp_path):
    """``make_gif`` without an image library: PIL decodes the port's file to
    the frames JAX's (PIL-written) file decodes to, with its delay and loop."""
    rs = np.random.RandomState(0)
    frames = [rs.rand(28, 28, 1).astype(np.float32) for _ in range(5)]
    frames[2][0, 0, 0] = 1.0  # the extremes
    frames[3][0, 0, 0] = 0.0
    tvis.make_gif(frames, str(tmp_path / "port.gif"), duration_ms=80)
    jvis.make_gif(frames, str(tmp_path / "jax.gif"), duration_ms=80)
    got, info = _gif_frames(tmp_path / "port.gif")
    want, jinfo = _gif_frames(tmp_path / "jax.gif")
    assert len(got) == 5
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    assert info["duration"] == jinfo["duration"] == 80 and info["loop"] == 0
    big = [rs.randint(0, 256, (280, 280)).astype(np.uint8) for _ in range(2)]
    tvis.make_gif(big, str(tmp_path / "big.gif"))
    for a, b in zip(_gif_frames(tmp_path / "big.gif")[0], big):
        np.testing.assert_array_equal(a, b)


def test_visualize_writes_every_option(tmp_path):
    """Options 0-4 on a stand-in sampler write JAX's file names."""
    def sampler(z, y):
        return np.broadcast_to(((z[:, :1] + 1) / 2)[:, :, None, None], (len(z), 28, 28, 1))

    for option, want in ((0, {"test.png"}), (1, {"test_arange_0.png", "test_arange_3.png"}),
                         (2, {"test_gif_0.gif", "test_gif_3.gif"}),
                         (3, {"test_gif_0.gif", "test_gif_3.gif"}),
                         (4, {"test_gif_0.gif", "test_gif_merged.gif"})):
        out = tmp_path / str(option)
        tvis.visualize(sampler, 4, 10, 4, str(out), option=option, n_frames=4)
        assert want <= set(os.listdir(out)), option
    assert len(_gif_frames(tmp_path / "4" / "test_gif_merged.gif")[0]) == 8


def test_show_all_variables_counts_the_tree():
    _, jts, ts = _jax_trainer_state()
    from rcgan_tpu_torch.core.module import param_tree

    assert tvis.show_all_variables(param_tree(ts.gan)) == jvis.show_all_variables(
        _np(jts.params))


# ------------------------------------------------------------------ sampler
def test_mnist_sampler_matches_jax(tmp_path):
    """The same trained state as a JAX checkpoint and as the port's, each
    beside the run's config.json: the two ``Sampler.from_checkpoint("mnist")``
    give the same images (U[-1, 1] latents from the request's seed, G with BN
    in inference mode, [0, 1]), bucketed and through the coalescer; the
    port's HTTP server answers with a grey PNG grid."""
    jtr, jts, ts = _jax_trainer_state(z_dim=16)
    config = {"algorithm": "rcgan", "estimate_confuse": True, "aux_classifier": True,
              "disc_type": "projection", "z_dim": 16, **TINY_MNIST, "batch_size": 4,
              "spectral_norm": True, "max_norm": True, "concat_y": False}
    for side in ("jax", "port"):
        (tmp_path / side).mkdir()
        (tmp_path / side / "config.json").write_text(json.dumps(config))
    JaxCheckpointer(str(tmp_path / "jax" / "ckpt")).save(0, jts, wait=True)
    Checkpointer(str(tmp_path / "port" / "ckpt")).save(0, ts, wait=True)
    js = jserving.Sampler.from_checkpoint("mnist", str(tmp_path / "jax" / "ckpt"), buckets=(4, 8))
    s = tserving.Sampler.from_checkpoint("mnist", str(tmp_path / "port" / "ckpt"), buckets=(4, 8),
                                         device="cpu")
    assert s.model == "mnist" and s.n_labels == 10 and s.z_dim == 16
    labels = [3, 1, 4, 1, 5, 9, 2, 6, 5, 3, 5]
    z = np.random.RandomState(2).uniform(-1, 1, (len(labels), 16)).astype(np.float32)
    got = s.sample_with_z(z, labels)
    assert got.shape == (11, 28, 28, 1) and got.min() >= 0 and got.max() <= 1
    np.testing.assert_allclose(got, js.sample_with_z(z, labels), rtol=0, atol=1e-5)
    rng = np.random.default_rng(4)
    np.testing.assert_array_equal(s.draw_z(rng, 3), js.draw_z(np.random.default_rng(4), 3))
    jc, tc = jserving.Coalescer(js), tserving.Coalescer(s)
    try:
        np.testing.assert_allclose(tc.submit([0, 7], seed=5), jc.submit([0, 7], seed=5),
                                   rtol=0, atol=1e-5)
    finally:
        jc.close()
        tc.close()
    with pytest.raises(ValueError, match=r"\[0, 10\)"):
        s.check_labels([10])
    np.testing.assert_array_equal(tserving.to_unit_range(got, "mnist"), got)

    srv = tserving.make_server(s, port=0)
    import threading
    import urllib.request

    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    try:
        url = f"http://127.0.0.1:{srv.server_address[1]}/sample?n=5&seed=1"
        with urllib.request.urlopen(url, timeout=120) as r:
            im = Image.open(io.BytesIO(r.read()))
        assert im.size == (84, 84) and im.mode == "L"  # ceil(sqrt(5)) = 3 tiles a side
    finally:
        srv.shutdown()
        srv.server_close()
        t.join(timeout=10)
    assert not t.is_alive()


# ---------------------------------------------------------------------- app
TINY_APP = ["--algorithm", "rcgan", "--alpha", "0.3", "--disc_type", "projection",
            "--estimate_confuse", "--aux_classifier", "--noadd_noise", "--noconcat_y",
            "--spectral_norm", "--max_norm", "--batch_size", "20", "--train_size", "200",
            "--epoch", "5", "--recover_epoch", "4", "--recover_batch_size", "20",
            "--eval_train_size", "512", "--compute_dtype", "float32"]


@pytest.fixture
def small_app(monkeypatch, tmp_path):
    """The app at TINY_MNIST widths, everything under ``tmp_path``."""
    import dataclasses

    build = mnist_app.build_configs

    def narrow(flags):
        cfg, acfg, tcfg = build(flags)
        return dataclasses.replace(cfg, **TINY_MNIST), acfg, tcfg

    monkeypatch.setattr(mnist_app, "build_configs", narrow)
    return ["--checkpoint_dir", str(tmp_path), "--data_dir", str(tmp_path / "data"),
            "--logs_dir", str(tmp_path / "logs")]


def test_app_end_to_end_then_restore_and_recover(small_app, tmp_path):
    """rcgan-u with the perm classifier: 5 epochs of 10 iterations in blocks
    on the resident dataset, gen-label-acc and the learned-C report at epoch
    4, the final checkpoint, recovery.txt and the panel; then a run without
    ``--train`` on the same run dir restores the state bit for bit and
    recovers to the same accuracy."""
    stats = {}
    ts, rec = mnist_app.main(TINY_APP + ["--train"] + small_app, device="cpu", stats=stats)
    assert ts.step == 50 and 0.0 <= rec["accuracy"] <= 1.0
    assert stats["train"][1] == 50 and stats["gen_label_acc"][1] == 1
    runs = [d for d in os.listdir(tmp_path) if d.startswith("rcgan_0.3_projection_")]
    assert len(runs) == 1
    run = tmp_path / runs[0]
    assert {"ckpt", "samples", "recovery.txt", "recover_wrong_images.png", "command.txt",
            "config.json", "scripts", "log.pkl", "metrics.jsonl"} <= set(os.listdir(run))
    assert os.listdir(run / "ckpt") == ["50"]
    assert (tmp_path / "mnist_eval_classifier.pkl").exists()
    assert Image.open(run / "recover_wrong_images.png").mode == "L"
    assert (run / "recovery.txt").read_text() == f"accuracy {rec['accuracy']}\n"
    import pickle

    with open(run / "log.pkl", "rb") as f:
        hist = pickle.load(f)
    assert len(hist["d_loss"]) == 50 and len(hist["gen_label_acc"]) == 1
    assert "c_recovery_tv_perm" in hist

    again, rec2 = mnist_app.main(TINY_APP + ["--checkpoint", runs[0]] + small_app, device="cpu")
    a, b = state_payload(ts), state_payload(again)
    for g in a["groups"]:
        for k in a["groups"][g]:
            assert torch.equal(a["groups"][g][k], b["groups"][g][k]), k
    for k in a["state"]:
        assert torch.equal(a["state"][k], b["state"][k]), k
    assert a["step"] == b["step"] == 50
    assert rec2["accuracy"] == rec["accuracy"]
    np.testing.assert_array_equal(rec2["y_recover"], rec["y_recover"])


def test_app_per_iteration_path_and_add_noise(small_app, tmp_path, monkeypatch):
    """``--nodevice_data`` steps one batch at a time; ``--add_noise``
    re-noises the labels each epoch and records the schedule; the sample
    grid and checkpoint cadence (700 iterations, 7 here) lands on
    ``counter % cadence == 1``."""
    monkeypatch.setattr(mnist_app, "SAMPLE_EVERY", 7)
    argv = [a for a in TINY_APP if a != "--noadd_noise"]
    argv += ["--train", "--nodevice_data", "--add_noise", "--noise_alpha", "0.25",
             "--noise_start", "0", "--noise_end", "3", "--epoch", "2", "--train_size", "160",
             "--recover_epoch", "1"]
    ts, _ = mnist_app.main(argv + small_app, device="cpu")
    assert ts.step == 16
    run = tmp_path / next(d for d in os.listdir(tmp_path) if d.startswith("rcgan_"))
    assert sorted(os.listdir(run / "samples")) == ["train_00_0006.png", "train_01_0005.png"]
    assert sorted(os.listdir(run / "ckpt"), key=int) == ["8", "15", "16"]
    import pickle

    with open(run / "log.pkl", "rb") as f:
        hist = pickle.load(f)
    assert len(hist["noise_rel_alpha"]) == 2 and len(hist["d_loss"]) == 16


def test_app_refuses_more_than_one_device_and_other_datasets(small_app, monkeypatch):
    """More devices than the cards present raise (two ranks on the CPU run:
    ``tests/test_torch_parallel_app.py``); so does another dataset."""
    with monkeypatch.context() as m:
        m.setattr(torch.cuda, "is_available", lambda: True)
        m.setattr(torch.cuda, "device_count", lambda: 1)
        with pytest.raises(ValueError, match="2 devices asked for; 1 card"):
            mnist_app.main(TINY_APP + ["--mesh_devices", "2"] + small_app, device="cuda")
    with pytest.raises(SystemExit):
        mnist_app.main(["--dataset", "cifar"] + small_app, device="cpu")
