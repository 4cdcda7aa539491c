"""The port's entry points run on the card unless the caller asks for the
CPU: each of them, called without ``device`` where CUDA is absent, raises
from ``resolve_device`` instead of carrying on on the CPU."""

import numpy as np
import pytest
import torch

from rcgan_tpu_torch import bridge, serving
from rcgan_tpu_torch.algorithms.cifar import CifarAlgoConfig, CifarGAN
from rcgan_tpu_torch.algorithms.mnist import MnistAlgoConfig, MnistGAN
from rcgan_tpu_torch.apps import cifar_app, mnist_app, pggan_app
from rcgan_tpu_torch.data.confusion import build_confusion
from rcgan_tpu_torch.entry import EntryForward
from rcgan_tpu_torch.evals import calibrate_inception, inception, inception_v3
from rcgan_tpu_torch.evals.classifier import cifar_classifier, mnist_classifier
from rcgan_tpu_torch.models.dcgan import DCGANConfig
from rcgan_tpu_torch.models.pggan import PGGAN, PGGANConfig
from rcgan_tpu_torch.models.resnet_gan import Generator, ResnetGANConfig
from rcgan_tpu_torch.parallel import gspmd, mesh
from rcgan_tpu_torch.train import mnist_loop
from rcgan_tpu_torch.train.pggan_loop import PGGANTrainConfig, PGGANTrainer
from rcgan_tpu_torch.train.cifar_loop import CifarTrainConfig, CifarTrainer, new_train_state

CFG = ResnetGANConfig(dim_g=8, dim_d=16, embedding_dim=24)
ACFG, TCFG = CifarAlgoConfig(), CifarTrainConfig()
MCFG = DCGANConfig(gf_dim=8, df_dim=8, gfc_dim=32, dfc_dim=32, disc_type="projection")
MACFG, MTCFG = MnistAlgoConfig(algorithm="rcgan"), mnist_loop.MnistTrainConfig()
PCFG, PBASE = PGGANConfig(z_dim=8, dim=8, max_stage=2), ResnetGANConfig(dim_g=8, dim_d=8)
PTCFG = PGGANTrainConfig()

def _under_a_launcher():
    """``maybe_initialize_distributed`` in a process that torchrun started."""
    import os

    env = {"RANK": "0", "WORLD_SIZE": "1", "MASTER_ADDR": "127.0.0.1",
           "MASTER_PORT": str(mesh.free_port())}
    old = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        mesh.maybe_initialize_distributed()
    finally:
        for k, v in old.items():
            os.environ.pop(k) if v is None else os.environ.__setitem__(k, v)


def _never_called(group):
    raise AssertionError("no rank may start")


# each entry point called with every argument but device
CALLS = {
    "CifarTrainer": lambda: CifarTrainer(CFG, ACFG, TCFG, build_confusion(0.6)[0]),
    "new_train_state": lambda: new_train_state(CFG, ACFG, TCFG),
    "generator_from_jax": lambda: bridge.generator_from_jax({}, CFG),
    "gan_from_jax": lambda: bridge.gan_from_jax({}, None, CFG, ACFG),
    "train_state_from_jax": lambda: bridge.train_state_from_jax(None, CFG, ACFG, TCFG),
    "EntryForward": lambda: EntryForward(CFG),
    "CifarGAN": lambda: CifarGAN(CFG, ACFG),
    "Generator": lambda: Generator(CFG),
    "cifar_classifier": lambda: cifar_classifier(dim=8),
    "cifar_app.main": lambda: cifar_app.main(["--niters", "1"]),
    "cifar_app.main on 2 devices": lambda: cifar_app.main(["--niters", "1", "--mesh_devices",
                                                           "2"]),
    "parallel.launch": lambda: mesh.launch(_never_called, 2),
    "make_dp_tp_mesh": lambda: gspmd.make_dp_tp_mesh(1, 1),
    "gspmd_cycle": lambda: gspmd.gspmd_cycle(CifarTrainer(CFG, ACFG, TCFG,
                                                          build_confusion(0.6)[0]),
                                             gspmd.make_dp_tp_mesh(1, 1)),
    "maybe_initialize_distributed under a launcher": _under_a_launcher,
    "MnistTrainer": lambda: mnist_loop.MnistTrainer(MCFG, MACFG, MTCFG, np.eye(10)),
    "mnist new_train_state": lambda: mnist_loop.new_train_state(MCFG, MACFG, MTCFG),
    "MnistGAN": lambda: MnistGAN(MCFG, MACFG),
    "mnist_train_state_from_jax": lambda: bridge.mnist_train_state_from_jax(None, MCFG, MACFG,
                                                                            MTCFG),
    "mnist_classifier": lambda: mnist_classifier(),
    "mnist_app.main": lambda: mnist_app.main(["--epoch", "1"]),
    "mnist_app.main on 2 devices": lambda: mnist_app.main(["--epoch", "1", "--mesh_devices",
                                                           "2"]),
    "Sampler.from_checkpoint mnist": lambda: serving.Sampler.from_checkpoint("mnist",
                                                                              "/nonexistent"),
    "PGGANTrainer": lambda: PGGANTrainer(PCFG, PBASE, PTCFG),
    "PGGAN": lambda: PGGAN(PCFG, PBASE),
    "pggan_train_state_from_jax": lambda: bridge.pggan_train_state_from_jax(None, PCFG, PBASE,
                                                                            PTCFG),
    "pggan_app.main": lambda: pggan_app.main(["--run_dir", "/nonexistent/pg", "--size", "16",
                                              "--max_stage", "2"]),
    "Sampler.from_checkpoint pggan": lambda: serving.Sampler.from_checkpoint("pggan",
                                                                              "/nonexistent"),
    "Sampler.from_checkpoint cifar": lambda: serving.Sampler.from_checkpoint("cifar",
                                                                              "/nonexistent"),
    "inception_v3.make_logits_fn": lambda: inception_v3.make_logits_fn({}),
    "inception_score": lambda: inception.InceptionScore(lambda s, b: None, lambda x: x, batch=2),
    "real_data_score": lambda: inception.real_data_score(np.zeros((4, 4), np.float32),
                                                         lambda x: x, batch=2),
    "calibrate_inception.main": lambda: calibrate_inception.main(["--data_dir",
                                                                  "/nonexistent"]),
}


@pytest.mark.parametrize("name", sorted(CALLS))
def test_entry_point_defaults_to_the_card(name):
    if torch.cuda.is_available():
        pytest.skip("checks the default where CUDA is absent")
    with pytest.raises(RuntimeError, match="'cuda' requested but CUDA is not available"):
        CALLS[name]()


def test_the_cpu_is_taken_only_when_asked():
    """The same calls with ``device="cpu"`` build on the CPU, and a
    composite's parts land there too."""
    gan = CifarGAN(CFG, ACFG, device="cpu")
    fwd = EntryForward(CFG, device="cpu")
    tr = CifarTrainer(CFG, ACFG, TCFG, np.eye(10, dtype=np.float32), device="cpu")
    assert {p.device.type for m in (gan, fwd, tr.init().gan) for p in m.parameters()} == {"cpu"}
    assert tr.device == torch.device("cpu")
    mts = mnist_loop.MnistTrainer(MCFG, MACFG, MTCFG, np.eye(10), device="cpu").init()
    assert {p.device.type for p in mts.gan.parameters()} | {
        b.device.type for b in mts.gan.buffers()} == {"cpu"}
    pts = PGGANTrainer(PCFG, PBASE, PTCFG, device="cpu").init()
    assert {p.device.type for p in pts.gan.parameters()} | {
        b.device.type for b in pts.gan.buffers()} == {"cpu"}
