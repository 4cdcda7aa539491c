"""The port's entry points run on the card unless the caller asks for the
CPU: each of them, called without ``device`` where CUDA is absent, raises
from ``resolve_device`` instead of carrying on on the CPU."""

import numpy as np
import pytest
import torch

from rcgan_tpu_torch import bridge
from rcgan_tpu_torch.algorithms.cifar import CifarAlgoConfig, CifarGAN
from rcgan_tpu_torch.apps import cifar_app
from rcgan_tpu_torch.data.confusion import build_confusion
from rcgan_tpu_torch.entry import EntryForward
from rcgan_tpu_torch.evals.classifier import cifar_classifier
from rcgan_tpu_torch.models.resnet_gan import Generator, ResnetGANConfig
from rcgan_tpu_torch.train.cifar_loop import CifarTrainConfig, CifarTrainer, new_train_state

CFG = ResnetGANConfig(dim_g=8, dim_d=16, embedding_dim=24)
ACFG, TCFG = CifarAlgoConfig(), CifarTrainConfig()

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
