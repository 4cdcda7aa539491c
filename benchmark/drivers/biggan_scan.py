"""BigGAN training through ``CifarTrainer.step_scan`` over a dataset resident
on the device: ``cifar_scan.py``'s session, its blocks, inputs and
reference, with the trainer built on ``models.biggan.BigGANConfig``
(``CifarGAN`` builds its modules by the config's architecture).

Traffic parameters: those of ``cifar_scan.py`` (``algorithm``, ``alpha``,
``perm_classifier``, ``confuse_init``, ``scan_block``, ``check_steps``,
``trace_units``).  The same seed gives the same inputs and weights.
"""

from __future__ import annotations

from typing import Dict, List, Mapping

import numpy as np
import torch

from benchmark.drivers.cifar_scan import Session as CifarSession
from benchmark.drivers.cifar_scan import one_coin
from benchmark.reference.layers import fold_in


class Session(CifarSession):
    """:class:`cifar_scan.Session` with a BigGAN trainer."""

    def __init__(self, config: Mapping, traffic: Mapping, seed: int, device,
                 reference_module):
        from rcgan_tpu_torch.algorithms.cifar import CifarAlgoConfig
        from rcgan_tpu_torch.models.biggan import BigGANConfig
        from rcgan_tpu_torch.train.cifar_loop import CifarTrainConfig, CifarTrainer

        self.config, self.traffic, self.device = config, traffic, torch.device(device)
        self.ref = reference_module
        model, train = config["model"], config["train"]
        self.b = config["batch_size"]
        self.n_critic = train["n_critic"]
        self.gb = train["gen_bs_multiple"] * self.b
        self.block = traffic["scan_block"]
        self.unit_steps = self.block
        self.unit_images = self.block * self.n_critic * self.b
        self.seed = seed
        self.train_seed = fold_in(seed, 4)
        v = model["vocab_size"]
        self.c = one_coin(traffic["alpha"], v)
        self.c_inv = np.linalg.inv(self.c)
        self.dataset = self._dataset()
        self.n = len(self.dataset["labels"])
        self.rng = np.random.default_rng(fold_in(seed, 3))
        self._perm = np.empty(0, np.int64)
        self._pos = 0

        cfg = BigGANConfig(**model, algorithm=traffic["algorithm"])
        acfg = CifarAlgoConfig(algorithm=traffic["algorithm"], loss_type=config["loss_type"],
                               perm_classifier=bool(traffic.get("perm_classifier")),
                               confuse_init=bool(traffic.get("confuse_init")),
                               vocab_size=v)
        dtype = getattr(torch, config["compute_dtype"])
        self.trainer = CifarTrainer(cfg, acfg, CifarTrainConfig(**train), self.c, self.device,
                                    compute_dtype=dtype, device_dataset=self.dataset)
        self.ts = self.trainer.init(seed & 0x7FFFFFFF)
        self.before = self._load_weights()
        self.metrics: List[torch.Tensor] = []
        self.first: Dict = {}
        self.fed: List = []  # the first cycles' feeds, for the reference


def build(config: Mapping, traffic: Mapping, seed: int, device, reference_module) -> Session:
    return Session(config, traffic, seed, device, reference_module)
