"""CIFAR training through ``CifarTrainer.step_scan`` over a dataset resident
on the device: the app's main path (``apps/cifar_app.py`` with
``--scan_block``), one block of cycles a call, the block's metrics read
back to the host once a block, as the app reads them.

Traffic parameters (the workload file's ``traffic``): ``algorithm``
(``rcgan`` or ``rcgan-u``), ``alpha`` (the one-coin confusion matrix's
diagonal), ``perm_classifier``, ``confuse_init``, ``scan_block`` (cycles a
call), ``check_steps`` (the first cycles that the reference follows) and
``trace_units`` (blocks under the profiler in a traced run).

Inputs from the seed: the dataset on the device (uint8 images, true labels,
their one-coin corruption, uniform generator labels and their corruption,
the rows of ``C⁻¹``), the weights (``benchmark/weights.py``), and on the
host the index batches (a fresh permutation each epoch) and the generator's
labels of every block.  The same seed gives the same inputs; another seed
the same shapes and work.
"""

from __future__ import annotations

import gc
from typing import Dict, List, Mapping

import numpy as np
import torch

from benchmark.reference.layers import Key, fold_in
from benchmark.weights import draw


def one_coin(alpha: float, k: int) -> np.ndarray:
    """P(observed j | true i): ``alpha`` on the diagonal, the rest spread."""
    off = (1.0 - alpha) / (k - 1)
    return off * np.ones((k, k)) + (alpha - off) * np.eye(k)


def _corrupt(labels: torch.Tensor, cdf: torch.Tensor, gen: torch.Generator) -> torch.Tensor:
    u = torch.rand(labels.shape, generator=gen, device=labels.device)
    return (u[:, None] > cdf[labels]).sum(dim=1).clamp(max=cdf.shape[1] - 1)


class Session:
    """The program and its inputs for one run of a cell."""

    def __init__(self, config: Mapping, traffic: Mapping, seed: int, device,
                 reference_module):
        from rcgan_tpu_torch.algorithms.cifar import CifarAlgoConfig
        from rcgan_tpu_torch.models.resnet_gan import ResnetGANConfig
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

        cfg = ResnetGANConfig(**model, algorithm=traffic["algorithm"])
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

    # ------------------------------------------------------------ inputs
    def _dataset(self) -> Dict[str, torch.Tensor]:
        """The resident dataset, drawn on the device from the seed."""
        n, dim = self.config["dataset"]["train_size"], self.config["model"]["img_size"] ** 2 * \
            self.config["model"]["img_dim"]
        v = self.config["model"]["vocab_size"]
        gen = torch.Generator(device=self.device)
        gen.manual_seed(fold_in(self.seed, 2))
        dev = self.device
        cdf = torch.as_tensor(np.cumsum(self.c, axis=-1), dtype=torch.float32, device=dev)
        images = torch.randint(0, 256, (n, dim), generator=gen, device=dev, dtype=torch.uint8)
        actual = torch.randint(0, v, (n,), generator=gen, device=dev)
        labels = _corrupt(actual, cdf, gen)
        rand = torch.randint(0, v, (n,), generator=gen, device=dev)
        biased = _corrupt(rand, cdf, gen)
        inv = torch.as_tensor(self.c_inv, dtype=torch.float32, device=dev)[labels]
        return {"images": images, "labels": labels.to(torch.int32),
                "labels_random": rand.to(torch.int32), "labels_biased": biased.to(torch.int32),
                "labels_inv_weights": inv}

    def _weights(self):
        model = self.config["model"]
        specs = self.ref.param_specs(model, self.traffic)
        diag = self.traffic.get("confuse_init_diag", 0.2)
        start = (lambda shape: torch.from_numpy(self.ref.confusion_init(shape[0], diag))) \
            if self.traffic.get("confuse_init") else None
        return draw(specs, self.ref.sn_scopes(model, self.traffic), fold_in(self.seed, 1),
                    self.device, start)

    @torch.no_grad()
    def _load_weights(self) -> Dict[Key, torch.Tensor]:
        """The benchmark's weights and ``u`` into the program, by name;
        returns the weights on the host."""
        from rcgan_tpu_torch.core.module import scoped_modules

        params, u = self._weights()
        have = {k: p for ps in self.ts.groups.values() for k, p in ps.items()}
        if set(have) != set(params):
            raise ValueError(f"the program's leaves differ from the reference's: "
                             f"{sorted(set(have) ^ set(params))}")
        for k, p in have.items():
            p.copy_(params[k])
        mods = scoped_modules(self.ts.gan)
        for s, v in u.items():
            mods[s].u.copy_(v)
        return {k: v.cpu() for k, v in params.items()}

    def _index_block(self, k: int) -> np.ndarray:
        """``[k, n_critic, B]`` index batches, walking a fresh permutation of
        the dataset each epoch."""
        need = k * self.n_critic * self.b
        out = np.empty(need, np.int64)
        got = 0
        while got < need:
            if self._pos + self.b > len(self._perm):
                self._perm, self._pos = self.rng.permutation(self.n), 0
            take = min(need - got, (len(self._perm) - self._pos) // self.b * self.b)
            out[got:got + take] = self._perm[self._pos:self._pos + take]
            got += take
            self._pos += take
        return out.reshape(k, self.n_critic, self.b)

    def _g_labels(self, k: int):
        v = self.c.shape[0]
        rand = self.rng.integers(0, v, (k, self.gb))
        u = self.rng.random((k, self.gb, 1))
        biased = (u > np.cumsum(self.c, axis=-1)[rand]).sum(axis=-1).clip(max=v - 1)
        return rand, biased

    def _call(self, k: int) -> Dict[str, torch.Tensor]:
        idx = self._index_block(k)
        rand, biased = self._g_labels(k)
        if len(self.fed) < self.traffic["check_steps"]:
            self.fed.append((idx, rand, biased))
        _, ms = self.trainer.step_scan(self.ts, idx, rand, biased, self.train_seed)
        return ms

    # ------------------------------------------------------------ phases
    def first_steps(self) -> None:
        """The first ``check_steps`` cycles one call each, through the
        window's call and feed; keeps the losses, the first gradients (the
        critic's after the first cycle, the generator's and the confusion
        matrix's after their first step), the state after the first cycle
        (before the generator's first step) and the leaves after the last."""
        from rcgan_tpu_torch.core.module import scoped_modules

        losses = []
        grads: Dict[Key, torch.Tensor] = {}
        mid: Dict = {}
        for j in range(self.traffic["check_steps"]):
            ms = self._call(1)
            losses.append([float(ms[k][0]) for k in ("d_cost", "d_cost_mean", "g_cost")])
            for g, opt in self.trainer.optimizers.items():
                st = self.ts.opt_states.get(g)
                first = (g == "disc" and j == 0) or (g != "disc" and j == 1)
                if st is not None and first:
                    for key, mu in zip(self.ts.groups[g], st.mu):
                        grads[key] = (mu.float() / (1.0 - opt.b1)).cpu()
            if j == 0:
                mods = scoped_modules(self.ts.gan)
                mid = {"params": {k: p.detach().cpu().clone() for ps in self.ts.groups.values()
                                  for k, p in ps.items()},
                       "u": {s: mods[s].u.detach().cpu().clone()
                             for s in self.ref.sn_scopes(self.config["model"], self.traffic)}}
        params = {k: p.detach().cpu().clone() for ps in self.ts.groups.values()
                  for k, p in ps.items()}
        self.first = {"losses": losses, "grads": grads, "params": params, "mid": mid}

    def warm(self) -> None:
        """One whole block, which captures the window's block of
        ``scan_block`` rows."""
        self.unit()
        self.metrics.clear()

    def unit(self) -> None:
        """One block of cycles, and its metrics read back."""
        with torch.profiler.record_function("bench.call"):
            ms = self._call(self.block)
        with torch.profiler.record_function("bench.read_metrics"):
            self.metrics.append(torch.stack([ms["d_cost"], ms["g_cost"]]).cpu())

    def failed(self) -> int:
        """Cycles of the window whose costs are not finite."""
        return sum(int((~torch.isfinite(m)).any(dim=0).sum()) for m in self.metrics)

    def stats(self) -> Dict[str, float]:
        return self.trainer.captured.stats()

    def release(self) -> None:
        """Frees the program, its state and the dataset."""
        self.trainer = self.ts = self.dataset = None
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    # --------------------------------------------------------- reference
    def _feeds(self, data) -> List[Dict]:
        feeds = []
        dev = self.device
        for j, (idx, rand, biased) in enumerate(self.fed[:self.traffic["check_steps"]]):
            batches = [{k: data[k][torch.as_tensor(idx[0, i], device=dev)].long()
                        if k != "images" else data[k][torch.as_tensor(idx[0, i], device=dev)]
                        for k in ("images", "labels", "labels_random", "labels_biased")}
                       for i in range(self.n_critic)]
            feeds.append({"iteration": j, "seed": fold_in(self.train_seed, j),
                          "batches": batches,
                          "random": torch.as_tensor(rand[0], device=dev),
                          "biased": torch.as_tensor(biased[0], device=dev)})
        return feeds

    def reference(self, prec, half=()) -> Dict:
        """The reference's first cycles from the same weights on the same
        rows (the dataset drawn again from the seed)."""
        params, u = self._weights()
        c = torch.as_tensor(self.c, dtype=torch.float32, device=self.device)
        return self.ref.run(self.config, self.traffic, params, u, self._feeds(self._dataset()),
                            c, prec, half)

    def follow(self, mid: Mapping, prec) -> Dict:
        """The reference's generator step of the second cycle from a side's
        state ``mid`` (its ``first["mid"]``): ``{"grads", "loss"}``."""
        dev = self.device
        c = torch.as_tensor(self.c, dtype=torch.float32, device=dev)
        return self.ref.follow(self.config, self.traffic,
                               {k: v.to(dev) for k, v in mid["params"].items()},
                               {k: v.to(dev) for k, v in mid["u"].items()},
                               self._feeds(self._dataset())[1], c, prec)


def build(config: Mapping, traffic: Mapping, seed: int, device, reference_module) -> Session:
    return Session(config, traffic, seed, device, reference_module)
