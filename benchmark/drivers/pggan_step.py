"""PGGAN training through ``PGGANTrainer.step``, one iteration a call, in the
stabilisation phase of one stage: the app's path (``apps/pggan_app.py``),
with its per-iteration feed.  The step's costs stay on the device, as the
app leaves them between its phase logs.

Traffic parameters: ``stage`` (1 to ``max_stage``), ``check_steps`` (the
first iterations that the reference follows) and ``trace_units``
(iterations under the profiler in a traced run).

Inputs from the seed: the weights (``benchmark/weights.py``) and a dataset
of ``train_size`` full-resolution images with uniform labels, drawn on the
device as uint8 values and held as float32 in [-1, 1], as the app holds
its data; each iteration's batch is gathered on the device by indices
that the host draws from ``RandomState(feed seed + 2 + iteration)``, as
the app's ``data_fn`` draws them.
"""

from __future__ import annotations

import gc
from typing import Dict, List, Mapping

import numpy as np
import torch

from benchmark.reference.layers import Key, fold_in
from benchmark.weights import draw


class Session:
    def __init__(self, config: Mapping, traffic: Mapping, seed: int, device,
                 reference_module):
        from rcgan_tpu_torch.models.pggan import PGGANConfig
        from rcgan_tpu_torch.models.resnet_gan import ResnetGANConfig
        from rcgan_tpu_torch.train.pggan_loop import PGGANTrainConfig, PGGANTrainer

        self.config, self.traffic, self.device = config, traffic, torch.device(device)
        self.ref = reference_module
        model, train = config["model"], config["train"]
        self.stage = traffic["stage"]
        self.b = config["batch_size"]
        self.unit_steps, self.unit_images = 1, self.b
        self.seed = seed
        self.train_seed = fold_in(seed, 4)
        self.feed_seed = fold_in(seed, 3) & 0x3FFFFFFF
        self.x, self.labels = self._dataset()
        self.n = len(self.labels)
        self.it = 0
        cfg = PGGANConfig(z_dim=model["z_dim"], dim=model["dim"], img_dim=model["img_dim"],
                          base_size=model["base_size"], max_stage=model["max_stage"],
                          use_pixel_norm=model["use_pixel_norm"],
                          conditional=model["conditional"])
        base = ResnetGANConfig(dim_g=model["dim"], dim_d=model["dim"], z_dim=model["z_dim"],
                               vocab_size=model["vocab_size"],
                               embedding_dim=model["embedding_dim"])
        tcfg = PGGANTrainConfig(lr=train["lr"], beta1=train["beta1"], beta2=train["beta2"],
                                loss_type=config["loss_type"])
        self.trainer = PGGANTrainer(cfg, base, tcfg, self.device,
                                    compute_dtype=getattr(torch, config["compute_dtype"]))
        self.ts = self.trainer.init(seed & 0x7FFFFFFF)
        self.before = self._load_weights()
        self.metrics: List[Dict[str, torch.Tensor]] = []
        self.first: Dict = {}

    def _dataset(self):
        model = self.config["model"]
        n, size = self.config["dataset"]["train_size"], self.ref.resolution(model,
                                                                             model["max_stage"])
        gen = torch.Generator(device=self.device)
        gen.manual_seed(fold_in(self.seed, 2))
        u8 = torch.randint(0, 256, (n, size, size, model["img_dim"]), generator=gen,
                           device=self.device, dtype=torch.uint8)
        x = 2.0 * (u8.float() / 255.0 - 0.5)
        labels = torch.randint(0, model["vocab_size"], (n,), generator=gen, device=self.device)
        return x, labels

    def _weights(self):
        model = self.config["model"]
        return draw(self.ref.param_specs(model, self.traffic),
                    self.ref.sn_scopes(model, self.traffic), fold_in(self.seed, 1), self.device)

    @torch.no_grad()
    def _load_weights(self) -> Dict[Key, torch.Tensor]:
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

    def _rows(self, it: int) -> torch.Tensor:
        """Iteration ``it``'s indices, on the device."""
        idx = np.random.RandomState(self.feed_seed + 2 + it).randint(self.n, size=self.b)
        return torch.from_numpy(idx).to(self.device)

    def _call(self) -> Dict[str, torch.Tensor]:
        idx = self._rows(self.it)
        images = {"x": self.x[idx], "labels": self.labels[idx]}
        _, m = self.trainer.step(self.ts, images, fold_in(self.train_seed, self.it), 1.0,
                                 self.stage, False)
        self.it += 1
        return m

    def first_steps(self) -> None:
        """The first ``check_steps`` iterations: the losses, the first
        gradients of both groups, the state before the generator's first
        step (the critic's leaves and ``u`` after the first iteration, the
        generator's as drawn) and the leaves after the last."""
        from rcgan_tpu_torch.core.module import scoped_modules

        losses, grads, mid = [], {}, {}
        for j in range(self.traffic["check_steps"]):
            m = self._call()
            losses.append([float(m["d_cost"]), float(m["g_cost"])])
            if j == 0:
                for g, opt in self.trainer.optimizers.items():
                    for key, mu in zip(self.ts.groups[g], self.ts.opt_states[g].mu):
                        grads[key] = (mu.float() / (1.0 - opt.b1)).cpu()
                mods = scoped_modules(self.ts.gan)
                mid = {"params": {**self.before,
                                  **{k: p.detach().cpu().clone()
                                     for k, p in self.ts.groups["disc"].items()}},
                       "u": {s: mods[s].u.detach().cpu().clone()
                             for s in self.ref.sn_scopes(self.config["model"], self.traffic)}}
        params = {k: p.detach().cpu().clone() for ps in self.ts.groups.values()
                  for k, p in ps.items()}
        self.first = {"losses": losses, "grads": grads, "params": params, "mid": mid}

    def warm(self) -> None:
        """Nothing: the phase's graph was captured at the first iteration and
        the window replays it."""

    def unit(self) -> None:
        """One iteration; its costs stay on the device."""
        with torch.profiler.record_function("bench.call"):
            self.metrics.append(self._call())

    def failed(self) -> int:
        if not self.metrics:
            return 0
        costs = torch.stack([torch.stack([m["d_cost"], m["g_cost"]]) for m in self.metrics])
        return int((~torch.isfinite(costs)).any(dim=1).sum())

    def stats(self) -> Dict[str, float]:
        return self.trainer.program.captured.stats()

    def release(self) -> None:
        self.trainer = self.ts = self.x = self.labels = None
        self.metrics.clear()
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def _feed(self, x, labels, j: int) -> Dict:
        idx = self._rows(j)
        return {"x": x[idx], "labels": labels[idx], "seed": fold_in(self.train_seed, j)}

    def reference(self, prec, half=()) -> Dict:
        """The reference's first ``check_steps`` iterations from the
        benchmark's weights on the same rows (the dataset drawn again);
        ``half`` as :func:`benchmark.reference.pggan64.run`'s."""
        params, u = self._weights()
        x, labels = self._dataset()
        feeds = [self._feed(x, labels, j) for j in range(self.traffic["check_steps"])]
        return self.ref.run(self.config, self.traffic, params, u, feeds, prec, half)

    def follow(self, mid: Mapping, prec) -> Dict:
        """The reference's generator step of the first iteration from a
        side's state ``mid`` (its ``first["mid"]``): ``{"grads", "loss"}``."""
        x, labels = self._dataset()
        dev = self.device
        return self.ref.follow(self.config, self.traffic,
                               {k: v.to(dev) for k, v in mid["params"].items()},
                               {k: v.to(dev) for k, v in mid["u"].items()},
                               self._feed(x, labels, 0), prec)


def build(config: Mapping, traffic: Mapping, seed: int, device, reference_module) -> Session:
    return Session(config, traffic, seed, device, reference_module)
