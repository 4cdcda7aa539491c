"""Plain reference of the CIFAR-10 SNGAN (``configs/cifar_sngan.json``).

The paper's ResNet generator with conditional batch norm, the
spectral-normed ResNet discriminator with its projection head (Miyato and
Koyama), the hinge loss, and the training cycle of Robust Conditional GAN
(Thekumparampil et al., 2018; tkkiran/Robust-Conditional-GAN
``cifar10/gan_resnet.py``): one generator step on ``gen_bs_multiple × B``
rows (skipped at iteration 0), then ``n_critic`` discriminator steps, each
on its own batch, with Adam (β₁ 0, β₂ 0.9, lr 2e-4 decayed linearly from
iteration 0 to half at 50 000).

- rcgan: the real rows carry their noisy labels, the generated rows the
  generator's labels passed through the known confusion matrix
  (``labels_biased``); one discriminator pass over both.
- rcgan-u: the confusion matrix is learned (softmax of ``confusion_logits``,
  trained with the generator); the real and fake passes run apart, and the
  fake term weighs the logits against every label by the matrix's row of
  the generator's label.  With ``perm_classifier`` a spectral-normed
  linear classifier on the flat image adds its sigmoid cross-entropy to
  both costs.

Spectral norm takes one power-iteration step per call from the layer's
stored ``u``: every call in a discriminator cost stores its new ``u`` (the
second pass of rcgan-u reads what the first stored); the generator cost
stores none of the discriminator's, but the projection embedding's and the
classifier's move.  Everything is float32 under :class:`~.layers.Precision`.
"""

from __future__ import annotations

from typing import Dict, List, Mapping, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from benchmark.reference.layers import (Adam, Key, Precision, cond_batch_norm, conv,
                                        dequantize, fold_in, example_seeds, grads_of, hinge_d,
                                        linear, mean_pool, normal_rows, requiring,
                                        spectral_normed, upsample)

# ---------------------------------------------------------------- shapes


def param_specs(model: Mapping, traffic: Mapping) -> Dict[Key, Tuple[Tuple[int, ...], str]]:
    """``{(scope, var): (shape, kind)}`` of every trainable leaf; ``kind``
    says how the benchmark draws it (``benchmark/weights.py``)."""
    g, d, z = model["dim_g"], model["dim_d"], model["z_dim"]
    v, e, c = model["vocab_size"], model["embedding_dim"], model["img_dim"]
    out: Dict[Key, Tuple[Tuple[int, ...], str]] = {}

    def conv_(scope, k, cin, cout):
        out[(scope, "Filters")] = ((k, k, cin, cout), "fan")
        out[(scope, "Biases")] = ((cout,), "bias")

    def cbn(scope, ch):
        out[(scope, "offset")] = ((v, ch), "offset")
        out[(scope, "scale")] = ((v, ch), "scale")

    out[("G.Input", "W")] = ((z, 16 * 8 * g), "fan")
    out[("G.Input", "b")] = ((16 * 8 * g,), "bias")
    for k in (1, 2, 3):
        cin = 8 * g if k == 1 else 2 * g
        s = f"G.Block.{k}"
        conv_(s + ".Shortcut", 1, cin, 2 * g)
        cbn(s + ".N1", cin)
        conv_(s + ".Conv1", 3, cin, 2 * g)
        cbn(s + ".N2", 2 * g)
        conv_(s + ".Conv2", 3, 2 * g, 2 * g)
    cbn("G.OutputNorm", 2 * g)
    conv_("G.Output", 3, 2 * g, c)
    conv_("D.Block.1.Shortcut", 1, c, d)
    conv_("D.Block.1.Conv1", 3, c, d)
    conv_("D.Block.1.Conv2", 3, d, d)
    conv_("D.Block.2.Shortcut", 1, d, d)
    for k in (2, 3, 4, 5, 6):
        conv_(f"D.Block.{k}.Conv1", 3, d, d)
        conv_(f"D.Block.{k}.Conv2", 3, d, d)
    out[("D.Output", "W")] = ((d, 1), "fan")
    out[("D.Output", "b")] = ((1,), "bias")
    out[("D.Embedding.Label", "embedding_map")] = ((v, e), "embedding")
    out[("D.Embedding_y", "W")] = ((e, d), "fan")
    out[("D.Embedding_y", "b")] = ((d,), "bias")
    if traffic.get("perm_classifier"):
        dim = model["img_size"] ** 2 * c
        out[("D.d_perm_classifier_h1", "W")] = ((dim, v), "fan")
        out[("D.d_perm_classifier_h1", "b")] = ((v,), "bias")
    if traffic["algorithm"] == "rcgan-u":
        out[("confusion_logits", "logits")] = ((v, v), "confusion")
    return out


def sn_scopes(model: Mapping, traffic: Mapping) -> Dict[str, int]:
    """``{scope: cout}`` of every spectral-normed layer (its ``u [1, cout]``)."""
    d, v = model["dim_d"], model["vocab_size"]
    scopes = ["D.Block.1.Shortcut", "D.Block.1.Conv1", "D.Block.1.Conv2", "D.Block.2.Shortcut"]
    scopes += [f"D.Block.{k}.Conv{i}" for k in (2, 3, 4, 5, 6) for i in (1, 2)]
    out = {s: d for s in scopes}
    out["D.Output"] = 1
    out["D.Embedding_y"] = d
    if traffic.get("perm_classifier"):
        out["D.d_perm_classifier_h1"] = v
    return out


def groups(keys) -> Dict[str, List[Key]]:
    """The optimiser groups: ``gen`` (``G.*``), ``disc`` (``D.*``) and
    ``confusion``."""
    out: Dict[str, List[Key]] = {"gen": [], "disc": [], "confusion": []}
    for k in sorted(keys):
        s = k[0]
        out["gen" if s.startswith("G.") else "disc" if s.startswith("D.") else "confusion"] \
            .append(k)
    return {g: ks for g, ks in out.items() if ks}


def confusion_init(vocab: int, diag: float) -> np.ndarray:
    """The diagonal-dominant logits that ``confuse_init`` starts from: with
    ``a = min(7, log(V d / (1 - d)))`` (7 at d > 0.99 and V = 10), ``a - a/V``
    on the diagonal and ``-a/V`` off it."""
    a = 7.0 if (diag > 0.99 and vocab == 10) else float(np.log(vocab * diag / (1.0 - diag)))
    a = min(7.0, a)
    out = np.full((vocab, vocab), -a / vocab, np.float32)
    np.fill_diagonal(out, a - a / vocab)
    return out


# --------------------------------------------------------------- the model
class Model:
    """The parameters (a dict the optimiser rebinds), the ``u`` state and
    the forwards, at precision ``prec``."""

    def __init__(self, model: Mapping, traffic: Mapping, params: Dict[Key, torch.Tensor],
                 u: Dict[str, torch.Tensor], prec: Precision):
        self.m, self.t, self.p, self.u, self.prec = model, traffic, params, u, prec

    def _sn(self, scope: str, var: str, store: bool) -> torch.Tensor:
        w, u_new = spectral_normed(self.p[(scope, var)], self.u[scope])
        if store:
            self.u[scope] = u_new.detach()
        return w

    def _conv(self, scope: str, x: torch.Tensor, sn: bool = False, store: bool = True):
        w = self._sn(scope, "Filters", store) if sn else self.p[(scope, "Filters")]
        return conv(self.prec, x, w, self.p[(scope, "Biases")])

    def _linear(self, scope: str, x: torch.Tensor, sn: bool = False, store: bool = True):
        w = self._sn(scope, "W", store) if sn else self.p[(scope, "W")]
        return linear(self.prec, x, w, self.p[(scope, "b")])

    def _cbn_relu(self, scope: str, x, labels):
        return self.prec.q(F.relu(cond_batch_norm(x, labels, self.p[(scope, "scale")],
                                                  self.p[(scope, "offset")])))

    def generator(self, z: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
        g, s = self.m["dim_g"], self.m["img_size"]
        q = self.prec.q
        out = self._linear("G.Input", z).reshape(-1, 4, 4, 8 * g)
        for k in (1, 2, 3):
            b = f"G.Block.{k}"
            sc = self._conv(b + ".Shortcut", upsample(out))
            h = self._conv(b + ".Conv1", upsample(self._cbn_relu(b + ".N1", out, labels)))
            h = self._conv(b + ".Conv2", self._cbn_relu(b + ".N2", h, labels))
            out = q(sc + h)
        out = q(torch.tanh(self._conv("G.Output", self._cbn_relu("G.OutputNorm", out, labels))))
        return out.reshape(-1, s * s * self.m["img_dim"])

    def discriminator(self, x: torch.Tensor, store: bool):
        """Features ``[n, dim_d]`` and the wgan logit ``[n]`` of flat HWC
        images."""
        s = self.m["img_size"]
        x = x.reshape(-1, s, s, self.m["img_dim"])

        def c(scope, h):
            return self._conv(scope, h, sn=True, store=store)

        q = self.prec.q
        out = q(c("D.Block.1.Shortcut", q(mean_pool(x))) + q(mean_pool(
            c("D.Block.1.Conv2", F.relu(c("D.Block.1.Conv1", x))))))
        h = q(mean_pool(c("D.Block.2.Conv2", F.relu(c("D.Block.2.Conv1", F.relu(out))))))
        out = q(q(mean_pool(c("D.Block.2.Shortcut", out))) + h)
        for k in (3, 4, 5, 6):
            out = q(out + c(f"D.Block.{k}.Conv2", F.relu(c(f"D.Block.{k}.Conv1", F.relu(out)))))
        feat = q(F.relu(out).mean(dim=(1, 2)))
        return feat, self._linear("D.Output", feat, sn=True, store=store).reshape(-1)

    def projection(self, labels: torch.Tensor) -> torch.Tensor:
        return self._linear("D.Embedding_y", self.p[("D.Embedding.Label", "embedding_map")][labels],
                            sn=True)

    def all_label_logits(self, feat: torch.Tensor, wgan: torch.Tensor) -> torch.Tensor:
        emb = self._linear("D.Embedding_y", self.p[("D.Embedding.Label", "embedding_map")],
                           sn=True)
        return linear(self.prec, feat, emb.T, None) + wgan[:, None]

    def perm_cost(self, images: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
        logits = self._linear("D.d_perm_classifier_h1", images.reshape(images.shape[0], -1),
                              sn=True)
        target = F.one_hot(labels, self.m["vocab_size"]).float()
        return torch.mean(F.binary_cross_entropy_with_logits(logits, target, reduction="none"))

    def confusion(self, c_actual: torch.Tensor) -> torch.Tensor:
        if self.t["algorithm"] == "rcgan-u":
            return torch.softmax(self.p[("confusion_logits", "logits")], dim=-1)
        return c_actual

    def disc_cost(self, batch: Mapping[str, torch.Tensor], z: torch.Tensor,
                  c_actual: torch.Tensor) -> torch.Tensor:
        real = batch["real"]
        fake = self.generator(z, batch["labels_random"])
        if self.t["algorithm"] == "rcgan-u":
            cmat = self.confusion(c_actual)
            feat, wgan = self.discriminator(real, store=True)
            logit = wgan + torch.sum(feat * self.projection(batch["labels"]), dim=1)
            cost = torch.mean(F.relu(1.0 - logit))
            feat, wgan = self.discriminator(fake, store=True)
            logits = self.all_label_logits(feat, wgan)
            w = cmat[batch["labels_random"]]
            cost = cost + torch.mean(torch.sum(F.relu(1.0 + logits) * w, dim=1))
        elif self.t["algorithm"] == "rcgan":
            b = real.shape[0]
            feat, wgan = self.discriminator(torch.cat([real, fake]), store=True)
            labels = torch.cat([batch["labels"], batch["labels_biased"]])
            logit = wgan + torch.sum(feat * self.projection(labels), dim=1)
            cost = hinge_d(logit[:b], logit[b:])
        else:
            raise ValueError(self.t["algorithm"])
        if self.t.get("perm_classifier"):
            cost = cost + self.perm_cost(real, batch["labels"])
        return cost

    def gen_cost(self, random: torch.Tensor, biased: torch.Tensor, z: torch.Tensor,
                 c_actual: torch.Tensor) -> torch.Tensor:
        fake = self.generator(z, random)
        if self.t["algorithm"] == "rcgan-u":
            feat, wgan = self.discriminator(fake, store=False)
            w = self.confusion(c_actual)[random]
            cost = torch.mean(torch.sum(-self.all_label_logits(feat, wgan) * w, dim=1))
        else:
            feat, wgan = self.discriminator(fake, store=False)
            cost = torch.mean(-(wgan + torch.sum(feat * self.projection(biased), dim=1)))
        if self.t.get("perm_classifier"):
            cost = cost + self.t.get("perm_multiplier", 1.0) * self.perm_cost(fake, random)
        return cost


# ------------------------------------------------------------- the cycles
def lr_at(train: Mapping, iteration: int) -> float:
    """The learning rate of ``iteration``: linear decay to half at 50 000
    (float32 arithmetic), then half."""
    if not train["decay"]:
        return train["lr"]
    it = np.float32(iteration)
    decay = np.float32(max(np.float32(1.0) - it / np.float32(100000.0), np.float32(0.0))) \
        if it < 50000 else np.float32(0.5)
    return train["lr"] * float(decay)


def _gen_grads(model: Mapping, traffic: Mapping, params, u, prec: Precision, gs, feed: Mapping,
               c_actual: torch.Tensor, half: bool):
    """The generator's (and the confusion matrix's) cost and gradients of
    the cycle's generator step."""
    names = [g for g in ("gen", "confusion") if g in gs]
    keys = [k for g in names for k in gs[g]]
    m = Model(model, traffic, requiring(params, keys), u, prec)
    random, biased = feed["random"], feed["biased"]
    zg = normal_rows(fold_in(feed["seed"], 1), len(random), model["z_dim"], random.device)
    if half:
        n = len(random) // 2
        random, biased, zg = random[:n], biased[:n], zg[:n]
    cost = m.gen_cost(random, biased, zg, c_actual)
    return cost, grads_of(cost, m.p, keys), names


def run(config: Mapping, traffic: Mapping, params: Dict[Key, torch.Tensor],
        u: Dict[str, torch.Tensor], feeds: List[Mapping], c_actual: torch.Tensor,
        prec: Precision = Precision(), half: Sequence[str] = ()) -> Dict:
    """The first ``len(feeds)`` cycles from ``params`` and ``u``; returns
    ``{"losses": [[d_cost, d_cost_mean, g_cost] per cycle], "grads":
    {first gradient per leaf}, "params": {leaf after the last cycle},
    "mid": {"params", "u"} after the first cycle, just before the
    generator's first step}``.  Each feed holds a cycle's ``iteration``,
    ``seed``, the ``n_critic`` batches of rows (``images`` uint8 CHW-flat,
    ``labels``, ``labels_random``, ``labels_biased``) and the generator's
    ``random`` and ``biased`` labels.  ``half`` names the steps (``disc``,
    ``gen``) that leave out the second half of every batch (a fault)."""
    model, train = config["model"], config["train"]
    n_critic, z_dim = train["n_critic"], model["z_dim"]
    params = {k: v.detach().clone() for k, v in params.items()}
    u = {k: v.detach().clone() for k, v in u.items()}
    gs = groups(params)
    opts = {g: Adam(ks, params, train["beta1"], train["beta2"]) for g, ks in gs.items()}
    firsts: Dict[Key, torch.Tensor] = {}
    losses, mid = [], None
    for feed in feeds:
        it, seed = feed["iteration"], feed["seed"]
        lr = lr_at(train, it)
        d_key = fold_in(seed, 2)
        g_cost = torch.zeros(())
        if it > 0:
            cost, grads, names = _gen_grads(model, traffic, params, u, prec, gs, feed,
                                            c_actual, "gen" in half)
            for g in names:
                g_lr = lr if g == "gen" else train["lr"] * train["confuse_multiplier"] * (
                    lr / train["lr"] if train["confuse_lr_decay"] else 1.0)
                opts[g].step(params, grads, g_lr)
                if opts[g].count == 1:
                    firsts.update(opts[g].first_gradient())
            g_cost = cost.detach()
        d_costs = []
        for k in range(n_critic):
            key = fold_in(d_key, k)
            batch = feed["batches"][k]
            b = len(batch["labels"])
            qs = torch.from_numpy(example_seeds(fold_in(key, 1), b)).to(batch["labels"].device)
            rows = dict(batch, real=dequantize(batch["images"], qs, model["img_size"],
                                               model["img_dim"]))
            z = normal_rows(fold_in(key, 0), b, z_dim, batch["labels"].device)
            if "disc" in half:
                rows = {k_: v[:b // 2] for k_, v in rows.items()}
                z = z[:b // 2]
            m = Model(model, traffic, requiring(params, gs["disc"]), u, prec)
            cost = m.disc_cost(rows, z, c_actual)
            grads = grads_of(cost, m.p, gs["disc"])
            opts["disc"].step(params, grads, lr)
            d_costs.append(cost.detach())
        if opts["disc"].count == n_critic:  # after the first cycle: its last step's gradient
            firsts.update(opts["disc"].first_gradient())
        if mid is None:
            mid = {"params": dict(params), "u": dict(u)}
        losses.append([float(d_costs[-1]), float(torch.stack(d_costs).mean()), float(g_cost)])
    return {"losses": losses, "grads": firsts, "params": params, "mid": mid}


def follow(config: Mapping, traffic: Mapping, params: Dict[Key, torch.Tensor],
           u: Dict[str, torch.Tensor], feed: Mapping, c_actual: torch.Tensor,
           prec: Precision = Precision()) -> Dict:
    """``{"grads", "loss"}`` of the generator's step of the cycle ``feed``
    (the second) from ``params`` and ``u``: a state that the caller hands
    over (the one a side reached after its first cycle)."""
    u = {k: v.detach().clone() for k, v in u.items()}
    cost, grads, _ = _gen_grads(config["model"], traffic, params, u, prec, groups(params), feed,
                                c_actual, False)
    return {"grads": grads, "loss": float(cost.detach())}
