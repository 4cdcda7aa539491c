"""Plain reference of the progressive-growing conditional ResNet GAN
(``configs/pggan64.json``; tkkiran/Robust-Conditional-GAN
``cifar10/common/resnet_block.py:192-349``), in its stabilisation phase at
one stage.

- The generator: a linear from ``z`` to a 4x4 grid, pixel norm, then per
  stage a residual "up" block (conditional batch norm with ReLU, 3x3
  convs, a 1x1 shortcut) followed by pixel norm, and a 1x1 ``ToRGB`` of
  the ReLU under ``tanh``.
- The critic: a spectral-normed 1x1 ``FromRGB``, residual "down" blocks from
  the stage to the first (batch norm with the batch's statistics and ReLU,
  3x3 convs, a 1x1 shortcut, 2x2 mean pools), the mean of the ReLU over
  the grid, a spectral-normed linear logit and the projection
  ``Σ feat · Embedding_y(label)``.
- One iteration: the critic step on the fakes and then the reals (each
  pass stores its new ``u``), hinge loss, then the generator step with the
  same ``z`` (the critic's ``u`` not stored), each with Adam (β₁ 0,
  β₂ 0.99, lr 2e-4).  The full-resolution batch is average-pooled to the
  stage's resolution.

Everything is float32 under :class:`~.layers.Precision`.
"""

from __future__ import annotations

from typing import Dict, List, Mapping, Sequence, Tuple

import torch
import torch.nn.functional as F

from benchmark.reference.layers import (Adam, Key, Precision, batch_norm, cond_batch_norm, conv,
                                        fold_in, grads_of, hinge_d, linear, mean_pool,
                                        normal_rows, pixel_norm, requiring, spectral_normed,
                                        upsample)


def resolution(model: Mapping, stage: int) -> int:
    return model["base_size"] * 2 ** stage


def param_specs(model: Mapping, traffic: Mapping) -> Dict[Key, Tuple[Tuple[int, ...], str]]:
    """``{(scope, var): (shape, kind)}`` of every trainable leaf, every
    stage's included (the phases that do not call a layer leave it be)."""
    g, z, c = model["dim"], model["z_dim"], model["img_dim"]
    v, e, b0 = model["vocab_size"], model["embedding_dim"], model["base_size"]
    out: Dict[Key, Tuple[Tuple[int, ...], str]] = {}

    def conv_(scope, k, cin, cout):
        out[(scope, "Filters")] = ((k, k, cin, cout), "fan")
        out[(scope, "Biases")] = ((cout,), "bias")

    out[("PG.G.Input", "W")] = ((z, b0 * b0 * g), "fan")
    out[("PG.G.Input", "b")] = ((b0 * b0 * g,), "bias")
    for s in range(1, model["max_stage"] + 1):
        blk = f"PG.G.Block.{s}"
        conv_(blk + ".Shortcut", 1, g, g)
        conv_(blk + ".Conv1", 3, g, g)
        conv_(blk + ".Conv2", 3, g, g)
        for n in (".N1", ".N2"):
            out[(blk + n, "offset")] = ((v, g), "offset")
            out[(blk + n, "scale")] = ((v, g), "scale")
        conv_(f"PG.G.ToRGB.{s}", 1, g, c)
        conv_(f"PG.D.FromRGB.{s}", 1, c, g)
        blk = f"PG.D.Block.{s}"
        conv_(blk + ".Shortcut", 1, g, g)
        conv_(blk + ".Conv1", 3, g, g)
        conv_(blk + ".Conv2", 3, g, g)
        for n in (".N1", ".N2"):
            out[(blk + n, "gamma")] = ((g,), "scale")
            out[(blk + n, "beta")] = ((g,), "offset")
    out[("PG.D.Output", "W")] = ((g, 1), "fan")
    out[("PG.D.Output", "b")] = ((1,), "bias")
    out[("PG.D.Embedding.Label", "embedding_map")] = ((v, e), "embedding")
    out[("PG.D.Embedding_y", "W")] = ((e, g), "fan")
    out[("PG.D.Embedding_y", "b")] = ((g,), "bias")
    return out


def sn_scopes(model: Mapping, traffic: Mapping) -> Dict[str, int]:
    g = model["dim"]
    out = {}
    for s in range(1, model["max_stage"] + 1):
        out[f"PG.D.FromRGB.{s}"] = g
        for n in ("Shortcut", "Conv1", "Conv2"):
            out[f"PG.D.Block.{s}.{n}"] = g
    out["PG.D.Output"] = 1
    out["PG.D.Embedding_y"] = g
    return out


def groups(keys) -> Dict[str, List[Key]]:
    out: Dict[str, List[Key]] = {"gen": [], "disc": []}
    for k in sorted(keys):
        out["gen" if k[0].startswith("PG.G.") else "disc"].append(k)
    return out


class Model:
    def __init__(self, model: Mapping, params: Dict[Key, torch.Tensor],
                 u: Dict[str, torch.Tensor], prec: Precision):
        self.m, self.p, self.u, self.prec = model, params, u, prec

    def _w(self, scope: str, var: str, sn: bool, store: bool) -> torch.Tensor:
        if not sn:
            return self.p[(scope, var)]
        w, u_new = spectral_normed(self.p[(scope, var)], self.u[scope])
        if store:
            self.u[scope] = u_new.detach()
        return w

    def _conv(self, scope, x, sn=False, store=True):
        return conv(self.prec, x, self._w(scope, "Filters", sn, store), self.p[(scope, "Biases")])

    def _linear(self, scope, x, sn=False, store=True):
        return linear(self.prec, x, self._w(scope, "W", sn, store), self.p[(scope, "b")])

    def generator(self, z: torch.Tensor, labels: torch.Tensor, stage: int) -> torch.Tensor:
        g, b0 = self.m["dim"], self.m["base_size"]
        q = self.prec.q
        out = q(pixel_norm(self._linear("PG.G.Input", z).reshape(-1, b0, b0, g)))
        for s in range(1, stage + 1):
            blk = f"PG.G.Block.{s}"

            def cbn_relu(n, h):
                return q(F.relu(cond_batch_norm(h, labels, self.p[(blk + n, "scale")],
                                                self.p[(blk + n, "offset")])))

            sc = self._conv(blk + ".Shortcut", upsample(out))
            h = self._conv(blk + ".Conv1", upsample(cbn_relu(".N1", out)))
            h = self._conv(blk + ".Conv2", cbn_relu(".N2", h))
            out = q(pixel_norm(q(sc + h)))
        return q(torch.tanh(self._conv(f"PG.G.ToRGB.{stage}", F.relu(out))))

    def critic(self, x: torch.Tensor, labels: torch.Tensor, stage: int, store: bool):
        q = self.prec.q
        out = self._conv(f"PG.D.FromRGB.{stage}", x, sn=True, store=store)
        for s in range(stage, 0, -1):
            blk = f"PG.D.Block.{s}"

            def bn_relu(n, h):
                return q(F.relu(batch_norm(h, self.p[(blk + n, "gamma")],
                                           self.p[(blk + n, "beta")])))

            sc = q(mean_pool(self._conv(blk + ".Shortcut", out, sn=True, store=store)))
            h = self._conv(blk + ".Conv1", bn_relu(".N1", out), sn=True, store=store)
            h = q(mean_pool(self._conv(blk + ".Conv2", bn_relu(".N2", h), sn=True, store=store)))
            out = q(sc + h)
        feat = q(F.relu(out).mean(dim=(1, 2)))
        logit = self._linear("PG.D.Output", feat, sn=True, store=store).reshape(-1)
        emb = self._linear("PG.D.Embedding_y", self.p[("PG.D.Embedding.Label", "embedding_map")]
                           [labels], sn=True, store=store)
        return logit + torch.sum(feat * emb, dim=1)


def pool_to_stage(x: torch.Tensor, model: Mapping, stage: int) -> torch.Tensor:
    """``[B, H, W, C]`` at full resolution → the stage's, by average pooling."""
    r = resolution(model, stage)
    f = x.shape[1] // r
    if f <= 1:
        return x
    b, _, _, c = x.shape
    return x.reshape(b, r, f, r, f, c).mean(dim=(2, 4))


def _gen_cost(model: Mapping, params, u, prec: Precision, gs, z, labels, stage: int):
    """The generator's cost with only its leaves requiring grad (the
    critic's ``u`` read, not stored), and the model it ran on."""
    m = Model(model, requiring(params, gs["gen"]), u, prec)
    return torch.mean(-m.critic(m.generator(z, labels, stage), labels, stage, store=False)), m


def _rows(feed: Mapping, model: Mapping, stage: int, half: bool):
    x = pool_to_stage(feed["x"], model, stage)
    labels = feed["labels"]
    z = normal_rows(fold_in(feed["seed"], 0), x.shape[0], model["z_dim"], x.device)
    if half:
        n = x.shape[0] // 2
        x, labels, z = x[:n], labels[:n], z[:n]
    return x, labels, z


def run(config: Mapping, traffic: Mapping, params: Dict[Key, torch.Tensor],
        u: Dict[str, torch.Tensor], feeds: List[Mapping], prec: Precision = Precision(),
        half: Sequence[str] = ()) -> Dict:
    """The first ``len(feeds)`` iterations at ``traffic["stage"]`` (its
    stabilisation); returns ``{"losses": [[d_cost, g_cost] per iteration],
    "grads": {first gradient per leaf}, "params": {leaf after the last},
    "mid": {"params", "u"} just before the generator's first step}``.
    Each feed holds ``x`` (full-resolution NHWC in [-1, 1]), ``labels`` and
    the iteration's ``seed``.  ``half`` names the steps (``disc``,
    ``gen``) that leave out the second half of every batch (a fault)."""
    model, train = config["model"], config["train"]
    stage = traffic["stage"]
    params = {k: v.detach().clone() for k, v in params.items()}
    u = {k: v.detach().clone() for k, v in u.items()}
    gs = groups(params)
    opts = {g: Adam(ks, params, train["beta1"], train["beta2"]) for g, ks in gs.items()}
    firsts: Dict[Key, torch.Tensor] = {}
    losses, mid = [], None
    for feed in feeds:
        x, labels, z = _rows(feed, model, stage, "disc" in half)
        m = Model(model, requiring(params, gs["disc"]), u, prec)
        fake = m.generator(z, labels, stage)
        d_fake = m.critic(fake, labels, stage, store=True)
        d_real = m.critic(x, labels, stage, store=True)
        d_cost = hinge_d(d_real, d_fake)
        opts["disc"].step(params, grads_of(d_cost, m.p, gs["disc"]), train["lr"])
        if mid is None:
            mid = {"params": dict(params), "u": dict(u)}
        _, labels, z = _rows(feed, model, stage, "gen" in half)
        g_cost, m = _gen_cost(model, params, u, prec, gs, z, labels, stage)
        opts["gen"].step(params, grads_of(g_cost, m.p, gs["gen"]), train["lr"])
        if not firsts:
            firsts = {**opts["disc"].first_gradient(), **opts["gen"].first_gradient()}
        losses.append([float(d_cost.detach()), float(g_cost.detach())])
    return {"losses": losses, "grads": firsts, "params": params, "mid": mid}


def follow(config: Mapping, traffic: Mapping, params: Dict[Key, torch.Tensor],
           u: Dict[str, torch.Tensor], feed: Mapping,
           prec: Precision = Precision()) -> Dict:
    """``{"grads", "loss"}`` of the generator's step on ``feed`` from
    ``params`` and ``u``: the first iteration's generator step, followed
    from a state that the caller hands over (the one a side reached after
    its first critic step)."""
    model, stage = config["model"], traffic["stage"]
    gs = groups(params)
    _, labels, z = _rows(feed, model, stage, False)
    g_cost, m = _gen_cost(model, params, u, prec, gs, z, labels, stage)
    return {"grads": grads_of(g_cost, m.p, gs["gen"]), "loss": float(g_cost.detach())}
