"""Plain reference of BigGAN at 128x128 (``configs/biggan128.json``).

The layers of Brock, Donahue and Simonyan (ICLR 2019) as the authors'
PyTorch reproduction defines them (ajbrock/BigGAN-PyTorch ``BigGAN.py``
``G_arch``/``D_arch``, ``layers.py``), in NHWC with HWIO filters:

- G: ``z`` split into one chunk per block and one for the input; a shared
  class embedding ``y`` (no spectral norm) joined to each block's chunk,
  ``c = [y, z_k]``; a spectral-normed linear to ``4 x 4 x 16 ch``; GBlocks
  ``h' = conv2(relu(ccbn₂(conv1(up(relu(ccbn₁(h, c)))), c))) +
  conv_sc(up(h))`` with ``ccbn(x, c) = BN(x)·(1 + gain(c)) + bias(c)``
  (spectral-normed linears with no bias term); the non-local attention
  block after the block at ``attention_g``; then BN, ReLU, a 3x3 conv and
  tanh.  Every weight but the shared embedding is spectral-normed.
- D (wide): DBlocks ``h' = pool(conv2(relu(conv1(a(h))))) + sc(h)``, ``a``
  the identity in the first block (whose shortcut pools before its 1x1
  conv) and ReLU after it (pool after the conv); attention after the
  block at ``attention_d``; ``Σ_{H,W} relu(h)``; a spectral-normed linear
  plus the projection ``⟨SNEmbedding(label), h⟩``.
- Attention: ``θ``, ``φ``, ``g`` 1x1 convs to C/8, C/8, C/2 (``φ`` and
  ``g`` then a 2x2 max pool), ``x + γ · conv_o(softmax(θ φᵀ) g)``,
  unscaled, no biases.  Its core runs on chunks of the batch under
  activation checkpointing, so that the float32 logits of a 512-image
  critic pass (8.6 GB) are never held whole.

Spectral norm is ``layers.spectral_normed``'s one power step, gradient
through the iteration, as the program's; ``G.Input``'s weight and the
projection table are normalized as their transposes (``TRANSPOSED``),
the program's orientation of their ``u``.  The training cycle is the
CIFAR reference's (``reference/cifar_sngan.py``): one generator step
(skipped at iteration 0), then ``n_critic`` critic steps, each on its own
rows, with the critic at its own learning rate ``d_lr``.  The
generator's ``u`` advances on every generator forward; the critic's in
its own cost and not in the generator's, the projection table's in
both.  Everything is float32 under :class:`~.layers.Precision`.
"""

from __future__ import annotations

from typing import Dict, List, Mapping, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from benchmark.reference import cifar_sngan
from benchmark.reference.cifar_sngan import confusion_init, lr_at  # noqa: F401
from benchmark.reference.layers import (Adam, Key, Precision, cond_batch_norm, conv,
                                        dequantize, example_seeds, fold_in, grads_of, linear,
                                        mean_pool, normal_rows, requiring, spectral_normed,
                                        upsample)

TRANSPOSED = ("G.Input", "D.Embedding")
ATTENTION_CHUNK = 32  # images per chunk of the attention's core


# ---------------------------------------------------------------- shapes
def g_arch(ch: int, resolution: int) -> Dict[str, List[int]]:
    """BigGAN's ``G_arch[resolution]``: in and out channels per block and
    the resolution each outputs."""
    mults = {256: ([16, 16, 8, 8, 4, 2], [16, 8, 8, 4, 2, 1]),
             128: ([16, 16, 8, 4, 2], [16, 8, 4, 2, 1]),
             64: ([16, 16, 8, 4], [16, 8, 4, 2]),
             32: ([4, 4, 4], [4, 4, 4])}[resolution]
    return {"in": [ch * m for m in mults[0]], "out": [ch * m for m in mults[1]],
            "resolution": [8 * 2 ** i for i in range(len(mults[0]))]}


def d_arch(ch: int, resolution: int) -> Dict[str, list]:
    """BigGAN's ``D_arch[resolution]`` (``D_wide``): in and out channels,
    downsampling, and the resolution that places attention."""
    ins, outs, down, res = {
        256: ([1, 2, 4, 8, 8, 16], [1, 2, 4, 8, 8, 16, 16], 6, [128, 64, 32, 16, 8, 4, 4]),
        128: ([1, 2, 4, 8, 16], [1, 2, 4, 8, 16, 16], 5, [64, 32, 16, 8, 4, 4]),
        64: ([1, 2, 4, 8], [1, 2, 4, 8, 16], 4, [32, 16, 8, 4, 4]),
        32: ([4, 4, 4], [4, 4, 4, 4], 2, [16, 16, 16, 16])}[resolution]
    return {"in": [3] + [ch * m for m in ins], "out": [ch * m for m in outs],
            "down": [i < down for i in range(len(outs))], "resolution": res}


def groups(keys) -> Dict[str, List[Key]]:
    """The leaves the comparison reads by group: the optimiser groups
    (``reference/cifar_sngan.py``'s ``gen``, ``disc``, ``confusion``) after
    ``gen_cond``, the generator's conditioning leaves (``G.Shared``'s
    table, ``G.Input``'s weight and every cond-BN gain and offset linear).
    Each of their gradients is a sum over the batch of a per-sample term
    driven by that sample's ``z`` or class, with no common direction, so its
    norm falls as ``1/√B``: a generator step over half of its batch reads
    about ``√2 − 1`` in ``norm_gap.gen_cond``, where rounding moves it by
    far less.  ``gen_cond`` comes first, so that ``change_gap`` reads its
    leaves against their optimiser group, which follows."""
    opt = cifar_sngan.groups(keys)
    cond = [k for k in opt.get("gen", [])
            if (k[0] in ("G.Shared", "G.Input") and k[1] != "b")
            or k[0].endswith((".Gain", ".Bias"))]
    return {"gen_cond": cond, **opt} if cond else opt


def _chunk(model: Mapping) -> int:
    return model["z_dim"] // (len(g_arch(model["dim_g"], model["img_size"])["in"]) + 1)


def _has_shortcut(cin: int, cout: int, down: bool) -> bool:
    return cin != cout or down


def param_specs(model: Mapping, traffic: Mapping) -> Dict[Key, Tuple[Tuple[int, ...], str]]:
    """``{(scope, var): (shape, kind)}`` of every trainable leaf; ``kind``
    says how the benchmark draws it (``benchmark/weights.py``).  The
    attention's ``gamma`` is drawn near 1 (``scale``), where BigGAN starts
    it at 0, so that the attention counts whole in the comparison."""
    v, s, c = model["vocab_size"], model["img_size"], model["img_dim"]
    ga, da = g_arch(model["dim_g"], s), d_arch(model["dim_d"], s)
    chunk = _chunk(model)
    cond = model["shared_dim"] + chunk
    out: Dict[Key, Tuple[Tuple[int, ...], str]] = {}

    def conv_(scope, k, cin, cout, bias=True):
        out[(scope, "Filters")] = ((k, k, cin, cout), "fan")
        if bias:
            out[(scope, "Biases")] = ((cout,), "bias")

    def attention_(scope, ch):
        out[(scope, "gamma")] = ((1,), "scale")
        for name, cin, cout in (("Theta", ch, ch // 8), ("Phi", ch, ch // 8),
                                ("G", ch, ch // 2), ("O", ch // 2, ch)):
            conv_(f"{scope}.{name}", 1, cin, cout, bias=False)

    out[("G.Shared", "embedding_map")] = ((v, model["shared_dim"]), "embedding")
    out[("G.Input", "W")] = ((chunk, 16 * ga["in"][0]), "fan")
    out[("G.Input", "b")] = ((16 * ga["in"][0],), "bias")
    for i, (cin, cout, res) in enumerate(zip(ga["in"], ga["out"], ga["resolution"])):
        b = f"G.Block.{i + 1}"
        for bn, ch in (("BN1", cin), ("BN2", cout)):
            out[(f"{b}.{bn}.Gain", "W")] = ((cond, ch), "fan")
            out[(f"{b}.{bn}.Bias", "W")] = ((cond, ch), "fan")
        conv_(b + ".Conv1", 3, cin, cout)
        conv_(b + ".Conv2", 3, cout, cout)
        conv_(b + ".Shortcut", 1, cin, cout)
        if res == model["attention_g"]:
            attention_(b + ".Attention", cout)
    out[("G.OutputNorm", "gamma")] = ((ga["out"][-1],), "scale")
    out[("G.OutputNorm", "beta")] = ((ga["out"][-1],), "offset")
    conv_("G.Output", 3, ga["out"][-1], c)
    for i, (cin, cout, down, res) in enumerate(zip(da["in"], da["out"], da["down"],
                                                   da["resolution"])):
        b = f"D.Block.{i + 1}"
        conv_(b + ".Conv1", 3, cin, cout)
        conv_(b + ".Conv2", 3, cout, cout)
        if _has_shortcut(cin, cout, down):
            conv_(b + ".Shortcut", 1, cin, cout)
        if res == model["attention_d"]:
            attention_(b + ".Attention", cout)
    out[("D.Output", "W")] = ((da["out"][-1], 1), "fan")
    out[("D.Output", "b")] = ((1,), "bias")
    out[("D.Embedding", "embedding_map")] = ((v, da["out"][-1]), "embedding")
    if traffic.get("perm_classifier"):
        out[("D.d_perm_classifier_h1", "W")] = ((s * s * c, v), "fan")
        out[("D.d_perm_classifier_h1", "b")] = ((v,), "bias")
    if traffic["algorithm"] == "rcgan-u":
        out[("confusion_logits", "logits")] = ((v, v), "confusion")
    return out


def sn_scopes(model: Mapping, traffic: Mapping) -> Dict[str, int]:
    """``{scope: n}`` of every spectral-normed layer (its ``u [1, n]``): the
    output width, or for a layer in ``TRANSPOSED`` the input's."""
    specs = param_specs(model, traffic)
    out = {}
    for (scope, var), (shape, _) in specs.items():
        if scope.startswith(("G.Shared", "G.OutputNorm")) or var not in (
                "Filters", "W", "embedding_map") or scope == "confusion_logits":
            continue
        out[scope] = shape[0] if scope in TRANSPOSED else shape[-1]
    return out


# --------------------------------------------------------------- the model
def _max_pool(x: torch.Tensor) -> torch.Tensor:
    return F.max_pool2d(x.permute(0, 3, 1, 2), 2).permute(0, 2, 3, 1)


def _attention_core(prec: Precision, theta, phi, g) -> torch.Tensor:
    """``softmax(θ φᵀ) g``: the logits accumulated in float32 from the
    rounded operands, the weights rounded as the product's operand."""
    q = prec.q
    beta = torch.softmax(q(theta) @ q(phi).transpose(1, 2), dim=-1)
    return q(q(beta) @ q(g))


class Model(cifar_sngan.Model):
    """BigGAN's forwards on the CIFAR reference's losses (its
    ``disc_cost`` and ``gen_cost``), at precision ``prec``."""

    def _sn(self, scope: str, var: str, store: bool) -> torch.Tensor:
        w = self.p[(scope, var)]
        flip = scope in TRANSPOSED
        w_bar, u_new = spectral_normed(w.T if flip else w, self.u[scope])
        if store:
            self.u[scope] = u_new.detach()
        return w_bar.T if flip else w_bar

    def _conv(self, scope: str, x: torch.Tensor, sn: bool = True, store: bool = True):
        return conv(self.prec, x, self._sn(scope, "Filters", store),
                    self.p.get((scope, "Biases")))

    def _linear(self, scope: str, x: torch.Tensor, sn: bool = True, store: bool = True):
        return linear(self.prec, x, self._sn(scope, "W", store), self.p.get((scope, "b")))

    def _ccbn(self, scope: str, x: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
        rows = torch.arange(x.shape[0], device=x.device)
        scale = 1.0 + self._linear(scope + ".Gain", c)
        offset = self._linear(scope + ".Bias", c)
        return self.prec.q(F.relu(cond_batch_norm(x, rows, scale, offset)))

    def _attention(self, scope: str, x: torch.Tensor, store: bool) -> torch.Tensor:
        b, h, w, c = x.shape
        theta = self._conv(scope + ".Theta", x, store=store).reshape(b, h * w, c // 8)
        phi = _max_pool(self._conv(scope + ".Phi", x, store=store)).reshape(b, h * w // 4, c // 8)
        g = _max_pool(self._conv(scope + ".G", x, store=store)).reshape(b, h * w // 4, c // 2)
        core = [checkpoint(_attention_core, self.prec, *parts, use_reentrant=False)
                for parts in zip(*(t.split(ATTENTION_CHUNK) for t in (theta, phi, g)))]
        o = self._conv(scope + ".O", torch.cat(core).reshape(b, h, w, c // 2), store=store)
        return self.prec.q(x + self.p[(scope, "gamma")] * o)

    def generator(self, z: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
        m, q = self.m, self.prec.q
        arch = g_arch(m["dim_g"], m["img_size"])
        zs = torch.split(z, _chunk(m), dim=1)
        y = self.p[("G.Shared", "embedding_map")][labels]
        h = self._linear("G.Input", zs[0]).reshape(-1, 4, 4, arch["in"][0])
        for i, res in enumerate(arch["resolution"]):
            b, c = f"G.Block.{i + 1}", torch.cat([y, zs[i + 1]], dim=1)
            out = self._conv(b + ".Conv1", upsample(self._ccbn(b + ".BN1", h, c)))
            out = self._conv(b + ".Conv2", self._ccbn(b + ".BN2", out, c))
            h = q(out + self._conv(b + ".Shortcut", upsample(h)))
            if res == m["attention_g"]:
                h = self._attention(b + ".Attention", h, store=True)
        n = torch.zeros(h.shape[0], dtype=torch.int64, device=h.device)
        h = q(F.relu(cond_batch_norm(h, n, self.p[("G.OutputNorm", "gamma")][None],
                                     self.p[("G.OutputNorm", "beta")][None])))
        out = q(torch.tanh(self._conv("G.Output", h)))
        return out.reshape(-1, m["img_size"] ** 2 * m["img_dim"])

    def discriminator(self, x: torch.Tensor, store: bool):
        """Features ``[n, C]`` (the sum over the positions of the last
        block's ReLU) and the linear logit ``[n]`` of flat HWC images."""
        m, q = self.m, self.prec.q
        arch = d_arch(m["dim_d"], m["img_size"])
        h = x.reshape(-1, m["img_size"], m["img_size"], m["img_dim"])

        def c(scope, t):
            return self._conv(scope, t, store=store)

        for i, (cin, cout, down, res) in enumerate(zip(arch["in"], arch["out"], arch["down"],
                                                       arch["resolution"])):
            b, pre = f"D.Block.{i + 1}", i > 0
            out = c(b + ".Conv2", F.relu(c(b + ".Conv1", F.relu(h) if pre else h)))
            out = q(mean_pool(out)) if down else out
            sc, short = h, _has_shortcut(cin, cout, down)
            if pre:
                sc = c(b + ".Shortcut", sc) if short else sc
                sc = q(mean_pool(sc)) if down else sc
            else:
                sc = q(mean_pool(sc)) if down else sc
                sc = c(b + ".Shortcut", sc) if short else sc
            h = q(out + sc)
            if res == m["attention_d"]:
                h = self._attention(b + ".Attention", h, store)
        feat = q(F.relu(h).sum(dim=(1, 2)))
        return feat, self._linear("D.Output", feat, store=store).reshape(-1)

    def projection(self, labels: torch.Tensor) -> torch.Tensor:
        return self._sn("D.Embedding", "embedding_map", True)[labels]

    def all_label_logits(self, feat: torch.Tensor, wgan: torch.Tensor) -> torch.Tensor:
        table = self._sn("D.Embedding", "embedding_map", True)
        return linear(self.prec, feat, table.T, None) + wgan[:, None]


# ------------------------------------------------------------- the cycles
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
    """The first ``len(feeds)`` cycles from ``params`` and ``u``, as
    ``reference/cifar_sngan.py``'s ``run`` takes them and returns them,
    the critic at ``d_lr``."""
    model, train = config["model"], config["train"]
    n_critic, z_dim = train["n_critic"], model["z_dim"]
    params = {k: v.detach().clone() for k, v in params.items()}
    u = {k: v.detach().clone() for k, v in u.items()}
    gs = cifar_sngan.groups(params)
    opts = {g: Adam(ks, params, train["beta1"], train["beta2"]) for g, ks in gs.items()}
    firsts: Dict[Key, torch.Tensor] = {}
    losses, mid = [], None
    for feed in feeds:
        it, seed = feed["iteration"], feed["seed"]
        lr = lr_at(train, it)
        d_lr = lr_at(dict(train, lr=train["d_lr"]), it)
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
            opts["disc"].step(params, grads, d_lr)
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
    (the second) from ``params`` and ``u``, a state the caller hands over."""
    u = {k: v.detach().clone() for k, v in u.items()}
    cost, grads, _ = _gen_grads(config["model"], traffic, params, u, prec,
                                cifar_sngan.groups(params), feed, c_actual, False)
    return {"grads": grads, "loss": float(cost.detach())}
