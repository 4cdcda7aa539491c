"""The operations and bytes of one CIFAR training cycle, from the
configuration's shapes (``configs/cifar_sngan.json``).

A cycle is one generator step on ``gen_bs_multiple × B`` rows (with the
confusion matrix's for rcgan-u) and ``n_critic`` discriminator steps on
``B`` real and ``B`` generated rows.  Counted are the convolutions and the
linear layers' products that each step needs, forward and backward, and
nothing recomputed:

- a discriminator step runs the generator forward only; the critic's
  layers take their weight gradients, and input gradients everywhere but at
  the layers that read the images;
- a generator step takes the generator's weight and input gradients (not
  the input gradient of ``G.Input``, whose input is ``z``), and the
  critic's input gradients only.

The spectral-norm power iteration, the batch norms, the projection's dot
products and the losses are elementwise and not counted.
"""

from __future__ import annotations

from typing import List, Mapping

from benchmark.roofline import ITEMSIZE, Work, conv, mm


def _generator(model: Mapping, n: int, grads: bool, it: int) -> List[Work]:
    g, z, c, s = model["dim_g"], model["z_dim"], model["img_dim"], model["img_size"]
    out = [mm("fwd", n, z, 16 * 8 * g, it)]
    if grads:
        out.append(mm("wgrad", n, z, 16 * 8 * g, it))
    convs = []
    for k in (1, 2, 3):
        r, cin = 4 * 2 ** k, (8 * g if k == 1 else 2 * g)
        convs += [(r, cin, 2 * g, 1), (r, cin, 2 * g, 3), (r, 2 * g, 2 * g, 3)]
    convs.append((s, 2 * g, c, 3))
    for r, cin, cout, k in convs:
        for phase in (("fwd", "dgrad", "wgrad") if grads else ("fwd",)):
            out.append(conv(phase, n, r, r, cin, cout, k, it))
    return out


def _critic(model: Mapping, n: int, weight_grads: bool, input_grad: bool, it: int) -> List[Work]:
    """One pass over ``n`` images; ``input_grad``: the images need a
    gradient (a generator step)."""
    d, c, s = model["dim_d"], model["img_dim"], model["img_size"]
    # (resolution, cin, cout, k, reads the images)
    convs = [(s // 2, c, d, 1, True), (s, c, d, 3, True), (s, d, d, 3, False),
             (s // 2, d, d, 1, False), (s // 2, d, d, 3, False), (s // 2, d, d, 3, False)]
    convs += [(s // 4, d, d, 3, False)] * 8
    out = []
    for r, cin, cout, k, first in convs:
        out.append(conv("fwd", n, r, r, cin, cout, k, it))
        if input_grad or not first:
            out.append(conv("dgrad", n, r, r, cin, cout, k, it))
        if weight_grads:
            out.append(conv("wgrad", n, r, r, cin, cout, k, it))
    out.append(mm("fwd", n, d, 1, it))
    out.append(mm("dgrad", n, d, 1, it))
    if weight_grads:
        out.append(mm("wgrad", n, d, 1, it))
    return out


def _projection(model: Mapping, n: int, grads: bool, it: int) -> List[Work]:
    """``Embedding_y`` over ``n`` label rows (the table's rows need a
    gradient in a critic step)."""
    e, d = model["embedding_dim"], model["dim_d"]
    phases = ("fwd", "dgrad", "wgrad") if grads else ("fwd",)
    return [mm(p, n, e, d, it) for p in phases]


def _all_label(model: Mapping, n: int, disc_step: bool, it: int) -> List[Work]:
    """``Embedding_y`` over the whole table, then ``feat @ embᵀ``."""
    v, d = model["vocab_size"], model["dim_d"]
    out = _projection(model, v, disc_step, it)
    out += [mm("fwd", n, d, v, it), mm("dgrad", n, d, v, it)]
    if disc_step:
        out.append(mm("wgrad", n, d, v, it))
    return out


def _perm(model: Mapping, n: int, disc_step: bool, it: int) -> List[Work]:
    dim, v = model["img_size"] ** 2 * model["img_dim"], model["vocab_size"]
    return [mm("fwd", n, dim, v, it), mm("wgrad" if disc_step else "dgrad", n, dim, v, it)]


def step_work(config: Mapping, traffic: Mapping, iteration: int = 1) -> List[Work]:
    """Every counted operation of the cycle at ``iteration`` (iteration 0
    has no generator step)."""
    model, train = config["model"], config["train"]
    it = ITEMSIZE[config["compute_dtype"]]
    b = config["batch_size"]
    gb = train["gen_bs_multiple"] * b
    u = traffic["algorithm"] == "rcgan-u"
    perm = bool(traffic.get("perm_classifier"))
    out: List[Work] = []
    if iteration > 0:
        out += _generator(model, gb, True, it)
        out += _critic(model, gb, False, True, it)
        out += _all_label(model, gb, False, it) if u else _projection(model, gb, False, it)
        if perm:
            out += _perm(model, gb, False, it)
    for _ in range(train["n_critic"]):
        out += _generator(model, b, False, it)
        if u:
            out += _critic(model, b, True, False, it) + _critic(model, b, True, False, it)
            out += _projection(model, b, True, it) + _all_label(model, b, True, it)
        else:
            out += _critic(model, 2 * b, True, False, it) + _projection(model, 2 * b, True, it)
        if perm:
            out += _perm(model, b, True, it)
    return out
