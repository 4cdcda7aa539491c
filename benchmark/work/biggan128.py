"""The operations and bytes of one BigGAN training cycle, from the
configuration's shapes (``configs/biggan128.json``), counted as
``work/cifar_sngan.py`` counts the CIFAR cycle's: the convolutions (3x3 and
1x1), the linear layers' products and the attention's two products, forward
and backward, each once, nothing recomputed.

- A critic step runs the generator forward only; the critic's layers take
  their weight gradients, and input gradients everywhere but at the layers
  that read the images (the first block's conv1 and its shortcut).
- A generator step takes the generator's weight and input gradients (not
  the input gradient of ``G.Input``, whose input is ``z``; the cond-BN
  linears' inputs hold the shared embedding, so theirs is taken) and the
  critic's input gradients only.
- The attention is one fused piece a pass: forward ``θ φᵀ`` and its
  product with ``g`` (``2 N M (dq + dv)`` a row), backward the four
  products of their gradients (twice that); its bytes are ``q``, ``k``,
  ``v`` and the output (and in the backward their gradients and the
  output's), never the logits.

The spectral norm's power step, the norms, the pools, the softmax, the
projection's dot products and the losses are elementwise and not counted.
"""

from __future__ import annotations

from typing import List, Mapping

from benchmark.reference.biggan128 import _chunk, _has_shortcut, d_arch, g_arch
from benchmark.roofline import ITEMSIZE, Work, conv, mm

PHASES = ("fwd", "dgrad", "wgrad")


def attention(phase: str, n: int, hw: int, c: int, itemsize: int) -> Work:
    """The attention core at ``c`` channels on ``n`` maps of ``hw``
    positions: ``q [hw, c/8]``, ``k [hw/4, c/8]``, ``v [hw/4, c/2]``."""
    dq, dv, m = c // 8, c // 2, hw // 4
    flops = 2.0 * n * hw * m * (dq + dv) * (1 if phase == "fwd" else 2)
    elems = n * (hw * dq + m * dq + m * dv + hw * dv)
    if phase != "fwd":  # read q, k, v, o, dO; write dq, dk, dv
        elems = n * (2 * (hw * dq + m * dq + m * dv) + 2 * hw * dv)
    return Work("attn", phase, flops, float(itemsize * elems))


def _attention_block(n: int, r: int, c: int, weight_grads: bool, input_grad: bool,
                     it: int) -> List[Work]:
    """The block's four 1x1 convs and its core; ``input_grad``: a gradient
    flows back through it."""
    out = []
    for cin, cout in ((c, c // 8), (c, c // 8), (c, c // 2), (c // 2, c)):
        out.append(conv("fwd", n, r, r, cin, cout, 1, it))
        if input_grad:
            out.append(conv("dgrad", n, r, r, cin, cout, 1, it))
        if weight_grads:
            out.append(conv("wgrad", n, r, r, cin, cout, 1, it))
    out.append(attention("fwd", n, r * r, c, it))
    if input_grad or weight_grads:
        out.append(attention("bwd", n, r * r, c, it))
    return out


def _generator(model: Mapping, n: int, grads: bool, it: int) -> List[Work]:
    arch = g_arch(model["dim_g"], model["img_size"])
    chunk = _chunk(model)
    cond = model["shared_dim"] + chunk
    phases = PHASES if grads else ("fwd",)
    out = [mm("fwd", n, chunk, 16 * arch["in"][0], it)]
    if grads:
        out.append(mm("wgrad", n, chunk, 16 * arch["in"][0], it))
    for cin, cout, r in zip(arch["in"], arch["out"], arch["resolution"]):
        for ch in (cin, cin, cout, cout):
            out += [mm(p, n, cond, ch, it) for p in phases]
        for k, a, b in ((3, cin, cout), (3, cout, cout), (1, cin, cout)):
            out += [conv(p, n, r, r, a, b, k, it) for p in phases]
        if r == model["attention_g"]:
            out += _attention_block(n, r, cout, grads, grads, it)
    s = model["img_size"]
    out += [conv(p, n, s, s, arch["out"][-1], model["img_dim"], 3, it) for p in phases]
    return out


def _critic(model: Mapping, n: int, weight_grads: bool, input_grad: bool, it: int) -> List[Work]:
    """One pass over ``n`` images; ``input_grad``: the images need a
    gradient (a generator step)."""
    arch = d_arch(model["dim_d"], model["img_size"])
    r = model["img_size"]
    out: List[Work] = []

    def add(res, cin, cout, k, reads_images=False):
        out.append(conv("fwd", n, res, res, cin, cout, k, it))
        if input_grad or not reads_images:
            out.append(conv("dgrad", n, res, res, cin, cout, k, it))
        if weight_grads:
            out.append(conv("wgrad", n, res, res, cin, cout, k, it))

    for i, (cin, cout, down, res) in enumerate(zip(arch["in"], arch["out"], arch["down"],
                                                   arch["resolution"])):
        add(r, cin, cout, 3, i == 0)
        add(r, cout, cout, 3)
        if _has_shortcut(cin, cout, down):
            add(r // 2 if (i == 0 and down) else r, cin, cout, 1, i == 0)
        r = r // 2 if down else r
        if res == model["attention_d"]:
            out += _attention_block(n, r, cout, weight_grads, True, it)
    c = arch["out"][-1]
    out += [mm("fwd", n, c, 1, it), mm("dgrad", n, c, 1, it)]
    if weight_grads:
        out.append(mm("wgrad", n, c, 1, it))
    return out


def _all_label(model: Mapping, n: int, disc_step: bool, it: int) -> List[Work]:
    """``feat @ tableᵀ`` against every label."""
    v, c = model["vocab_size"], d_arch(model["dim_d"], model["img_size"])["out"][-1]
    out = [mm("fwd", n, c, v, it), mm("dgrad", n, c, v, it)]
    if disc_step:
        out.append(mm("wgrad", n, c, v, it))
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
        if u:
            out += _all_label(model, gb, False, it)
        if perm:
            out += _perm(model, gb, False, it)
    for _ in range(train["n_critic"]):
        out += _generator(model, b, False, it)
        if u:
            out += _critic(model, b, True, False, it) + _critic(model, b, True, False, it)
            out += _all_label(model, b, True, it)
        else:
            out += _critic(model, 2 * b, True, False, it)
        if perm:
            out += _perm(model, b, True, it)
    return out
