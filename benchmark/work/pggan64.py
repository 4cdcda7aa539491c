"""The operations and bytes of one PGGAN iteration in a stabilisation
phase, from the configuration's shapes (``configs/pggan64.json``).

An iteration is a critic step (the generator forward, the critic over the
fakes and over the reals) and a generator step (the generator forward and
backward, the critic forward and its input gradients).  Counted are the
convolutions and the linear layers' products each step needs, forward and
backward, nothing recomputed: the critic's ``FromRGB`` takes no input
gradient in a critic step, whose images need none, and ``G.Input`` none in
either, whose input is ``z``.  Pooling, the norms, the projection's dot
products and the losses are elementwise and not counted.
"""

from __future__ import annotations

from typing import List, Mapping

from benchmark.roofline import ITEMSIZE, Work, conv, mm


def _res(model: Mapping, stage: int) -> int:
    return model["base_size"] * 2 ** stage


def _generator(model: Mapping, n: int, stage: int, grads: bool, it: int) -> List[Work]:
    g, z, c, b0 = model["dim"], model["z_dim"], model["img_dim"], model["base_size"]
    out = [mm("fwd", n, z, b0 * b0 * g, it)]
    if grads:
        out.append(mm("wgrad", n, z, b0 * b0 * g, it))
    convs = []
    for s in range(1, stage + 1):
        r = _res(model, s)
        convs += [(r, g, g, 1), (r, g, g, 3), (r, g, g, 3)]
    convs.append((_res(model, stage), g, c, 1))
    for r, cin, cout, k in convs:
        for phase in (("fwd", "dgrad", "wgrad") if grads else ("fwd",)):
            out.append(conv(phase, n, r, r, cin, cout, k, it))
    return out


def _critic(model: Mapping, n: int, stage: int, disc_step: bool, it: int) -> List[Work]:
    g, c, v, e = model["dim"], model["img_dim"], model["vocab_size"], model["embedding_dim"]
    r = _res(model, stage)
    out = [conv("fwd", n, r, r, c, g, 1, it)]
    out.append(conv("wgrad" if disc_step else "dgrad", n, r, r, c, g, 1, it))
    for s in range(stage, 0, -1):
        r = _res(model, s)
        for k in (1, 3, 3):
            for phase in (("fwd", "dgrad", "wgrad") if disc_step else ("fwd", "dgrad")):
                out.append(conv(phase, n, r, r, g, g, k, it))
    out += [mm(p, n, g, 1, it) for p in (("fwd", "dgrad", "wgrad") if disc_step
                                         else ("fwd", "dgrad"))]
    out += [mm(p, n, e, g, it) for p in (("fwd", "dgrad", "wgrad") if disc_step else ("fwd",))]
    return out


def step_work(config: Mapping, traffic: Mapping, iteration: int = 1) -> List[Work]:
    """Every counted operation of one iteration at ``traffic["stage"]``."""
    model, stage = config["model"], traffic["stage"]
    it = ITEMSIZE[config["compute_dtype"]]
    n = config["batch_size"]
    return (_generator(model, n, stage, False, it) + _critic(model, n, stage, True, it)
            + _critic(model, n, stage, True, it) + _generator(model, n, stage, True, it)
            + _critic(model, n, stage, False, it))
