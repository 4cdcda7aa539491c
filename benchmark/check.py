"""The numbers that decide ``correct`` in a training cell.

A side (the program, or in its place the control or a planted fault) and
the reference start from the same weights and take the same first steps
on the same rows.  The side gives its first gradient per leaf (as the
optimiser holds it after its first step), its state just before the
generator's first step (``mid``) and its leaves after the last step.  The
reference gives its own first steps, and the generator's first gradient
followed from the side's ``mid`` (``followed``): the generator's step is
judged on the critic that the side reached, whose own first step
``grad_diff.disc`` reads.  From them:

- ``grad_diff.<group>``: ``‖g_side − g_reference‖ / ‖g_reference‖`` of
  the group's first gradient, all its leaves at once (the generator's
  against ``followed``): the error of its direction and size;
- ``norm_gap.<group>``: ``|‖g_side‖ − ‖g_reference‖| / ‖g_reference‖``
  of the same, all its leaves at once: the error of its size alone, which
  a batch's rounding hardly moves and a gradient taken over part of the
  batch does (the part's noise does not average out);
- ``change_gap``: the worst leaf's gap of ``‖leaf after − leaf before‖``,
  over the larger of that leaf's reference change and the median leaf's of
  its group, over the leaves whose reference gradient is at least a
  thousandth of the median leaf's of its group (a leaf whose gradient is
  nought to rounding, a bias under a batch norm, moves under Adam by
  round-off alone).  A side that leaves its state unchanged reads 1; so
  does one that moves a leaf twice as far.

A cell computes and compares those that its workload file gives a limit.
"""

from __future__ import annotations

import math
import statistics
from typing import Dict, List, Mapping, Optional, Sequence

import torch

from benchmark.reference.layers import Key

DEAD = 1e-3  # of the median leaf's gradient norm


def _finite(x: float) -> float:
    """``x``, or infinity where it is not finite: a non-finite reading fails."""
    return x if math.isfinite(x) else math.inf


def norms(leaves: Mapping[Key, torch.Tensor]) -> Dict[Key, float]:
    return {k: _finite(float(torch.linalg.vector_norm(v.detach().double())))
            for k, v in leaves.items()}


def gradient_numbers(side: Mapping[Key, torch.Tensor], reference: Mapping[Key, torch.Tensor],
                     groups: Mapping[str, List[Key]]) -> Dict[str, float]:
    """``grad_diff.<group>`` and ``norm_gap.<group>`` of the gradients
    ``side`` against ``reference``, over the leaves the reference's
    gradient reaches."""
    g_s, g_r = norms(side), norms(reference)
    g_d = norms({k: side[k].float().cpu() - reference[k].float().cpu() for k in reference})
    out = {}
    for group, keys in groups.items():
        keys = [k for k in keys if g_r.get(k, 0.0) > 0.0]
        if keys:
            ref = math.sqrt(sum(g_r[k] ** 2 for k in keys))
            out[f"grad_diff.{group}"] = _finite(math.sqrt(sum(g_d[k] ** 2 for k in keys)) / ref)
            out[f"norm_gap.{group}"] = _finite(
                abs(math.sqrt(sum(g_s[k] ** 2 for k in keys)) - ref) / ref)
    return out


def names(groups: Mapping[str, List[Key]]) -> List[str]:
    """Every number this module gives for the optimiser groups ``groups``."""
    return [f"{n}.{g}" for g in groups for n in ("grad_diff", "norm_gap")] + ["change_gap"]


def changes(params: Mapping[Key, torch.Tensor], before: Mapping[Key, torch.Tensor]
            ) -> Dict[Key, float]:
    """``‖leaf after − leaf before‖`` per leaf."""
    return norms({k: params[k].float().cpu() - before[k].float().cpu() for k in before})


def numbers(side: Mapping, reference: Mapping, followed: Mapping,
            before: Mapping[Key, torch.Tensor], groups: Mapping[str, List[Key]],
            wanted: Sequence[str], worst: Optional[dict] = None) -> Dict[str, float]:
    """The numbers ``wanted`` (of :func:`names`) of ``side`` against
    ``reference`` (each ``{"grads", "params"}``), ``followed`` the
    reference's generator step from the side's ``mid`` (``{"grads",
    "loss"}``), ``before`` the leaves both started from, ``groups`` the
    optimiser groups' leaves; ``worst``, when given, receives the leaf that
    sets ``change_gap``."""
    out: Dict[str, float] = {}
    if any(n != "change_gap" for n in wanted):
        out.update(gradient_numbers(side["grads"],
                                    {**reference["grads"], **followed["grads"]}, groups))
    if "change_gap" in wanted:
        g_r = norms(reference["grads"])
        d_p, d_r = changes(side["params"], before), changes(reference["params"], before)
        gaps = {}
        for keys in groups.values():
            keys = [k for k in keys if g_r.get(k, 0.0) > 0.0]
            if not keys:
                continue
            med = statistics.median(g_r[k] for k in keys)
            live = [k for k in keys if g_r[k] >= DEAD * med]
            dmed = statistics.median(d_r[k] for k in live)
            gaps.update({k: abs(d_p[k] - d_r[k]) / max(d_r[k], dmed) for k in live})
        key = max(gaps, key=lambda k: gaps[k])
        out["change_gap"] = _finite(gaps[key])
        if worst is not None:
            worst["change_gap"] = key
    return {n: out[n] for n in wanted}
