"""Scalar metric recording for training runs, copied from
``rcgan_tpu/utils/metrics.py`` (the reference's ``lib.plot`` channel,
``cifar10/common/plot.py``): named scalars against an iteration counter, a
one-line window summary in the log per flush, one curve image per metric,
and the full history on disk as ``log.pkl`` (``{name: {step: value}}``) and
``metrics.jsonl``.

Curves are rendered with matplotlib, imported when a flush renders; where
it (or the image writer it needs for JPEG) is missing, the curves are
skipped with one logged warning and the history is still written.
"""

from __future__ import annotations

import json
import logging
import os
import pickle

import numpy as np

log = logging.getLogger(__name__)


class _Series:
    __slots__ = ("steps", "values", "watermark")

    def __init__(self):
        self.steps: list[int] = []
        self.values: list[float] = []
        self.watermark = 0  # prefix length already summarized by a flush

    def append(self, step: int, value: float):
        self.steps.append(step)
        self.values.append(value)

    def window(self):
        """Values recorded since the last flush."""
        return self.values[self.watermark:]

    def advance(self):
        self.watermark = len(self.values)


class MetricLogger:
    """Step-indexed scalar recorder with windowed flushes.

    ``plot`` records at the current step, ``plot_at`` at an explicit step
    (metrics fetched in blocks), ``tick`` advances the step counter, and
    ``dir_flush`` summarizes, renders and persists.
    """

    def __init__(self):
        self._series: dict[str, _Series] = {}
        self._step = 0
        self._can_render = True

    @property
    def step(self) -> int:
        return self._step

    def tick(self):
        self._step += 1

    def plot(self, name: str, value):
        self.plot_at(name, value, self._step)

    def plot_at(self, name: str, value, step: int):
        self._series.setdefault(name, _Series()).append(int(step), float(value))

    def history(self, name: str):
        """Full (steps, values) arrays for one metric."""
        s = self._series[name]
        return np.asarray(s.steps), np.asarray(s.values)

    def dir_flush(self, out_dir: str, log_pkl: bool = True, render: bool = True):
        """Summarize the unflushed tail of every metric: one log line of
        per-metric window means, curve images when ``render``, and the
        history on disk.  Returns the summary strings."""
        parts = []
        for name, series in self._series.items():
            tail = series.window()
            if not tail:
                continue
            parts.append(f"{name}: {np.mean(tail):.6g}")
            series.advance()
            if render:
                self._render(name, out_dir)
        log.info("iter %d\n%s", self._step, ", ".join(parts))
        if log_pkl:
            self._persist(out_dir)
        return parts

    def _render(self, name: str, out_dir: str):
        if not self._can_render:
            return
        try:
            import matplotlib

            matplotlib.use("Agg")
            import matplotlib.pyplot as plt

            steps, values = self.history(name)
            order = np.argsort(steps, kind="stable")
            plt.clf()
            plt.plot(steps[order], values[order])
            plt.xlabel("iteration")
            plt.ylabel(name)
            plt.savefig(os.path.join(out_dir, f"{name.replace(' ', '_')}.jpg"))
        except (ImportError, ValueError) as e:  # no matplotlib, or no JPEG writer
            self._can_render = False
            log.warning("metric curves disabled (%s); log.pkl and metrics.jsonl still "
                        "hold every value", e)

    def _persist(self, out_dir: str):
        # log.pkl keeps the {name: {step: value}} layout for plot tooling
        snapshot = {name: dict(zip(s.steps, s.values)) for name, s in self._series.items()}
        with open(os.path.join(out_dir, "log.pkl"), "wb") as f:
            pickle.dump(snapshot, f, pickle.HIGHEST_PROTOCOL)
        with open(os.path.join(out_dir, "metrics.jsonl"), "w") as f:
            for name, s in self._series.items():
                f.write(json.dumps({"name": name, "steps": s.steps, "values": s.values}) + "\n")
