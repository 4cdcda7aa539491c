"""The program's own spans, as its counters report them
(``train/graphs.py::CapturedStep.stats()``, kept by
``rcgan_tpu_torch/utils/profiling.py::Spans``): milliseconds a step of
device spans and of host spans, or ``None`` where the program reports none
of them (a program without spans)."""

from typing import Mapping, Optional, Sequence


def device_ms(stats: Mapping, names: Sequence[str]) -> Optional[float]:
    """The device spans ``names`` (``device_s.<name>``, summed over the
    steps since the program's graph was captured) in ms a step
    (``device_steps``); a name the program did not mark counts 0."""
    steps = (stats or {}).get("device_steps")
    found = [stats[f"device_s.{n}"] for n in names if f"device_s.{n}" in stats] if steps else []
    return 1e3 * sum(found) / steps if found else None


def host_ms(stats: Mapping, names: Sequence[str]) -> Optional[float]:
    """The host spans ``names`` in ms a step: each span's seconds over the
    steps it covered (``host_s.<name>`` / ``host_steps.<name>``), summed;
    ``None`` unless the program reports every one."""
    stats = stats or {}
    if not all(stats.get(f"host_steps.{n}") for n in names):
        return None
    return 1e3 * sum(stats[f"host_s.{n}"] / stats[f"host_steps.{n}"] for n in names)
