"""Statistics over all requests of a window.

``percentile`` is a copy of ``repro_torch.serving.api.percentile``
(linear interpolation, numpy's default), kept here so that the yardstick
does not move with the program."""
from __future__ import annotations

from typing import Sequence


def percentile(xs: Sequence[float], q: float) -> float:
    """Linear-interpolated ``q``-th percentile of ``xs`` (nan if empty)."""
    if not xs:
        return float("nan")
    s = sorted(xs)
    if len(s) == 1:
        return s[0]
    pos = (len(s) - 1) * q / 100.0
    lo = int(pos)
    hi = min(lo + 1, len(s) - 1)
    return s[lo] + (s[hi] - s[lo]) * (pos - lo)


def mean(xs: Sequence[float]) -> float:
    """Arithmetic mean of ``xs`` (nan if empty)."""
    return sum(xs) / len(xs) if xs else float("nan")
