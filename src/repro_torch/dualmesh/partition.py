"""theta split of one card into the c-core and the p-core.

Port of ``repro/dualmesh/partition.py``.  The reference splits a pod's
chips into a compute-shaped c-submesh (prefill) and a bandwidth-shaped
p-submesh (decode) with the Eq.10 ratio ``theta``.  One card has no chips
to split, but it has SMs: :func:`split_streams` gives the c-core and the
p-core as two disjoint sets of the card's SMs at ``theta``, each a green
context with its own streams (the port's :class:`~repro_torch.dualcore.
runtime.DualCores`), one "chip" each with no tensor parallelism; the
realised c-share is recorded, as the reference records ``n_c / n``, and
each core's share of the SMs is what the planner prices it at, as the
reference prices each submesh by its chips.
``sm_split=False`` gives two plain streams on every SM, the baseline.  On
the CPU both cores alias one queue, like the reference's degenerate
single-device split.

The design-flow search (``dualmesh/search.py``) prices splits it never
makes: :class:`SplitPlan` has the fields the planner reads and no
streams.  :func:`abstract_split` is the reference's pod of abstract chips
with a TP width a side; :func:`card_split` is the card's SMs split as
:func:`split_streams` would split them, counted only (no green context).
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.dualcore.runtime import DualCores
from repro_torch.kernels.green import split_count
from repro_torch.kernels.util import resolve_device


@dataclasses.dataclass(frozen=True)
class DualStreams:
    """The c/p split of one device, in the shape the planner reads
    (chips and TP width per side, and each core's share of the card's
    SMs: its SM count over the card's on a split, else 1.0)."""

    cores: DualCores
    theta: float                 # realised c-share (the SMs' on a split)
    c_share: float = 1.0
    p_share: float = 1.0
    c_chips: int = 1
    p_chips: int = 1
    tp_c: int = 1
    tp_p: int = 1

    @property
    def device(self) -> torch.device:
        """The device both cores run on."""
        return self.cores.device

    def stream(self, core: str) -> torch.cuda.Stream | None:
        """The CUDA stream of core ``"c"`` or ``"p"`` (None on the CPU)."""
        return self.cores.streams[core]


def split_streams(device: str | torch.device = "cuda", theta: float = 0.5,
                  one_stream: bool = False,
                  sm_split: bool = True) -> DualStreams:
    """The c-core and the p-core of ``device``: two green contexts on
    disjoint SMs (two plain streams on every SM with ``sm_split=False``,
    one with ``one_stream``, the no-overlap baseline), or one aliased queue
    on the CPU.  ``device`` defaults to the card and raises without one;
    a split CUDA cannot make raises."""
    if not 0.0 < theta < 1.0:
        raise ValueError(f"theta must lie in (0, 1), got {theta}")
    dev = resolve_device(device)
    cores = DualCores(dev, theta, one_stream=one_stream, sm_split=sm_split)
    if cores.split is None:
        return DualStreams(cores=cores, theta=cores.theta)
    total = cores.split.total
    return DualStreams(cores=cores, theta=cores.theta,
                       c_share=cores.sms("c") / total,
                       p_share=cores.sms("p") / total)


@dataclasses.dataclass(frozen=True)
class SplitPlan:
    """A c/p split as the planner prices it, with nothing to run on: the
    realised c-share, chips and TP width a side, each core's share of the
    card's SMs, and on a card plan each core's SM count."""

    theta: float
    c_chips: int = 1
    p_chips: int = 1
    tp_c: int = 1
    tp_p: int = 1
    c_share: float = 1.0
    p_share: float = 1.0
    c_sms: int | None = None
    p_sms: int | None = None


def abstract_split(n_devices: int, theta: float, tp_c: int = 16,
                   tp_p: int = 4) -> SplitPlan:
    """The reference's plan-time split of ``n_devices`` abstract chips:
    ``n_c = min(n-1, max(1, round(theta*n)))`` chips for the c-side, each
    side's TP width the largest divisor of its chips up to ``tp_c`` /
    ``tp_p``; each side prices a whole chip (share 1)."""
    n_c = min(n_devices - 1, max(1, round(theta * n_devices)))
    n_p = n_devices - n_c
    tc = max(1, min(tp_c, n_c))
    while n_c % tc:
        tc -= 1
    tp_ = max(1, min(tp_p, n_p))
    while n_p % tp_:
        tp_ -= 1
    return SplitPlan(theta=n_c / n_devices, c_chips=n_c, p_chips=n_p,
                     tp_c=tc, tp_p=tp_)


def card_split(theta: float, sms: int) -> SplitPlan:
    """The split of a card of ``sms`` SMs that :func:`split_streams` makes
    at ``theta`` (``split_count``'s c-core SMs, the rest for the p-core),
    counted only: one chip and TP 1 a core, each priced at its share of
    the SMs, as ``split_streams`` records it."""
    n_c = split_count(theta, sms)
    return SplitPlan(theta=n_c / sms, c_share=n_c / sms,
                     p_share=(sms - n_c) / sms, c_sms=n_c, p_sms=sms - n_c)
