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
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.dualcore.runtime import DualCores
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
