"""Shared device pool for fleet serving.

Port of ``repro/fleet/pool.py``.  One pool backs every member of a fleet:
it makes the c/p split of its device once (a
:class:`~repro_torch.dualcore.runtime.DualCores`: on a card the c-core and
the p-core are two CUDA streams, on the CPU one aliased queue) and
*leases* that split to each member engine.  Every member's c-groups then
go to the same c stream and its p-groups to the same p stream, which lets
a conv-heavy exec group of one network overlap a dw-heavy group of
another: the multi-network generalization of the Fig.4b two-image offset.

Leases are named and exclusive per name (two engines accounting the same
traffic is a wiring bug); releasing frees the name.  ``resplit`` keeps the
same two streams and changes only the recorded ``theta``: both streams
share all of the card's SMs until the SMs are split (ROADMAP queue 1
item 3), and :meth:`DevicePool.stats` and the cores' ``describe`` say so.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.dualcore.runtime import DualCores
from repro_torch.kernels.util import resolve_device


@dataclasses.dataclass(frozen=True)
class Lease:
    """One member's hold on the pool's cores."""

    name: str
    cores: DualCores


class DevicePool:
    """Owns one device and the single c/p split every member shares.

    ``device`` defaults to the card and raises without one
    (``device="cpu"`` runs the plain versions).  ``theta`` is the c-share
    of the pool (Eq.10), recorded on the split.
    """

    def __init__(self, device: str | torch.device = "cuda", *,
                 theta: float = 0.5):
        self.device = resolve_device(device)
        self.theta = theta
        self.cores = DualCores(self.device, theta)
        self._leases: dict[str, Lease] = {}

    @property
    def degenerate(self) -> bool:
        """True when both cores alias one queue (the CPU): dispatches
        serialize."""
        return not self.cores.distinct

    @property
    def leases(self) -> list[str]:
        """Names currently holding a lease on the shared split."""
        return list(self._leases)

    def lease(self, name: str) -> DualCores:
        """Lease the shared c/p split to member ``name`` (exclusive)."""
        if name in self._leases:
            raise ValueError(f"pool lease {name!r} already held; release "
                             f"it before re-leasing (one engine per name)")
        self._leases[name] = Lease(name=name, cores=self.cores)
        return self.cores

    def release(self, name: str) -> None:
        """Release ``name``'s lease; unknown names raise KeyError."""
        if name not in self._leases:
            raise KeyError(f"no lease named {name!r} "
                           f"(held: {sorted(self._leases)})")
        del self._leases[name]

    def revoke_all(self) -> list[str]:
        """Drop every lease (the pool's half of a REBALANCE) and return the
        revoked names, so the caller can re-lease and relocate each."""
        revoked = sorted(self._leases)
        self._leases.clear()
        return revoked

    def resplit(self, theta: float) -> DualCores:
        """Re-split the pool at a new ``theta`` (Eq.10): the same two
        streams under the new recorded theta.  Refuses while leases are
        held (``revoke_all`` first: holders must relocate)."""
        if self._leases:
            raise RuntimeError(f"resplit with leases held "
                               f"({sorted(self._leases)}); revoke_all() "
                               f"first and relocate the holders")
        self.theta = theta
        self.cores = self.cores.resplit(theta)
        return self.cores

    def stats(self) -> dict:
        """Pool summary: device, theta, whether the two cores are distinct
        streams, whether the SMs are split, and the lease holders."""
        return {"device": str(self.device),
                "theta": self.cores.theta,
                "streams": 2 if self.cores.distinct else 1,
                "degenerate": self.degenerate,
                "sm_split": False,
                "leases": sorted(self._leases)}
