"""Shared device pool for fleet serving.

Port of ``repro/fleet/pool.py``.  One pool backs every member of a fleet:
it makes the c/p split of its device once (a
:class:`~repro_torch.dualcore.runtime.DualCores`: on a card the c-core and
the p-core are two green contexts on disjoint SMs, each with its own
stream; on the CPU one aliased queue) and *leases* that split to each
member engine.  Every member's c-groups then go to the same c stream and
its p-groups to the same p stream, which lets a conv-heavy exec group of
one network overlap a dw-heavy group of another on the other core's SMs:
the multi-network generalization of the Fig.4b two-image offset.  Each of
N in-process pools splits the whole card, as each reference pool splits
all of ``jax.devices()``.

Leases are named and exclusive per name (two engines accounting the same
traffic is a wiring bug); releasing frees the name.  ``resplit`` makes a
new split at the new ``theta`` and replaces the pool's cores; the work in
flight drains on the old green contexts, which are kept, and a count
split before gives back its split (``kernels/green.py``).  ``sm_split=False`` keeps two plain streams on every SM,
whose ``resplit`` only records the new theta.
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
    the pool asks for (Eq.10), kept as asked, as the reference pool keeps
    it; the cores record the share the split realised.
    """

    def __init__(self, device: str | torch.device = "cuda", *,
                 theta: float = 0.5, sm_split: bool = True):
        self.device = resolve_device(device)
        self.theta = theta
        self.cores = DualCores(self.device, theta, sm_split=sm_split)
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
        """Re-split the pool at a new ``theta`` (Eq.10): new green
        contexts on a split card (the same two streams under the new
        recorded theta without a split).  Refuses while leases are held
        (``revoke_all`` first: holders must relocate)."""
        if self._leases:
            raise RuntimeError(f"resplit with leases held "
                               f"({sorted(self._leases)}); revoke_all() "
                               f"first and relocate the holders")
        self.theta = theta
        self.cores = self.cores.resplit(theta)
        return self.cores

    def stats(self) -> dict:
        """Pool summary: device, theta (the realised share on a split
        card), whether the two cores are distinct streams, whether the SMs
        are split and, if so, each core's SMs, and the lease holders."""
        out = {"device": str(self.device),
               "theta": self.cores.theta,
               "streams": 2 if self.cores.distinct else 1,
               "degenerate": self.degenerate,
               "sm_split": self.cores.sm_split,
               "leases": sorted(self._leases)}
        if self.cores.sm_split:
            out["sms"] = {core: self.cores.sms(core) for core in "cp"}
        return out
