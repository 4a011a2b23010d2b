"""Closed loop: ``clients`` callers, each sending its next request the
moment its last one is served, with no think time.  A request is due
when its client sends it, so the loop never runs late."""
from __future__ import annotations


class Loop:
    """The clients of a traffic file whose ``loop`` is ``"closed"``."""

    def __init__(self, traffic: dict, seed: int):
        self.idle = int(traffic["clients"])

    def due(self, now: float) -> list[float]:
        """Due times of the requests to send at ``now``: one for each
        idle client."""
        out = [now] * self.idle
        self.idle = 0
        return out

    def served(self, n: int) -> None:
        """``n`` requests came back: their clients are idle again."""
        self.idle += n
