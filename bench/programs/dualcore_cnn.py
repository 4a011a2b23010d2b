"""The program under test for a zoo CNN: ``repro_torch``'s serving path
with the port's own defaults.

``build_schedule(graph, DUAL_BASELINE, BoardModel(), scheme)``, then
``DualCoreRunner(model, params, schedule)`` (``fuse="group"``,
``jit_groups=True``; on a card green contexts whose c-core SM count the
runner measures at its first lane capture, from a start at theta 0.5:
``green.balanced_count``), then ``DualCoreEngine(runner)``.  The
harness drives the engine's ``submit``, ``advance`` and ``retire``
itself; it neither tunes nor writes the port's plan cache."""
from __future__ import annotations

import os

import torch


class Program:
    """One model served by ``DualCoreEngine`` on ``device``."""

    def __init__(self, config: dict, params: dict, device: torch.device):
        from repro_torch.core.arch import DUAL_BASELINE, BoardModel
        from repro_torch.core.scheduler import build_schedule
        from repro_torch.dualcore.runtime import DualCoreRunner
        from repro_torch.models.zoo import get_graph
        from repro_torch.serving.cnn import DualCoreEngine

        graph = get_graph(config["model"])
        schedule = build_schedule(graph, DUAL_BASELINE, BoardModel(),
                                  config["scheme"])
        self.runner = DualCoreRunner(config["model"], params, schedule,
                                     device=device)
        self.engine = DualCoreEngine(self.runner)
        self.capacity = self.engine.capacity

    def submit(self, x: torch.Tensor) -> int:
        """Queue one request; its id."""
        return self.engine.submit(x).rid

    def advance(self):
        """Enqueue one slot's launches; what ``retire`` waits for."""
        return self.engine.advance()

    def retire(self, token) -> list[tuple[int, torch.Tensor, float]]:
        """Wait for the outputs ``advance`` finished: ``(id, logits,
        admitted at)`` each."""
        return [(c.ticket.rid, c.output, c.metrics.started_at)
                for c in self.engine.retire(token)]

    @property
    def has_work(self) -> bool:
        """True while requests are queued or in flight."""
        return self.engine.has_work

    def launches(self) -> int:
        """Kernel launches the port has counted so far."""
        from repro_torch.kernels.util import launch_counts

        return sum(launch_counts().values())

    def lanes(self) -> int:
        """Lanes (sets of captured graphs) the runner holds."""
        return self.runner.lanes.count

    def describe(self) -> list[str]:
        """Lines for the log: the cores, the groups, the plan cache."""
        from repro_torch.kernels import autotune

        path = autotune.cache_path()
        state = "present" if os.path.isfile(path) else "absent"
        return [self.runner.cores.describe(),
                f"{len(self.runner.groups)} exec groups "
                f"({''.join(g.core for g in self.runner.groups)})",
                f"plan cache {os.path.abspath(path)} ({state}); lookups "
                f"{autotune.LOOKUPS['hit']} hit, "
                f"{autotune.LOOKUPS['miss']} missed"]

    def close(self) -> None:
        """Drop the engine, the runner and their lanes."""
        self.engine = self.runner = None
