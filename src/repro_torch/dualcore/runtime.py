"""Pipelined dual-core CNN runtime: execute a Schedule for real (Fig.4b).

Port of ``repro/dualcore/runtime.py``.  ``core/scheduler.py`` builds the
alternating c/p group chain; :func:`build_exec_plan` maps it onto the step
program (each step goes to the core carrying the dominant share of its
cycles, consecutive same-core steps merge into exec groups, and the merged
chain is re-expressed as a ``Schedule`` so T_b2 stays comparable with what
runs); :class:`DualCoreRunner` runs the groups with the paper's one-slot
offset through ``repro_torch.serving.cnn.DualCoreEngine``.

The two cores on one card (:class:`DualCores`): the c-core and the p-core
are two CUDA streams of the same device.  Both streams share all of the
card's SMs: ``theta`` (the Eq.10 split) is recorded but does not split SMs
yet.  A group waits on the ready event of the env it receives, runs its
steps on its core's stream, and records a new ready event; tensors handed
across streams are marked with ``record_stream`` so the caching allocator
never reuses their memory while the other stream may still read them.  On
the CPU both cores alias one queue, like the reference's degenerate
single-device split.  Parameters live once on the device: the reference's
per-core ``device_put`` and ``jax.jit`` donation have no counterpart.
"""
from __future__ import annotations

import copy
import dataclasses
import time

import torch

from repro_torch.core.arch import BoardModel, DualCoreConfig
from repro_torch.core.graph import LayerGraph
from repro_torch.core.latency import layer_latency
from repro_torch.core.scheduler import Group, Schedule
from repro_torch.dualcore.program import (Env, Params, Program, Step,
                                          build_program, regroup_fused)
from repro_torch.kernels.util import resolve_device

#: env key of the CUDA event that marks the env's tensors as written
READY = "ready_event"


@dataclasses.dataclass
class ExecGroup:
    """One pipeline stage: consecutive same-core steps."""

    core: str                    # 'c' | 'p'
    steps: list[Step]

    @property
    def layers(self) -> list[str]:
        """Graph layers of the group's steps, in order."""
        return [n for s in self.steps for n in s.layers]


@dataclasses.dataclass
class ExecPlan:
    """Executable partition of a program + its analytical twin."""

    groups: list[ExecGroup]
    exec_schedule: Schedule      # the merged chain as a Schedule (T_b2 etc.)
    live_after: list[set[str]]   # env keys that must survive each boundary


def _layer_core_map(schedule: Schedule) -> dict[str, tuple[str, int]]:
    """Base layer name -> (core, height); the tallest split of a
    load-balanced layer wins (it carries the dominant share of the work)."""
    out: dict[str, tuple[str, int]] = {}
    for g in schedule.groups:
        for l in g.layers:
            base = l.name.split(".")[0]
            cur = out.get(base)
            if cur is None or l.H > cur[1]:
                out[base] = (g.core, l.H)
    return out


def _step_core(step: Step, lmap: dict[str, tuple[str, int]],
               graph: LayerGraph, cfg: DualCoreConfig,
               board: BoardModel) -> str:
    """Core carrying the dominant share of the step's cycles."""
    weight = {"c": 0, "p": 0}
    for name in step.layers:
        core = lmap[name][0]
        lat = layer_latency(graph.layer(name), cfg.core(core),
                            board).t_layer
        weight[core] += lat
    return "c" if weight["c"] >= weight["p"] else "p"


def build_exec_plan(program: Program, schedule: Schedule,
                    group_fusion: bool = False) -> ExecPlan:
    """Partition ``program`` into alternating-core exec groups per the
    schedule's allocation.  With ``group_fusion`` the per-layer steps of
    each group are re-fused (dw->pw chains the schedule kept on one core
    become single fused launches)."""
    graph = program.graph
    lmap = _layer_core_map(schedule)
    missing = [n for s in program.steps for n in s.layers if n not in lmap]
    if missing:
        raise ValueError(f"schedule does not cover layers {missing[:4]}; "
                         f"was it built from graph {graph.name!r}?")
    cores = [_step_core(s, lmap, graph, schedule.cfg, schedule.board)
             for s in program.steps]
    parts: list[list[Step]] = []
    part_cores: list[str] = []
    for step, core in zip(program.steps, cores):
        if part_cores and part_cores[-1] == core:
            parts[-1].append(step)
        else:
            parts.append([step])
            part_cores.append(core)
    if group_fusion:
        parts = regroup_fused(program, parts)
    groups = [ExecGroup(core=c, steps=p)
              for c, p in zip(part_cores, parts)]
    exec_schedule = Schedule(
        groups=[Group(g.core, [graph.layer(n) for n in g.layers])
                for g in groups],
        cfg=schedule.cfg, board=schedule.board,
        scheme=schedule.scheme + "+exec")
    # liveness: buffers read after each boundary before being rewritten
    # (plus the final output): the env a group must hand to the next
    live_after: list[set[str]] = []
    live = {"out"}
    for g in reversed(groups):
        live_after.append(set(live))
        for s in reversed(g.steps):
            live -= set(s.writes)
            live |= set(s.reads)
    live_after.reverse()
    return ExecPlan(groups=groups, exec_schedule=exec_schedule,
                    live_after=live_after)


# --------------------------------------------------------------------------
# the two cores on one device
# --------------------------------------------------------------------------
class DualCores:
    """The c-core and the p-core of one device.

    On CUDA: two streams of the same card (one stream for both with
    ``one_stream``, the no-overlap baseline).  They share every SM:
    ``theta`` is recorded for the printout and does not split SMs yet.  On
    the CPU: both cores alias the one eager queue (no overlap)."""

    def __init__(self, device: torch.device, theta: float = 0.5,
                 one_stream: bool = False):
        self.device = device
        self.theta = theta
        if device.type == "cuda":
            c = torch.cuda.Stream(device)
            p = c if one_stream else torch.cuda.Stream(device)
            self.streams = {"c": c, "p": p}
        else:
            self.streams = {"c": None, "p": None}

    def resplit(self, theta: float) -> "DualCores":
        """The same two streams under a new recorded ``theta`` (SMs are not
        split, so only the record changes)."""
        out = copy.copy(self)
        out.theta = theta
        return out

    @property
    def on_card(self) -> bool:
        """True when the cores are CUDA streams (events order them)."""
        return self.streams["c"] is not None

    @property
    def distinct(self) -> bool:
        """True when the two cores are separate queues (two streams)."""
        return self.on_card and self.streams["c"] is not self.streams["p"]

    def describe(self) -> str:
        """One line for the printout: what the two cores are."""
        if not self.on_card:
            return (f"c/p cores alias one {self.device.type} queue "
                    f"(degenerate: no overlap)")
        name = torch.cuda.get_device_name(self.device)
        if not self.distinct:
            return (f"c/p cores share one CUDA stream on one {name} "
                    f"(no overlap)")
        sms = torch.cuda.get_device_properties(self.device) \
            .multi_processor_count
        return (f"c/p cores are two CUDA streams on one {name}; both "
                f"streams share all {sms} SMs (theta={self.theta:.2f} is "
                f"recorded, SMs are not split)")


def wait_ready(env: Env) -> None:
    """Block the host until ``env``'s tensors are written, then mark them
    as used by the current stream so their memory outlives any work that
    stream queues on them.  No-op on the CPU."""
    ready = env.get(READY)
    if ready is None:
        return
    ready.synchronize()
    stream = torch.cuda.current_stream()
    for k, v in env.items():
        if k != READY:
            v.record_stream(stream)


# --------------------------------------------------------------------------
# runner
# --------------------------------------------------------------------------
@dataclasses.dataclass
class GroupHandle:
    """Executable handle on one exec group: what a RUN needs to advance a
    stream one stage.  The cross-core hop is the ready event the env
    carries: nothing is copied between cores."""

    runner: "DualCoreRunner"
    index: int
    core: str

    def __call__(self, env: Env) -> Env:
        return self.runner._run_group(self.index, env)


class DualCoreRunner:
    """Executes one CNN's schedule on the c/p cores, images pipelined with
    the one-slot offset of Fig.4b.

    fuse='group' (default) builds the per-layer program and re-fuses dw->pw
    chains *within* each exec group, so fusion never crosses a core
    boundary; fuse=True partitions the full fusion-plan program; fuse=False
    keeps every layer its own kernel.  ``device`` defaults to the card and
    raises without one; ``device="cpu"`` runs the plain versions.
    ``cores`` is a :class:`DualCores` leased from a fleet's pool, so that
    every member dispatches onto the same two streams (the reference's
    ``devices=`` taking a ``DualMesh``); without it the runner makes its
    own at ``theta``.
    """

    def __init__(self, graph: LayerGraph | str, params: Params,
                 schedule: Schedule, *, device: str | torch.device = "cuda",
                 theta: float = 0.5, fuse: bool | str = "group",
                 cores: DualCores | None = None):
        self.device = resolve_device(device)
        group_fusion = fuse == "group"
        self.program = build_program(graph,
                                     fuse=bool(fuse) and not group_fusion)
        self.graph = self.program.graph
        self.schedule = schedule
        self.plan = build_exec_plan(self.program, schedule,
                                    group_fusion=group_fusion)
        self.groups = self.plan.groups
        if cores is None:
            cores = DualCores(self.device, theta)
        self._check_cores(cores)
        self.cores = cores
        # one copy of the parameters, read by both cores
        self._params = {n: {k: v.to(self.device) for k, v in p.items()}
                        for n, p in params.items()}
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)   # params visible to both
        self._fns = [self._group_fn(i) for i in range(len(self.groups))]

    def _check_cores(self, cores: DualCores) -> None:
        if cores.device != self.device:
            raise ValueError(f"cores on {cores.device} cannot run a runner "
                             f"on {self.device}")

    def relocate(self, cores: DualCores) -> None:
        """Rebind the runner onto a re-split pool's cores (the runner's
        half of a REBALANCE).  The parameters stay where they are: one
        copy on the device serves both cores.  Envs in flight keep their
        ready events; the next group's stream waits on them."""
        self._check_cores(cores)
        self.cores = cores

    def _group_fn(self, gi: int):
        steps = self.groups[gi].steps
        live = self.plan.live_after[gi]

        def group_fn(params: Params, env: Env) -> Env:
            env = dict(env)
            for s in steps:
                s.fn(params, env, None)
            return {k: v for k, v in env.items() if k in live}

        return group_fn

    def _run_group(self, gi: int, env: Env) -> Env:
        """Run exec group ``gi`` on its core.  On CUDA: wait for the env's
        ready event on the core's stream, mark the incoming tensors as used
        there, run, and record the new env's ready event."""
        stream = self.cores.streams[self.groups[gi].core]
        if stream is None:
            return self._fns[gi](self._params, env)
        env = dict(env)
        ready = env.pop(READY, None)
        with torch.cuda.stream(stream):
            if ready is not None:
                stream.wait_event(ready)
            for v in env.values():
                v.record_stream(stream)
            out = self._fns[gi](self._params, env)
            done = torch.cuda.Event()
            done.record(stream)
        out[READY] = done
        return out

    # ------------------------------------------------------------------
    # executor-facing surface: what a RUN instruction needs
    # ------------------------------------------------------------------
    @property
    def handles(self) -> list[GroupHandle]:
        """One :class:`GroupHandle` per exec group, in chain order."""
        return [GroupHandle(runner=self, index=i, core=g.core)
                for i, g in enumerate(self.groups)]

    def place_input(self, x: torch.Tensor) -> Env:
        """Wrap a raw input into the env of a new stream, on the runner's
        device, with a ready event recorded on the caller's stream (the
        first group's core waits on it)."""
        if x.device != self.device:
            x = x.to(self.device)
        env: Env = {"h": x.contiguous()}
        if self.cores.on_card:
            ready = torch.cuda.Event()
            ready.record(torch.cuda.current_stream(self.device))
            env[READY] = ready
        return env

    # ------------------------------------------------------------------
    def run_pipelined(self, images, record: list | None = None):
        """Stream every image through the exec-group chain, offset by one
        slot (the engine's saturated schedule); ``record`` receives
        ``(slot, stream, group, core)`` tuples in dispatch order."""
        from repro_torch.serving.cnn import stream_images

        return stream_images(self, images, record=record).outputs

    def run_sequential(self, images):
        """Strictly serialized baseline: one image at a time through the
        whole chain, awaiting completion before the next image starts (one
        core active at any moment: the denominator of the pipeline
        speedup)."""
        outs = []
        handles = self.handles
        for x in images:
            env = self.place_input(x)
            for h in handles:
                env = h(env)
            wait_ready(env)
            outs.append(env["out"])
        return outs

    def timed(self, images, mode: str = "pipelined",
              reps: int = 1) -> tuple[list, float]:
        """Best-of-``reps`` wall-clock of a full run (every output
        materialized before the clock stops)."""
        run = (self.run_pipelined if mode == "pipelined"
               else self.run_sequential)
        outs, best = None, float("inf")
        for _ in range(max(1, reps)):
            t0 = time.perf_counter()
            outs = run(images)
            best = min(best, time.perf_counter() - t0)
        return outs, best
