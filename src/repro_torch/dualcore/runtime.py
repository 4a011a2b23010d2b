"""Pipelined dual-core CNN runtime: execute a Schedule for real (Fig.4b).

Port of ``repro/dualcore/runtime.py``.  ``core/scheduler.py`` builds the
alternating c/p group chain; :func:`build_exec_plan` maps it onto the step
program (each step goes to the core carrying the dominant share of its
cycles, consecutive same-core steps merge into exec groups, and the merged
chain is re-expressed as a ``Schedule`` so T_b2 stays comparable with what
runs); :class:`DualCoreRunner` runs the groups with the paper's one-slot
offset through ``repro_torch.serving.cnn.DualCoreEngine``.

The two cores on one card (:class:`DualCores`): the c-core and the p-core
are two disjoint sets of the card's SMs, each a green context with its own
streams, split at ``theta`` (the Eq.10 split, the reference's ``split_mesh``
with SMs for chips) or, for a runner that makes its own, at a count it
measures once (:class:`DualCoreRunner`); ``sm_split=False`` keeps two plain
streams on every SM as the baseline.  A group waits on the ready event of the env it receives,
runs on its core's stream, and records a new ready event; tensors handed
across streams are marked with ``record_stream`` so the caching allocator
never reuses their memory while the other stream may still read them.  On the
CPU both cores alias one queue, like the reference's degenerate
single-device split.  Parameters live once on the device, read by both cores:
the reference's per-core ``device_put`` has no counterpart.

Compiled groups (``jit_groups``, the reference's per-group ``jax.jit``): on
the card each exec group runs as one CUDA graph, replayed between the
ready-event wait and the new event's record.  A graph reads and writes fixed
addresses, so a request runs on a :class:`Lane`: one graph per exec group,
captured in chain order from one private memory pool on its own core's
capture stream (so a c-group's kernels run on the c-core's SMs wherever the
graph is replayed), group g+1's graph reading in place what group g's graph
wrote (the counterpart of ``donate_argnums=(1,)``).  ``place_input`` copies
the image into the lane (group 0 never writes the caller's tensor), the last
group clones ``"out"`` out of it and hands the lane back to its
:class:`LanePool`, behind that group's ready event.  Lanes are pooled per
input shape and dtype; a lane is reused only behind a device-side wait on
its previous request's last ready event, and when every lane is held the
pool grows by a new capture.  A capture can wait until the card is idle
(``tools/capture_wait.py``), so the lanes a traffic pattern holds at once
are made by a warm-up run of that traffic (``serve``, ``chip_smoke.py``);
after it the host never waits.  The first lane of a shape is preceded by one
eager run of the chain on the cores' streams (the library build, the
kernels' attributes, the host planners, the allocator).  A runner moved onto
a re-split pool drops its lanes and captures new ones in the new partitions
at the next request, as the reference re-jits on the new mesh.  A failed
capture raises with the group and the step; nothing falls back to the eager
path, which runs only with ``jit_groups=False``.  On the CPU ``jit_groups``
and ``donate`` are accepted and change nothing, as donation changes nothing
on the reference's CPU backend.
"""
from __future__ import annotations

import copy
import dataclasses
import statistics
import time
from collections import deque
from typing import Callable

import torch

from repro_torch.core.arch import BoardModel, DualCoreConfig
from repro_torch.core.graph import LayerGraph
from repro_torch.core.latency import layer_latency
from repro_torch.core.scheduler import Group, Schedule
from repro_torch.dualcore.program import (Env, Params, Program, Step,
                                          build_program, regroup_fused)
from repro_torch.kernels.green import (GreenContextError, Probe, SmSplit,
                                      balanced_count, split_sms)
from repro_torch.kernels.util import (CountedGraph, capture_graph,
                                     resolve_device)
from repro_torch.obs import Registry, SpanRecorder

#: env key of the CUDA event that marks the env's tensors as written
READY = "ready_event"
#: env key of the :class:`Lane` a request runs on (compiled groups)
LANE = "lane"
#: the theta a measured split starts from, and the one kept by a runner
#: that cannot measure (eager, the CPU)
START_THETA = 0.5
#: timed rounds of each core's chain at a probed count, after one untimed
BALANCE_ROUNDS = 9


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

    On CUDA, by default (``sm_split``): two disjoint sets of the card's
    SMs, each a green context with its own streams
    (:func:`~repro_torch.kernels.green.split_sms`), the c-core
    ``round(theta * SMs)`` of them rounded to CUDA's granularity of
    8 and the p-core the rest; ``theta`` is then the realised c-share, as
    the reference's ``split_mesh`` records ``n_c / len(devs)``, and
    ``asked`` the theta asked for.  A CUDA driver without green contexts, or a
    split it refuses, raises.  ``sm_split=False`` gives two plain streams
    that share every SM (theta recorded only), the baseline the split is
    measured against; ``one_stream`` one plain stream for both cores, the
    no-overlap baseline (its cores share every SM too).  On the CPU: both
    cores alias the one eager queue (no overlap), and nothing is split.

    The cores split where they are asked to.  A :class:`DualCoreRunner`
    that makes its own cores with no ``theta`` given moves them, once, to a
    count it measures (its docstring) and records its probes in
    ``balance`` (None on cores split at a theta asked)."""

    def __init__(self, device: torch.device, theta: float = 0.5,
                 one_stream: bool = False, sm_split: bool = True):
        self.device = device
        self.asked = theta
        self.theta = theta
        self.split: SmSplit | None = None
        self.balance: list[Probe] | None = None
        self._capture: torch.cuda.Stream | None = None
        if device.type == "cuda":
            if sm_split and not one_stream:
                self.split = split_sms(device, theta)
                self.theta = self.split.theta
                self.streams = {core: part.stream
                                for core, part in self.split.parts.items()}
            else:
                c = torch.cuda.Stream(device)
                p = c if one_stream else torch.cuda.Stream(device)
                self.streams = {"c": c, "p": p}
        else:
            self.streams = {"c": None, "p": None}

    def resplit(self, theta: float) -> "DualCores":
        """The cores re-split at ``theta``: on a split card, the split of
        the new count (made at its first split, then kept: a count split
        before gives the same partitions and streams); otherwise the same
        streams under a new recorded ``theta``."""
        if self.split is not None:
            return DualCores(self.device, theta)
        out = copy.copy(self)
        out.asked = out.theta = theta
        return out

    @property
    def sm_split(self) -> bool:
        """True when the two cores run on disjoint SMs."""
        return self.split is not None

    def sms(self, core: str) -> int | None:
        """SMs of core ``"c"`` or ``"p"`` on a split card, else None."""
        return None if self.split is None else self.split.sms(core)

    def capture_stream(self, core: str) -> torch.cuda.Stream | None:
        """The stream graphs of ``core`` are captured on: a second stream
        of the core's green context on a split card (the graph's kernels
        then run on the core's SMs wherever it is replayed), else one side
        stream for both cores; None on the CPU."""
        if self.split is not None:
            return self.split.parts[core].capture
        if self._capture is None and self.on_card:
            self._capture = torch.cuda.Stream(self.device)
        return self._capture

    def synchronize(self) -> None:
        """Block the host until both cores' streams are idle (on a split
        card ``torch.cuda.synchronize()`` does not wait for them)."""
        for s in {id(s): s for s in self.streams.values()
                  if s is not None}.values():
            s.synchronize()

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
        if self.split is not None:
            head = (f"c/p cores are two green contexts on disjoint SMs of "
                    f"one {name}: c {self.sms('c')} SMs, p {self.sms('p')} "
                    f"of {self.split.total}")
            if self.balance is None:
                return (f"{head} (theta {self.asked:.2f} asked, "
                        f"{self.theta:.4f} realised)")
            here = next(p for p in self.balance
                        if p.count == self.sms("c"))
            tried = ", ".join(f"{p.count}" + (" refused" if p.refused
                                               else f" {p.bound:.3f}")
                              for p in self.balance)
            return (f"{head} (c count measured: chains c {here.t_c:.3f} "
                    f"ms, p {here.t_p:.3f} ms at it; the slot bound in ms "
                    f"by count probed: {tried})")
        sms = torch.cuda.get_device_properties(self.device) \
            .multi_processor_count
        return (f"c/p cores are two CUDA streams on one {name}; both "
                f"streams share all {sms} SMs (sm_split=False; "
                f"theta={self.theta:.2f} is recorded, SMs are not split)")


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
# lanes: the static buffers of compiled groups
# --------------------------------------------------------------------------
@dataclasses.dataclass(eq=False)
class Lane:
    """One request's static buffers and the graphs that use them: the
    input ``x``, and for each exec group its graph and the env it leaves
    (the next group's graph reads that env in place)."""

    key: tuple                       # (input shape, dtype)
    x: torch.Tensor                  # the static input group 0 reads
    graphs: list[CountedGraph]       # one per exec group, in chain order
    envs: list[dict]                 # the static env each group leaves
    nbytes: int = 0                  # device memory the capture took
    free_after: torch.cuda.Event | None = None  # last user's final event

    def load(self, x: torch.Tensor) -> dict:
        """Copy ``x`` into the lane on the current stream, behind a
        device-side wait on the previous request's final ready event;
        return group 0's env.  The caller's tensor is only read."""
        if self.free_after is not None:
            torch.cuda.current_stream(self.x.device).wait_event(
                self.free_after)
        self.x.copy_(x)
        return {"h": self.x}


class LanePool:
    """Lanes pooled by key: a :class:`Lane` by input shape and dtype, the
    LM runtime's ``DecodeLane`` by rows and capacity (anything with a
    ``key`` and a ``free_after`` event).  ``acquire`` hands out the free
    lane of the key released longest ago, whose next user waits for its
    ``free_after`` event on the card, or makes a new one with
    ``make(key)`` when every lane of the key is held; ``retire`` takes a
    lane back with the event after which its buffers are free.  Plain
    Python: it never waits.  Making a lane captures graphs, which can wait
    until the card is idle, so the lanes a traffic pattern holds at once
    are made by a warm-up run of that traffic."""

    def __init__(self, make: Callable[[tuple], Lane]):
        self._make = make
        self._free: dict[tuple, deque[Lane]] = {}
        self.lanes: dict[tuple, list[Lane]] = {}   # every lane made, by key

    def acquire(self, key: tuple) -> Lane:
        """The free lane of ``key`` released longest ago, or a new one."""
        free = self._free.get(key)
        if free:
            return free.popleft()
        lane = self._make(key)
        self.lanes.setdefault(key, []).append(lane)
        return lane

    def retire(self, lane: Lane, ready: torch.cuda.Event | None) -> None:
        """Return ``lane``; its next user waits on ``ready`` on the card."""
        lane.free_after = ready
        self._free.setdefault(lane.key, deque()).append(lane)

    @property
    def count(self) -> int:
        """Lanes made, over every key."""
        return sum(len(v) for v in self.lanes.values())


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

    def __call__(self, env: Env, rid: int | None = None) -> Env:
        return self.runner._run_group(self.index, env, rid)


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

    ``theta=None`` (the default) measures the split: a compiled runner on
    a card that makes its own split cores then sizes the c-core from each
    core's measured time, as the paper tunes each core's PE count.  It
    starts at ``START_THETA`` (c 64 SMs, p 68 of an H100); at its first
    lane capture it times the lane's c-groups replayed back to back on the
    c-core's stream and its p-groups on the p-core's, both chains enqueued
    together as a slot enqueues them (one untimed round, then the median
    of ``BALANCE_ROUNDS``), then does the same at the count where the two
    cores' measured SM-time balances
    (:func:`~repro_torch.kernels.green.balanced_count`; ``relocate`` onto
    ``resplit`` cores, a lane captured there).  It stays at the count with
    the lower slot bound (the start on a tie, or where the other count's
    split is refused), holding that count's lane only, and records the
    probes on ``cores.balance``.  Any other failure raises.  The split is
    decided once per runner: every later lane, of this input shape or
    another, is captured there.  An explicit ``theta``, leased ``cores``,
    cores with ``sm_split=False`` or ``one_stream``, ``jit_groups=False``
    and the CPU measure nothing: they keep the split they were given
    (``START_THETA`` for the last two without a ``theta``).

    The plan cache (``kernels/autotune.py``) keys a plan by the SMs of the
    partition a call runs on, so the search times each count with the
    plans the cache holds for it, as it would serve there: a cache tuned
    at one count only favours that count.  Tune the plans at the count a
    runner measures with no cache, which its cores line names
    (``DualCores.describe``): ``python -m repro_torch.kernels.autotune
    --sweep-zoo --c-sms N``.

    ``jit_groups`` (the reference's name and default) runs each exec group
    as one CUDA graph on the card, on a :class:`Lane` the request holds
    (module docstring); ``donate`` (default: on the card) lets a group
    hand on the lane's buffers in place, and without it each group's env is
    cloned out of the lane, so an env a caller holds stays valid.  Neither
    changes anything on the CPU.  ``lanes`` is the :class:`LanePool`, and
    ``capture_s`` the host seconds spent capturing lanes.

    ``spans`` and ``obs`` are the span recorder and the registry the
    runner reports to (``runner.group``, ``runner.clone_out``,
    ``runner.load``, ``runner.capture``, ``runner.balance`` and its
    ``runner.probe``; ``runner_lane_captures_total``,
    ``runner_split_probes_total``, ``runner_split_c_sms``,
    ``runner_se_gates``); disabled until an engine hands the runner its
    own (:meth:`report_plan`).
    """

    def __init__(self, graph: LayerGraph | str, params: Params,
                 schedule: Schedule, *, device: str | torch.device = "cuda",
                 theta: float | None = None, fuse: bool | str = "group",
                 cores: DualCores | None = None, jit_groups: bool = True,
                 donate: bool | None = None):
        self.device = resolve_device(device)
        group_fusion = fuse == "group"
        self.program = build_program(graph,
                                     fuse=bool(fuse) and not group_fusion)
        self.graph = self.program.graph
        self.schedule = schedule
        self.plan = build_exec_plan(self.program, schedule,
                                    group_fusion=group_fusion)
        self.groups = self.plan.groups
        own = cores is None
        if own:
            cores = DualCores(self.device,
                              START_THETA if theta is None else theta)
        self._check_cores(cores)
        self.cores = cores
        # one copy of the parameters, read by both cores
        self._params = {n: {k: v.to(self.device) for k, v in p.items()}
                        for n, p in params.items()}
        on_card = self.device.type == "cuda"
        if on_card:
            torch.cuda.synchronize(self.device)   # params visible to both
        self.jit_groups = jit_groups
        self.donate = on_card if donate is None else donate
        self._compiled = jit_groups and on_card
        # the split is measured once, at the first lane capture
        self._balance = theta is None and own and self._compiled \
            and cores.sm_split
        self.lanes = LanePool(self._new_lane)
        self._warmed: set[tuple] = set()     # input keys run eagerly once
        self.capture_s = 0.0
        self.spans = SpanRecorder()
        self.obs = Registry(enabled=False)

    def report_plan(self) -> None:
        """Set the plan's gauge in ``obs``: ``runner_se_gates``, the SE
        gates (layers named ``*_se_reduce``) each core's exec groups hold,
        labelled by core; absent for a model without SE gates."""
        gates = {core: sum(n.endswith("_se_reduce") for g in self.groups
                           if g.core == core for n in g.layers)
                 for core in ("c", "p")}
        if not any(gates.values()):
            return
        gauge = self.obs.gauge("runner_se_gates", "SE gates the core's "
                               "exec groups hold", "wall")
        for core, n in gates.items():
            gauge.set(n, {"core": core})

    def _check_cores(self, cores: DualCores) -> None:
        if cores.device != self.device:
            raise ValueError(f"cores on {cores.device} cannot run a runner "
                             f"on {self.device}")

    def relocate(self, cores: DualCores) -> None:
        """Rebind the runner onto a re-split pool's cores (the runner's
        half of a REBALANCE).  The parameters stay where they are: one
        copy on the device serves both cores.  When the new cores' split
        is another than the old (another count) the lanes are dropped:
        their graphs' kernels belong to the old partitions, so the next
        request captures new lanes in the new ones (the same split, or none,
        keeps them: their graphs run there).
        Envs in flight keep their ready events and their lanes, which
        finish on the old partitions and are not pooled again."""
        self._check_cores(cores)
        if cores.split is not self.cores.split:
            self.lanes = LanePool(self._new_lane)
        self.cores = cores

    def _eager(self, gi: int, env: Env, at: list | None = None) -> Env:
        """Exec group ``gi``'s steps, one launch each, on the current
        stream; returns the env the next group needs.  ``at[0]`` names
        the step running, when given."""
        env = dict(env)
        for s in self.groups[gi].steps:
            if at is not None:
                at[0] = s.name
            s.fn(self._params, env, None)
        live = self.plan.live_after[gi]
        return {k: v for k, v in env.items() if k in live}

    def _run_group(self, gi: int, env: Env, rid: int | None = None) -> Env:
        """Run exec group ``gi`` on its core, for request ``rid`` (the
        spans' id; None outside an engine).  On CUDA: wait for the env's
        ready event on the core's stream, mark the incoming tensors as used
        there, run the group (its lane's graph, or eagerly), and record the
        new env's ready event.  The last group clones ``"out"`` out of
        the lane and retires the lane behind that event."""
        core = self.groups[gi].core
        stream = self.cores.streams[core]
        if stream is None:
            with self.spans.span("runner.group", rid=rid, group=gi,
                                 core=core, graph=False):
                return self._eager(gi, env)
        env = dict(env)
        ready = env.pop(READY, None)
        lane = env.pop(LANE, None)
        last = gi == len(self.groups) - 1
        with self.spans.span("runner.group", rid=rid, group=gi, core=core,
                             graph=lane is not None), \
                torch.cuda.stream(stream):
            if ready is not None:
                stream.wait_event(ready)
            for v in env.values():
                v.record_stream(stream)
            if lane is None:
                out = self._eager(gi, env)
            else:
                lane.graphs[gi].replay()
                if last:
                    with self.spans.span("runner.clone_out"):
                        out = {k: v.clone() for k, v in lane.envs[gi].items()}
                else:
                    out = {k: v if self.donate else v.clone()
                           for k, v in lane.envs[gi].items()}
            done = torch.cuda.Event()
            done.record(stream)
        if lane is not None:
            if not last:
                out[LANE] = lane
            elif lane in self.lanes.lanes.get(lane.key, ()):
                self.lanes.retire(lane, done)   # not a relocated one
        out[READY] = done
        return out

    # ------------------------------------------------------------------
    # compiled groups
    # ------------------------------------------------------------------
    def _new_lane(self, key: tuple) -> Lane:
        """Capture a lane for inputs of ``key`` (shape, dtype): every
        exec group in chain order, from one new private pool.  The first
        lane of a key first runs the chain eagerly on the cores' streams."""
        with self.spans.span("runner.capture"):
            lane = self._capture_lane(key)
        self.obs.counter("runner_lane_captures_total",
                         "lanes captured (the lane pool grew)",
                         "wall").inc()
        return lane

    def _capture_lane(self, key: tuple) -> Lane:
        shape, dtype = key
        x = torch.zeros(shape, dtype=dtype, device=self.device)
        if key not in self._warmed:
            self._warm(x)
            self._warmed.add(key)
        t0 = time.perf_counter()
        reserved = torch.cuda.memory_reserved(self.device)
        pool = torch.cuda.graph_pool_handle()
        env: Env = {"h": x}
        graphs, envs = [], []
        for gi in range(len(self.groups)):
            graph, env = self._capture(gi, env, pool)
            graphs.append(graph)
            envs.append(env)
        nbytes = (torch.cuda.memory_reserved(self.device) - reserved
                  + x.numel() * x.element_size())
        self.capture_s += time.perf_counter() - t0
        return Lane(key=key, x=x, graphs=graphs, envs=envs, nbytes=nbytes)

    def _balance_split(self, key: tuple) -> None:
        """Move the cores to the c-core count whose measured slot bound is
        lower (the class docstring), a lane of ``key`` captured at each
        count measured; keep that count's cores and its one lane."""
        start = self.cores, self.lanes
        total = self.cores.split.total

        def measure(n: int) -> tuple[float, float] | None:
            with self.spans.span("runner.probe"):
                if n != self.cores.sms("c"):
                    try:
                        cores = self.cores.resplit(n / total)
                    except GreenContextError:
                        return None         # the count's split is refused
                    self.relocate(cores)
                lane = self.lanes.acquire(key)
                times = self._time_chains(lane)
                self.lanes.retire(lane, None)
                return times

        with self.spans.span("runner.balance"):
            count, probes = balanced_count(measure, self.cores.sms("c"),
                                           total)
        if count != self.cores.sms("c"):
            self.cores, self.lanes = start
        self.cores.balance = probes
        self.obs.gauge("runner_split_c_sms", "the c-core's SMs the "
                       "measured split gives", "wall").set(count)
        self.obs.counter("runner_split_probes_total", "counts the split's "
                         "search measured beyond its start",
                         "wall").inc(len(probes) - 1)

    def _time_chains(self, lane: Lane) -> tuple[float, float]:
        """Each core's chain of ``lane``'s graphs, replayed back to back on
        the core's stream, both chains enqueued together round after round
        (a round starts on both when both ended the last); the median ms of
        each core's chain over ``BALANCE_ROUNDS`` timed rounds after one
        untimed.
        The lane's buffers are left holding nothing of use."""
        streams = self.cores.streams
        marks: dict[str, list] = {"c": [], "p": []}
        for _ in range(1 + BALANCE_ROUNDS):
            ends = {c: m[-1][1] for c, m in marks.items() if m}
            for core, other in (("c", "p"), ("p", "c")):
                stream = streams[core]
                with torch.cuda.stream(stream):
                    if other in ends:
                        stream.wait_event(ends[other])
                    t0 = torch.cuda.Event(enable_timing=True)
                    t1 = torch.cuda.Event(enable_timing=True)
                    t0.record(stream)
                    for graph, group in zip(lane.graphs, self.groups):
                        if group.core == core:
                            graph.replay()
                    t1.record(stream)
                marks[core].append((t0, t1))
        self.cores.synchronize()
        return tuple(statistics.median(a.elapsed_time(b) for a, b in m[1:])
                     for m in marks.values())

    def _warm(self, x: torch.Tensor) -> None:
        """Run the chain eagerly once on the cores' streams: it builds the
        library, sets the kernels' attributes, fills the host planners'
        caches and the allocator's pools for the streams."""
        env = self._eager_input(x)
        for gi in range(len(self.groups)):
            env = self._run_group(gi, env)

    def _capture(self, gi: int, env: Env, pool,
                 debug: bool = False) -> tuple[CountedGraph, Env]:
        """Capture exec group ``gi`` reading ``env`` (static tensors) on
        its core's capture stream; raises naming the group and the step
        that broke the capture."""
        at: list[str | None] = [None]

        def body() -> Env:
            out = self._eager(gi, env, at)
            at[0] = None
            return out

        try:
            core = self.groups[gi].core
            return capture_graph(body, stream=self.cores.capture_stream(core),
                                 pool=pool, debug=debug)
        except Exception as err:
            where = (f"in step {at[0]!r}" if at[0] is not None
                     else "at the end of the capture")
            raise RuntimeError(
                f"{self.graph.name}: capturing exec group {gi} "
                f"({self.groups[gi].core}-core) failed {where}: {err}"
            ) from err

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
        first group's core waits on it).  With compiled groups the input
        is copied into a lane the request holds until its last group."""
        with self.spans.span("runner.load"):
            if x.device != self.device:
                x = x.to(self.device)
            if not self._compiled:
                return self._eager_input(x.contiguous())
            key = (tuple(x.shape), x.dtype)
            if self._balance:
                self._balance = False
                self._balance_split(key)
            lane = self.lanes.acquire(key)
            env = lane.load(x)
            env[READY] = self._record_ready()
            env[LANE] = lane
            return env

    def _eager_input(self, x: torch.Tensor) -> Env:
        env: Env = {"h": x}
        if self.cores.on_card:
            env[READY] = self._record_ready()
        return env

    def _record_ready(self) -> torch.cuda.Event:
        ready = torch.cuda.Event()
        ready.record(torch.cuda.current_stream(self.device))
        return ready

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
        materialized before the clock stops).  With reps > 1 the best rep
        excludes the lanes' captures (they land in the first rep)."""
        run = (self.run_pipelined if mode == "pipelined"
               else self.run_sequential)
        outs, best = None, float("inf")
        for _ in range(max(1, reps)):
            t0 = time.perf_counter()
            outs = run(images)
            best = min(best, time.perf_counter() - t0)
        return outs, best
