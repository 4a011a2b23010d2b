"""Interleaved N-stream scheduling for LM serving, and makespan-aware
admission.

Port of ``repro/dualmesh/schedule.py``: the paper's §V algorithms
re-targeted from a CNN's layer graph to a request's stage chain
(prefill -> decode) and generalized from the two-image interleave to N
concurrent request streams.  ``DualSchedule.makespan`` runs the
reference's greedy FIFO simulation: each core serves one group at a
time, stream j's group i becomes ready when its group i-1 completes, and
the earliest-startable ready group is dispatched next (ties by ready
time, then stream order); for N = 2 it equals the paper's corrected
T_b2 closed form.  ``build`` seeds an allocation (stage type, greedy,
round robin), ``load_balance`` is Alg.1's largest-gap split along a
prefill's sequence or a decode's steps, and ``best_schedule`` keeps the
shortest.  ``plan_admission`` picks the decode fusion width the runtime
serves with: prefills serialize on the c-core while decode groups of
``group_size`` fused streams run batched on the p-core.

Where the reference prices a submesh by its chips and TP width, each core
here is priced by the split's chips and TP width and by its share of the
card's SMs (``CardModel.share``): a ``DualStreams`` the runtime serves on,
or a planner-only ``SplitPlan`` (``partition.py``).  At share 1 every
number is the reference's.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

from repro_torch.dualmesh.cost import CardModel, decode_cost, prefill_cost
from repro_torch.lm.config import ArchConfig

ALLOCATIONS = ("stage_type", "greedy", "round_robin")


@dataclasses.dataclass(frozen=True)
class Stage:
    """One schedulable unit of a request batch."""

    kind: str                 # 'prefill' | 'decode'
    batch: int
    seq: int                  # prefill: tokens to process; decode: kv_len
    steps: int = 1            # decode steps in this stage

    @property
    def tokens(self) -> int:
        """Tokens this stage processes (prefill) or emits (decode)."""
        return self.batch * (self.seq if self.kind == "prefill"
                             else self.steps)

    def split_seq(self, left: int) -> tuple["Stage", "Stage"]:
        """A prefill cut after ``left`` tokens (chunked prefill)."""
        assert self.kind == "prefill" and 0 < left < self.seq
        return (dataclasses.replace(self, seq=left),
                dataclasses.replace(self, seq=self.seq - left))

    def split_steps(self, left: int) -> tuple["Stage", "Stage"]:
        """A decode cut after ``left`` steps."""
        assert self.kind == "decode" and 0 < left < self.steps
        return (dataclasses.replace(self, steps=left),
                dataclasses.replace(self, steps=self.steps - left))


def stage_cost(st: Stage, cfg: ArchConfig, chips: int, tp: int,
               hw: CardModel) -> float:
    """Latency of ``st`` on ``chips`` devices of TP ``tp`` as ``hw``."""
    if st.kind == "prefill":
        return prefill_cost(cfg, st.batch, st.seq, chips, hw, tp).latency
    return decode_cost(cfg, st.batch, st.seq, chips, st.steps, hw,
                       tp).latency


def core_cost(st: Stage, cfg: ArchConfig, dual, core: str,
              hw: CardModel) -> float:
    """Latency of ``st`` on core ``"c"`` or ``"p"`` of the split ``dual``:
    its chips and TP width, the card at the core's SM share."""
    if core == "c":
        return stage_cost(st, cfg, dual.c_chips, dual.tp_c,
                          hw.share(dual.c_share))
    return stage_cost(st, cfg, dual.p_chips, dual.tp_p,
                      hw.share(dual.p_share))


@dataclasses.dataclass
class MeshGroup:
    """Consecutive stages on one core."""

    mesh: str                 # 'c' | 'p'
    stages: list[Stage]

    def latency(self, cfg: ArchConfig, dual, hw: CardModel) -> float:
        """The group's stages one after another on its core."""
        return sum(core_cost(s, cfg, dual, self.mesh, hw)
                   for s in self.stages)


@dataclasses.dataclass
class DualSchedule:
    """A stage chain allocated to the two cores, run by ``n_streams``
    identical staggered streams."""

    groups: list[MeshGroup]
    cfg: ArchConfig
    dual: object              # DualStreams or SplitPlan
    hw: CardModel
    scheme: str = "custom"
    n_streams: int = 2

    def latencies(self) -> list[float]:
        """Each group's latency on its core."""
        return [g.latency(self.cfg, self.dual, self.hw)
                for g in self.groups]

    def makespan(self, n_streams: int | None = None) -> float:
        """N-stream staggered makespan: greedy FIFO simulation with each
        core serving one group at a time (module docstring)."""
        n = self.n_streams if n_streams is None else n_streams
        t = self.latencies()
        if not t or n < 1:
            return 0.0
        meshes = [g.mesh for g in self.groups]
        free: dict[str, float] = {}
        nxt = [0] * n                  # next group index per stream
        prev_done = [0.0] * n          # completion of the stream's last group
        for _ in range(n * len(t)):
            best = None
            for j in range(n):
                i = nxt[j]
                if i == len(t):
                    continue
                ready = prev_done[j]
                start = max(ready, free.get(meshes[i], 0.0))
                key = (start, ready, j)
                if best is None or key < best[0]:
                    best = (key, j, i, start)
            _, j, i, start = best
            end = start + t[i]
            free[meshes[i]] = end
            prev_done[j] = end
            nxt[j] += 1
        return max(prev_done)

    def stream_tokens(self) -> int:
        """Tokens one stream processes and emits over the whole chain."""
        return sum(s.tokens for g in self.groups for s in g.stages)

    def total_tokens(self, n_streams: int | None = None) -> int:
        """Tokens of all the streams."""
        n = self.n_streams if n_streams is None else n_streams
        return n * self.stream_tokens()

    def throughput_tokens_per_s(self, n_streams: int | None = None
                                ) -> float:
        """Every stream's prompt and emitted tokens over the N-stream
        makespan, as the runtime counts them."""
        span = self.makespan(n_streams)
        toks = self.total_tokens(n_streams)
        return toks / span if span else float("inf")


def request_stages(cfg: ArchConfig, prompts: Sequence[tuple[int, int, int]]
                   ) -> list[Stage]:
    """prompts: (batch, prompt_len, gen_len) per request group ->
    alternating prefill/decode stage chain (the 'layer graph')."""
    out = []
    for batch, plen, glen in prompts:
        out.append(Stage("prefill", batch, plen))
        out.append(Stage("decode", batch, plen, steps=glen))
    return out


def allocate(stages: list[Stage], cfg: ArchConfig, dual, hw: CardModel,
             scheme: str) -> list[str]:
    """The core of each stage under ``scheme`` (one of ``ALLOCATIONS``)."""
    if scheme == "stage_type":     # layer-type analogue
        return ["c" if s.kind == "prefill" else "p" for s in stages]
    if scheme == "round_robin":
        return ["c" if i % 2 == 0 else "p" for i in range(len(stages))]
    if scheme == "greedy":
        return ["c" if core_cost(s, cfg, dual, "c", hw)
                <= core_cost(s, cfg, dual, "p", hw) else "p"
                for s in stages]
    raise ValueError(scheme)


def build(stages, cfg: ArchConfig, dual, hw: CardModel, scheme: str,
          n_streams: int = 2) -> DualSchedule:
    """Consecutive stages of one core merged into groups."""
    groups: list[MeshGroup] = []
    for s, m in zip(stages, allocate(stages, cfg, dual, hw, scheme)):
        if groups and groups[-1].mesh == m:
            groups[-1].stages.append(s)
        else:
            groups.append(MeshGroup(m, [s]))
    return DualSchedule(groups, cfg, dual, hw, scheme, n_streams)


def load_balance(sched: DualSchedule, rounds: int = 32) -> DualSchedule:
    """Alg.1 analogue: split the boundary stage of the worst-gap pair along
    its sequence (prefill) or steps (decode) and move the remainder to the
    neighbouring group on the other core.  Optimizes the schedule's own
    N-stream makespan, so the split point shifts with N."""
    s = DualSchedule([MeshGroup(g.mesh, list(g.stages))
                      for g in sched.groups], sched.cfg, sched.dual,
                     sched.hw, sched.scheme + "+lb", sched.n_streams)
    best = s.makespan()
    for _ in range(rounds):
        t = s.latencies()
        if len(t) < 2:
            break
        pairs = sorted(range(len(t) - 1), key=lambda i: -abs(t[i] - t[i + 1]))
        improved = False
        for pi in pairs:
            longer, shorter = (pi, pi + 1) if t[pi] > t[pi + 1] \
                else (pi + 1, pi)
            val = _try_split(s, longer, shorter, best)
            if val is not None and val < best - 1e-12:
                best = val
                improved = True
                break
        if not improved:
            break
    return s


def _try_split(s: DualSchedule, longer: int, shorter: int,
               best: float) -> float | None:
    """Move the best cut of the boundary stage of group ``longer`` into
    its neighbour ``shorter``, in place, if some cut beats ``best``;
    returns the new makespan or None."""
    gl = s.groups[longer]
    if not gl.stages:
        return None
    tail = longer < shorter
    st = gl.stages[-1] if tail else gl.stages[0]
    axis = st.seq if st.kind == "prefill" else st.steps
    if axis < 2:
        return None
    best_cut, best_val = None, best
    step = max(1, axis // 16)
    for cut in range(step, axis, step):
        a, b = (st.split_seq(cut) if st.kind == "prefill"
                else st.split_steps(cut))
        keep, move = (a, b) if tail else (b, a)
        trial = [MeshGroup(g.mesh, list(g.stages)) for g in s.groups]
        if tail:
            trial[longer].stages[-1] = keep
            trial[shorter].stages.insert(0, move)
        else:
            trial[longer].stages[0] = keep
            trial[shorter].stages.append(move)
        val = DualSchedule(trial, s.cfg, s.dual, s.hw,
                           n_streams=s.n_streams).makespan()
        if val < best_val:
            best_val, best_cut = val, cut
    if best_cut is None:
        return None
    a, b = (st.split_seq(best_cut) if st.kind == "prefill"
            else st.split_steps(best_cut))
    keep, move = (a, b) if tail else (b, a)
    if tail:
        gl.stages[-1] = keep
        s.groups[shorter].stages.insert(0, move)
    else:
        gl.stages[0] = keep
        s.groups[shorter].stages.append(move)
    return best_val


def best_schedule(stages, cfg: ArchConfig, dual,
                  hw: CardModel = CardModel(),
                  with_load_balance: bool = True,
                  n_streams: int = 2) -> DualSchedule:
    """The shortest of the three allocations, each also load-balanced."""
    cands = []
    for scheme in ALLOCATIONS:
        b = build(stages, cfg, dual, hw, scheme, n_streams)
        cands.append(b)
        if with_load_balance:
            cands.append(load_balance(b))
    return min(cands, key=lambda x: x.makespan())


# ==========================================================================
# Makespan-aware admission (the runtime's continuous-batching policy)
# ==========================================================================
@dataclasses.dataclass(frozen=True)
class AdmissionPlan:
    """Decode-fusion policy for a homogeneous request queue: admit new
    streams whenever the c-core is idle; launch a fused decode group as
    soon as ``group_size`` streams are prefilled (or the queue drains)."""

    n_streams: int
    group_size: int
    est_makespan: float
    est_tokens_per_s: float


def wave_makespan(cfg: ArchConfig, dual, hw: CardModel,
                  batch: int, prompt_len: int, gen_steps: int,
                  n_streams: int, group_size: int) -> float:
    """Projected makespan of the wave-fused execution: prefills serialize
    on the c-core (one stream per wave slot); each decode group of
    ``group_size`` streams runs batched (batch*size) on the p-core and can
    only launch once its last member has prefilled.  Each core is priced
    at its share of the card (``CardModel.share``), as the reference
    prices each submesh at its chips."""
    hw_c, hw_p = hw.share(dual.c_share), hw.share(dual.p_share)
    t_pf = prefill_cost(cfg, batch, prompt_len, dual.c_chips, hw_c,
                        dual.tp_c).latency
    p_free = 0.0
    admitted = 0
    while admitted < n_streams:
        size = min(group_size, n_streams - admitted)
        admitted += size
        prefill_done = admitted * t_pf          # c-core serialized
        t_dec = decode_cost(cfg, batch * size, prompt_len + gen_steps,
                            dual.p_chips, gen_steps, hw_p,
                            dual.tp_p).latency
        p_free = max(p_free, prefill_done) + t_dec
    return p_free


def plan_admission(cfg: ArchConfig, dual, hw: CardModel,
                   batch: int, prompt_len: int, gen_steps: int,
                   n_streams: int,
                   max_group: int | None = None) -> AdmissionPlan:
    """Pick the decode fusion size minimizing projected makespan.

    Small groups maximize prefill/decode overlap (a group launches early);
    large groups amortize the per-step decode floor over a bigger fused
    batch.  The argmin trades the two."""
    hi = min(n_streams, max_group or n_streams)
    best: AdmissionPlan | None = None
    toks = n_streams * batch * (prompt_len + gen_steps)
    for g in range(1, max(1, hi) + 1):
        span = wave_makespan(cfg, dual, hw, batch, prompt_len, gen_steps,
                             n_streams, g)
        if best is None or span < best.est_makespan - 1e-12:
            best = AdmissionPlan(n_streams, g, span,
                                 toks / span if span else float("inf"))
    assert best is not None
    return best
