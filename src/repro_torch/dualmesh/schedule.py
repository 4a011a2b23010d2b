"""Makespan-aware admission planning for LM serving.

Port of the ``plan_admission`` / ``wave_makespan`` part of
``repro/dualmesh/schedule.py``: prefills serialize on the c-core while
decode groups of ``group_size`` fused streams run batched on the p-core;
the planner picks the fusion width minimizing the projected makespan of
the whole request queue.  The Alg.1-style ``build`` / ``load_balance``
and the search are not ported yet (ROADMAP).
"""
from __future__ import annotations

import dataclasses

from repro_torch.dualmesh.cost import CardModel, decode_cost, prefill_cost
from repro_torch.dualmesh.partition import DualStreams
from repro_torch.lm.config import ArchConfig


@dataclasses.dataclass(frozen=True)
class AdmissionPlan:
    """Decode-fusion policy for a homogeneous request queue: admit new
    streams whenever the c-core is idle; launch a fused decode group as
    soon as ``group_size`` streams are prefilled (or the queue drains)."""

    n_streams: int
    group_size: int
    est_makespan: float
    est_tokens_per_s: float


def wave_makespan(cfg: ArchConfig, dual: DualStreams, hw: CardModel,
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


def plan_admission(cfg: ArchConfig, dual: DualStreams, hw: CardModel,
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
