"""Co-optimisation of the c/p split and the schedule: the paper's §V-B
branch and bound.

Port of ``repro/dualmesh/search.py``.  Branch on theta (the c-share,
Eq.10), bound with the ideal roofline (Eq.11: every stage at its better
core, perfect overlap), and keep the best ``best_schedule`` over the
discrete knobs.  Two plans:

- **on abstract cards** (``n_devices=N``): the reference's semantics.
  Each theta splits N chips (``abstract_split``), every pair of TP
  widths in ``TP_CANDIDATES`` is tried, and each side must hold its
  TP-sharded weights and the workload's KV cache over its chips in
  ``0.75 * mem_bytes``.
- **on the card's SMs** (the default): each theta is the split
  ``split_streams`` would make (``card_split``: ``split_count``'s SMs),
  evaluated at its realised share, TP 1 on each core.  The two cores
  share one memory, so the check counts the weights once and both
  cores' KV caches (``card_memory`` says what it leaves out).  Thetas
  whose split repeats one already evaluated are branched from but not
  evaluated again and not counted as a visit.
  Nothing here makes a green context.

When no split fits, the plan at 0.5 is returned regardless (``relaxed``),
as the reference does.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import torch

from repro_torch.dualmesh.cost import CardModel
from repro_torch.dualmesh.partition import SplitPlan, abstract_split, \
    card_split
from repro_torch.dualmesh.schedule import Stage, best_schedule, stage_cost
from repro_torch.kernels.util import resolve_device
from repro_torch.lm.config import ArchConfig

TP_CANDIDATES = (1, 2, 4, 8, 16)


@dataclasses.dataclass
class DualSearchResult:
    """The best split found and its schedule.  ``tp_c``/``tp_p`` are the
    TP candidates it was found at, as the reference reports them (the
    split's own widths, ``dual.tp_c``/``dual.tp_p``, may be smaller where
    the chips do not divide); ``visited`` lists the thetas evaluated, in
    order; ``sms`` is the card's SM count on a card plan (None on abstract
    cards); ``relaxed`` says no split fitted."""

    dual: SplitPlan
    theta: float
    tp_c: int
    tp_p: int
    makespan: float
    tokens_per_s: float
    schedule: object
    visited: list[float]
    n_streams: int = 2
    sms: int | None = None
    relaxed: bool = False


def card_model(device: str | torch.device = "cuda",
               hw: CardModel = CardModel()) -> CardModel:
    """``hw`` with the memory size and SM count of ``device`` when it is a
    card (``torch.cuda.get_device_properties``); unchanged on the CPU."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        return hw
    props = torch.cuda.get_device_properties(dev)
    return dataclasses.replace(hw, mem_bytes=props.total_memory,
                               sm_count=props.multi_processor_count)


def kv_bytes(stages: Sequence[Stage], cfg: ArchConfig, hw: CardModel,
             chips: int = 1) -> float:
    """The KV cache of the workload's decode stages over ``chips``."""
    kv = 0.0
    for s in stages:
        if s.kind == "decode" and cfg.block_type == "transformer":
            kv += (2.0 * cfg.n_layers * s.batch * cfg.n_kv_heads
                   * cfg.d_head * s.seq * hw.elem_bytes) / max(1, chips)
    return kv


def card_memory(stages: Sequence[Stage], cfg: ArchConfig,
                hw: CardModel) -> dict:
    """The card plan's memory check: one copy of the weights and both
    cores' KV caches of the workload's decode stages, against ``0.75 *
    mem_bytes``.  It prices the plan, not the run: like the reference's
    check, it takes one request's KV at the prompt length and leaves out
    the ``n_streams`` requests in flight, the fused decode groups' lanes
    at their full length and the prefill logits, which the 0.25 of
    headroom must hold."""
    weights = float(hw.elem_bytes) * cfg.param_count()
    kv = 2 * kv_bytes(stages, cfg, hw)
    limit = 0.75 * hw.mem_bytes
    return dict(weights=weights, kv=kv, limit=limit,
                margin=limit - weights - kv)


def makespan_lower_bound(stages: Sequence[Stage], cfg: ArchConfig,
                         n_devices: int, theta: float, hw: CardModel,
                         on_card: bool = False) -> float:
    """Eq.11 analogue: each stage at the ideal rate of its better side,
    perfect overlap across the two.  On ``n_devices`` abstract cards each
    side at TP ``min(16, chips)``, as the reference bounds it; on a card of
    ``n_devices`` SMs (``on_card``) each core at its share of the split
    ``card_split`` makes."""
    if on_card:
        plan = card_split(theta, n_devices)
        sides = [(1, 1, hw.share(plan.c_share)),
                 (1, 1, hw.share(plan.p_share))]
    else:
        n_c = max(1, round(theta * n_devices))
        n_p = max(1, n_devices - n_c)
        sides = [(n_c, min(16, n_c), hw), (n_p, min(16, n_p), hw)]
    t_c = t_p = 0.0
    for s in stages:
        cost_c, cost_p = (stage_cost(s, cfg, chips, tp, side_hw)
                          for chips, tp, side_hw in sides)
        if cost_c <= cost_p:
            t_c += cost_c
        else:
            t_p += cost_p
    return max(t_c, t_p)      # perfect pipeline: the busier side bounds


def search(stages: Sequence[Stage], cfg: ArchConfig,
           n_devices: int | None = None, hw: CardModel = CardModel(),
           max_evals: int = 16, n_streams: int = 2) -> DualSearchResult:
    """Plan on ``n_devices`` abstract cards, or, without it, on the
    ``hw.sm_count`` SMs of one card (``card_model`` gives the card in
    hand's).  ``n_streams`` is the number of concurrent staggered request
    streams the schedule is optimized for."""
    on_card = n_devices is None
    n = hw.sm_count if on_card else n_devices
    incumbent: DualSearchResult | None = None
    visited: list[float] = []
    seen: set[int] = set()

    def fits(tp: int, chips: int) -> bool:
        """Per abstract card: TP-sharded weights + the workload's KV."""
        w = float(hw.elem_bytes) * cfg.param_count() / max(1, tp)
        return w + kv_bytes(stages, cfg, hw, chips) <= 0.75 * hw.mem_bytes

    def evaluate(theta: float, relax: bool = False) -> None:
        nonlocal incumbent
        if on_card:
            plan = card_split(theta, n)
            if plan.c_sms in seen and not relax:
                return                    # the same split: not a new visit
            seen.add(plan.c_sms)
            pairs = [(1, 1)]
            ok = card_memory(stages, cfg, hw)["margin"] >= 0
        else:
            pairs = [(tc, tp) for tc in TP_CANDIDATES for tp in TP_CANDIDATES
                     if tc <= n and tp <= n]
        visited.append(theta)
        for tp_c, tp_p in pairs:
            if not on_card:
                plan = abstract_split(n, theta, tp_c, tp_p)
                ok = fits(tp_c, plan.c_chips) and fits(tp_p, plan.p_chips)
            if not relax and not ok:
                continue
            sched = best_schedule(stages, cfg, plan, hw,
                                  n_streams=n_streams)
            ms = sched.makespan()
            if incumbent is None or ms < incumbent.makespan:
                incumbent = DualSearchResult(
                    dual=plan, theta=plan.theta, tp_c=tp_c, tp_p=tp_p,
                    makespan=ms,
                    tokens_per_s=sched.throughput_tokens_per_s(),
                    schedule=sched, visited=visited, n_streams=n_streams,
                    sms=n if on_card else None, relaxed=relax)

    evaluate(0.5)
    work = [(0.1, 0.9)]
    while work and len(visited) < max_evals:
        lo, hi = work.pop(0)
        if hi - lo < 0.08:
            continue
        mid = 0.5 * (lo + hi)
        # admissible at any n_streams: the N-stream makespan is bounded
        # below by one chain's busy time
        lb = makespan_lower_bound(stages, cfg, n, mid, hw, on_card)
        if incumbent is not None and lb >= incumbent.makespan:
            continue                      # prune (early termination, §V-B2)
        evaluate(mid)
        work += [(lo, mid), (mid, hi)]
    if incumbent is None:
        # nothing fits: the best-effort plan at 0.5, for the caller to see
        evaluate(0.5, relax=True)
    assert incumbent is not None
    incumbent.visited = visited
    return incumbent
