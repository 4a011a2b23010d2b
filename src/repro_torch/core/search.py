"""Co-optimization of PE allocation and scheduling (paper §V-B).

Branch-and-bound over the c-core DSP ratio theta (Eq.10), with the Eq.11
compute lower bound, followed by an exhaustive local search over
(n_c, v_c, n_p, v_p) with v in V_CANDIDATES, all under the ResourceBudget
constraints (Table II).

The objective is pluggable:
  * single CNN  -> minimize two-batch latency T_b2 (maximize fps),
  * multi-CNN   -> maximize the harmonic mean of per-model fps (Table VII),
  * fleet mix   -> maximize the *weighted* harmonic mean under a
    {model: qps share} traffic mix (``weights=``) — the steady-state
    aggregate fps of time-multiplexing the networks in those proportions
    (``repro_torch.fleet.planner`` drives this).

Copy of ``repro/core/search.py`` (the port imports nothing of ``repro``).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Sequence

from repro_torch.core.arch import (ALPHA, V_CANDIDATES, BoardModel,
                                   CoreConfig, DualCoreConfig,
                                   ResourceBudget)
from repro_torch.core.area import dual_core_area
from repro_torch.core.graph import LayerGraph
from repro_torch.core.latency import compute_lower_bound, load_cycles
from repro_torch.core.scheduler import ALLOCATION_SCHEMES, best_schedule


@dataclasses.dataclass
class SearchResult:
    config: DualCoreConfig
    theta: float
    fps: dict[str, float]             # per-model throughput
    objective: float                  # harmonic-mean fps (higher is better)
    schedules: dict[str, object]
    visited_thetas: list[float]


def harmonic_mean(xs: Sequence[float],
                  weights: Sequence[float] | None = None) -> float:
    """Harmonic mean of ``xs``; with ``weights`` the weighted form
    ``sum(w) / sum(w/x)``.  For per-model fps under a traffic mix this IS
    the aggregate fps of serving the models in those proportions — model m
    takes ``w_m / fps_m`` of each unit of mixed work."""
    xs = list(xs)
    if not xs or any(x <= 0 for x in xs):
        return 0.0
    if weights is None:
        return len(xs) / sum(1.0 / x for x in xs)
    if len(weights) != len(xs):
        raise ValueError(f"{len(xs)} values but {len(weights)} weights")
    if any(w < 0 for w in weights) or not sum(weights) > 0:
        raise ValueError(f"weights must be >= 0 with a positive sum "
                         f"(got {list(weights)})")
    return sum(weights) / sum(w / x for w, x in zip(weights, xs))


# --------------------------------------------------------------------------
# Lower bound at a given theta (Eq.11)
# --------------------------------------------------------------------------
def t_b2_lower_bound(graph: LayerGraph, theta: float, dsp_budget: int,
                     board: BoardModel) -> float:
    """Lower bound of T_b2 at DSP split theta: every layer runs at the ideal
    MAC rate of its (best-case) core, still bounded below by its load time.

    The bound relaxes tiling mismatch (Eq.11) and group structure: the best
    possible T_b2 is 2x the larger of the two per-core workload sums when
    perfectly balanced, >= sum over layers of per-layer lower bounds spread
    over both cores.  We use the paper's per-sch bound: evaluate Eq.9 with
    T_compute replaced by Eq.11 under each allocation scheme and take the
    minimum — a valid lower bound for the schedules the flow can emit."""
    dsp_c = theta * dsp_budget
    dsp_p = (1.0 - theta) * dsp_budget
    best = math.inf
    layers = graph.topological_order()
    for scheme in ALLOCATION_SCHEMES:
        if scheme == "layer_type":
            assign = ["p" if l.op == "dwconv" else "c" for l in layers]
        elif scheme == "round_robin":
            assign = ["c" if i % 2 == 0 else "p" for i in range(len(layers))]
        else:  # greedy on the lower bounds themselves
            assign = []
            for l in layers:
                tc = max(compute_lower_bound(l, dsp_c, board),
                         load_cycles(l, board))
                tp = max(compute_lower_bound(l, dsp_p, board),
                         load_cycles(l, board))
                assign.append("c" if tc <= tp else "p")
        # group merge + Eq.9 on lower-bound latencies
        t: list[float] = []
        cur_core = None
        for l, a in zip(layers, assign):
            dsp = dsp_c if a == "c" else dsp_p
            lat = max(compute_lower_bound(l, dsp, board),
                      load_cycles(l, board))
            if a == cur_core:
                t[-1] += lat
            else:
                t.append(lat)
                cur_core = a
        if not t:
            continue
        tb2 = t[0] + sum(max(t[i], t[i - 1])
                         for i in range(1, len(t))) + t[-1]
        best = min(best, tb2)
    return best


def objective_lower_bound(graphs: Sequence[LayerGraph], theta: float,
                          dsp_budget: int, board: BoardModel,
                          weights: Sequence[float] | None = None) -> float:
    """Upper bound on achievable (weighted-)harmonic-mean fps at this theta
    (from the T_b2 lower bounds) — valid for pruning because the weighted
    harmonic mean is monotone in every per-model fps."""
    fps = []
    for g in graphs:
        lb = t_b2_lower_bound(g, theta, dsp_budget, board)
        fps.append(2 * board.freq_mhz * 1e6 / lb if lb > 0 else math.inf)
    return harmonic_mean(fps, weights)


# --------------------------------------------------------------------------
# Local search: (n_c, v_c, n_p, v_p) at a fixed theta
# --------------------------------------------------------------------------
def configs_at_theta(theta: float, budget: ResourceBudget,
                     slack: float = 0.08) -> list[DualCoreConfig]:
    """Enumerate (n_c,v_c,n_p,v_p) whose DSP split is within ``slack`` of
    theta and which fit the full resource budget."""
    out = []
    dsp_budget = budget.n_dsp
    for v_c in V_CANDIDATES:
        n_c = int(theta * ALPHA * dsp_budget / v_c)
        n_c -= n_c % 2                      # PE pairs share DSP macros
        if n_c < 2:
            continue
        dsp_c = (n_c // 2) * v_c
        for v_p in V_CANDIDATES:
            n_p = int((dsp_budget - dsp_c - 1) * ALPHA / v_p)
            n_p -= n_p % 2
            if n_p < 2:
                continue
            cfg = DualCoreConfig(CoreConfig("c", n_c, v_c),
                                 CoreConfig("p", n_p, v_p))
            area = dual_core_area(cfg)
            if not budget.fits(area.dsp, area.bram18k, area.lut, area.ff):
                # back off p-core size until it fits (greedy allocation of
                # leftover resources, §V-B2)
                while n_p > 2:
                    n_p -= 2
                    cfg = DualCoreConfig(CoreConfig("c", n_c, v_c),
                                         CoreConfig("p", n_p, v_p))
                    area = dual_core_area(cfg)
                    if budget.fits(area.dsp, area.bram18k, area.lut, area.ff):
                        break
                else:
                    continue
                if not budget.fits(area.dsp, area.bram18k,
                                   area.lut, area.ff):
                    continue
            if abs(cfg.theta(dsp_budget) - theta) <= slack:
                out.append(cfg)
    return out


def evaluate_config(cfg: DualCoreConfig, graphs: Sequence[LayerGraph],
                    board: BoardModel,
                    with_load_balance: bool = True,
                    weights: Sequence[float] | None = None):
    fps, scheds = {}, {}
    for g in graphs:
        s = best_schedule(g, cfg, board, with_load_balance=with_load_balance)
        scheds[g.name] = s
        fps[g.name] = s.throughput_fps()
    return harmonic_mean(list(fps.values()), weights), fps, scheds


# --------------------------------------------------------------------------
# Branch-and-bound over theta (§V-B2)
# --------------------------------------------------------------------------
def search(graphs: Sequence[LayerGraph], board: BoardModel,
           budget: ResourceBudget | None = None,
           theta0: float = 0.5, min_interval: float = 0.04,
           max_evals: int = 24,
           with_load_balance: bool = True,
           weights: Sequence[float] | None = None) -> SearchResult:
    """Branch on theta starting at 0.5, bound with Eq.11, then local-search
    (n,v) pairs at promising thetas.  Early termination when an interval's
    bound cannot beat the incumbent (paper §V-B2).  ``weights`` (aligned
    with ``graphs``) switches the objective to the weighted harmonic mean —
    the fleet planner's aggregate-fps-under-a-traffic-mix objective."""
    budget = budget or ResourceBudget()
    incumbent: tuple[float, DualCoreConfig, dict, dict] | None = None
    visited: list[float] = []
    evals = 0

    def consider(theta: float):
        nonlocal incumbent, evals
        visited.append(theta)
        for cfg in configs_at_theta(theta, budget):
            if evals >= max_evals * 4:
                return
            evals += 1
            obj, fps, scheds = evaluate_config(cfg, graphs, board,
                                               with_load_balance, weights)
            if incumbent is None or obj > incumbent[0]:
                incumbent = (obj, cfg, fps, scheds)

    # Interval worklist: (lo, hi).  Evaluate midpoint, prune by bound.
    work = [(0.05, 0.95)]
    consider(theta0)
    while work and len(visited) < max_evals:
        lo, hi = work.pop(0)
        if hi - lo < min_interval:
            continue
        mid = 0.5 * (lo + hi)
        ub = objective_lower_bound(graphs, mid, budget.n_dsp, board, weights)
        # ub is the *best possible* fps at mid; prune if it can't beat
        # the incumbent (early termination).
        if incumbent is not None and ub <= incumbent[0]:
            continue
        consider(mid)
        work.append((lo, mid))
        work.append((mid, hi))

    if incumbent is None:
        raise RuntimeError("search found no feasible configuration")
    obj, cfg, fps, scheds = incumbent
    return SearchResult(config=cfg, theta=cfg.theta(budget.n_dsp),
                        fps=fps, objective=obj, schedules=scheds,
                        visited_thetas=visited)
