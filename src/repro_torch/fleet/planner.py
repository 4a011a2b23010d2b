"""Static co-scheduling planner for a multi-network traffic mix.

The paper's Table VII picks ONE PE configuration that serves a workload of
several networks well (its multi-CNN column beats the best single-CNN
config by ~2% on average throughput).  :func:`plan_fleet` reproduces that
flow for an arbitrary ``{model: qps share}`` mix by reusing the §V-B
design-space search (``core.search.search``) with the weighted-harmonic
objective: if model *m* is an ``s_m`` share of the request stream and runs
at ``fps_m`` when its groups occupy the cores, the steady-state aggregate
of time-multiplexing the networks is

    aggregate_fps = 1 / sum_m (s_m / fps_m)        (weighted harmonic mean)

— each unit of mixed work spends ``s_m / fps_m`` seconds in model *m*.
The unweighted case is exactly the paper's Table VII objective.  The
search picks theta (Eq.10) and the (n, v) PE shapes once for the whole
mix; per-model group merging falls out of ``best_schedule`` under that
shared config, and the resulting per-model ``Schedule``s are what
``fleet.engine.build_cnn_fleet`` executes.

:func:`plan_rows` renders the plan as the Table-VII-style
predicted-vs-measured rows: the prediction is the modelled FPGA's fps,
the measurement whatever served fps the caller passes (``serve fleet
--plan`` and ``chip_smoke.py`` pass the card's).

Copy of ``repro/fleet/planner.py`` (the port imports nothing of ``repro``).
"""
from __future__ import annotations

import dataclasses
from typing import Mapping

from repro_torch.core.arch import (BoardModel, DualCoreConfig,
                                   ResourceBudget)
from repro_torch.core.search import evaluate_config, harmonic_mean, search
from repro_torch.models.zoo import get_graph


@dataclasses.dataclass
class FleetPlan:
    """Output of the co-scheduling search for one traffic mix."""

    mix: dict[str, float]            # normalized qps shares, sum == 1
    config: DualCoreConfig           # shared PE configuration
    theta: float                     # its Eq.10 DSP split
    schedules: dict[str, object]     # per-model Schedule under config
    fps: dict[str, float]            # per-model fps while its groups run
    aggregate_fps: float             # weighted-harmonic aggregate
    predicted: dict[str, float]      # per-model *served* fps under the mix

    def summary(self) -> dict:
        # key is predicted_aggregate_fps, NOT aggregate_fps: this is a
        # deterministic cycle-domain prediction, not a measurement
        """JSON-ready summary of the planned config."""
        return {"mix": {m: round(s, 4) for m, s in self.mix.items()},
                "config": str(self.config),
                "theta": round(self.theta, 4),
                "model_fps": {m: round(f, 2) for m, f in self.fps.items()},
                "predicted_fps": {m: round(f, 2)
                                  for m, f in self.predicted.items()},
                "predicted_aggregate_fps": round(self.aggregate_fps, 2)}


def normalize_mix(mix: Mapping[str, float]) -> dict[str, float]:
    """Normalize qps shares to sum 1; all shares must be positive (a model
    with zero traffic does not belong in the mix)."""
    if not mix:
        raise ValueError("empty traffic mix")
    if any(s <= 0 for s in mix.values()):
        raise ValueError(f"mix shares must be > 0 (got {dict(mix)}); drop "
                         f"zero-traffic models from the mix instead")
    total = float(sum(mix.values()))
    return {m: s / total for m, s in mix.items()}


def mix_schedule(mix: Mapping[str, float], n: int) -> list[str]:
    """Deterministic model-tag sequence of length ``n`` realizing the mix:
    at every position the model with the largest deficit (entitled count
    so far minus issued count) goes next — the same largest-deficit rule
    the weighted-fair step scheduler uses, so a replayed trace exercises
    the mix evenly instead of in model-sized bursts."""
    shares = normalize_mix(mix)
    counts = dict.fromkeys(shares, 0)
    out = []
    for i in range(n):
        m = max(shares, key=lambda k: (shares[k] * (i + 1) - counts[k],
                                       shares[k]))
        counts[m] += 1
        out.append(m)
    return out


def plan_fleet(mix: Mapping[str, float], *,
               board: BoardModel | None = None,
               budget: ResourceBudget | None = None,
               config: DualCoreConfig | None = None,
               max_evals: int = 8,
               with_load_balance: bool = True) -> FleetPlan:
    """Co-schedule the mix: pick (or evaluate) a shared PE config and the
    per-model schedules that maximize aggregate fps under the mix.

    With ``config`` given, skip the theta/(n,v) search and just schedule
    every model under it (the cheap path tests and the Table-VII
    cross-check use); otherwise run the §V-B branch-and-bound with the
    mix-weighted objective.
    """
    board = board or BoardModel()
    shares = normalize_mix(mix)
    models = list(shares)
    graphs = [get_graph(m) for m in models]
    weights = [shares[m] for m in models]
    if config is None:
        res = search(graphs, board, budget, max_evals=max_evals,
                     with_load_balance=with_load_balance, weights=weights)
        config, fps, schedules = res.config, res.fps, res.schedules
        aggregate = res.objective
    else:
        aggregate, fps, schedules = evaluate_config(
            config, graphs, board, with_load_balance, weights)
    predicted = {m: shares[m] * aggregate for m in models}
    return FleetPlan(mix=shares, config=config,
                     theta=config.theta(
                         (budget or ResourceBudget()).n_dsp),
                     schedules=schedules, fps=fps,
                     aggregate_fps=aggregate, predicted=predicted)


def plan_rows(plan: FleetPlan,
              measured: Mapping[str, float] | None = None,
              measured_aggregate: float | None = None
              ) -> list[tuple[str, float, float, float, float | None]]:
    """Table-VII-style rows: (model, share, model fps, predicted served
    fps, measured served fps) plus a final ``("aggregate", ...)`` row.
    ``measured`` maps model -> measured served fps (``None`` entries
    where nothing was measured)."""
    rows: list[tuple[str, float, float, float, float | None]] = []
    for m in plan.mix:
        rows.append((m, plan.mix[m], plan.fps[m], plan.predicted[m],
                     (measured or {}).get(m)))
    rows.append(("aggregate", 1.0,
                 harmonic_mean([plan.fps[m] for m in plan.mix],
                               [plan.mix[m] for m in plan.mix]),
                 plan.aggregate_fps, measured_aggregate))
    return rows
