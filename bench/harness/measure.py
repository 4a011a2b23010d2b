"""One run of one cell: set-up, the window, the traced slice, the drain,
the check, and the metrics by name.  ``run.py`` calls :func:`run_cell`
on the card; tests call it on the CPU at small sizes."""
from __future__ import annotations

import dataclasses
import gc
import math
import sys
import time

import torch

from bench.harness.cell import Cell
from bench.harness.check import check, forward_of
from bench.harness.inputs import make_inputs
from bench.harness.serve import Feeder, Phase
from bench.harness.stats import percentile
from bench.harness.trace import Summary, Tracer
from bench.harness.work import PEAKS, flops_per_image, request_bytes


@dataclasses.dataclass
class Run:
    """What a run measured; the metric readers take it."""

    cell: Cell
    kind: str                    # the card's name (or "cpu")
    setup_s: float
    window: Phase
    trace: Phase | None
    summary: Summary | None
    failed: int
    latencies_s: list[float]     # every request of the window
    flops_per_request: float
    bytes_per_request: float

    @property
    def window_s(self) -> float:
        """The measured window's length."""
        return self.window.t1 - self.window.t0

    @property
    def done(self) -> list:
        """Requests served inside the window."""
        return self.window.done_by(self.window.t1)

    @property
    def peak(self) -> dict | None:
        """The card's published peaks (None: not in the table)."""
        return PEAKS.get(self.kind)


def log(msg: str) -> None:
    """One line on standard error."""
    print(msg, file=sys.stderr, flush=True)


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool,
             device: torch.device, t_start: float) -> dict:
    """Run ``cell`` once; the result's fields but ``device``'s name and
    the isolation check, which the caller adds."""
    cfg, mix = cell.config, cell.traffic
    marks = [("imports", time.perf_counter())]
    reference = cell.part("reference", cfg["reference"])
    table = reference.layers(cfg)
    params, pool = make_inputs(table, cfg, mix, seed, device)
    marks.append(("inputs", time.perf_counter()))
    program = cell.part("programs", cfg["program"]).Program(cfg, params,
                                                             device)
    marks.append(("program", time.perf_counter()))
    loop = cell.part("loops", mix["loop"]).Loop(mix, seed)
    feeder = Feeder(program, loop, pool, seed)
    warm = feeder.warm()
    marks.append(("warm-up", time.perf_counter()))
    log("set-up s: " + ", ".join(
        f"{name} {t - prev:.3f}" for (name, t), prev in
        zip(marks, [t_start] + [t for _, t in marks[:-1]])))
    for line in program.describe():
        log(f"program: {line}")
    log(f"warm-up: {warm.slots} slots, {len(warm.served)} requests, lanes "
        f"{warm.lanes[0]} -> {warm.lanes[1]}")
    setup_s = time.perf_counter() - t_start
    win = feeder.window(seconds)
    cap = float(mix["latency_cap_s"])
    late = [win.t1 - r.sent for r in feeder.flight.values()
            if win.t1 - r.sent > cap]
    slot_ms = sorted(x * 1e3 for x in win.slot_s) or [math.nan]
    log(f"window: {win.slots} slots, {len(win.served)} requests served, "
        f"lanes {win.lanes[0]} -> {win.lanes[1]}, "
        f"{win.launches} launches; a slot's ms: median "
        f"{percentile(slot_ms, 50):.3f}, p99 {percentile(slot_ms, 99):.3f}, "
        f"max {slot_ms[-1]:.3f}, {sum(x > 20 for x in slot_ms)} over 20")
    ph_trace = summary = None
    if trace:
        tracer = Tracer(device.type == "cuda")
        ph_trace = feeder.trace(tracer)
        summary = tracer.summary
    drain = feeder.drain()
    log(f"drain: {drain.slots} slots, {len(drain.served)} requests")
    lat = [r.done - r.due for r in win.done_by(win.t1)] + late
    lat_ms = sorted(x * 1e3 for x in lat) or [math.nan]
    log(f"latency ms: median {percentile(lat_ms, 50):.3f}, p95 "
        f"{percentile(lat_ms, 95):.3f}, max {lat_ms[-1]:.3f}")
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        peak_bytes = torch.cuda.max_memory_allocated(device)
    else:
        peak_bytes = 0
    run = Run(cell=cell,
              kind=(torch.cuda.get_device_name(device)
                    if device.type == "cuda" else "cpu"),
              setup_s=setup_s, window=win, trace=ph_trace, summary=summary,
              failed=sum(1 for x in lat if x > cap), latencies_s=lat,
              flops_per_request=mix["batch"] * flops_per_image(table),
              bytes_per_request=request_bytes(table, mix["batch"],
                                              cfg["image_px"],
                                              cfg["in_channels"]))
    metrics = read_metrics(run, cell.per_layer if trace else cell.end_to_end)
    # the program's state goes before the reference runs
    kept = feeder.kept
    program.close()
    del program, feeder
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    err = check(kept, forward_of(reference), table, params, pool)
    limit = float(cfg["limits"]["logit_err"])
    correct = math.isfinite(err) and err <= limit
    result = {
        "correct": correct,
        "attempted": len(lat),
        "failed": run.failed,
        "metrics": metrics,
        "device": {"count": cell.chips, "memory_peak_bytes": peak_bytes},
        "check": {"logit_err": {"value": err if math.isfinite(err) else None,
                                "limit": limit},
                  "checked": {"value": len(kept), "limit": 1}},
    }
    if summary is not None:
        result["device"].update(busy_s=summary.busy_s,
                                window_s=summary.window_s)
        result["breakdown"] = {
            "device_ops": [[n[:160], s] for n, s in summary.ops],
            "idle_gaps": [[n, s] for n, s in summary.idle]}
    return result


def read_metrics(run: Run, entries: list[dict]) -> dict:
    """Each metric of ``entries`` from its reader ``metrics/<name>.py``;
    a reader that finds nothing to read leaves its metric out."""
    out = {}
    for m in entries:
        value = run.cell.part("metrics", m["name"]).read(run)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out
