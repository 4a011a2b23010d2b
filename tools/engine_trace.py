"""A benchmark cell served with the engine's own spans and counters on.

    python3 tools/engine_trace.py --workload <cell> --seed <n> \\
        [--seconds 30] [--spans on|off] [--out results/engine_trace.jsonl]

Serves a cell of ``BENCHMARK.json`` the way ``bench/run.py`` does (its
weights and images from the seed, its program adapter, loop, warm-up,
window and traced slice, imported from ``bench/`` unchanged), but hands
the adapter's runner a ``DualCoreEngine`` built with an enabled
``Registry`` and ``SpanRecorder`` (``--spans on``) or disabled ones
(``--spans off``, as the benchmark serves).  Prints one JSON line and
appends it to ``--out``:

* ``img_per_s`` and ``host_slot_ms`` over the window, as the benchmark
  reads them (so ``--spans on`` against ``--spans off`` is the tracing's
  cost), and ``cores``, the runner's cores line (``DualCores.describe``:
  the split it served at, measured or asked);
* with spans on: ``advance_ms`` (mean ``engine.advance``), ``ready_wait_ms``
  (``engine.ready_wait`` summed a slot, mean over slots) and
  ``device_allocs_per_kreq`` (``device_allocs_total`` over the window per
  1000 requests served in it), then, over the 2 s profiled slice that
  follows,
  ``c_core_busy_pct``, ``p_core_busy_pct``, ``other_busy_pct`` and
  ``union_busy_pct`` (the share of the slice in which an operation ran on
  the c-core's streams, the p-core's, neither's, any), the harness's own
  ``device_idle_pct`` of the same slice, and the slice's idle ms by the
  innermost program span at each gap's midpoint (also one line on standard
  error).

No output check is made (``bench/run.py`` makes it).  A measurement for
the card: without one it exits 2.

The device-trace readers live here, beside their one consumer: a device
operation is tied to a core through the launch that made it.  The CUDA
runtime or driver call (a ``cudaGraphLaunch``, a kernel launch, a copy)
whose host interval lies inside a ``runner.group`` span of that core
shares its correlation id with the operations it launched; the trace's
stream ids (``device_resource_id``) are CUPTI's, not the streams'
handles, so a core's streams are the stream ids of the operations its
groups launched.

The tool is a stopgap: it goes once the benchmark's own harness hands
the program's spans, counters and events to per-layer metric readers,
which take these readers with them.
"""
from __future__ import annotations

import argparse
import bisect
import contextlib
import json
import sys
import time
from pathlib import Path
from typing import Iterable, Sequence

ROOT = Path(__file__).resolve().parents[1]
for _p in (str(ROOT / "src"), str(ROOT)):
    if _p not in sys.path:
        sys.path.insert(0, _p)

import torch  # noqa: E402

from bench.harness.cell import Cell, load_cell  # noqa: E402
from bench.harness.inputs import make_inputs  # noqa: E402
from bench.harness.serve import Feeder  # noqa: E402
from bench.harness.trace import _merge, summarize  # noqa: E402
from repro_torch.obs import Registry, Span, SpanRecorder  # noqa: E402
from repro_torch.obs import readings  # noqa: E402
from repro_torch.serving.cnn import DualCoreEngine  # noqa: E402


class KeptTracer:
    """A tracer for ``Feeder.trace`` that keeps the profiler's events
    and the slice's edges (``events``, ``t0``, ``t1``, on
    ``time.time_ns``) besides the harness's ``summary`` of them."""

    def __init__(self, on: bool):
        self.on = on
        self.events: list | None = None
        self.summary = None
        self._prof = None

    def __enter__(self) -> "KeptTracer":
        if self.on:
            from torch.profiler import ProfilerActivity, profile

            self._prof = profile(activities=[ProfilerActivity.CPU,
                                             ProfilerActivity.CUDA])
            self._prof.__enter__()
        self.t0 = time.time_ns()
        return self

    def span(self, name: str):
        """The harness's host span, an annotation in the trace (nothing
        when not tracing)."""
        if self._prof is None:
            return contextlib.nullcontext()
        return torch.profiler.record_function(name)

    def __exit__(self, *exc) -> None:
        self.t1 = time.time_ns()
        if self._prof is None:
            return
        self._prof.__exit__(*exc)
        self.events = list(self._prof.profiler.kineto_results.events())
        self.summary = summarize(self.events, self.t0, self.t1)
        self._prof = None


def _is_device(e, cuda) -> bool:
    return e.device_type() == cuda and not e.is_user_annotation()


def _is_launch(e, cuda) -> bool:
    """A CUDA runtime or driver call on the host (``cuda*``, ``cu*``)."""
    return e.device_type() != cuda and e.name().startswith("cu") \
        and e.correlation_id() > 0


def core_streams(events: Iterable, spans: Sequence[Span], cuda
                 ) -> dict[str, set[int]]:
    """Each core's stream ids in the trace: those of the device operations
    launched inside its ``runner.group`` spans (``cuda`` is the device
    type of the card's events, ``torch.autograd.DeviceType.CUDA``)."""
    groups = sorted((s.start_ns, s.end_ns, s.core) for s in spans
                    if s.name == "runner.group")
    starts = [g[0] for g in groups]
    events = list(events)
    core_of: dict[int, str] = {}
    for e in events:
        if not _is_launch(e, cuda):
            continue
        a = e.start_ns()
        i = bisect.bisect_right(starts, a) - 1
        if i >= 0 and a + e.duration_ns() <= groups[i][1]:
            core_of[e.correlation_id()] = groups[i][2]
    out: dict[str, set[int]] = {"c": set(), "p": set()}
    for e in events:
        if _is_device(e, cuda):
            core = core_of.get(e.correlation_id())
            if core is not None:
                out[core].add(e.device_resource_id())
    return out


def busy_ns(events: Iterable, streams: dict[str, set[int]], t0: int,
            t1: int, cuda) -> dict[str, int]:
    """ns of ``[t0, t1]`` in which a device operation ran: on the
    c-core's streams (``"c"``), the p-core's (``"p"``), streams of
    neither, such as the input copy's and the allocator's (``"other"``),
    and on any (``"union"``)."""
    iv: dict[str, list[tuple[int, int]]] = {"c": [], "p": [], "other": []}
    for e in events:
        if not _is_device(e, cuda):
            continue
        a = max(e.start_ns(), t0)
        b = min(e.start_ns() + e.duration_ns(), t1)
        if b <= a:
            continue
        sid = e.device_resource_id()
        hit = [k for k in ("c", "p") if sid in streams.get(k, ())]
        for k in hit or ["other"]:
            iv[k].append((a, b))
    out = {k: sum(b - a for a, b in _merge(v)) for k, v in iv.items()}
    out["union"] = sum(b - a for a, b in
                       _merge(iv["c"] + iv["p"] + iv["other"]))
    return out


def idle_by_span(events: Iterable, spans: Sequence[Span], t0: int, t1: int,
                 cuda) -> dict[str, int]:
    """The device's idle ns in ``[t0, t1]`` (no operation on any stream)
    by the innermost program span open at each gap's midpoint (``"none"``
    where none was), largest first."""
    dev = []
    for e in events:
        if _is_device(e, cuda):
            a = max(e.start_ns(), t0)
            b = min(e.start_ns() + e.duration_ns(), t1)
            if b > a:
                dev.append((a, b))
    host = sorted((s.start_ns, s.end_ns, s.name, s.parent is None)
                  for s in spans)
    starts = [h[0] for h in host]
    idle: dict[str, int] = {}
    edge = t0
    for a, b in [*_merge(dev), (t1, t1)]:
        if a > edge:
            mid = (edge + a) // 2
            label = "none"
            # spans nest: the latest-started span holding mid is innermost;
            # none before a top-level span that ended holds it
            for i in range(bisect.bisect_right(starts, mid) - 1, -1, -1):
                if host[i][1] >= mid:
                    label = host[i][2]
                    break
                if host[i][3]:
                    break
            idle[label] = idle.get(label, 0) + (a - edge)
        edge = max(edge, b)
    return dict(sorted(idle.items(), key=lambda kv: -kv[1]))


def measure(cell: Cell, seed: int, seconds: float, on: bool,
            device: torch.device) -> dict:
    """One run of ``cell`` with the engine's spans on or off; the line's
    fields (module docstring)."""
    cfg, mix = cell.config, cell.traffic
    table = cell.part("reference", cfg["reference"]).layers(cfg)
    params, pool = make_inputs(table, cfg, mix, seed, device)
    program = cell.part("programs", cfg["program"]).Program(cfg, params,
                                                             device)
    spans = SpanRecorder(enabled=on)
    program.engine = engine = DualCoreEngine(
        program.runner, obs=Registry(enabled=on), spans=spans)
    feeder = Feeder(program, cell.part("loops", mix["loop"]).Loop(mix, seed),
                    pool, seed)
    feeder.warm()
    spans.drain()
    before, w0 = engine.snapshot(), time.time_ns()
    win = feeder.window(seconds)
    w1, after = time.time_ns(), engine.snapshot()
    done = win.done_by(win.t1)
    out = {"workload": cell.name, "seed": seed, "spans": on,
           "img_per_s": sum(r.batch for r in done) / (win.t1 - win.t0),
           "host_slot_ms": win.advance_s / win.slots * 1e3,
           "slots": win.slots, "served": len(win.served),
           "cores": program.runner.cores.describe()}
    if on:
        out.update(_traced(feeder, engine, spans, before, after, w0, w1,
                           win, device))
    feeder.drain()
    program.close()
    return out


def _traced(feeder: Feeder, engine: DualCoreEngine, spans: SpanRecorder,
            before: dict, after: dict, w0: int, w1: int, win,
            device: torch.device) -> dict:
    """The span and counter readings of the window, then the profiled
    slice and its device readings."""
    cuda = torch.autograd.DeviceType.CUDA
    tracer = KeptTracer(device.type == "cuda")
    feeder.trace(tracer)
    kept = spans.drain()
    out = dict(advance_ms=readings.advance_ms(kept, w0, w1),
               ready_wait_ms=readings.ready_wait_ms(kept, w0, w1),
               device_allocs_per_kreq=readings.per_kreq(
                   before, after, "device_allocs_total", len(win.served)),
               lane_captures=readings.growth(
                   before, after, "runner_lane_captures_total"),
               spans_dropped=spans.dropped)
    if tracer.events is not None:
        t0, t1 = tracer.t0, tracer.t1
        streams = core_streams(tracer.events, kept, cuda)
        busy = busy_ns(tracer.events, streams, t0, t1, cuda)
        idle = idle_by_span(tracer.events, kept, t0, t1, cuda)
        s = tracer.summary
        out.update({f"{k}_busy_pct" if k in ("union", "other")
                    else f"{k}_core_busy_pct": v / (t1 - t0) * 100
                    for k, v in busy.items()})
        out.update(device_idle_pct=(1 - s.busy_s / s.window_s) * 100,
                   core_streams={k: sorted(v) for k, v in streams.items()},
                   idle_ms_by_span={k: v / 1e6 for k, v in idle.items()})
        print("program idle ms by innermost span: " + ", ".join(
            f"{k} {v / 1e6:.3f}" for k, v in idle.items())
            + f"; streams of neither core busy "
            f"{out['other_busy_pct']:.3f}% of the slice",
            file=sys.stderr, flush=True)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=30.0)
    ap.add_argument("--spans", choices=("on", "off"), default="on")
    ap.add_argument("--out", default="results/engine_trace.jsonl")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("engine_trace: no CUDA card", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    line = measure(load_cell(args.workload, ROOT), args.seed, args.seconds,
                   args.spans == "on", device)
    line["device"] = torch.cuda.get_device_name(device)
    text = json.dumps(line)
    print(text, flush=True)
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    with open(args.out, "a") as f:
        f.write(text + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
