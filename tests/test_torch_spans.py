"""The CNN engine's spans and counters on the CPU, and their readings.

Tiny MobileNet v1 (11 exec groups) at 32 px, a few requests, the runner
on ``device="cpu"``.  The device-trace readers of ``tools/engine_trace.py``
are held on made-up events; the card's own trace is held in
``tests/test_torch_cuda.py``.
"""
import importlib.util
import json
import sys
import time
from pathlib import Path

import pytest
import torch

from repro_torch.core.arch import DUAL_BASELINE, BoardModel
from repro_torch.core.scheduler import build_schedule
from repro_torch.dualcore.runtime import DualCoreRunner
from repro_torch.models.cnn import init_params, params_from_numpy
from repro_torch.models.zoo import get_graph
from repro_torch.obs import Registry, Span, SpanRecorder, readings
from repro_torch.serving.api import Request, replay
from repro_torch.serving.cnn import DualCoreEngine

ROOT = Path(__file__).resolve().parents[1]
MODEL = "mobilenet_v1"


@pytest.fixture(scope="module")
def runner():
    graph = get_graph(MODEL)
    sched = build_schedule(graph, DUAL_BASELINE, BoardModel(), "balanced")
    return DualCoreRunner(MODEL, params_from_numpy(init_params(graph, 0),
                                                   "cpu"),
                          sched, device="cpu")


def _images(n, seed=0):
    g = torch.Generator().manual_seed(seed)
    return [torch.randn((1, 32, 32, 3), generator=g) for _ in range(n)]


@pytest.fixture(scope="module")
def traced(runner):
    """Five requests over a queue bound of 2, arriving over four slots,
    served with spans on: the engine's record and every span."""
    record: list = []
    spans = SpanRecorder(enabled=True)
    eng = DualCoreEngine(runner, max_queue=2, record=record,
                         obs=Registry(), spans=spans)
    res = replay(eng, [Request(x) for x in _images(5)], [0, 0, 0, 1, 3])
    return eng, record, spans.drain(), res


def _by_sid(spans):
    return {s.sid: s for s in spans}


def test_each_slot_has_one_advance_and_one_retire(traced):
    eng, _, spans, res = traced
    adv = sorted(s.slot for s in spans if s.name == "engine.advance")
    ret = sorted(s.slot for s in spans if s.name == "engine.retire")
    assert adv == ret == list(range(res.stats["slots"]))
    assert all(s.parent is None for s in spans
               if s.name in ("engine.advance", "engine.retire"))


def test_group_spans_match_the_engines_record(traced):
    """Each ``engine.advance`` span's ``runner.group`` children are the
    engine's ``(slot, rid, group, core)`` tuples of that slot, one for
    one and in order."""
    _, record, spans, _ = traced
    sid = _by_sid(spans)
    groups = sorted((s for s in spans if s.name == "runner.group"),
                    key=lambda s: s.start_ns)
    assert all(sid[s.parent].name == "engine.advance" for s in groups)
    assert [(sid[s.parent].slot, s.rid, s.group, s.core)
            for s in groups] == record
    assert all(s.graph is False for s in groups)


def test_a_requests_rid_links_its_spans(traced):
    """Every request has one ``engine.admit``, ``runner.load`` and
    ``engine.ready_wait`` and a ``runner.group`` for each exec group, all
    under its rid, in that order on the clock; its admission comes after
    its submit and its ready wait before its finish stamp."""
    eng, _, spans, res = traced
    n_groups = len(eng.runner.groups)
    assert res.metrics.completed == 5
    for rid in range(5):
        mine = [s for s in spans if s.rid == rid]
        names = [s.name for s in mine]
        for name in ("engine.admit", "runner.load", "engine.ready_wait"):
            assert names.count(name) == 1, (rid, name)
        groups = sorted((s for s in mine if s.name == "runner.group"),
                        key=lambda s: s.start_ns)
        assert [s.group for s in groups] == list(range(n_groups))
        one = {s.name: s for s in mine}
        assert one["engine.admit"].end_ns <= groups[0].start_ns
        assert groups[-1].end_ns <= one["engine.ready_wait"].start_ns
        m = res.completions[rid].metrics
        assert m.submitted_at <= m.started_at <= m.finished_at


def test_spans_nest(traced):
    """A child lies inside its parent, which opened before it; the
    parents are the ones the engine's layers give."""
    _, _, spans, _ = traced
    sid = _by_sid(spans)
    parent_of = {"runner.group": "engine.advance",
                 "engine.admit": "engine.advance",
                 "runner.load": "engine.admit",
                 "engine.ready_wait": "engine.retire"}
    for s in spans:
        if s.parent is None:
            continue
        p = sid[s.parent]
        assert p.start_ns <= s.start_ns <= s.end_ns <= p.end_ns
        assert p.sid < s.sid
        assert parent_of[s.name] == p.name
    assert len(sid) == len(spans)


def test_the_bound_counts_what_it_drops(runner):
    """A recorder of 10 keeps the first 10 spans to end and counts the
    rest."""
    spans = SpanRecorder(enabled=True, capacity=10)
    eng = DualCoreEngine(runner, obs=Registry(), spans=spans)
    for x in _images(2):
        eng.submit(x)
    eng.drain()
    kept = spans.drain()
    assert len(kept) == 10 and spans.dropped > 0
    assert spans.dropped + 10 == spans._next_sid
    with pytest.raises(ValueError, match="capacity"):
        SpanRecorder(capacity=0)


def test_tracing_off_records_nothing_and_reads_no_clock(runner,
                                                        monkeypatch):
    """Off (the default), the engine records no span and never reads
    ``time.time_ns``, the spans' clock; the outputs are the traced
    run's."""
    calls = {"n": 0}
    real = time.time_ns

    def counting():
        calls["n"] += 1
        return real()

    monkeypatch.setattr(time, "time_ns", counting)
    spans = SpanRecorder()
    eng = DualCoreEngine(runner, spans=spans)
    assert not eng.spans.enabled and not eng.obs.enabled
    assert runner.spans is spans
    images = _images(3, seed=4)
    res = replay(eng, [Request(x) for x in images], [0, 0, 1])
    assert calls["n"] == 0
    assert spans.drain() == [] and spans._next_sid == 0
    assert eng.snapshot()["counters"] == {}
    default = DualCoreEngine(runner)
    assert not default.spans.enabled and not default.obs.enabled
    on = DualCoreEngine(runner, spans=SpanRecorder(enabled=True))
    got = replay(on, [Request(x) for x in images], [0, 0, 1])
    for a, b in zip(res.outputs, got.outputs):
        assert torch.equal(a, b)


def test_a_span_without_rid_takes_its_parents():
    """A span opened without a rid carries its parent's (as the
    runner's ``runner.load``, ``runner.capture`` and ``runner.clone_out``
    carry their request's); one under a slot-scoped span has none, and one
    given a rid keeps it."""
    rec = SpanRecorder(enabled=True)
    with rec.span("engine.admit", rid=7):
        with rec.span("runner.load"):
            with rec.span("runner.capture"):
                pass
    with rec.span("engine.advance", slot=3):
        with rec.span("runner.group", rid=9, group=0, core="c"):
            with rec.span("runner.clone_out"):
                pass
        with rec.span("inner"):
            pass
    got = {s.name: (s.rid, s.slot) for s in rec.drain()}
    assert got == {"engine.admit": (7, None), "runner.load": (7, None),
                   "runner.capture": (7, None),
                   "engine.advance": (None, 3), "runner.group": (9, None),
                   "runner.clone_out": (9, None), "inner": (None, None)}


# --------------------------------------------------------------------------
# the readings
# --------------------------------------------------------------------------
def _span(sid, name, a, b, parent=None, **kw):
    return Span(sid, name, a, b, parent, **kw)


def test_span_readings_over_a_window():
    spans = [_span(0, "engine.advance", 100, 300, slot=0),
             _span(1, "engine.retire", 300, 400, slot=0),
             _span(2, "engine.ready_wait", 310, 350, 1, rid=0),
             _span(3, "engine.ready_wait", 350, 390, 1, rid=1),
             _span(4, "engine.advance", 400, 1000, slot=1),
             _span(5, "engine.retire", 1000, 1010, slot=1),
             _span(6, "engine.advance", 2000, 2100, slot=2)]
    assert readings.advance_ms(spans, 0, 1500) == pytest.approx(400 / 1e6)
    assert readings.ready_wait_ms(spans, 0, 1500) == pytest.approx(40 / 1e6)
    assert readings.advance_ms(spans, 5000, 6000) is None
    assert readings.ready_wait_ms(spans, 5000, 6000) is None
    before = {"counters": {"device_allocs_total": {"series": {"": 4}}}}
    after = {"counters": {"device_allocs_total": {"series": {"": 10}}}}
    assert readings.per_kreq(before, after, "device_allocs_total",
                             300) == pytest.approx(20.0)
    assert readings.per_kreq({"counters": {}}, after,
                             "device_allocs_total", 1000) == 10.0
    assert readings.per_kreq(before, {"counters": {}},
                             "device_allocs_total", 300) is None
    assert readings.per_kreq(before, after, "device_allocs_total", 0) is None


@pytest.fixture(scope="module")
def tool():
    """``tools/engine_trace.py``, which holds the device-trace readers."""
    for p in (str(ROOT), str(ROOT / "src")):
        if p not in sys.path:
            sys.path.insert(0, p)
    spec = importlib.util.spec_from_file_location(
        "engine_trace_tool", ROOT / "tools" / "engine_trace.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class _Ev:
    """A kineto event's surface, made up."""

    def __init__(self, name, dev, a, d, corr=0, stream=0, user=False):
        self._v = (name, dev, a, d, corr, stream, user)

    def name(self):
        return self._v[0]

    def device_type(self):
        return self._v[1]

    def start_ns(self):
        return self._v[2]

    def duration_ns(self):
        return self._v[3]

    def correlation_id(self):
        return self._v[4]

    def device_resource_id(self):
        return self._v[5]

    def is_user_annotation(self):
        return self._v[6]


CPU, CUDA = "cpu", "cuda"


def _trace():
    """Two groups, c then p, each launching a graph whose kernels land on
    CUPTI streams 7 (c) and 9 (p); an input copy on stream 3; a launch
    outside any group; the spans' own annotations on the device row."""
    spans = [_span(0, "engine.advance", 0, 1000, slot=0),
             _span(1, "runner.group", 100, 200, 0, rid=0, group=0,
                   core="c", graph=True),
             _span(2, "runner.group", 200, 300, 0, rid=1, group=1,
                   core="p", graph=True),
             _span(3, "engine.admit", 300, 400, 0, rid=2),
             _span(4, "runner.load", 310, 390, 3, rid=2),
             _span(6, "engine.retire", 1000, 1600, slot=0),
             _span(7, "engine.ready_wait", 1010, 1590, 6, rid=0)]
    events = [_Ev("cudaGraphLaunch", CPU, 120, 20, corr=11),
              _Ev("cudaGraphLaunch", CPU, 220, 20, corr=12),
              _Ev("cudaMemcpyAsync", CPU, 320, 10, corr=13),
              _Ev("cudaLaunchKernel", CPU, 1100, 10, corr=14),
              _Ev("aten::add", CPU, 120, 20, corr=11),
              _Ev("k_c1", CUDA, 150, 300, corr=11, stream=7),
              _Ev("k_c2", CUDA, 500, 200, corr=11, stream=7),
              _Ev("k_p1", CUDA, 250, 600, corr=12, stream=9),
              _Ev("copy", CUDA, 900, 150, corr=13, stream=3),
              _Ev("runner.group", CUDA, 100, 2000, user=True),
              _Ev("k_late", CUDA, 1200, 100, corr=14, stream=7)]
    return events, spans


def test_core_streams_follow_the_launch_inside_each_group(tool):
    events, spans = _trace()
    assert tool.core_streams(events, spans, CUDA) == {"c": {7}, "p": {9}}


def test_busy_by_core_other_and_union(tool):
    """c: [150, 450], [500, 700] and [1200, 1300]; p: [250, 850]; other
    (the copy): [900, 1050]; union [150, 850], [900, 1050] and [1200,
    1300]; the annotation on the device row counts for nothing."""
    events, spans = _trace()
    streams = tool.core_streams(events, spans, CUDA)
    busy = tool.busy_ns(events, streams, 0, 2000, CUDA)
    assert busy == {"c": 600, "p": 600, "other": 150, "union": 950}
    clipped = tool.busy_ns(events, streams, 600, 1000, CUDA)
    assert clipped == {"c": 100, "p": 250, "other": 100, "union": 350}
    assert max(busy["c"], busy["p"]) <= busy["union"] \
        <= busy["c"] + busy["p"] + busy["other"]


def test_idle_by_the_innermost_span(tool):
    """Idle [0, 150) and [850, 900) under the advance (inside no group or
    admission), [1050, 1200) under the ready wait, [1300, 2000) past the
    retire (mid 1650: none)."""
    events, spans = _trace()
    idle = tool.idle_by_span(events, spans, 0, 2000, CUDA)
    assert idle == {"none": 700, "engine.advance": 200,
                    "engine.ready_wait": 150}
    assert list(idle) == ["none", "engine.advance", "engine.ready_wait"]


# --------------------------------------------------------------------------
# the tool that serves a benchmark cell with the spans on
# --------------------------------------------------------------------------
def test_tool_reads_span_and_counter_metrics_on_cpu(tool):
    """A tiny cell on the CPU (MobileNet v1 at 32 px, 3 clients of 2
    images, the benchmark's closed loop) with spans on: the span readings
    have values; the allocator's counter and the device trace's readings,
    which only a card has, are absent or None, never a CPU number."""
    from bench.harness.cell import Cell

    cfg = json.loads((ROOT / "bench/configs/mobilenet_v1.json").read_text())
    cfg["image_px"] = 32
    cell = Cell(root=ROOT, name="tiny.closed", chips=1, config=cfg,
                traffic={"loop": "closed", "clients": 3, "batch": 2,
                         "pool": 3, "latency_cap_s": 10.0},
                end_to_end=[], per_layer=[])
    line = tool.measure(cell, 2 ** 33 + 5, 0.3, True, torch.device("cpu"))
    assert line["slots"] > 0 and line["served"] > 0
    assert line["advance_ms"] > 0 and line["ready_wait_ms"] >= 0
    assert line["device_allocs_per_kreq"] is None
    assert line["lane_captures"] is None and line["spans_dropped"] == 0
    for name in ("c_core_busy_pct", "p_core_busy_pct", "other_busy_pct",
                 "union_busy_pct", "device_idle_pct"):
        assert name not in line
    off = tool.measure(cell, 3, 0.2, False, torch.device("cpu"))
    assert off["img_per_s"] > 0 and "advance_ms" not in off
    assert tool.main(["--workload", "mnv1.offline.b64", "--seed", "1"]) == 2
