"""CPU tests of the benchmark's harness: the closed loop, the metrics'
arithmetic, the work counts, the card check, isolation, a cell added
from files alone, and a reference that brings its own forward or table
entries."""
from __future__ import annotations

import dataclasses
import json
import sys
import time
from pathlib import Path

import pytest
import torch

from bench.harness import serve
from bench.harness.cell import load_cell, load_file
from bench.harness.check import check, forward_of
from bench.harness.inputs import generator, make_inputs, make_params
from bench.harness.serve import Feeder, Phase, Req
from bench.harness.stats import percentile
from bench.harness.work import flops_per_image, request_bytes, weight_bytes
from bench.reference import plain
from bench.tests.cells import tiny_root

BENCH = Path(__file__).resolve().parents[1]


def metric(name: str):
    return load_file(BENCH / "metrics" / f"{name}.py")


def table(config: str, **changes) -> list:
    cfg = json.loads((BENCH / "configs" / f"{config}.json").read_text())
    cfg.update(changes)
    return load_file(BENCH / "reference" / f"{cfg['reference']}.py") \
        .layers(cfg)


class FakeProgram:
    """A pipeline of ``depth`` slots that admits one request a slot;
    ``stall`` maps a slot index to host seconds slept in that slot."""

    def __init__(self, depth: int, stall: dict | None = None):
        self.capacity = depth
        self.queue, self.flight = [], []
        self.stall = stall or {}
        self.slot = 0
        self.next_rid = 0

    def submit(self, x):
        rid = self.next_rid
        self.next_rid += 1
        self.queue.append(rid)
        return rid

    def advance(self):
        time.sleep(self.stall.get(self.slot, 0.0))
        self.slot += 1
        self.flight = [(rid, left - 1) for rid, left in self.flight]
        done = [rid for rid, left in self.flight if left == 0]
        self.flight = [(r, n) for r, n in self.flight if n > 0]
        if self.queue:
            self.flight.append((self.queue.pop(0), self.capacity))
        return done

    def retire(self, done):
        now = time.perf_counter()
        return [(rid, torch.zeros(2, 3), now) for rid in done]

    @property
    def has_work(self):
        return bool(self.queue or self.flight)

    def launches(self):
        return 0

    def lanes(self):
        return 0


def closed(clients: int):
    return load_file(BENCH / "loops" / "closed.py").Loop(
        {"clients": clients}, 0)


def test_closed_loop_keeps_every_client_outstanding():
    prog = FakeProgram(depth=16)
    feeder = Feeder(prog, closed(16), torch.zeros(4, 2, 1, 1, 3), seed=1)
    seen = []
    submit = prog.submit

    def counting(x):
        rid = submit(x)
        seen.append(len(feeder.flight) + 1)
        return rid

    prog.submit = counting
    ph = feeder._run(Phase("t"), lambda ph: ph.slots >= 200)
    assert len(ph.served) > 100
    # after the first 16 sends, every send refills the 16th slot
    assert seen[:16] == list(range(1, 17))
    assert set(seen[16:]) == {16}
    assert len(feeder.flight) + feeder.loop.idle == 16


def run_of(served, t0, t1, lat=None):
    ph = Phase("window", t0=t0, t1=t1, slots=len(served), served=served)
    ns = type("Run", (), {})()
    ns.window, ns.window_s = ph, t1 - t0
    ns.done = ph.done_by(t1)
    ns.latencies_s = lat if lat is not None else \
        [r.done - r.due for r in ns.done]
    return ns


def test_img_per_s_counts_only_requests_served_in_the_window():
    served = [Req(i, 64, 0, due=0.0, sent=0.0, started=0.0, done=d)
              for i, d in enumerate([0.5, 1.0, 1.5, 2.0, 2.5])]
    run = run_of(served, 0.0, 2.0)
    assert metric("img_per_s").read(run) == pytest.approx(4 * 64 / 2.0)


def test_latency_p95_is_over_every_request_and_a_stall_moves_it():
    def p95(stall):
        prog = FakeProgram(depth=8, stall=stall)
        feeder = Feeder(prog, closed(8), torch.zeros(4, 2, 1, 1, 3), 3)
        feeder._run(Phase("warm"), lambda ph: ph.slots >= 40)
        win = feeder._run(Phase("window"), lambda ph: ph.slots >= 300)
        run = run_of(win.served, win.t0, win.t1)
        lat = sorted(run.latencies_s)
        assert len(lat) == len(win.done_by(win.t1)) > 250
        assert metric("latency_p95_ms.offline").read(run) == pytest.approx(
            percentile(lat, 95) * 1e3)
        return metric("latency_p95_ms.offline").read(run)

    calm = p95({})
    stalled = p95({60 + 10 * k: 0.05 for k in range(3)})
    assert stalled > calm + 20


def test_percentile_interpolates_as_numpy():
    xs = [5.0, 1.0, 3.0, 2.0, 4.0]
    assert percentile(xs, 95) == pytest.approx(4.8)
    assert percentile(xs, 50) == 3.0


@pytest.mark.parametrize("config, gflop, weights_mb", [
    ("mobilenet_v2", 0.602, 13.95),
    ("mobilenet_v1", 1.137, 16.88),
])
def test_flops_and_weights_from_the_published_tables(config, gflop,
                                                      weights_mb):
    t = table(config)
    assert round(flops_per_image(t) / 1e9, 3) == gflop
    assert round(weight_bytes(t) / 1e6, 2) == weights_mb
    assert t[-1].op == "fc" and t[-1].c_out == 1000


@pytest.mark.parametrize("config", ["mobilenet_v2", "mobilenet_v1"])
def test_layer_table_matches_the_served_graph(config):
    from repro_torch.models.zoo import get_graph

    graph = get_graph(config)
    ops = {"conv": "conv", "dwconv": "dw", "fc": "fc"}
    assert [(l.name, l.op, l.h, l.c_in, l.c_out, l.k, l.stride)
            for l in table(config)] == \
        [(l.name, ops[l.op], l.H, l.C_i, l.C_o, l.K_h, l.stride)
         for l in graph.layers]


def test_forbidden_modules_compares_whole_top_level_names():
    run = load_file(BENCH / "run.py")
    assert run.forbidden_modules(["repro_torch.serving", "reprox", "torch",
                                  "jax_extra", "bench.run"]) == []
    assert run.forbidden_modules(["repro.core.graph", "jax.numpy", "flax",
                                  "jaxlib.xla_client"]) == \
        ["flax", "jax", "jaxlib", "repro"]


def test_a_cell_added_from_new_files_runs(tmp_path, monkeypatch):
    from bench.harness.measure import run_cell

    monkeypatch.setattr(serve, "TRACE_S", 0.2)
    cell = load_cell("tiny.alone", tiny_root(tmp_path))
    out = run_cell(cell, 2 ** 31 + 11, 0.3, True, torch.device("cpu"),
                   time.perf_counter())
    assert out["correct"] is True
    assert out["metrics"]["slots.tiny"]["value"] > 0
    assert set(out["metrics"]) == {"slots.tiny"}
    out = run_cell(cell, 5, 0.3, False, torch.device("cpu"),
                   time.perf_counter())
    assert set(out["metrics"]) == {"img_per_s", "setup_s"}
    assert out["check"]["logit_err"]["value"] <= \
        out["check"]["logit_err"]["limit"]


#: a reference module of its own: MobileNet v1's table, and a forward that
#: records each precision it is called at and scales ``plain.forward``'s
#: logits by ``SCALE``
OWN_FORWARD = """
from bench.reference import plain
from bench.reference.mobilenet_v1 import layers

SCALE = {scale!r}
CALLS = []


def forward(table, params, x, precision="f32"):
    CALLS.append(precision)
    return plain.forward(table, params, x, precision) * SCALE
"""


def own_forward_cell(tmp_path, scale: float):
    cell = load_cell("tiny.alone",
                     tiny_root(tmp_path, OWN_FORWARD.format(scale=scale)))
    return cell, cell.part("reference", "tiny_ref")


def test_a_reference_with_its_own_forward_is_added_from_new_files(tmp_path):
    from bench.harness.measure import run_cell

    cell, ref = own_forward_cell(tmp_path, 1.0)
    assert forward_of(ref) is ref.forward
    out = run_cell(cell, 2 ** 31 + 13, 0.3, False, torch.device("cpu"),
                   time.perf_counter())
    assert out["correct"] is True
    assert ref.CALLS and set(ref.CALLS) == {"f32"}


def test_the_check_and_the_control_use_the_references_forward(tmp_path):
    from bench.control import readings
    from bench.harness.measure import run_cell

    cell, ref = own_forward_cell(tmp_path, 1.01)
    out = run_cell(cell, 2 ** 31 + 17, 0.3, False, torch.device("cpu"),
                   time.perf_counter())
    assert out["correct"] is False
    # a logit 1% off its reference: at least 1% of the row's RMS
    assert out["check"]["logit_err"]["value"] > 0.0099 > \
        out["check"]["logit_err"]["limit"]
    ref.CALLS.clear()
    readings(cell, 19, torch.device("cpu"))
    pool = cell.traffic["pool"]
    assert ref.CALLS == ["f32"] * pool + ["tf32"] * pool + \
        ["tf32_library"] * pool


@dataclasses.dataclass(frozen=True)
class GateFC:
    """An SE gate's reduce or expand FC on a pooled map: a table entry of
    a reference's own class, not a ``plain.Layer``."""

    name: str
    c_in: int
    c_out: int

    def weight_shape(self) -> tuple[int, ...]:
        return (self.c_in, self.c_out)

    @property
    def fan_in(self) -> int:
        return self.c_in

    @property
    def flops(self) -> int:
        return 2 * self.c_in * self.c_out


def test_an_entry_of_its_own_class_gets_weights_flops_and_bytes():
    cpu = torch.device("cpu")
    t = table("mobilenet_v1", image_px=32)
    gate = [GateFC("se_reduce", 1024, 256), GateFC("se_expand", 256, 1024)]
    mixed = t[:-1] + gate + t[-1:]
    assert all(isinstance(e, plain.Entry) for e in mixed)
    assert not isinstance(gate[0], plain.Layer)
    params = make_params(mixed, generator(2 ** 31 + 23, cpu), cpu)
    assert set(params) == {e.name for e in mixed}
    for e in gate:
        w, b = params[e.name]["w"], params[e.name]["b"]
        assert w.shape == (e.c_in, e.c_out) and b.shape == (e.c_out,)
        assert float(w.std()) == pytest.approx((2 / e.c_in) ** 0.5,
                                               rel=0.05)
    gate_flops = 2 * (2 * 1024 * 256)
    assert flops_per_image(mixed) == flops_per_image(t) + gate_flops
    gate_bytes = 4 * (1024 * 256 + 256 + 256 * 1024 + 1024)
    assert request_bytes(mixed, 2, 32, 3) == \
        request_bytes(t, 2, 32, 3) + gate_bytes


@pytest.mark.parametrize("config", ["mobilenet_v2", "mobilenet_v1"])
def test_a_reference_without_a_forward_checks_as_plain(config):
    cpu = torch.device("cpu")
    cfg = json.loads((BENCH / "configs" / f"{config}.json").read_text())
    cfg["image_px"] = 32
    ref = load_file(BENCH / "reference" / f"{cfg['reference']}.py")
    assert not hasattr(ref, "forward")
    forward = forward_of(ref)
    assert forward is plain.forward
    t = ref.layers(cfg)
    params, pool = make_inputs(t, cfg, {"pool": 2, "batch": 2},
                               2 ** 31 + 29, cpu)
    kept = [(1, plain.forward(t, params, pool[1]) * (1 + 1e-4)),
            (0, plain.forward(t, params, pool[0], "tf32"))]
    err = check(kept, forward, t, params, pool)
    assert 0 < err < 1
    assert err == check(kept, plain.forward, t, params, pool)
