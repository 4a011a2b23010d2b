"""CPU tests of EfficientNet-B4's cell: its reference table against the
served graph, its work counts, its own forward against the port's plain
reference, a tiny cell of it run from new files (sound, then with the SE
gate skipped), its new metrics' readers, and the control against its
limit."""
from __future__ import annotations

import json
import time
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch

from bench.harness import serve
from bench.harness.cell import load_cell, load_file
from bench.harness.check import forward_of, logit_err, reference_logits
from bench.harness.inputs import make_inputs
from bench.harness.measure import run_cell
from bench.harness.trace import Summary
from bench.harness.work import flops_per_image, weight_bytes
from bench.reference import plain
from bench.tests.cells import tiny_root

BENCH = Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")


def config(**changes) -> dict:
    cfg = json.loads((BENCH / "configs" / "efficientnet_b4.json").read_text())
    cfg.update(changes)
    return cfg


def reference():
    return load_file(BENCH / "reference" / "efficientnet_b4.py")


def test_layer_table_matches_the_served_graph():
    from repro_torch.models.zoo import get_graph

    graph = get_graph("efficientnet_b4")
    ops = {"conv": "conv", "dwconv": "dw"}
    ref = reference()
    table = ref.layers(config())
    assert [l.name for l in table] == [l.name for l in graph.layers]
    for entry, l in zip(table, graph.layers):
        if isinstance(entry, ref.GateFC):
            assert l.op == "fc" and (entry.c_in, entry.c_out) == \
                (l.C_i, l.C_o)
            assert entry.weight_shape() == (1, 1, l.C_i, l.C_o)
        elif entry.op == "fc":
            assert (l.op, l.C_i, l.C_o) == ("fc", entry.c_in, entry.c_out)
        else:
            assert (entry.op, entry.h, entry.c_in, entry.c_out, entry.k,
                    entry.stride, entry.pad) == \
                (ops[l.op], l.H, l.C_i, l.C_o, l.K_h, l.stride, l.pad)
            assert entry.add == ("add" in l.fused)
    assert all(isinstance(e, plain.Entry) for e in table)
    assert sum(isinstance(e, ref.GateFC) for e in table) == 64


def test_flops_weights_and_se_work_from_the_published_table():
    ref = reference()
    t = ref.layers(config())
    # 4.394 G multiply-adds (the SE FCs' 3.1 M among them), 19.28 M
    # weights and biases
    assert round(flops_per_image(t) / 1e9, 2) == 8.79
    assert round(weight_bytes(t) / 1e6, 2) == 77.12
    assert t[-1].op == "fc" and t[-1].c_out == 1000
    flops, nbytes = ref.se_work(t, 1)
    dw_out = sum(l.h_out ** 2 * l.c_out for l in t
                 if isinstance(l, plain.Layer) and l.op == "dw")
    gates = [l for l in t if isinstance(l, ref.GateFC)]
    fc_flops = sum(l.flops for l in gates)
    fc_bytes = 4 * sum(l.c_in * l.c_out + l.c_out for l in gates)
    assert round(4 * dw_out / 1e6, 1) == 78.2
    assert flops == 2 * dw_out + fc_flops
    assert nbytes == 4 * dw_out + fc_bytes
    flops16, nbytes16 = ref.se_work(t, 16)
    assert flops16 == 16 * flops
    assert nbytes16 == 16 * 4 * dw_out + fc_bytes


@pytest.mark.parametrize("precision", ["f32", "tf32"])
def test_the_references_forward_matches_the_ports_plain_reference(precision):
    """The benchmark's own forward and ``models/efficientnet_ref.py`` are
    written apart; at f32 they differ by summation order only, and the
    control's TF32 rounding moves the logits by far more."""
    from repro_torch.models.efficientnet_ref import efficientnet_forward_ref

    cfg = config(image_px=48)
    ref = reference()
    t = ref.layers(cfg)
    params, pool = make_inputs(t, cfg, {"pool": 1, "batch": 2}, 2 ** 31 + 3,
                               CPU)
    got = ref.forward(t, params, pool[0], precision)
    want = efficientnet_forward_ref(params, pool[0])
    err = logit_err(got, want)
    if precision == "f32":
        assert err < 1e-5
    else:
        assert err > 1e-4


def effnet_cell(tmp_path: Path, **traffic):
    """The tiny cell with its configuration replaced by B4's at 32 px and
    the new metrics listing it (new files and entries only)."""
    root = tiny_root(tmp_path)
    (root / "bench/configs/tiny_v1.json").write_text(
        json.dumps(config(image_px=32)))
    spec = json.loads((root / "BENCHMARK.json").read_text())
    for m in spec["per_layer"]:
        if m["name"].endswith(".offline_b16"):
            m["workloads"].append("tiny.alone")
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    if traffic:
        mix = json.loads((root / "bench/traffic/tiny.json").read_text())
        mix.update(traffic)
        (root / "bench/traffic/tiny.json").write_text(json.dumps(mix))
    return load_cell("tiny.alone", root)


def test_a_tiny_effnet_cell_runs_from_new_files(tmp_path, monkeypatch):
    monkeypatch.setattr(serve, "TRACE_S", 0.2)
    cell = effnet_cell(tmp_path)
    assert cell.config["model"] == "efficientnet_b4"
    out = run_cell(cell, 2 ** 31 + 41, 0.3, True, CPU, time.perf_counter())
    assert out["correct"] is True
    assert out["check"]["checked"]["value"] > 0
    # no device trace and no peaks on the CPU: the readers of the trace
    # and of the peaks find nothing to read and leave their metrics out;
    # the engine's and the runtime's read the run as the .offline ones do
    host = {f"{name}.offline_b16" for name in (
        "launches_per_req", "latency_p95_ms", "host_slot_ms",
        "queue_wait_ms")}
    assert set(out["metrics"]) == {"slots.tiny"} | host
    assert out["check"]["logit_err"]["value"] <= \
        out["check"]["logit_err"]["limit"]


def test_a_skipped_se_gate_makes_the_run_incorrect(tmp_path, monkeypatch):
    import repro_torch.kernels.se.ops as se_ops

    monkeypatch.setattr(se_ops, "se_scale", lambda h, gate: h)
    cell = effnet_cell(tmp_path)
    out = run_cell(cell, 2 ** 31 + 43, 0.3, False, CPU, time.perf_counter())
    assert out["correct"] is False
    value = out["check"]["logit_err"]["value"]
    assert value is None or value > out["check"]["logit_err"]["limit"]


class FakeRun:
    """What the new readers take from a traced run."""

    def __init__(self, cell, ops, device_s, served, kind):
        self.cell = cell
        self.summary = Summary(window_s=2.0, busy_s=1.9, device_s=device_s,
                               ops=ops, idle=[])
        self.trace = serve.Phase("trace", served=[object()] * served)
        self.kind = kind
        self.flops_per_request = 1e12
        self.bytes_per_request = 1e9


def test_se_readers_sum_the_se_kernels_by_name(tmp_path):
    cell = effnet_cell(tmp_path, batch=16)
    ops = [("void (anonymous namespace)::se_gate_kernel<4>(float const*)",
            0.02),
           ("void (anonymous namespace)::se_scale_kernel<4>(float*)", 0.03),
           ("matmul_bias_act_kernel<2, 4, 32>", 0.5)]
    kind = "NVIDIA H100 80GB HBM3"
    run = FakeRun(cell, ops, 1.0, 10, kind)
    part = lambda name: cell.part("metrics", name)  # noqa: E731
    assert part("se_device_pct.offline_b16").read(run) == \
        pytest.approx(5.0)
    ref = reference()
    flops, nbytes = ref.se_work(ref.layers(cell.config), 16)
    bound = max(flops / (495e12 / 3), nbytes / 3.35e12)
    assert part("se_roofline_pct.offline_b16").read(run) == \
        pytest.approx(bound / (0.05 / 10) * 100)
    # the readers of the .offline metrics read the same here
    for name in ("kernels_roofline_pct", "device_idle_pct"):
        assert part(f"{name}.offline_b16").read(run) == \
            part(f"{name}.offline").read(run)
    # no SE kernel among the slice's largest operations: nothing to read
    run = FakeRun(cell, ops[2:], 1.0, 10, kind)
    assert part("se_device_pct.offline_b16").read(run) is None
    assert part("se_roofline_pct.offline_b16").read(run) is None


@pytest.mark.parametrize("name", ["launches_per_req", "latency_p95_ms",
                                  "host_slot_ms", "queue_wait_ms"])
def test_the_engine_readers_read_as_the_offline_ones(tmp_path, name):
    cell = effnet_cell(tmp_path)
    run = SimpleNamespace(
        window=SimpleNamespace(served=[object()] * 4, launches=644, slots=8,
                               advance_s=0.02),
        latencies_s=[0.1, 0.2, 0.3, 0.5],
        done=[SimpleNamespace(sent=0.0, started=0.01 * i) for i in range(5)])
    got = cell.part("metrics", f"{name}.offline_b16").read(run)
    assert got is not None
    assert got == cell.part("metrics", f"{name}.offline").read(run)


def test_the_control_fails_the_limit_and_the_port_passes():
    """At 64 px on the CPU the control reads 1.3e-3 to 1.5e-3 and the
    port's plain path about 1.5e-6; on the card at 380 px the control
    read 2.0e-3 and more at every seed, the port's kernels at most
    2.7e-4 (``PERF.md`` §2)."""
    from repro_torch.dualcore.program import build_program

    cfg = config(image_px=64)
    ref = reference()
    table = ref.layers(cfg)
    forward = forward_of(ref)
    assert forward is ref.forward
    limit = cfg["limits"]["logit_err"]
    for seed in (1, 2, 3):
        params, pool = make_inputs(table, cfg, {"pool": 1, "batch": 2}, seed,
                                   CPU)
        want = reference_logits(forward, table, params, pool, [0])[0]
        control = reference_logits(forward, table, params, pool, [0],
                                   "tf32")[0]
        port = build_program(cfg["model"]).run(params, pool[0])
        assert logit_err(control, want) > limit
        assert logit_err(port, want) < limit / 10
