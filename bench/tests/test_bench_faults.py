"""The output check against the faults a served CNN can have and against
its control, on the CPU at a size a test run holds.

Each fault is planted in the program's timed path (the runner's exec
groups) and a whole run is driven past the card check; ``correct`` has to
come out false.  A run without a fault has to come out true.  The control,
the reference computed in TF32, has to read above each configuration's
limit, and the port's own plain path below it."""
from __future__ import annotations

import json
import time
from pathlib import Path

import pytest
import torch

from bench.harness.cell import Cell, load_file
from bench.harness.check import forward_of, logit_err, reference_logits
from bench.harness.inputs import make_inputs
from bench.harness.measure import run_cell

BENCH = Path(__file__).resolve().parents[1]


def tiny_cell(config: str, image_px: int = 32) -> Cell:
    cfg = json.loads((BENCH / "configs" / f"{config}.json").read_text())
    cfg["image_px"] = image_px
    mix = {"loop": "closed", "clients": 4, "batch": 2, "pool": 4,
           "latency_cap_s": 10.0}
    return Cell(root=BENCH.parent, name=f"tiny.{config}", chips=1,
                config=cfg, traffic=mix, end_to_end=[], per_layer=[])


def shape_keeping_group(runner) -> int:
    """An exec group whose output env has its input's shapes."""
    env = {"h": torch.zeros(2, 32, 32, 3)}
    for gi in range(len(runner.groups)):
        out = runner._eager(gi, env)
        if gi and {k: v.shape for k, v in out.items()} == \
                {k: v.shape for k, v in env.items()}:
            return gi
        env = out
    raise AssertionError("no exec group keeps its input's shapes")


def plant(monkeypatch, fault: str) -> None:
    from repro_torch.dualcore.runtime import DualCoreRunner

    eager = DualCoreRunner._eager

    def faulty(self, gi, env, at=None):
        if fault == "state_unchanged":
            if not hasattr(self, "_skip"):
                self._skip = -1
                self._skip = shape_keeping_group(self)
            if gi == self._skip:
                return dict(env)
        out = eager(self, gi, env, at)
        if gi == len(self.groups) - 1 and fault != "state_unchanged":
            y = out["out"].clone()
            n = y.shape[0]
            if fault == "half_batch":
                y[n // 2:] = y[:n - n // 2]
            elif fault == "answer_altered":
                y[0, 0] += 1e-2 * y[0].pow(2).mean().sqrt()
            out["out"] = y
        return out

    monkeypatch.setattr(DualCoreRunner, "_eager", faulty)


def run(config: str) -> dict:
    return run_cell(tiny_cell(config), 2 ** 31 + 5, 0.3, False,
                    torch.device("cpu"), time.perf_counter())


@pytest.mark.parametrize("config", ["mobilenet_v2", "mobilenet_v1"])
def test_a_sound_run_is_correct(config):
    out = run(config)
    assert out["correct"] is True
    assert out["check"]["checked"]["value"] > 0


@pytest.mark.parametrize("fault", ["state_unchanged", "half_batch",
                                   "answer_altered"])
def test_a_planted_fault_makes_the_run_incorrect(monkeypatch, fault):
    plant(monkeypatch, fault)
    out = run("mobilenet_v1")
    assert out["correct"] is False
    value = out["check"]["logit_err"]["value"]
    assert value is None or value > out["check"]["logit_err"]["limit"]


@pytest.mark.parametrize("config", ["mobilenet_v2", "mobilenet_v1"])
def test_the_control_fails_the_limit_and_the_port_passes(config):
    from repro_torch.dualcore.program import build_program

    cell = tiny_cell(config, image_px=64)
    cfg = cell.config
    reference = load_file(BENCH / "reference" / f"{cfg['reference']}.py")
    table = reference.layers(cfg)
    forward = forward_of(reference)
    limit = cfg["limits"]["logit_err"]
    for seed in (1, 2, 3):
        params, pool = make_inputs(table, cfg, cell.traffic, seed,
                                   torch.device("cpu"))
        ref = reference_logits(forward, table, params, pool, [0])[0]
        control = reference_logits(forward, table, params, pool, [0],
                                   "tf32")[0]
        port = build_program(cfg["model"]).run(params, pool[0])
        assert logit_err(control, ref) > 2 * limit
        assert logit_err(port, ref) < limit / 10
