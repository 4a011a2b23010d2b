"""Fault-tolerant training runner.

Port of ``repro/train/runner.py``: the train step wrapped with the
machinery a long job needs, in the same loop:
  * periodic atomic checkpoints (step 0 and every ``ckpt_every``) and
    resume from the latest;
  * failure recovery: a step that raises (a device fault, an injected
    one) rolls back to the last checkpoint and replays; data is
    step-indexed, so the replay sees the same batches;
  * straggler accounting: a step longer than ``straggler_factor`` times
    the rolling median is counted.
The state lives on ``device`` (the card by default).  The reference's
``remesh`` re-shards the state onto a new TPU mesh between steps; one
card has no mesh, so it has no counterpart here.
"""
from __future__ import annotations

import dataclasses
import os
import statistics
import time

import torch

from repro_torch.data.pipeline import DataConfig, SyntheticLM
from repro_torch.kernels.util import resolve_device
from repro_torch.lm.config import ArchConfig
from repro_torch.lm.steps import (TrainState, make_init_state,
                                  make_train_step, state_shapes)
from repro_torch.train import checkpoint as ckpt
from repro_torch.train.optimizer import AdamW
from repro_torch.train.tree import leaves


@dataclasses.dataclass
class RunnerConfig:
    ckpt_dir: str
    ckpt_every: int = 50
    max_steps: int = 200
    microbatches: int = 1
    straggler_factor: float = 3.0
    max_retries: int = 3
    seed: int = 0


class FaultInjector:
    """Test hook: raise at chosen steps to exercise recovery."""

    def __init__(self, fail_at=()):
        self.fail_at = set(fail_at)
        self.fired = set()

    def maybe_fail(self, step: int):
        if step in self.fail_at and step not in self.fired:
            self.fired.add(step)
            raise RuntimeError(f"injected fault at step {step}")


class TrainRunner:
    def __init__(self, cfg: ArchConfig, rcfg: RunnerConfig,
                 optimizer: AdamW | None = None,
                 fault_injector: FaultInjector | None = None,
                 data_cfg: DataConfig | None = None,
                 device: str | torch.device = "cuda"):
        self.cfg = cfg
        self.rcfg = rcfg
        self.device = resolve_device(device)
        self.opt = optimizer or AdamW(total_steps=rcfg.max_steps)
        self.fault = fault_injector
        self.data_cfg = data_cfg or DataConfig(
            vocab=cfg.vocab, seq_len=64, global_batch=8, seed=rcfg.seed)
        self.data = SyntheticLM(self.data_cfg)
        self.train_step = make_train_step(cfg, self.opt, rcfg.microbatches)
        self.step_times: list[float] = []
        self.stragglers = 0
        self.recoveries = 0
        self.metrics_log: list[dict] = []
        #: each checkpoint written: step, host seconds, bytes
        self.saves: list[dict] = []
        #: the state after the last step run
        self.state: TrainState | None = None

    # ---- state ------------------------------------------------------------
    def init_state(self) -> TrainState:
        return make_init_state(self.cfg, self.opt, self.device)(
            self.rcfg.seed)

    def resume_or_init(self) -> tuple[TrainState, int]:
        last = ckpt.latest_step(self.rcfg.ckpt_dir)
        if last is None:
            return self.init_state(), 0
        state = ckpt.restore(self.rcfg.ckpt_dir, state_shapes(self.cfg),
                             device=self.device)
        return state, last

    def _save(self, state: TrainState, step: int) -> None:
        t0 = time.perf_counter()
        ckpt.save(self.rcfg.ckpt_dir, state, step)
        self.saves.append({
            "step": step, "seconds": time.perf_counter() - t0,
            "bytes": sum(t.numel() * t.element_size()
                         for t in leaves(state))})

    # ---- main loop --------------------------------------------------------
    def run(self, steps: int | None = None) -> dict:
        os.makedirs(self.rcfg.ckpt_dir, exist_ok=True)
        state, start = self.resume_or_init()
        if start == 0:
            self._save(state, 0)
        target = steps or self.rcfg.max_steps
        step = start
        retries = 0
        while step < target:
            batch = self.data.batch_at(step)
            t0 = time.perf_counter()
            try:
                if self.fault is not None:
                    self.fault.maybe_fail(step)
                state, metrics = self.train_step(state, batch)
                metrics = {k: float(v) for k, v in metrics.items()}
            except Exception:  # noqa: BLE001 — the node-failure path
                self.recoveries += 1
                retries += 1
                if retries > self.rcfg.max_retries:
                    raise
                state, step = self.resume_or_init()
                continue
            retries = 0
            dt = time.perf_counter() - t0
            self.step_times.append(dt)
            if len(self.step_times) >= 8:
                med = statistics.median(self.step_times[-32:])
                if dt > self.rcfg.straggler_factor * med:
                    self.stragglers += 1
            step += 1
            metrics["step"] = step
            metrics["step_time_s"] = dt
            self.metrics_log.append(metrics)
            if step % self.rcfg.ckpt_every == 0 or step == target:
                self._save(state, step)
        self.state = state
        return {"final_step": step,
                "final_loss": self.metrics_log[-1]["loss"]
                if self.metrics_log else None,
                "recoveries": self.recoveries,
                "stragglers": self.stragglers,
                "metrics": self.metrics_log}
