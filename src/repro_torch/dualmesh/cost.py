"""Roofline cost model for LM serving stages on a CUDA card.

Port of ``repro/dualmesh/cost.py`` (the paper's Eq.5-7 latency model
re-targeted to LM stages).  A stage costs the max of three terms:

    t_compute    = stage FLOPs / (chips * peak)
    t_memory     = device-memory bytes touched / (chips * mem_bw)
    t_collective = TP-collective bytes / (chips * link_bw)

The formulas are the reference's.  The reference's TPU constants give way
to :class:`CardModel`, whose defaults are an NVIDIA H100 SXM's; each names
its source.  The reference counts 2 bytes (bf16) for every weight,
activation, KV and collective element; here each counts
``CardModel.elem_bytes``, 4 by default because the port serves f32 (2
gives the reference's numbers).
"""
from __future__ import annotations

import dataclasses
import math

from repro_torch.lm.config import ArchConfig


@dataclasses.dataclass(frozen=True)
class CardModel:
    """One CUDA card, as the stage model sees it."""

    # H100 SXM data sheet: 67 TFLOP/s f32 on the CUDA cores; the port's
    # projections are f32 matmuls with TF32 off
    peak_flops: float = 67e12
    # H100 SXM data sheet: HBM3 at 3.35 TB/s
    mem_bw: float = 3.35e12
    # H100 SXM data sheet: NVLink 900 GB/s, 450 GB/s each way (one card
    # has no TP collective, so this term is 0 on the served path)
    link_bw: float = 450e9
    # achievable fractions of peak, measured by chip_smoke.py on an NVIDIA
    # H100 80GB HBM3 at 700 W (PERF.md, section 6): an f32 matmul of the
    # prefill's up projection (1024 x 896 @ 896 x 4864) at 39.26 TFLOP/s,
    # and a 1 GiB device copy at 3.031 TB/s
    mfu_ceiling: float = 0.586
    bw_ceiling: float = 0.905
    # Per-decode-step floor: the reference's dispatch + collective + DP
    # sync term, which makes decode prefer large fused groups.  On one card
    # it is what the serving loop waits a step: chip_smoke.py measured 5.387
    # ms of host enqueue per Qwen2-0.5B decode step (24 layers) replayed
    # from a CUDA graph, on an NVIDIA H100 80GB HBM3 at 700 W (PERF.md,
    # section 6); the formula charges n_layers * base / 4 a step, so
    # base = 4 * 5.387 ms / 24.  With graphs that enqueue waits on the
    # card's full launch queue, so it stands for the step's time on the
    # card (6.35 ms on its stream, against 0.72 ms of f32 bytes in this
    # model); the launch alone, 0.409 ms of host time, would give 6.82e-5,
    # and the planner would then size groups by the 0.72 ms alone (2, not
    # 8, for the path's 8 requests).  Eager launches, 16.738 ms a step,
    # gave 2.79e-3 before decode steps were graphs.  The TP and DP parts
    # have no card number: one card has no TP or DP group (ROADMAP).
    step_floor_base: float = 8.978e-4
    step_floor_tp: float = 0.0     # x log2(tp)
    step_floor_dp: float = 0.0     # x log2(chips / tp)
    # bytes of one served element (weights, activations, KV cache): the
    # port's parameters and cache are float32
    elem_bytes: int = 4
    # How a core holding a share s of the card's SMs sees the card (see
    # ``share``): peak_flops * s ** flops_share_exp and mem_bw * s **
    # bw_share_exp.  Both fitted to chip_smoke.py on an NVIDIA H100 80GB
    # HBM3 at 700 W, split at theta 0.5 (PERF.md, sections 5 and 6).
    # Compute: a Qwen2-0.5B prefill (2 x 512) took 41.3-41.6 ms on the
    # c-core's 64 SMs against 23.7 on all 132, 1.75x where a linear law
    # gives 2.06x: ln(41.45 / 23.7) / ln(132 / 64).  Memory: a decode step
    # of 16 rows, its HBM-bound f32 projections most of it, took 7.53 ms on
    # the p-core's 68 SMs against 6.22, 1.21x: ln(7.53 / 6.22) / ln(132 /
    # 68).  The step floor stands for that step's time and scales with it.
    flops_share_exp: float = 0.772
    bw_share_exp: float = 0.288
    # H100 SXM data sheet: 80 GB of HBM3 and 132 SMs.  A plan for the card
    # in hand takes the card's own (``dualmesh.search.card_model``:
    # ``torch.cuda.get_device_properties``' ``total_memory`` and
    # ``multi_processor_count``)
    mem_bytes: int = 80 * 10 ** 9
    sm_count: int = 132

    def share(self, fraction: float) -> "CardModel":
        """The card as a core holding ``fraction`` of its SMs sees it: the
        compute peak, the memory rate and the decode step floor scaled by
        the fitted laws above.  ``fraction`` 1.0 (the whole card: no split,
        or the CPU) returns this model unchanged."""
        if not 0.0 < fraction <= 1.0:
            raise ValueError(f"an SM share lies in (0, 1], got {fraction}")
        if fraction == 1.0:
            return self
        bw = fraction ** self.bw_share_exp
        return dataclasses.replace(
            self, peak_flops=self.peak_flops * fraction
            ** self.flops_share_exp,
            mem_bw=self.mem_bw * bw,
            step_floor_base=self.step_floor_base / bw)

    def step_floor(self, chips: int, tp: int) -> float:
        """Latency floor of one decode step on ``chips`` with TP ``tp``."""
        tp = max(1, tp)
        dp = max(1, chips // tp)
        t = self.step_floor_base
        if tp > 1:
            t += self.step_floor_tp * math.log2(tp)
        if dp > 1:
            t += self.step_floor_dp * math.log2(dp)
        return t


@dataclasses.dataclass(frozen=True)
class StageCost:
    """The three terms of one stage, in seconds."""

    t_compute: float
    t_memory: float
    t_collective: float

    @property
    def latency(self) -> float:
        """max() of the three (the paper's Eq.7 discipline)."""
        return max(self.t_compute, self.t_memory, self.t_collective)

    @property
    def bound(self) -> str:
        """The term that sets the latency."""
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)


def _weight_bytes(cfg: ArchConfig, hw: CardModel,
                  active: bool = True) -> float:
    n = cfg.active_param_count() if active else cfg.param_count()
    return float(hw.elem_bytes) * n


def prefill_cost(cfg: ArchConfig, batch: int, seq: int, chips: int,
                 hw: CardModel = CardModel(), tp: int = 8) -> StageCost:
    """Process ``batch`` prompts of ``seq`` tokens on ``chips`` devices."""
    tokens = batch * seq
    flops = 2.0 * cfg.active_param_count() * tokens
    if cfg.block_type == "transformer":
        flops += 4.0 * cfg.n_layers * batch * seq * seq * cfg.q_dim / 2
    t_c = flops / (chips * hw.peak_flops * hw.mfu_ceiling)
    act = 2.0 * tokens * cfg.d_model * hw.elem_bytes * cfg.n_layers
    t_m = (_weight_bytes(cfg, hw) / max(1, chips) + act / chips) \
        / (hw.mem_bw * hw.bw_ceiling)
    coll = 2.0 * cfg.n_layers * tokens * cfg.d_model * hw.elem_bytes \
        * (tp - 1) / tp
    t_x = coll / (chips * hw.link_bw)
    return StageCost(t_c, t_m, t_x)


def decode_cost(cfg: ArchConfig, batch: int, kv_len: int, chips: int,
                steps: int = 1, hw: CardModel = CardModel(),
                tp: int = 8) -> StageCost:
    """Generate ``steps`` tokens for ``batch`` sequences with a ``kv_len``
    cache."""
    flops = 2.0 * cfg.active_param_count() * batch * steps
    if cfg.block_type == "transformer":
        flops += 4.0 * cfg.n_layers * batch * kv_len * cfg.q_dim * steps
    t_c = flops / (chips * hw.peak_flops * hw.mfu_ceiling)
    kv = 0.0
    if cfg.block_type == "transformer" or cfg.attn_every:
        layers = (cfg.n_layers if cfg.block_type == "transformer"
                  else cfg.n_layers // max(1, cfg.attn_every))
        kv = 2.0 * layers * batch * cfg.n_kv_heads * cfg.d_head * kv_len \
            * hw.elem_bytes
    if cfg.block_type in ("mamba2", "mlstm"):
        din = cfg.d_inner
        state = cfg.n_layers * batch * cfg.ssm_heads * \
            (din // cfg.ssm_heads) * max(cfg.ssm_state, 1) * 4
        kv += state
    t_m = steps * (_weight_bytes(cfg, hw) + kv) / (chips * hw.mem_bw
                                                   * hw.bw_ceiling)
    coll = 2.0 * cfg.n_layers * batch * cfg.d_model * hw.elem_bytes \
        * (tp - 1) / tp * steps
    t_x = coll / (chips * hw.link_bw)
    floor = steps * cfg.n_layers * hw.step_floor(chips, tp) / 4
    return StageCost(t_c, max(t_m, floor), t_x)
