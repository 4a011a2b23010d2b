"""Latency model (paper §IV-B, Eq.5-7).

  Eq.5:  T_load    = ceil((H*W*C_i + K_h*K_w*C_i*C_o + C_o) / BW_dram) + L_dram
  Eq.6:  T_compute = passes * streamed-pixels + L_post
  Eq.7:  T_total   = sum_l max(T_compute^l, T_load^l)

The compiler overlaps load and compute through the ping-pong buffers, hence the
max() per layer.  ``T_compute`` streams one pixel-tile per cycle through the
deep MAC + post-processing pipeline; the pass count is the Eq.6 product of
channel/kernel tile counts and the pixel term is the Eq.4 padded block count.

This module is a pure function of (LayerSpec, CoreConfig, BoardModel) so the
scheduler, the branch-and-bound search and the instruction-level simulator all
share one latency definition.

Copy of ``repro/core/latency.py`` (the port imports nothing of ``repro``).
"""
from __future__ import annotations

import dataclasses
import math

from repro_torch.core.arch import BoardModel, CoreConfig
from repro_torch.core.graph import LayerSpec
from repro_torch.core.tiling import Tiling, tile_layer


@dataclasses.dataclass(frozen=True)
class LayerLatency:
    """Modelled load, compute and total cycles of one layer on one core."""
    layer: str
    core: str
    t_load: int
    t_compute: int
    tiling: Tiling
    macs: int

    @property
    def t_layer(self) -> int:
        """Eq.7 per-layer term."""
        return max(self.t_load, self.t_compute)

    @property
    def bound(self) -> str:
        """'memory' or 'compute': which of load and compute is longer."""
        return "memory" if self.t_load >= self.t_compute else "compute"

    def pe_efficiency(self, core: CoreConfig) -> float:
        """Runtime PE efficiency, Eq.1 with alpha*N_PE == n*v multipliers."""
        denom = core.n_mult * self.t_layer
        return self.macs / denom if denom else 0.0


def load_cycles(layer: LayerSpec, board: BoardModel) -> int:
    """Eq.5."""
    return math.ceil(layer.load_elems / board.bw_dram) + board.l_dram


def compute_cycles(layer: LayerSpec, core: CoreConfig, board: BoardModel,
                   tiling: Tiling | None = None) -> tuple[int, Tiling]:
    """Eq.6 with the streaming interpretation (see tiling.py docstring)."""
    t = tiling if tiling is not None else tile_layer(layer, core)
    if layer.op == "dwconv":
        ch_tiles = math.ceil(layer.C_i / t.T_co)
        win_tiles = (math.ceil(layer.K_h / t.T_kh)
                     * math.ceil(layer.K_w / t.T_kw))
        if not core.has_line_buffer:
            # One useful multiplier per PE: every kernel tap is a pass.
            win_tiles = layer.K_h * layer.K_w
        passes = ch_tiles * win_tiles
    else:
        passes = t.passes(layer)
    cycles = passes * t.spatial_cycles(layer) + board.l_post
    return cycles, t


def layer_latency(layer: LayerSpec, core: CoreConfig,
                  board: BoardModel) -> LayerLatency:
    """Modelled latency of ``layer`` on ``core`` (Eq.3-7)."""
    t_c, tiling = compute_cycles(layer, core, board)
    return LayerLatency(layer=layer.name, core=core.kind,
                        t_load=load_cycles(layer, board),
                        t_compute=t_c, tiling=tiling, macs=layer.macs)


def total_latency(layers, core: CoreConfig, board: BoardModel) -> int:
    """Eq.7 over a sequence of layers on a single core."""
    return sum(layer_latency(l, core, board).t_layer for l in layers)


def graph_latency_report(layers, core: CoreConfig, board: BoardModel):
    """Per-layer latency + Eq.1 efficiency (reproduces Fig.1 curves)."""
    rows = [layer_latency(l, core, board) for l in layers]
    total = sum(r.t_layer for r in rows)
    total_macs = sum(r.macs for r in rows)
    overall_eff = total_macs / (core.n_mult * total) if total else 0.0
    return rows, total, overall_eff


def compute_lower_bound(layer: LayerSpec, n_dsp_core: float,
                        board: BoardModel, alpha: int = 2) -> float:
    """Eq.11: ideal compute latency ignoring tiling mismatch.

    T_compute^lb = (C_o*H*W*C_i*K_h*K_w * 2) / (alpha * N_DSP^core) + L_post
    (the *2 and /alpha cancel into MACs / multipliers; kept explicit to mirror
    the paper's formula).  For depthwise conv the MAC count has no C_o factor.
    """
    if n_dsp_core <= 0:
        return float("inf")
    ops = 2.0 * layer.macs                      # MAC -> 2 ops, as in Eq.11
    return ops / (alpha * n_dsp_core) + board.l_post
