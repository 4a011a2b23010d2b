"""Dual-OPU instruction set + compiler (paper §VI-A a, modeled after OPU [14]).

The compiler lowers a scheduled group chain to a per-core instruction stream.
Instruction granularity is one memory block / one tile pass, which is what the
cycle-accurate simulator executes.  Instructions:

  LOAD   ifm/weight/bias block from DRAM into the ping or pong bank
  COMPUTE one (output-tile x reduction-tile) pass over a pixel block
  STORE  a ready ofm block back to DRAM (through the PP unit)
  SYNC   cross-core barrier at group boundaries (interleaved schedule slots)

Copy of ``repro/core/isa.py`` (the port imports nothing of ``repro``).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Iterable

from repro_torch.core.arch import BoardModel, CoreConfig
from repro_torch.core.graph import LayerSpec
from repro_torch.core.latency import compute_cycles, load_cycles
from repro_torch.core.scheduler import Schedule
from repro_torch.core.tiling import tile_layer


@dataclasses.dataclass(frozen=True)
class Instr:
    op: str              # LOAD | COMPUTE | STORE | SYNC
    layer: str
    cycles: int          # latency charged by the simulator
    bank: int = 0        # ping(0) / pong(1)
    meta: tuple = ()

    def __str__(self):
        return f"{self.op:<8}{self.layer:<24}{self.cycles:>10} cyc {self.meta}"


def compile_layer(layer: LayerSpec, core: CoreConfig,
                  board: BoardModel) -> list[Instr]:
    """Lower one layer to blocked LOAD/COMPUTE/STORE instructions.

    Loads are split per spatial block (Eq.4 blocks), computes per block too,
    so the simulator can overlap block k+1's load with block k's compute via
    the ping-pong banks — reproducing Eq.7's max(T_load, T_compute) plus the
    true pipeline fill/drain that the analytic model folds into L_dram/L_post.
    """
    t = tile_layer(layer, core)
    n_blocks = math.ceil(layer.H / t.T_h) * math.ceil(layer.W / t.T_w)
    total_compute, _ = compute_cycles(layer, core, board, t)
    total_load = load_cycles(layer, board)
    # Split totals evenly across blocks; remainders charged to block 0.
    per_block_c = (total_compute - board.l_post) // n_blocks
    per_block_l = (total_load - board.l_dram) // n_blocks
    rc = (total_compute - board.l_post) - per_block_c * n_blocks
    rl = (total_load - board.l_dram) - per_block_l * n_blocks
    instrs: list[Instr] = []
    for b in range(n_blocks):
        lc = per_block_l + (rl if b == 0 else 0) + (
            board.l_dram if b == 0 else 0)   # CAS charged on first burst
        cc = per_block_c + (rc if b == 0 else 0)
        instrs.append(Instr("LOAD", layer.name, lc, bank=b % 2,
                            meta=("block", b, n_blocks)))
        instrs.append(Instr("COMPUTE", layer.name, cc, bank=b % 2,
                            meta=("block", b, n_blocks)))
    instrs.append(Instr("STORE", layer.name, board.l_post,
                        meta=("drain",)))
    return instrs


def compile_group(layers: Iterable[LayerSpec], core: CoreConfig,
                  board: BoardModel) -> list[Instr]:
    out: list[Instr] = []
    for l in layers:
        out.extend(compile_layer(l, core, board))
    return out


def compile_schedule(schedule: Schedule) -> list[list[Instr]]:
    """Per-group instruction streams, in chain order."""
    return [compile_group(g.layers, schedule.cfg.core(g.core),
                          schedule.board)
            for g in schedule.groups]
