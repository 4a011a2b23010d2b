"""Cycle-accurate instruction-level simulator (paper §VI-A d, Table IV).

Executes the compiled instruction streams on a machine model with, per core:
a DRAM load engine and a compute+PP engine connected by ping-pong buffers.
A COMPUTE on bank b may start once the LOAD into bank b has finished and the
previous COMPUTE has drained; a LOAD into bank b may start once the COMPUTE
that last read bank b has finished (double-buffer hazard).  This reproduces
Eq.7's max(T_load, T_compute) overlap plus true fill/drain effects.

For the dual-core interleaved schedule, two streams advance through the group
chain offset by one slot (Fig.4b); a SYNC barrier at every slot boundary
models the data hand-off between cores.

Copy of ``repro/core/simulator.py`` (the port imports nothing of ``repro``).
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

from repro_torch.core.arch import BoardModel, CoreConfig
from repro_torch.core.graph import LayerGraph
from repro_torch.core.isa import Instr, compile_group, compile_schedule
from repro_torch.core.scheduler import Schedule


@dataclasses.dataclass
class SimTrace:
    cycles: int
    instr_count: int
    busy_cycles: dict[str, int]          # per engine
    per_layer: dict[str, int]

    def pe_efficiency(self, macs: int, n_mult: int) -> float:
        return macs / (n_mult * self.cycles) if self.cycles else 0.0


def run_stream(instrs: Sequence[Instr], board: BoardModel,
               start_cycle: int = 0) -> SimTrace:
    """Simulate one core executing one instruction stream."""
    load_free = start_cycle       # when the load engine is next available
    comp_free = start_cycle
    bank_loaded = [start_cycle, start_cycle]   # LOAD completion per bank
    bank_released = [start_cycle, start_cycle]  # last COMPUTE read done
    busy = {"load": 0, "compute": 0}
    per_layer: dict[str, int] = {}
    t_end = start_cycle
    layer_start: dict[str, int] = {}
    for ins in instrs:
        if ins.op == "LOAD":
            begin = max(load_free, bank_released[ins.bank])
            end = begin + ins.cycles
            load_free = end
            bank_loaded[ins.bank] = end
            busy["load"] += ins.cycles
        elif ins.op == "COMPUTE":
            begin = max(comp_free, bank_loaded[ins.bank])
            end = begin + ins.cycles
            comp_free = end
            bank_released[ins.bank] = end
            busy["compute"] += ins.cycles
        elif ins.op == "STORE":
            begin = comp_free
            end = begin + ins.cycles
            comp_free = end
            busy["compute"] += ins.cycles
        else:  # SYNC: the barriers are simulate_dual_core's slots
            continue
        t_end = max(t_end, end)
        layer_start.setdefault(ins.layer, begin)
        per_layer[ins.layer] = end - layer_start[ins.layer]
    return SimTrace(cycles=t_end - start_cycle, instr_count=len(instrs),
                    busy_cycles=busy, per_layer=per_layer)


def simulate_single_core(graph: LayerGraph, core: CoreConfig,
                         board: BoardModel) -> SimTrace:
    """One image through one core, layers in topological order (the P(128,9)
    baseline of Tables IV/VI)."""
    instrs = compile_group(graph.topological_order(), core, board)
    return run_stream(instrs, board)


@dataclasses.dataclass
class DualSimResult:
    cycles_two_images: int
    slot_latencies: list[int]
    fps: float
    pe_efficiency: float


def simulate_dual_core(schedule: Schedule) -> DualSimResult:
    """Two interleaved images through the dual-core schedule (Fig.4b).

    Slot k runs stream-A group k and stream-B group k-1 concurrently on
    different cores, with a barrier between slots (the hand-off of feature
    maps between cores goes through DRAM, which the per-group instruction
    streams already charge).  Optionally halves effective DRAM bandwidth
    while both cores are active (board.dram_contention).
    """
    board = schedule.board
    group_instrs = compile_schedule(schedule)
    n = len(group_instrs)
    slot_lat: list[int] = []
    contention = 1.3 if board.dram_contention else 1.0
    for k in range(n + 1):
        a = run_stream(group_instrs[k], board).cycles if k < n else 0
        b = run_stream(group_instrs[k - 1], board).cycles if k >= 1 else 0
        both = a > 0 and b > 0
        lat = max(a, b)
        if both and board.dram_contention:
            lat = int(lat * contention)
        slot_lat.append(lat)
    total = sum(slot_lat)
    macs = 2 * sum(l.macs for g in schedule.groups for l in g.layers)
    peak = schedule.cfg.c.n_mult + schedule.cfg.p.n_mult
    return DualSimResult(
        cycles_two_images=total,
        slot_latencies=slot_lat,
        fps=2 * board.freq_mhz * 1e6 / total if total else float("inf"),
        pe_efficiency=macs / (peak * total) if total else 0.0)
