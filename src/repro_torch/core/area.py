"""FPGA resource model (paper §IV-C, Eq.8, Tables I & III).

Component constants are reverse-engineered from the paper's own numbers:

* Table III gives exact component LUT costs:
    - multipliers: P(64,9) -> 40,896 / 576 mult = 71.0 LUT-equiv per 8-bit
      multiplier; C(128,8) -> 72,704 / 1024 = 71.0.  (Used for *equivalent
      area* comparisons; real multipliers are DSP.)
    - adders: with count = n*(v-1) tree adders + (n-1) output accumulators,
      P(64,9): 17,859 / 575 = 31.06 LUT;  C(128,8): 31,749 / 1023 = 31.04.
      We use 31.05 — both match within 0.1%.
    - line buffer: P(64,9) has a 128-channel line buffer (2n channels, for the
      double-pixel ifm buffers) of length T_w*(T_kh-1)+T_kw = 224*2+3 = 451
      taps: 39,868 / 128 = 311.5 LUT/channel -> 0.6907 LUT per (channel*tap).
* Table I anchors the invariants for a full core (P(128,9) + buffers):
    LUT 137,149 / FF 234,046 / DSP 577 / BRAM 237.
  With the component constants above, the P(128,9) variants are
  adders (128*8+127)*31.05 = 35,734 and line buffer 256ch*311.5 = 79,744,
  leaving INVARIANT_LUT ~= 21,670 (memory controller + decoder + PP unit).

DSP:  Eq.8,  N_DSP = ceil(n/alpha)*v  (+1 invariant DSP in the PP unit,
      which makes P(128,9) = 64*9+1 = 577, matching Tables I/IV/VI exactly).
BRAM: RAMB18K counting over the configurable width x depth modes
      {36x512, 18x1k, 9x2k, 4x4k, 2x8k, 1x16k} with width-priority
      (paper: "minimum number of RAMB18K in term of width size").

Copy of ``repro/core/area.py`` (the port imports nothing of ``repro``).
"""
from __future__ import annotations

import dataclasses
import math

from repro_torch.core.arch import CoreConfig, DualCoreConfig

# Component constants (see module docstring for derivation).
MULT_LUT_EQUIV = 71.0          # Table III: LUT-equivalent of one 8-bit mult
ADDER_LUT = 31.05              # Table III: per adder (tree + accumulators)
LB_LUT_PER_CH_TAP = 0.6907     # Table III: line buffer LUT per channel*tap
LB_DEFAULT_TAPS = 451          # T_w*(T_kh-1)+T_kw for 224-wide ifm, 3x3 window
INVARIANT_LUT = 21_670         # Table I residual (mem ctrl, decoder, PP)
INVARIANT_DSP = 1              # Table I: 577 = 64*9 + 1
# FF constants calibrated so P(128,9)+buffers ~= 234,046 (Table I).
FF_PER_ADDER = 36.0
FF_PER_MULT_PIPE = 16.0
FF_PER_DELAYER = 16.0          # register insertion when v is not a power of 2
INVARIANT_FF = 172_130

RAMB18K_MODES = ((36, 512), (18, 1024), (9, 2048), (4, 4096),
                 (2, 8192), (1, 16384))
BASE_BUFFER_DEPTH = 4096       # P(128,9) ifm buffer depth; scales with n/128


def count_ramb18k(width_bits: int, depth: int) -> int:
    """Min RAMB18K for one bank, trying every width x depth mode with
    width-priority (fewest units across the width dimension first)."""
    if width_bits <= 0 or depth <= 0:
        return 0
    best = None
    for w, d in RAMB18K_MODES:
        cnt = math.ceil(width_bits / w) * math.ceil(depth / d)
        key = (math.ceil(width_bits / w), cnt)
        if best is None or key < best[0]:
            best = (key, cnt)
    # width-priority: among modes, min width-units; ties -> min total.
    return best[1]


@dataclasses.dataclass(frozen=True)
class CoreArea:
    dsp: int
    bram18k: int
    lut: int
    ff: int
    lut_equiv: float   # "equivalent LUT cost" of the PE structure (Table III)

    def __add__(self, other: "CoreArea") -> "CoreArea":
        return CoreArea(self.dsp + other.dsp, self.bram18k + other.bram18k,
                        self.lut + other.lut, self.ff + other.ff,
                        self.lut_equiv + other.lut_equiv)


def adder_count(core: CoreConfig) -> int:
    """n*(v-1) balanced-tree adders + (n-1) output accumulators."""
    return core.n * (core.v - 1) + (core.n - 1)


def line_buffer_channels(core: CoreConfig) -> int:
    """p-core line buffer spans 2n channels (double ifm buffers feed two
    sliding-window pixel groups, §III-B / §VI-A)."""
    return 2 * core.n if core.has_line_buffer else 0


def pe_structure_lut_equiv(core: CoreConfig,
                           lb_taps: int = LB_DEFAULT_TAPS) -> dict:
    """Table III decomposition: line buffer / multipliers / adders."""
    lb = line_buffer_channels(core) * LB_LUT_PER_CH_TAP * lb_taps
    mult = core.n_mult * MULT_LUT_EQUIV
    add = adder_count(core) * ADDER_LUT
    return {"line_buffer": lb, "multipliers": mult, "adders": add,
            "total": lb + mult + add}


def buffer_bram(core: CoreConfig) -> int:
    """RAMB18K for ifm / weight / output buffers (§IV-C b).

    ifm: ping-pong (x2), doubled again on p-core (double ifm buffers);
         width 32 elements x 8 bit, depth scales with n (P(64,9) has half the
         buffer depth of P(128,9), §VI-A).
    weights: ping-pong, width v elements, depth 1024.
    ofm: ping-pong, 36-bit accumulators, same depth as ifm.
    Bias lives in logic (paper: "bias amount is usually small").
    """
    depth = max(512, BASE_BUFFER_DEPTH * core.n // 128)
    ifm_banks = 2 * (2 if core.has_line_buffer else 1)
    ifm = ifm_banks * count_ramb18k(32 * 8, depth)
    wgt = 2 * count_ramb18k(core.v * 8, 1024)
    ofm = 2 * count_ramb18k(36, depth)
    return ifm + wgt + ofm


def core_area(core: CoreConfig, include_invariant: bool = False,
              lb_taps: int = LB_DEFAULT_TAPS) -> CoreArea:
    adders = adder_count(core)
    lb_ch = line_buffer_channels(core)
    lut = adders * ADDER_LUT + lb_ch * LB_LUT_PER_CH_TAP * lb_taps
    delayers = core.n if (core.v & (core.v - 1)) else 0   # v not power of 2
    ff = (adders * FF_PER_ADDER + core.n_mult * FF_PER_MULT_PIPE
          + delayers * FF_PER_DELAYER)
    dsp = core.n_dsp
    bram = buffer_bram(core)
    if include_invariant:
        lut += INVARIANT_LUT
        ff += INVARIANT_FF
        dsp += INVARIANT_DSP
    eq = pe_structure_lut_equiv(core, lb_taps)["total"]
    return CoreArea(dsp=int(dsp), bram18k=int(bram), lut=int(round(lut)),
                    ff=int(round(ff)), lut_equiv=eq)


def dual_core_area(cfg: DualCoreConfig) -> CoreArea:
    """Total area of a dual-OPU design: both cores + one set of invariants
    (shared memory controller / decoder / post-processing, §IV-C).  The DSP
    column counts PE DSPs only, matching Table VI/VIII "Allocated DSP"
    (832 = C(128,12)+P(8,16), 840 = C(130,8)+P(64,10))."""
    a = core_area(cfg.c) + core_area(cfg.p)
    return CoreArea(a.dsp, a.bram18k,
                    a.lut + INVARIANT_LUT, a.ff + INVARIANT_FF, a.lut_equiv)


def fits_budget(cfg, budget: ResourceBudget) -> bool:
    a = dual_core_area(cfg) if isinstance(cfg, DualCoreConfig) \
        else core_area(cfg, include_invariant=True)
    return budget.fits(a.dsp, a.bram18k, a.lut, a.ff)
