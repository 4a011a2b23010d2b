"""Hardware model of the dual-OPU (paper §III).

A *core* is an ``(n, v)`` PE array: ``n`` PEs, each an inner product over ``v``
multipliers reduced by a balanced adder tree, followed by configurable adders
that produce 2..n accumulated outputs per cycle (paper §III-B).  DSP macros are
decomposed into two 8-bit multipliers sharing one input (alpha = 2, Eq.8):
  * c-core: two multipliers share one ifm pixel, produce two output channels.
  * p-core: two pixels share one weight (needs double ifm buffers + line buffer).

The board model carries the calibrated DRAM constants of Eq.5 and the FPGA
resource budget used by the search (§V-B, Table II).

Copy of ``repro/core/arch.py`` (the port imports nothing of ``repro``).
"""
from __future__ import annotations

import dataclasses


ALPHA = 2  # MACs per DSP macro per cycle (one DSP48E1 -> two 8-bit multipliers)

# Paper §V-B2: candidate values of v for the local search.  "Prime numbers are
# excluded since common channel numbers are not multiple of prime numbers."
V_CANDIDATES = (8, 9, 10, 12, 14, 15, 16, 18)


@dataclasses.dataclass(frozen=True)
class CoreConfig:
    """One core: C(n, v) or P(n, v) (paper notation, §VI-A)."""

    kind: str  # 'c' (channel-parallel) or 'p' (pixel-parallel, line buffer)
    n: int     # N_PE
    v: int     # N_vector (multipliers per PE)

    def __post_init__(self):
        if self.kind not in ("c", "p"):
            raise ValueError(f"core kind must be 'c' or 'p', got {self.kind!r}")
        if self.n < 1 or self.v < 1:
            raise ValueError(f"invalid PE config ({self.n},{self.v})")

    @property
    def has_line_buffer(self) -> bool:
        """True for the p-core, which streams through a line buffer."""
        return self.kind == "p"

    @property
    def n_mult(self) -> int:
        """Total 8-bit multipliers == peak MACs per cycle."""
        return self.n * self.v

    @property
    def n_dsp(self) -> int:
        """Eq.8: N_DSP = ceil(n / alpha) * v."""
        return -(-self.n // ALPHA) * self.v

    @property
    def buffer_depth(self) -> int:
        """ifm buffer depth (T_h*T_w capacity).  Scales with the PE count:
        'P(64,9) has half multipliers, buffer depth and line buffer channels
        of P(128,9)' (§VI-A c); P(128,9) carries depth 4096."""
        return max(512, 4096 * self.n // 128)

    def __str__(self) -> str:
        return f"{self.kind.upper()}({self.n},{self.v})"


@dataclasses.dataclass(frozen=True)
class DualCoreConfig:
    """Heterogeneous dual-OPU: one c-core + one p-core (paper Fig.2)."""

    c: CoreConfig
    p: CoreConfig

    def __post_init__(self):
        if self.c.kind != "c" or self.p.kind != "p":
            raise ValueError("DualCoreConfig wants (c-core, p-core)")

    @property
    def n_dsp(self) -> int:
        """DSPs of both cores."""
        return self.c.n_dsp + self.p.n_dsp

    def core(self, which: str) -> CoreConfig:
        """The c-core or the p-core config."""
        return self.c if which == "c" else self.p

    def theta(self, dsp_budget: int) -> float:
        """Eq.10: c-core share of the DSP budget."""
        return self.c.n_mult / (ALPHA * dsp_budget)

    def __str__(self) -> str:
        return f"{self.c}+{self.p}"


@dataclasses.dataclass(frozen=True)
class BoardModel:
    """Calibrated board constants (paper §IV-B: L_dram / L_post are 'average
    values based on multiple execution traces on FPGA'; unpublished, so we
    calibrate them against Table IV and record the values in EXPERIMENTS.md).

    ``bw_dram`` is in 8-bit elements per cycle (PE precision is Int8,
    Table VIII), i.e. bytes/cycle.  XCK325T DDR3 @200 MHz core clock gives
    a theoretical 64 B/cycle; the effective value is calibrated.
    """

    freq_mhz: float = 200.0
    # Calibrated against Table IV board cycle counts (see EXPERIMENTS.md):
    # bw=21 B/cycle (4.2 GB/s effective DDR3), L_dram=250, L_post=150 give
    # MobileNet v1 +0.26%, v2 -0.84%, SqueezeNet +2.49% vs the paper's board.
    bw_dram: int = 21        # elements (bytes) per cycle, Eq.5 denominator
    l_dram: int = 250        # CAS-latency pipeline term of Eq.5 (cycles)
    l_post: int = 150        # post-processing drain term of Eq.6 (cycles)
    # When True the simulator halves effective per-core DRAM bandwidth while
    # both cores load concurrently.  The paper does not model contention
    # (loads are independent per-core buffers); keep False for fidelity.
    dram_contention: bool = False

    def cycles_to_seconds(self, cycles: float) -> float:
        """Seconds taken by ``cycles`` at the board clock."""
        return cycles / (self.freq_mhz * 1e6)

    def fps(self, cycles_per_image: float) -> float:
        """Images per second at ``cycles_per_image``."""
        if cycles_per_image <= 0:
            return float("inf")
        return self.freq_mhz * 1e6 / cycles_per_image


@dataclasses.dataclass(frozen=True)
class ResourceBudget:
    """FPGA resource upper bounds (Table II constraints).

    Defaults are the Xilinx Kintex-7 XCK325T used by the paper (Table VIII):
    203,800 LUTs / 407,600 FFs / 840 DSP48E1 / 890 RAMB18K.
    """

    n_dsp: int = 840
    n_bram18k: int = 890
    n_lut: int = 203_800
    n_ff: int = 407_600

    def fits(self, dsp: int, bram: int, lut: int, ff: int) -> bool:
        """True when the resources fit the board."""
        return (dsp <= self.n_dsp and bram <= self.n_bram18k
                and lut <= self.n_lut and ff <= self.n_ff)


# Published configurations from the paper (used in tests / benchmarks).
P128_9 = CoreConfig("p", 128, 9)                       # single-core baseline
DUAL_BASELINE = DualCoreConfig(CoreConfig("c", 128, 8), CoreConfig("p", 64, 9))
DUAL_MBV1 = DualCoreConfig(CoreConfig("c", 128, 12), CoreConfig("p", 8, 16))
DUAL_MBV2 = DualCoreConfig(CoreConfig("c", 160, 8), CoreConfig("p", 48, 8))
DUAL_SQZ = DualCoreConfig(CoreConfig("c", 130, 8), CoreConfig("p", 64, 10))
DUAL_MULTI = DualCoreConfig(CoreConfig("c", 128, 10), CoreConfig("p", 32, 12))
