"""Tile sizing (paper §IV-A, Eq.2-4).

Given a PE configuration ``(n, v)`` and a layer, pick
``(T_kh, T_kw, T_ci, T_co, T_h, T_w)`` such that

  Eq.2:  T_kh * T_kw * T_ci * T_co = n * v,   T_kh * T_kw * T_ci = i * v
  Eq.3:  i minimizes ceil(C_o/T_co) * ceil(C_i*K_h*K_w / (T_ci*T_kh*T_kw))
  Eq.4:  (T_h, T_w) maximize buffer utilisation
         H*W / (ceil(H/T_h) * ceil(W/T_w) * T_h * T_w)
         (the paper prints argmin of the inverse ratio; the intent — minimise
          padded pixels — is an argmax of utilisation, which we implement)

Core-type rules (paper §III-B):
  * c-core has no line buffer  ->  T_kh = T_kw = 1 always.
  * p-core may set T_kh, T_kw > 1; the line buffer expands the ifm by
    T_kh x T_kw before broadcast.  Channels packed per PE is
    floor(v / (T_kh*T_kw)) (the paper prints ceil; floor is the physically
    realisable packing and is what we use — a PE cannot multiply more than v
    operands per cycle).
  * depthwise conv has no cross-channel reduction: on p-core each PE owns one
    channel and reduces over the window; on c-core (no line buffer) only one
    multiplier per PE does useful work (this is the paper's motivation for the
    heterogeneous design, §II).

Copy of ``repro/core/tiling.py`` (the port imports nothing of ``repro``).
"""
from __future__ import annotations

import dataclasses
import math

from repro_torch.core.arch import CoreConfig
from repro_torch.core.graph import LayerSpec

# Upper bound on ifm buffer depth (T_h * T_w); matches the RAMB18K-backed
# buffer depths the area model can realise (paper §IV-C uses up to 1x16k).
MAX_BUFFER_DEPTH = 4096


@dataclasses.dataclass(frozen=True)
class Tiling:
    """One tiling of a layer onto a core's PE array."""
    T_kh: int
    T_kw: int
    T_ci: int
    T_co: int
    T_h: int
    T_w: int
    i: int          # PEs ganged per output (Eq.2)
    # im2col fold (OPU [14] first-layer reshaping): the whole C_i*K_h*K_w
    # reduction is laid out as one inner-product input via on-chip buffer
    # addressing; the PE array then streams *output* pixels.  Used when the
    # channel count is too small to fill the array (e.g. 3-channel conv1).
    fold: bool = False

    @property
    def reduction(self) -> int:
        """Reduction length of one tile."""
        return self.T_kh * self.T_kw * self.T_ci

    def passes(self, layer: LayerSpec) -> int:
        """Number of (output-tile x reduction-tile) passes (Eq.3 / Eq.6)."""
        if self.fold:
            red = layer.C_i * layer.K_h * layer.K_w
            return (math.ceil(layer.C_o / self.T_co)
                    * math.ceil(red / self.reduction))
        return (math.ceil(layer.C_o / self.T_co)
                * math.ceil(layer.C_i / self.T_ci)
                * math.ceil(layer.K_h / self.T_kh)
                * math.ceil(layer.K_w / self.T_kw))

    def spatial_cycles(self, layer: LayerSpec) -> int:
        """Padded pixel count streamed per pass (Eq.4's block structure):
        ceil(H/T_h)*ceil(W/T_w) blocks, T_h*T_w pixels each, one pixel/cycle.
        Folded layers stream output pixels (im2col buffer addressing)."""
        H = layer.H_out if self.fold else layer.H
        W = layer.W_out if self.fold else layer.W
        th, tw = min(self.T_h, H), min(self.T_w, W)
        return math.ceil(H / th) * math.ceil(W / tw) * th * tw

    def utilization(self, core: CoreConfig) -> float:
        """Static PE-array utilisation: live multipliers / (n*v)."""
        return (self.T_kh * self.T_kw * self.T_ci * self.T_co) / core.n_mult


def _spatial_tiles(H: int, W: int, width: int,
                   max_depth: int = MAX_BUFFER_DEPTH) -> tuple[int, int]:
    """Eq.4: pick (T_h, T_w) maximising H*W / (ceil*ceil*T_h*T_w), subject to
    the ifm buffer capacity T_h*T_w <= max_depth."""
    best = None
    best_util = -1.0
    # Candidate tile heights: exact fit if possible, else divisors-ish sweep.
    cand_h = sorted({min(H, max_depth), *range(1, min(H, 256) + 1)})
    for th in cand_h:
        tw = min(W, max(1, max_depth // th))
        if th * tw > max_depth:
            continue
        padded = math.ceil(H / th) * math.ceil(W / tw) * th * tw
        util = (H * W) / padded
        if util > best_util + 1e-12:
            best_util, best = util, (th, tw)
    assert best is not None
    return best


def tile_layer(layer: LayerSpec, core: CoreConfig) -> Tiling:
    """Choose the tiling of ``layer`` on ``core`` (Eq.2-4)."""
    n, v = core.n, core.v
    T_h, T_w = _spatial_tiles(layer.H, layer.W, width=1,
                              max_depth=core.buffer_depth)

    if layer.op == "dwconv":
        return _tile_depthwise(layer, core, T_h, T_w)

    # Regular / pointwise convolution (and fc == 1x1 conv on 1x1 map).
    best: Tiling | None = None
    best_key: tuple | None = None
    window_opts = [(1, 1)]
    if core.has_line_buffer and (layer.K_h > 1 or layer.K_w > 1):
        for tkh in range(1, layer.K_h + 1):
            for tkw in range(1, layer.K_w + 1):
                if tkh * tkw <= v:
                    window_opts.append((tkh, tkw))
    for tkh, tkw in window_opts:
        ch_per_pe = max(1, v // (tkh * tkw))
        i_max = max(1, math.ceil(layer.C_i / ch_per_pe))
        for i in range(1, min(i_max, n) + 1):
            t_ci = min(i * ch_per_pe, layer.C_i)
            t_co = n // i
            if t_co < 1:
                break
            t_co = min(t_co, layer.C_o)
            t = Tiling(tkh, tkw, t_ci, t_co, T_h, T_w, i)
            # Rank by total compute passes (Eq.3), tie-break on fewer live
            # multipliers == lower resource cost (paper §IV-A last sentence).
            key = (t.passes(layer), -t.utilization(core))
            if best_key is None or key < best_key:
                best, best_key = t, key
    # im2col fold candidates (OPU [14] reshaping): the whole C_i*K_h*K_w
    # reduction is addressed as one inner-product input and the layer
    # streams output pixels.  Only the c-core uses this mode — it has no
    # line buffer, so K>1 windows are realised through ifm-buffer
    # addressing; the p-core's line buffer physically streams input pixels.
    red = layer.C_i * layer.K_h * layer.K_w
    if (not core.has_line_buffer and layer.K_h * layer.K_w > 1
            and layer.C_i <= v and red <= n * v):
        i = max(1, math.ceil(red / v))
        t_co = n // i
        if t_co >= 1:
            t = Tiling(layer.K_h, layer.K_w, layer.C_i,
                       min(t_co, layer.C_o), T_h, T_w, i, fold=True)
            # Compare on total cycles (passes x pixels): fold changes the
            # pixel term (output- vs input-pixel streaming), so the Eq.3
            # pass count alone cannot rank it.
            tot_fold = t.passes(layer) * t.spatial_cycles(layer)
            tot_best = best.passes(layer) * best.spatial_cycles(layer)
            if tot_fold < tot_best:
                best = t
    assert best is not None
    return best


def _tile_depthwise(layer: LayerSpec, core: CoreConfig,
                    T_h: int, T_w: int) -> Tiling:
    if core.has_line_buffer:
        # Window packed inside one PE (T_kh*T_kw <= v), one channel per PE.
        tkh = min(layer.K_h, core.v)
        tkw = max(1, min(layer.K_w, core.v // tkh))
        t_c = min(core.n, layer.C_i)
        return Tiling(tkh, tkw, 1, t_c, T_h, T_w, i=1)
    # c-core: no line buffer -> single-tap reduction; one useful multiplier
    # per PE.  This is the degenerate case motivating the dual-core design.
    t_c = min(core.n, layer.C_i)
    return Tiling(1, 1, 1, t_c, T_h, T_w, i=1)


def dw_channel_tiles(layer: LayerSpec, core: CoreConfig, t: Tiling) -> int:
    """Channel tiles for depthwise conv: each PE owns one channel."""
    return math.ceil(layer.C_i / t.T_co)
