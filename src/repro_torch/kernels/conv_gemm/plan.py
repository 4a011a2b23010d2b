"""Host-side tiling of the GEMM kernels K1 (``matmul_bias_act``) and K3
(``conv2d_implicit_gemm``) on an H100.

``plan_k1`` chooses, from a call's shape alone, how
``csrc/matmul_bias_act.cu`` covers ``(M, K) @ (K, N)``: the output tile
(``bm`` rows from 16 to 128, ``bn`` columns from 32 to 128, or all of N
where N <= 128), the k-step (``bk``, 16, 32 or 64 floats), the warps' layout
over the tile (``wm`` rows of warps; each warp ``mi`` m-tiles by ``nj``
n-tiles of m16n8k8), the thread-block cluster whose blocks split K between
them, the depth of the cp.async ring, and the dynamic shared memory.  The
wrapper passes the tile, step, layout, cluster, ring depth and shared
memory to the C entry point, and the kernel trusts them.

The C side derives the rest with formulas it must keep equal to these:
``k_splits`` (``rank_range`` in tc_common.cuh), the grid ``(cluster,
tiles_n, tiles_m)`` (tile ``(tm, tn)`` at rows ``tm * bm`` and columns
``tn * bn``), the warp layout's ``mi`` and ``nj`` (``pick`` compiles the
pairs in ``COMPILED``) and ``k1_smem_floats`` (``smem_floats``).  Of these
the C side checks the shared-memory size and the compiled pair, and refuses
a call that disagrees.

The choice is deterministic: among the tilings that fit (shared memory,
cluster <= 16, a compiled warp layout), the plans that put at least one
block on each of the 132 SMs are preferred when any does, then the one a
simple cost model thinks fastest (the busiest SM's blocks times a block's
staged steps, products, cluster reduction, stores and fixed cost, or the
bytes the whole call moves, whichever is longer), then smaller clusters,
larger tiles and the longer step.  The ring is the deepest (2-4 stages)
its steps use that still lets two blocks share an SM.  No timing here: a
shape's plan is only memoised, since the serving path asks for it at every
launch.  The plan cache (``kernels/autotune.py``) times the best-ranked
``candidates`` that keep the pick's ``k_splits`` on the card, and the ops
launch its measured winner where it holds one.

``plan_k3`` tiles K3's implicit GEMM (M = N*Ho*Wo pixels, K = Kh*Kw*Ci, N =
Co) the same way: both kernels run ``gemm_tile`` of ``csrc/tc_common.cuh``.
K3's shared memory adds its tables (``k3_smem_floats``: 3 ints a pixel
row, 2 a k entry of the busiest rank), its k-steps are ``K3_BKS`` (16-byte
copies where Ci % 4 == 0, else 4-byte ones, which the cost model charges
four times the staging time), and the bytes a call moves count the input
image once a column tile, not the patch matrix.  K3 shares K1's cost
constants.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass

SMS = 132                   # streaming multiprocessors of an H100 SXM
MAX_SMEM = 232_448          # dynamic shared memory a block may opt in to
SM_SMEM = 233_472           # shared memory of an SM, 1 KB of it a block's
SM_BLOCKS = 2               # blocks an SM holds by registers (128 a thread)
MAX_CLUSTER = 16            # above 8 the kernel opts in to non-portable
WARPS = 8                   # 256 threads a block
MAX_STAGES = 4              # cp.async ring depth
BMS = (16, 32, 64, 128)     # output tile rows
BNS = (32, 64, 128)         # output tile columns (or all of N <= 128)
BKS = (16, 32, 64)          # floats of K a step
# (m-tiles, n-tiles) a warp holds that the kernel is compiled for, at each
# k-step of BKS: the layouts of the fastest tilings at the paths' shapes
# (1x2, 1x4, 1x8 and 2x1 never were: tools/plan_sweep.py --sweep)
COMPILED = ((1, 1), (2, 2), (2, 4))
# K3's k-steps, by whether a quad of k is one 16-byte copy (Ci % 4 == 0)
K3_BKS = {True: (16, 32, 64), False: (16, 32)}

# cost model (ns), fitted to a sweep of every candidate at the paths'
# shapes on an H100 (tools/plan_sweep.py --sweep, then --fit): the latency
# of one staged step and its barrier, a block's rate of products (3xTF32,
# three products counted per f32 product) and of staged bytes, the rate at
# which partial sums meet across the cluster and outputs leave, how much
# each further co-resident block slows a block, a block's fixed cost, and
# the card's rate for the bytes a whole call moves
STEP_NS = 76.5
FLOP_PER_NS = 2284.8
BYTES_PER_NS = 160.0
REDUCE_BYTES_PER_NS = 80.0
PAIR_SHARE = 0.50575
BLOCK_NS = 1000.0
DRAM_BYTES_PER_NS = 2500.0



def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _round_up(a: int, b: int) -> int:
    return _cdiv(a, b) * b


@dataclass(frozen=True)
class GemmPlan:
    """One call's tiling: ``bm`` x ``bn`` output tiles, ``tiles_m`` x
    ``tiles_n`` of them, each owned by a cluster of ``cluster`` blocks that
    split K in steps of ``bk`` (``k_splits``); warps in ``wm`` rows, each
    holding ``mi`` x ``nj`` m16n8 tiles; ``blocks`` in all."""
    bm: int
    bn: int
    bk: int
    wm: int
    mi: int
    nj: int
    tiles_m: int
    tiles_n: int
    cluster: int
    blocks: int
    stages: int
    smem_bytes: int


def k_splits(k: int, bk: int, cluster: int) -> tuple[tuple[int, int], ...]:
    """The range ``[lo, hi)`` of K each cluster rank reduces over, in rank
    order: contiguous runs of ``bk``-wide steps."""
    steps = _cdiv(k, bk)
    return tuple((r * steps // cluster * bk,
                  min((r + 1) * steps // cluster * bk, k))
                 for r in range(cluster))


def nj_class(nj: int) -> int:
    """The compiled n-tile count a warp takes: ``nj`` rounded up to a power
    of two."""
    return 1 << (nj - 1).bit_length()


def warp_layout(bm: int, bn: int) -> tuple[int, int, int] | None:
    """(wm, mi, nj) of a bm x bn tile: the 8 warps in ``wm`` rows of 8/wm,
    each holding ``mi`` m-tiles of 16 rows and ``nj`` (a compiled class)
    n-tiles of 8 columns; the fewest tiles a warp, then the fewest fragment
    splits a k-step (4 mi + 2 nj).  None if no compiled layout covers it."""
    mt, nt = bm // 16, _cdiv(bn, 8)
    best = None
    for wm in (1, 2, 4, 8):
        if wm > mt or mt % wm:
            continue
        mi = mt // wm
        nj = nj_class(_cdiv(nt, WARPS // wm))
        if (mi, nj) not in COMPILED:
            continue
        key = (mi * nj, 4 * mi + 2 * nj, wm)
        if best is None or key < best[0]:
            best = (key, (wm, mi, nj))
    return None if best is None else best[1]


def k1_smem_floats(bm: int, bn: int, bk: int, stages: int) -> int:
    """Shared memory of K1 in floats: a ring of ``stages`` stages of (A
    [bm][bk + 4], B [bk][round_up(bn, 32) + 8]); the partial sums
    [bm][round_up(bn, 8) + 4] reuse it."""
    stage = bm * (bk + 4) + bk * (_round_up(bn, 32) + 8)
    return max(stages * stage, bm * (_round_up(bn, 8) + 4))


def candidates(m: int, k: int, n: int) -> list[tuple[tuple, GemmPlan]]:
    """Every K1 tiling that fits, each with its sort key (the plan is the
    least key)."""
    return _candidates(m, k, n, BKS, lambda bm, bk, cl: 0, 1.0, m * k, "k1")


def k3_entries(k: int, bk: int, cluster: int, vec: bool) -> int:
    """Entries of K3's k table: the busiest rank's k, a quad an entry
    where ``vec``."""
    return _cdiv(_cdiv(k, bk), cluster) * bk // (4 if vec else 1)


def k3_smem_floats(bm: int, bn: int, bk: int, stages: int,
                   entries: int) -> int:
    """Shared memory of K3 in floats: K1's, then the pixel rows' table (3
    ints a row) and the k table (2 ints an entry)."""
    return k1_smem_floats(bm, bn, bk, stages) + 3 * bm + 2 * entries


def k3_candidates(n: int, h: int, w: int, ci: int, co: int, kh: int,
                  kw: int, stride: int, pad: int,
                  vec: bool) -> list[tuple[tuple, GemmPlan]]:
    """Every K3 tiling that fits, each with its sort key."""
    ho = (h + 2 * pad - kh) // stride + 1
    wo = (w + 2 * pad - kw) // stride + 1
    m, k = n * ho * wo, kh * kw * ci
    return _candidates(
        m, k, co, K3_BKS[vec],
        lambda bm, bk, cl: 3 * bm + 2 * k3_entries(k, bk, cl, vec),
        1.0 if vec else 4.0, n * h * w * ci, "k3")


def _candidates(m, k, n, bks, extra, a_cost, a_elems,
                name) -> list[tuple[tuple, GemmPlan]]:
    """The tilings of an (m, k) @ (k, n) GEMM tile at k-steps ``bks`` that
    fit, with ``extra(bm, bk, cluster)`` floats of shared memory beyond
    K1's, A's staging time times ``a_cost``, and A's ``a_elems`` floats
    read once a column tile."""
    out = []
    bns = sorted({min(b, n) for b in BNS})
    for bm in BMS:
        if bm > 16 and bm // 2 >= m:
            continue                     # only rows past M would be added
        for bn in bns:
            layout = warp_layout(bm, bn)
            if layout is None:
                continue
            for bk in bks:
                tiles_m, tiles_n = _cdiv(m, bm), _cdiv(n, bn)
                if tiles_n > 65535 or tiles_m > 65535:
                    continue
                steps = _cdiv(k, bk)
                for cl in range(1, min(MAX_CLUSTER, steps) + 1):
                    if cl > 1 and tiles_m * tiles_n * (cl - 1) >= 2 * SMS:
                        break            # the grid is full without it
                    plan = _candidate(m, k, n, bm, bn, bk, layout, tiles_m,
                                      tiles_n, cl, extra(bm, bk, cl),
                                      a_cost, a_elems)
                    if plan is not None:
                        out.append(plan)
    if not out:
        raise ValueError(f"{name}: no tiling fits M={m} K={k} N={n}")
    return out


def _candidate(m, k, n, bm, bn, bk, layout, tiles_m, tiles_n, cl, extra,
               a_cost, a_elems) -> tuple[tuple, GemmPlan] | None:
    """One tiling with its sort key, or None if it does not fit."""
    wm, mi, nj = layout
    steps = _cdiv(_cdiv(k, bk), cl)           # the busiest rank's steps
    room = SM_SMEM // SM_BLOCKS - 1024        # shared memory a block of two
    stages = next((ns for ns in range(min(MAX_STAGES, steps + 1), 1, -1)
                   if 4 * (k1_smem_floats(bm, bn, bk, ns) + extra) <= room),
                  2)
    floats = k1_smem_floats(bm, bn, bk, stages) + extra
    if 4 * floats > MAX_SMEM:
        return None
    per_sm = min(SM_BLOCKS, SM_SMEM // (4 * floats + 1024))
    rows, cols = min(bm, m), _round_up(min(bn, n), 8)
    step = (STEP_NS + 6 * _round_up(rows, 16) * cols * bk / FLOP_PER_NS
            + 4 * (a_cost * rows + cols) * bk / BYTES_PER_NS)
    per_block = (steps * step + 4 * rows * cols * cl / REDUCE_BYTES_PER_NS
                 + BLOCK_NS)
    blocks = cl * tiles_m * tiles_n
    # waves of per_sm blocks an SM; each further co-resident block slows a
    # block by PAIR_SHARE of its time
    resident = min(per_sm, _cdiv(blocks, SMS))
    est = (_cdiv(blocks, SMS * per_sm) * per_block
           * (1.0 + PAIR_SHARE * (resident - 1)))
    moved = 4 * (a_elems * tiles_n + k * n * tiles_m + m * n)
    est = max(est, moved / DRAM_BYTES_PER_NS)
    key = (blocks < SMS, est, cl, -bm * bn, -bk)
    return key, GemmPlan(bm=bm, bn=bn, bk=bk, wm=wm, mi=mi, nj=nj,
                         tiles_m=tiles_m, tiles_n=tiles_n, cluster=cl,
                         blocks=blocks, stages=stages, smem_bytes=4 * floats)


@functools.cache
def plan_k1(m: int, k: int, n: int) -> GemmPlan:
    """K1's tiling of ``(m, k) @ (k, n)``."""
    if m < 1 or k < 1 or n < 1:
        raise ValueError(f"k1: empty product M={m} K={k} N={n}")
    return min(candidates(m, k, n), key=lambda kp: kp[0])[1]


@functools.cache
def plan_k3(n: int, h: int, w: int, ci: int, co: int, kh: int, kw: int,
            stride: int, pad: int, vec: bool) -> GemmPlan:
    """K3's tiling of an NHWC (n, h, w, ci) conv with a (kh, kw, ci, co)
    weight; ``vec``: the input may be staged in 16-byte copies (Ci % 4 ==
    0 and the input 16-byte aligned)."""
    ho = (h + 2 * pad - kh) // stride + 1
    wo = (w + 2 * pad - kw) // stride + 1
    if min(n, ci, co, kh, kw, stride) < 1 or ho < 1 or wo < 1 or pad < 0:
        raise ValueError(f"k3: empty conv {n}x{h}x{w}x{ci} -> {co}, "
                         f"{kh}x{kw} stride {stride} pad {pad}")
    if vec and ci % 4:
        raise ValueError(f"k3: 16-byte copies need Ci % 4 == 0, Ci={ci}")
    return min(k3_candidates(n, h, w, ci, co, kh, kw, stride, pad, vec),
               key=lambda kp: kp[0])[1]
