"""Host-side tiling of the fused-block kernels K4 and K5 on an H100.

``plan_k4`` and ``plan_k5`` choose, from a call's shape alone, how
``csrc/fused_dw_pw_conv.cu`` and ``csrc/fused_pw_dw_pw_conv.cu`` cover it:
the output pixel tile (``th`` x ``tw``), the thread-block cluster that
splits the channel reduction (K4's input channels C, K5's expanded
channels Cm) between its blocks in chunks of 16, the depth of the
cp.async ring, K5's expand step (32 or 64 input channels) and the chunks
one expand pass covers, and the dynamic shared memory.  The wrappers pass
the tile, cluster, ring depth, step, pass and shared memory to the C entry
points, and the kernels trust them.

The C side derives the rest from those numbers with formulas it must keep
equal to these: ``channel_splits`` (``rank_chunks`` in fused_common.cuh),
the tile walk (grid ``(cluster, tiles_h * tiles_w, n)``, tile ``t`` at row
``t // tiles_w``: ``launch_clustered`` and the kernels' prologue),
``_product_shape`` (``ProductShape``) and ``k4_smem_floats`` /
``k5_smem_floats`` (each source's ``smem_floats``).  Of these the C side
checks only the shared-memory size, and refuses a call that disagrees.

The choice is deterministic: among the tilings that fit (registers,
shared memory, cluster <= 16), the plans that put at least one block on
each of the 132 SMs are preferred when any does, then the one a simple
cost model thinks fastest (the busiest SM's blocks times a block's staged
steps, products, bytes, cluster reduction and fixed cost), then smaller
clusters and larger tiles.  The ring is the deepest (2-4 stages) its steps use that
still lets two blocks share an SM.  No timing here: a shape's plan is only
memoised, since the serving path asks for it at every launch.  The plan
cache (``kernels/autotune.py``) times the best-ranked ``candidates`` that
keep the pick's ``channel_splits`` (and K5's ``expand_sets``) on the card,
and the ops launch its measured winner where it holds one.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass

SMS = 132                   # streaming multiprocessors of an H100 SXM
MAX_SMEM = 232_448          # dynamic shared memory a block may opt in to
MAX_CLUSTER = 16            # above 8 the kernels opt in to non-portable
THREADS = 256               # 8 warps a block
WARPS = THREADS // 32
CK = 16                     # channels a chunk (K4: C; K5: Cm)
AS = CK + 4                 # row stride of a [pixel][chunk] tile, floats
KCS = (32, 64)              # K5: input channels an expand step (64 only
                            # for halos of at most 8 m-tiles and Ci > 64;
                            # at most 4 m-tiles, only in passes of 4)
GROUPS = (1, 2, 4)          # K5: chunks an expand pass covers (above 1
                            # only for halos of at most 4 m-tiles)
NJ_MAX = 16                 # 8-wide n-tiles a warp accumulates
MAX_STAGES = 4              # cp.async ring depth
EMAX = 2                    # K5: 16-row expand m-tiles a warp holds
TILES = ((8, 8), (8, 4), (4, 8), (7, 7), (7, 4), (4, 7), (4, 4), (7, 2),
         (2, 7), (8, 2), (2, 8))

TWO_PER_SM = 115_712        # shared memory a block may take, two to an SM

# cost model (ns), fitted to a sweep of every candidate at the paths' shapes
# on an H100 (tools/fused_sweep.py --sweep): the latency of one staged
# step and its barrier, a block's rate of products (3xTF32) and of staged
# bytes, the rate at which partial sums meet across the cluster, the share
# of an SM each of two co-resident blocks runs at, and a block's fixed cost
_STEP_NS = 150.0
_FLOP_PER_NS = 1600.0
_BYTES_PER_NS = 80.0
_REDUCE_BYTES_PER_NS = 160.0
_PAIR_SHARE = 0.5
_BLOCK_NS = 1000.0


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _round_up(a: int, b: int) -> int:
    return _cdiv(a, b) * b


@dataclass(frozen=True)
class FusedPlan:
    """One call's tiling: ``th`` x ``tw`` pixel tiles, ``tiles_h`` x
    ``tiles_w`` of them an image, each owned by a cluster of ``cluster``
    blocks (``channel_splits`` gives each rank's channels); ``blocks`` in
    all."""
    th: int
    tw: int
    tiles_h: int
    tiles_w: int
    cluster: int
    blocks: int
    stages: int
    smem_bytes: int
    kc: int = 32
    group: int = 1


def channel_splits(channels: int, cluster: int) -> tuple[tuple[int, int], ...]:
    """The channel range ``[lo, hi)`` each cluster rank reduces over, in
    rank order: contiguous runs of 16-channel chunks."""
    nch = _cdiv(channels, CK)
    return tuple((r * nch // cluster * CK,
                  min((r + 1) * nch // cluster * CK, channels))
                 for r in range(cluster))


def expand_sets(th: int, tw: int, kh: int, kw: int, stride: int,
                group: int) -> int:
    """The accumulator sets K5's expand alternates its k-steps between
    (``ExpandShare::PAR`` in the source): two where a warp holds one
    n-tile (a halo of at most 4 m-tiles, one chunk a pass), else one.
    Plans with the same ``channel_splits`` and sets sum in one order."""
    hh, hw = _halo(th, tw, kh, kw, stride)
    return 2 if _cdiv(hh * hw, 16) <= 4 and group == 1 else 1


def _product_shape(tp: int, co: int) -> tuple[int, int]:
    """(16-row m-tiles, n-tiles a warp holds) of the [tile x Co] product:
    the 8 warps split into 1, 2 or 4 m-tile rows."""
    mt = _cdiv(tp, 16)
    mtp = 1 << (mt - 1).bit_length()
    return mt, _cdiv(_cdiv(co, 8), WARPS // mtp)


def _halo(th: int, tw: int, kh: int, kw: int,
          stride: int) -> tuple[int, int]:
    return (th - 1) * stride + kh, (tw - 1) * stride + kw


def k4_smem_floats(th: int, tw: int, co: int, kh: int, kw: int,
                   stride: int, stages: int) -> int:
    """Shared memory of K4 in floats: a ring of ``stages`` stages of (input
    halo, dw weights, pw weight rows), the dw tile and the halo's row
    offsets; the partial sums reuse it."""
    hh, hw = _halo(th, tw, kh, kw, stride)
    mt, _ = _product_shape(th * tw, co)
    stage = hh * hw * AS + kh * kw * CK + CK * (_round_up(co, 32) + 8)
    main = stages * stage + mt * 16 * AS + _round_up(hh * hw, 4)
    return max(main, mt * 16 * (_round_up(co, 8) + 4))


def k5_smem_floats(th: int, tw: int, co: int, kh: int, kw: int,
                   stride: int, stages: int, kc: int = 32,
                   group: int = 1) -> int:
    """Shared memory of K5 in floats: a ring of ``stages`` expand stages of
    (input halo rows, expand weights for ``group`` chunks), the expanded
    halo of those chunks, dw weights, the dw tile, the project weight rows
    and the halo's row offsets; the partial sums reuse it."""
    hh, hw = _halo(th, tw, kh, kw, stride)
    hp = hh * hw
    mt, _ = _product_shape(th * tw, co)
    estage = _cdiv(hp, 16) * 16 * (kc + 4) + kc * (CK * group + 8)
    main = (stages * estage + hp * (CK * group + 4) + kh * kw * CK
            + mt * 16 * AS
            + CK * (_round_up(co, 32) + 8) + _cdiv(hp, 16) * 16)
    return max(main, mt * 16 * (_round_up(co, 8) + 4))


def candidates(kind: str, n: int, ho: int, wo: int, ci: int, cx: int,
               co: int, kh: int, kw: int,
               stride: int) -> list[tuple[tuple, FusedPlan]]:
    """Every tiling that fits, each with its sort key (the plan is the
    least key).  ``kind``: "k4" or "k5"; ``cx``: the split channels (K4 C,
    K5 Cm); ``ci``: K5's input channels (unused by K4)."""
    nch = _cdiv(cx, CK)
    out = []
    for th, tw in TILES:
        if _product_shape(th * tw, co)[1] > NJ_MAX:
            continue
        hh, hw = _halo(th, tw, kh, kw, stride)
        hp = hh * hw
        if kind == "k5" and _cdiv(_cdiv(hp, 16), WARPS) > EMAX:
            continue
        tiles_h, tiles_w = _cdiv(ho, th), _cdiv(wo, tw)
        if tiles_h * tiles_w > 65535 or n > 65535:
            continue
        k3 = kh == kw == 3
        kcs = (32,) if kind == "k4" else tuple(
            kc for kc in KCS if kc == 32 or (
                _cdiv(hp, 16) <= 8 and ci > kc and k3))
        groups = (1,) if kind == "k4" or _cdiv(hp, 16) > 4 or not k3 \
            else GROUPS
        for cl in range(1, min(MAX_CLUSTER, nch) + 1):
            for kc in kcs:
                for g in groups:
                    if g > _cdiv(nch, cl) or (
                            kc == 64 and _cdiv(hp, 16) <= 4 and g != 4):
                        continue
                    plan = _candidate(kind, n, ci, cx, co, kh, kw, stride,
                                      th, tw, tiles_h, tiles_w, cl, kc, g)
                    if plan is not None:
                        out.append(plan)
    if not out:
        raise ValueError(f"{kind}: no tiling fits n={n} {ho}x{wo} C={cx} "
                         f"Co={co} k={kh}x{kw} stride={stride}")
    return out


def _candidate(kind, n, ci, cx, co, kh, kw, stride, th, tw, tiles_h,
               tiles_w, cl, kc, g) -> tuple[tuple, FusedPlan] | None:
    """One tiling with its sort key, or None if it does not fit."""
    nch = _cdiv(cx, CK)
    mt, _ = _product_shape(th * tw, co)
    hh, hw = _halo(th, tw, kh, kw, stride)
    hp = hh * hw
    chunks = _cdiv(nch, cl)
    # the ring's steps: K4's chunks, K5's input-channel steps; the deepest
    # ring they use that leaves two blocks to an SM
    steps = chunks if kind == "k4" else _cdiv(ci, kc)

    def smem(ns):
        if kind == "k4":
            return k4_smem_floats(th, tw, co, kh, kw, stride, ns)
        return k5_smem_floats(th, tw, co, kh, kw, stride, ns, kc, g)
    stages = next((ns for ns in range(min(MAX_STAGES, steps + 1), 1, -1)
                   if 4 * smem(ns) <= TWO_PER_SM), 2)
    floats = smem(stages)
    if 4 * floats > MAX_SMEM:
        return None
    per_sm = 2 if 4 * floats <= TWO_PER_SM else 1
    pad_px = mt * 16
    # a chunk's dw and 1x1 product (K4's pw, K5's project), its weight
    # bytes and one barrier; K4 stages its halo per chunk, K5 per pass of
    # g chunks, each pass an expand of its own staged steps
    chunk = (_STEP_NS + 2 * pad_px * CK * (kh * kw + 3 * _cdiv(co, 8) * 8)
             / _FLOP_PER_NS + 4 * CK * co / _BYTES_PER_NS)
    if kind == "k4":
        per_block = chunks * (chunk + 4 * hp * CK / _BYTES_PER_NS)
    else:
        passes = _cdiv(chunks, g)
        expand = (steps * _STEP_NS
                  + 6 * _cdiv(hp, 16) * 16 * _round_up(ci, kc) * CK * g
                  / _FLOP_PER_NS
                  + 4 * (hp * ci + ci * CK * g) / _BYTES_PER_NS)
        per_block = passes * expand + chunks * chunk
    per_block += 4 * th * tw * co * cl / _REDUCE_BYTES_PER_NS + _BLOCK_NS
    blocks = cl * tiles_h * tiles_w * n
    # the busiest SM's blocks; two on one SM run _PAIR_SHARE as fast each
    est = _cdiv(blocks, SMS) * per_block * (_PAIR_SHARE if per_sm == 2
                                            else 1.0)
    return (blocks < SMS, est, cl, -th * tw), FusedPlan(
        th=th, tw=tw, tiles_h=tiles_h, tiles_w=tiles_w, cluster=cl,
        blocks=blocks, stages=stages, smem_bytes=4 * floats, kc=kc, group=g)


def _plan(kind: str, n: int, ho: int, wo: int, ci: int, cx: int, co: int,
          kh: int, kw: int, stride: int) -> FusedPlan:
    return min(candidates(kind, n, ho, wo, ci, cx, co, kh, kw, stride),
               key=lambda kp: kp[0])[1]


def out_size(h: int, w: int, kh: int, kw: int, stride: int,
             pad: int) -> tuple[int, int]:
    return (h + 2 * pad - kh) // stride + 1, (w + 2 * pad - kw) // stride + 1


@functools.cache
def plan_k4(n: int, h: int, w: int, c: int, co: int, k: int, stride: int,
            pad: int, kw: int | None = None) -> FusedPlan:
    """K4's tiling of dw(k x k, stride, pad) -> pw over (n,h,w,c) -> co;
    ``kw`` a width other than ``k``."""
    kw = k if kw is None else kw
    ho, wo = out_size(h, w, k, kw, stride, pad)
    return _plan("k4", n, ho, wo, 0, c, co, k, kw, stride)


@functools.cache
def plan_k5(n: int, h: int, w: int, ci: int, cm: int, co: int, k: int,
            stride: int, pad: int, kw: int | None = None) -> FusedPlan:
    """K5's tiling of expand -> dw(k x k, stride, pad) -> project over
    (n,h,w,ci) -> cm -> co; ``kw`` a width other than ``k``."""
    kw = k if kw is None else kw
    ho, wo = out_size(h, w, k, kw, stride, pad)
    return _plan("k5", n, ho, wo, ci, cm, co, k, kw, stride)
