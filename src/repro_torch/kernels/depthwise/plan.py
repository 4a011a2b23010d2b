"""Host-side tiling of the depthwise kernel K2 on an H100.

``plan_k2`` chooses, from a call's shape alone, how
``csrc/depthwise_conv2d.cu`` covers the output: the pixel tile (``th`` x
``tw`` outputs of one image), the channel block (``cq`` quads of 4
channels), the outputs a thread computes along W (``ow``: 1 or 4,
reusing each input row it loads for all of them), the block's threads
(``cq * th * cdiv(tw, ow)``) and the dynamic shared memory.  The wrapper
passes the tile, channel block, ``ow`` and shared memory to the C entry
point, and the kernel trusts them.

The C side derives the rest with formulas it must keep equal to these:
the grid ``(tiles_h * tiles_w, cdiv(cdiv(C, 4), cq), n)`` (tile ``t`` at
row ``t // tiles_w``), the thread count and ``k2_smem_floats``
(``smem_floats``), of which it checks the shared-memory size and refuses a
call that disagrees; a window other than 3x3 at stride 1 or 2 is compiled
only for ``ow`` 1.

The choice is deterministic: among the tilings that fit (at most 256
threads, shared memory), the plans that put at least one block on each of the 132
SMs are preferred when any does, then the one a simple cost model thinks
fastest (the blocks an SM runs at once, a block's staged bytes and fixed
cost, or the bytes the whole call moves, whichever is longer), then more
outputs a thread and larger tiles.  No timing here: a shape's plan is only
memoised.  The plan cache (``kernels/autotune.py``) times the best-ranked
``candidates`` on the card, and the ops launch its measured winner where
it holds one.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass

SMS = 132                   # streaming multiprocessors of an H100 SXM
MAX_SMEM = 232_448          # dynamic shared memory a block may opt in to
SM_SMEM = 233_472           # shared memory of an SM
SM_THREADS = 2048           # resident threads of an SM
SM_BLOCKS = 32              # resident blocks of an SM
MAX_THREADS = 256
TILES = ((16, 16), (16, 8), (8, 16), (8, 8), (8, 4), (4, 8), (4, 4), (7, 7),
         (7, 4), (4, 7), (7, 2), (2, 7), (8, 2), (2, 8))
CQS = (2, 4, 8, 16, 32)     # channel quads a block
OWS = (1, 4)                # outputs a thread along W (2 was never the
                            # fastest at a path shape: plan_sweep --sweep)

# cost model (ns), fitted to a sweep of every candidate at the paths'
# shapes on an H100 (tools/plan_sweep.py --sweep, then --fit): a block's
# fixed cost (launch, one round trip of its staged loads, the barrier), its
# rate of staged bytes, its cost per output a thread, and the card's rate
# for the bytes a whole call moves
BLOCK_NS = 375.0
BYTES_PER_NS = 100.0
OUTPUT_NS = 120.0
DRAM_BYTES_PER_NS = 3500.0


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


@dataclass(frozen=True)
class DwPlan:
    """One call's tiling: ``th`` x ``tw`` pixel tiles, ``tiles_h`` x
    ``tiles_w`` of them an image, times ``cblocks`` blocks of ``cq``
    channel quads; a thread computes ``ow`` outputs along W of one channel
    quad; ``threads`` a block, ``blocks`` in all."""
    th: int
    tw: int
    tiles_h: int
    tiles_w: int
    cq: int
    cblocks: int
    ow: int
    threads: int
    blocks: int
    smem_bytes: int


def halo(th: int, tw: int, ow: int, kh: int, kw: int,
         stride: int) -> tuple[int, int]:
    """The staged input rows and columns of a tile: its threads cover
    ``cdiv(tw, ow) * ow`` output columns."""
    return ((th - 1) * stride + kh,
            (_cdiv(tw, ow) * ow - 1) * stride + kw)


def k2_smem_floats(th: int, tw: int, cq: int, ow: int, kh: int, kw: int,
                   stride: int) -> int:
    """Shared memory of K2 in floats: the input halo [hh * hw][4 cq], the
    window's weights [kh * kw][4 cq] and the bias [4 cq]."""
    hh, hw = halo(th, tw, ow, kh, kw, stride)
    return (hh * hw + kh * kw + 1) * 4 * cq


def compiled_ows(kh: int, kw: int, stride: int) -> tuple[int, ...]:
    """The outputs a thread the kernel is compiled for at this window."""
    return OWS if kh == kw == 3 and stride in (1, 2) else (1,)


def candidates(n: int, ho: int, wo: int, c: int, kh: int, kw: int,
               stride: int) -> list[tuple[tuple, DwPlan]]:
    """Every tiling that fits, each with its sort key (the plan is the
    least key)."""
    quads = _cdiv(c, 4)
    cqs = sorted({min(q, quads) for q in CQS})
    out = []
    for th, tw in TILES:
        if th > max(2 * ho, 4) or tw > max(2 * wo, 4):
            continue                     # mostly past the map
        tiles_h, tiles_w = _cdiv(ho, th), _cdiv(wo, tw)
        for cq in cqs:
            cblocks = _cdiv(quads, cq)
            if tiles_h * tiles_w > 2 ** 31 - 1 or cblocks > 65535 or \
                    n > 65535:
                continue
            for ow in compiled_ows(kh, kw, stride):
                if ow > tw:
                    continue
                threads = cq * th * _cdiv(tw, ow)
                if threads > MAX_THREADS:
                    continue
                floats = k2_smem_floats(th, tw, cq, ow, kh, kw, stride)
                if 4 * floats > MAX_SMEM:
                    continue
                blocks = tiles_h * tiles_w * cblocks * n
                hh, hw = halo(th, tw, ow, kh, kw, stride)
                staged = 4 * hh * hw * 4 * cq
                per_sm = min(SM_THREADS // (32 * _cdiv(threads, 32)),
                             SM_BLOCKS, SM_SMEM // (4 * floats + 1024))
                per_block = (BLOCK_NS + staged / BYTES_PER_NS
                             + ow * kh * kw * OUTPUT_NS / 9)
                est = _cdiv(blocks, SMS * per_sm) * per_block
                moved = blocks * staged + 4 * n * ho * wo * c
                est = max(est, moved / DRAM_BYTES_PER_NS)
                key = (blocks < SMS, est, -ow, -th * tw, cq)
                out.append((key, DwPlan(
                    th=th, tw=tw, tiles_h=tiles_h, tiles_w=tiles_w, cq=cq,
                    cblocks=cblocks, ow=ow, threads=threads, blocks=blocks,
                    smem_bytes=4 * floats)))
    if not out:
        raise ValueError(f"k2: no tiling fits n={n} {ho}x{wo} C={c} "
                         f"k={kh}x{kw} stride={stride}")
    return out


@functools.cache
def plan_k2(n: int, h: int, w: int, c: int, kh: int, kw: int, stride: int,
            pad: int) -> DwPlan:
    """K2's tiling of a ``kh`` x ``kw`` depthwise conv (stride, pad) over
    (n, h, w, c)."""
    ho = (h + 2 * pad - kh) // stride + 1
    wo = (w + 2 * pad - kw) // stride + 1
    return min(candidates(n, ho, wo, c, kh, kw, stride),
               key=lambda kp: kp[0])[1]
