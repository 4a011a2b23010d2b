"""Host-side plan of K7's decode kernel (``decode_attention``) on an H100.

``plan_decode`` chooses, from a call's shape alone, how
``csrc/flash_attention.cu``'s decode kernel covers q (B, Hq, 1, D) against
a cache of Sk keys on Hkv kv heads: which unit runs the products (``tc``:
the tensor cores for a GQA group G = Hq / Hkv above 8, padded to a
multiple of 16, at most 48; else the CUDA cores), how many ranks a
thread-block cluster has (``cluster``, up to 16) to split a (batch row, kv
head)'s 32-key tiles between them in contiguous runs (``key_splits``),
``slots`` (on the CUDA cores the tiles in flight, a pair of warps each; on the
tensor cores the depth of the cp.async ring), and the dynamic
shared memory.  The wrapper passes them to the C entry point, which
derives the rest with formulas it keeps equal to these
(``tc::rank_range``, ``dec::smem_floats``) and refuses a shared-memory
size that disagrees.

The choice is deterministic: the least ``waves * (rounds + 1)``, then the
smaller cluster.  ``rounds`` is the tiles a rank's busiest slot scores one
after another; ``waves`` is how many times the card must be filled to
place every cluster, where a cluster's blocks must share one GPC (graphics
processing cluster) of ``GPC_SMS`` SMs, ``blocks_per_sm`` of them an SM.
The ``+ 1`` stands for a wave's fixed cost: its loads' latency and the
merge.  A sweep of every cluster size at the paths' shapes on an H100
(``tools/plan_sweep.py --sweep --kernel decode_attention``) ranks the
plans this way.  A shape's plan is memoised, since the LM path asks for
it every layer.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass

SMS = 132                   # streaming multiprocessors of an H100 SXM
MAX_SMEM = 232_448          # dynamic shared memory a block may opt in to
SM_SMEM = 233_472           # shared memory of an SM, 1 KB of it a block's
MAX_CLUSTER = 16            # above 8 the kernel opts in to non-portable
MAX_STAGES = 4              # the tensor cores' cp.async ring depth
TK = 32                     # keys a tile
GM = 8                      # the CUDA cores take groups up to this
HW = 4                      # ... with two warps a tile, HW heads each
CUDA_WARPS = 16             # 512 threads a block on the CUDA cores
MAX_SLOTS = CUDA_WARPS // (GM // HW)    # tiles in flight
MAX_G = 48                  # the tensor cores' groups, padded to 16
MAX_D = 128
# the SMs of each GPC that clusters may fill: 132 in all; this split fits
# the waves the sweep shows (clusters of 4 blocks at one an SM take two
# waves for 32 clusters, clusters of 3 one)
GPC_SMS = (18, 18, 18, 18, 16, 16, 14, 14)


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


@dataclass(frozen=True)
class DecodePlan:
    """One decode call's plan: ``blocks`` = ``cluster`` ranks for each of
    the B * Hkv (batch row, kv head) pairs; each rank scores ``keys`` keys
    at most (whole tiles of 32, ``key_splits``) with ``slots`` warps a
    tile each (CUDA cores) or a ring of ``slots`` tiles (tensor cores)."""
    tc: bool
    cluster: int
    slots: int
    keys: int
    blocks: int
    smem_bytes: int


def decode_smem_floats(g: int, d: int, slots: int, cluster: int,
                       tc: bool) -> int:
    """Shared memory of the decode kernel in floats: q [QR][D + 4] (QR: G
    padded with zero rows to 8 on the CUDA cores, to a multiple of 16 on
    the tensor cores); ``slots`` tiles of K and V [64][D + 4]; the warps'
    p [16][4][32] (CUDA cores) or S / P [QR][36] and alpha [QR] (tensor
    cores); the inbox the cluster's partial states (one a tile slot of
    every rank, or one a rank on the tensor cores) fill for the
    ceil(G / cluster) heads this rank merges: acc [states][share][D], m
    and l [states][share]."""
    qr = _cdiv(g, 16) * 16 if tc else GM
    states = cluster if tc else cluster * slots
    return (qr * (d + 4) + slots * 2 * TK * (d + 4)
            + (qr * (TK + 4) + qr if tc else CUDA_WARPS * HW * TK)
            + states * _cdiv(g, cluster) * (d + 2))


def key_splits(sk: int, cluster: int) -> tuple[tuple[int, int], ...]:
    """The keys ``[lo, hi)`` each rank scores, in rank order: contiguous
    runs of 32-key tiles (``tc::rank_range`` over the tiles)."""
    tiles = _cdiv(sk, TK)
    return tuple((r * tiles // cluster * TK,
                  min((r + 1) * tiles // cluster * TK, sk))
                 for r in range(cluster))


def candidates(b: int, hq: int, hkv: int, sk: int,
               d: int) -> list[tuple[tuple, DecodePlan]]:
    """Every cluster size the keys allow, each with its sort key (the plan
    is the least key)."""
    _check(b, hq, hkv, sk, d)
    g = hq // hkv
    tc = g > GM
    tiles = max(1, _cdiv(sk, TK))
    room = SM_SMEM // 2 - 1024                 # a block of two on an SM
    out = []
    for cl in range(1, min(MAX_CLUSTER, tiles) + 1):
        per_rank = _cdiv(tiles, cl)
        if tc:
            fits = [ns for ns in range(2, MAX_STAGES + 1)
                    if ns <= per_rank + 1 and 4 * decode_smem_floats(
                        g, d, ns, cl, tc) <= room]
            slots = max(fits, default=2)
        else:
            slots = next((sl for sl in range(min(MAX_SLOTS, per_rank), 0,
                                             -1)
                          if 4 * decode_smem_floats(g, d, sl, cl, tc)
                          <= MAX_SMEM), 1)
        smem = 4 * decode_smem_floats(g, d, slots, cl, tc)
        if smem > MAX_SMEM:
            continue
        blocks = cl * b * hkv
        per_sm = blocks_per_sm(g, smem, tc)
        rounds = per_rank if tc else _cdiv(per_rank, slots)
        waves = _cdiv(b * hkv, sum(n * per_sm // cl for n in GPC_SMS))
        key = (waves * (rounds + 1), cl)
        out.append((key, DecodePlan(tc=tc, cluster=cl, slots=slots,
                                    keys=per_rank * TK, blocks=blocks,
                                    smem_bytes=smem)))
    if not out:
        raise ValueError(f"decode: no plan fits G={g} D={d}")
    return out


def blocks_per_sm(g: int, smem: int, tc: bool) -> int:
    """Blocks of the decode kernel an SM holds: one of 512 threads on the
    CUDA cores; on the tensor cores two where the registers allow (up to
    32 rows) and the shared memory does."""
    if not tc or g > 32:
        return 1
    return max(1, min(2, SM_SMEM // (smem + 1024)))


def _check(b: int, hq: int, hkv: int, sk: int, d: int) -> None:
    if b < 1 or hkv < 1 or hq % hkv or sk < 0:
        raise ValueError(f"decode: shape B={b} Hq={hq} Hkv={hkv} Sk={sk}")
    g = hq // hkv
    if g > MAX_G or d > MAX_D or d < 4 or d & (d - 1) or (g > GM and d < 8):
        raise ValueError(f"decode: G={g}, D={d} is past the kernel: G <= "
                         f"{MAX_G}, D a power of two from 4 (8 where G > "
                         f"{GM}) to {MAX_D}")
    if b * hkv > 65535:
        raise ValueError(f"decode: B * Hkv = {b * hkv} is past the grid")


@functools.cache
def plan_decode(b: int, hq: int, hkv: int, sk: int, d: int) -> DecodePlan:
    """The decode kernel's plan for q (b, hq, 1, d) against (b, hkv, sk,
    d)."""
    return min(candidates(b, hq, hkv, sk, d), key=lambda kp: kp[0])[1]
