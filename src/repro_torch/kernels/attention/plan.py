"""Host-side plans of K7's kernels (``flash_attention``,
``decode_attention``) on an H100.

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

``plan_flash`` chooses, for the flash kernel, the query rows a block takes
(``warps`` of 16 rows: 64 or 128), the depth of its cp.async ring of
K / V stages (2 or 3), and whether two groups of warps split a q tile's
key tiles between them (``kv_split``: twice the warps on the tile, half
the serial key tiles, and a merge of the two softmax states at the end).
Under a causal mask q tile i sees i + 1 key tiles, so the (batch, head, q
tile) items differ in cost by up to the q tiles' count; the grid runs
them heaviest first (block x takes q tile n - 1 - x // (B Hq) of (batch,
head) x % (B Hq)).  A block that took tiles i and n - 1 - i in turn, so
that every block's work is about the same, was slower than that order at
every shape swept (the Qwen2-0.5B prefill and the other dense configs'
geometry) and is not offered.  The choice is the least modelled
makespan: blocks are placed in launch order on the earliest free of
``blocks_per_sm`` slots on each of 132 SMs, a block lasting its serial
key tiles plus one (its q rows and its stores; plus ``MERGE_COST`` for a
key split) over the speed of a warp when the wave's blocks share its SM
(``SM_RATE``, measured); ties go to fewer warps, no split, then the
deeper ring.  A sweep of every plan on an H100
(``tools/plan_sweep.py --sweep --kernel flash_attention``) ranks the
plans this way at the LM paths' shapes.  One block serves one query head:
the heads of a GQA group each stage the group's K / V tiles themselves
(from L2), which keeps the kernel's work items small enough to balance.

``plan_flash_int8`` and ``plan_decode_int8`` choose, for the int8
kernels of ``csrc/flash_attention_int8.cu``, the rows a block takes (16,
32 or 64 of a (batch row, kv head)'s G x Sq query rows, the fewest that
hold them, at most 64) and, for the decode, a thread-block cluster that
splits a (batch row, kv head)'s 64-key tiles: enough ranks to put about
two blocks on each of the 132 SMs, at most one a key tile and 16.  The
prefill has blocks enough without one.

``plan_flash_bwd`` chooses, for the flash backward's two kernels, each
pass's warps and ring (the dQ pass: 64 or 128 query rows a block, heaviest
q tiles first, as the forward) and the dK/dV pass's balance: 16 keys a
warp (2, 4 or 8 warps), whether a block takes key tiles p and nkt - 1 - p
in turn (``pair``), and a thread-block cluster of up to 8 ranks that
splits a GQA group's heads, their partial dK and dV summed in rank order.
Under a causal mask key tile 0 is seen by every q tile and the last by
one; the model prices each dK/dV block at its serial (head, q tile) steps
plus one a key tile, places the blocks heaviest first on the earliest free
slot of 132 SMs (``_makespan``), and takes the least makespan, then the
smaller cluster, fewer warps, no pairing and the deeper ring.  The two
passes are planned independently.  A sweep of every plan on an H100
(``tools/bwd_sweep.py``) ranks them at the training path's call.
"""
from __future__ import annotations

import functools
import heapq
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
    if (g > MAX_G or d > MAX_D or d < 4 or (d & (d - 1) and d % 8)
            or (g > GM and d < 8)):
        raise ValueError(f"decode: G={g}, D={d} is past the kernel: G <= "
                         f"{MAX_G}, D up to {MAX_D}, a power of two from 4 "
                         f"(8 where G > {GM}) or a multiple of 8")
    if b * hkv > 65535:
        raise ValueError(f"decode: B * Hkv = {b * hkv} is past the grid")


@functools.cache
def plan_decode(b: int, hq: int, hkv: int, sk: int, d: int) -> DecodePlan:
    """The decode kernel's plan for q (b, hq, 1, d) against (b, hkv, sk,
    d)."""
    return min(candidates(b, hq, hkv, sk, d), key=lambda kp: kp[0])[1]


# --------------------------------------------------------------------------
# the flash kernel
# --------------------------------------------------------------------------
FLASH_WARPS = (4, 8)        # 64 or 128 query rows a block
WARP_ROWS = 16              # query rows a flash warp: one m16 tile
FLASH_RINGS = (2, 3)        # K / V stages in the cp.async ring
FLASH_MAX_WARPS = 8         # 256 threads a block
MERGE_COST = 0.5            # the key split's merge, in key tiles
# TF32 products an SM completes with the 3xTF32 splits beside them, by
# warps resident on it: 72, 126 and 180 TFLOP/s over the card at 4, 8 and
# 16 warps (tools/mma_rate.py, "mma+split", on an H100 at 700 W).  A warp
# alone on its quarter of the SM waits on its own latencies.
SM_RATE = ((4, 72.0), (8, 126.0), (16, 180.0))
MAX_GRID = 2 ** 31 - 1
# registers a thread at most (__launch_bounds__ of 256 threads, no floor
# on the blocks an SM holds)
FLASH_REGS = 255


@dataclass(frozen=True)
class FlashPlan:
    """One flash call's plan: ``blocks`` blocks of ``kv_split`` groups of
    ``warps`` warps (16 query rows each: ``rows`` a block), a ring of
    ``ring`` stages of K / V tiles of ``bk`` keys (one a group), q tiles
    heaviest first; ``per_sm`` blocks fit an SM; ``makespan`` is the
    model's, in key tiles over a warp's speed."""
    warps: int
    ring: int
    kv_split: int
    bk: int
    q_tiles: int
    blocks: int
    per_sm: int
    smem_bytes: int
    makespan: float

    @property
    def rows(self) -> int:
        return WARP_ROWS * self.warps


def flash_bk(d: int) -> int:
    """Keys a K / V tile: 64, or 32 where D > 64."""
    return 32 if d > 64 else 64


def flash_d_pad(d: int) -> int:
    """The width q, K and V take in shared memory: D padded with zero
    columns to 32, 64 or 128 (``fl::d_pad``)."""
    return 32 if d <= 32 else 64 if d <= 64 else 128


def flash_smem_floats(d: int, warps: int, ring: int, kv_split: int = 1
                      ) -> int:
    """Shared memory of the flash kernel in floats (``fl::smem_floats``):
    the q tile's rows [16 warps][D' + 4] and ``ring`` stages of
    ``kv_split`` tiles of K and V rows [2 bk][D' + 4], D' =
    ``flash_d_pad(d)``."""
    return ((WARP_ROWS * warps + ring * kv_split * 2 * flash_bk(d))
            * (flash_d_pad(d) + 4))


def flash_tile_keys(qt: int, rows: int, sq: int, sk: int, causal: bool,
                    q_offset: int, sk_valid: int | None) -> int:
    """The keys [0, n) any row of q tile ``qt`` sees (``fl::row_keys``)."""
    kv_end = sk if sk_valid is None else max(0, min(sk, sk_valid))
    if not causal:
        return kv_end
    return min(kv_end, q_offset + min((qt + 1) * rows, sq))


def flash_items(plan: FlashPlan, b: int, hq: int
                ) -> list[tuple[int, int, int]]:
    """Each block's (batch, head, q tile), blocks in launch order: the
    kernel's decoding of ``blockIdx.x``."""
    bh_n = b * hq
    return [((x % bh_n) // hq, x % hq, plan.q_tiles - 1 - x // bh_n)
            for x in range(plan.blocks)]


def flash_blocks_per_sm(warps: int, smem: int) -> int:
    """Blocks of the flash kernel an SM holds: shared memory, threads and
    registers (at the launch bounds' cap)."""
    return min(SM_SMEM // (smem + 1024), 2048 // (32 * warps),
               65536 // (32 * warps * (FLASH_REGS + 1)))


def _warp_speed(n: int) -> float:
    """A warp's share of ``SM_RATE`` when ``n`` warps share its SM."""
    pts = SM_RATE
    if n <= pts[0][0]:
        return pts[0][1] / pts[0][0]
    for (n0, r0), (n1, r1) in zip(pts, pts[1:]):
        if n <= n1:
            return (r0 + (r1 - r0) * (n - n0) / (n1 - n0)) / n
    return pts[-1][1] / n


def _makespan(costs: list[int], per_sm: int, warps: int) -> float:
    """Blocks of ``costs`` (key tiles + 1 each) placed in launch order on
    the earliest free of SMS * per_sm slots; each lasts its cost over a
    warp's speed when the blocks of a full wave share the SM."""
    live = min(per_sm, _cdiv(len(costs), SMS))
    speed = _warp_speed(live * warps)
    free = [0.0] * (SMS * per_sm)
    end = 0.0
    for c in costs:
        t = heapq.heappop(free) + c / speed
        end = max(end, t)
        heapq.heappush(free, t)
    return end


def _flash_check(b: int, hq: int, hkv: int, sq: int, sk: int, d: int,
                 q_offset: int) -> None:
    if b < 1 or hkv < 1 or hq % hkv or sq < 1 or sk < 0 or q_offset < 0:
        raise ValueError(f"flash: shape B={b} Hq={hq} Hkv={hkv} Sq={sq} "
                         f"Sk={sk} q_offset={q_offset}")
    if not 1 <= d <= MAX_D:
        raise ValueError(f"flash: D={d} is past the kernel: D from 1 to "
                         f"{MAX_D}")


def flash_candidates(b: int, hq: int, hkv: int, sq: int, sk: int, d: int,
                     causal: bool, q_offset: int, sk_valid: int | None
                     ) -> list[tuple[tuple, FlashPlan]]:
    """Every (warps, key split, ring) that fits, each with its sort key (the
    plan is the least key)."""
    _flash_check(b, hq, hkv, sq, sk, d, q_offset)
    bk = flash_bk(d)
    out = []
    for warps, kvs in [(w, k) for w in FLASH_WARPS for k in (1, 2)
                       if w * k <= FLASH_MAX_WARPS]:
        rows = WARP_ROWS * warps
        n = _cdiv(sq, rows)
        tiles = [_cdiv(flash_tile_keys(t, rows, sq, sk, causal, q_offset,
                                       sk_valid), bk) for t in range(n)]
        for ring in FLASH_RINGS:
            smem = 4 * flash_smem_floats(d, warps, ring, kvs)
            per_sm = flash_blocks_per_sm(warps * kvs, smem)
            if smem > MAX_SMEM or per_sm < 1:
                continue
            blocks = b * hq * n
            if blocks > MAX_GRID:
                continue
            cost = [_cdiv(tiles[t], kvs) + 1 + (MERGE_COST if kvs == 2
                                                else 0)
                    for t in reversed(range(n))]
            per_block = [c for c in cost for _ in range(b * hq)]
            span = _makespan(per_block, per_sm, warps * kvs)
            plan = FlashPlan(warps=warps, ring=ring, kv_split=kvs, bk=bk,
                             q_tiles=n, blocks=blocks, per_sm=per_sm,
                             smem_bytes=smem, makespan=span)
            out.append(((span, warps * kvs, kvs, -ring), plan))
    if not out:
        raise ValueError(f"flash: no plan fits D={d}")
    return out


@functools.cache
def plan_flash(b: int, hq: int, hkv: int, sq: int, sk: int, d: int,
               causal: bool = True, q_offset: int = 0,
               sk_valid: int | None = None) -> FlashPlan:
    """The flash kernel's plan for q (b, hq, sq, d) against (b, hkv, sk,
    d)."""
    return min(flash_candidates(b, hq, hkv, sq, sk, d, causal, q_offset,
                                sk_valid), key=lambda kp: kp[0])[1]


# --------------------------------------------------------------------------
# the flash backward kernels
# --------------------------------------------------------------------------
BWD_Q_WARPS = (4, 8)        # the dQ pass: 64 or 128 query rows a block
BWD_KV_WARPS = (2, 4, 8)    # the dK/dV pass: 32, 64 or 128 keys a block
BWD_KEY_ROWS = 16           # keys a dK/dV warp: one m16 tile
BWD_RINGS = (2, 3)          # stages of either pass's cp.async ring
BWD_BQ = 32                 # query rows a dK/dV ring stage
BWD_CLUSTERS = (1, 2, 4, 8)     # ... and G itself, where G <= 8
BWD_MAX_CLUSTER = 8
BWD_MERGE_COST = 0.5        # a cluster's merge of dK / dV, in steps


@dataclass(frozen=True)
class FlashBwdPlan:
    """One flash backward call's plan.

    The dQ pass (first): ``q_blocks`` blocks of ``q_warps`` warps (16 query
    rows each), a ring of ``q_ring`` stages of K / V tiles of ``q_bk``
    keys, q tiles heaviest first (``flash_items``' decoding).  It also
    writes each row's D = rowsum(dO O) and log2-unit log-sum-exp to a
    scratch of 2 (B, Hq, Sq) floats.

    The dK/dV pass: a block of ``kv_warps`` warps owns a key tile of 16
    keys a warp (``kv_keys``); with ``pair`` it takes key tiles ``p`` and
    ``nkt - 1 - p`` in turn (evening out causal work), else tile ``p``;
    ``cluster`` blocks share an item and split the GQA group's heads in
    contiguous runs, summing dK and dV over distributed shared memory in
    rank order; items run heaviest first.  Query tiles of ``kv_bq`` (32)
    rows (Q, dO, and their rows' D and log-sum-exp) stream through a ring
    of ``kv_ring`` stages.  ``*_per_sm`` blocks fit an SM; ``*_makespan`` is
    the model's, in serial steps over a warp's speed."""
    q_warps: int
    q_ring: int
    q_bk: int
    q_tiles: int
    q_blocks: int
    q_per_sm: int
    q_smem_bytes: int
    q_makespan: float
    kv_warps: int
    kv_ring: int
    kv_bq: int
    pair: bool
    cluster: int
    key_tiles: int
    kv_items: int
    kv_blocks: int
    kv_per_sm: int
    kv_smem_bytes: int
    kv_makespan: float

    @property
    def q_rows(self) -> int:
        return WARP_ROWS * self.q_warps

    @property
    def kv_keys(self) -> int:
        return BWD_KEY_ROWS * self.kv_warps


def flash_bwd_q_smem_floats(d: int, warps: int, ring: int) -> int:
    """Shared memory of the dQ pass in floats (``fb::q_smem_floats``): the
    block's Q and dO rows [2][16 warps][D' + 4], then ``ring`` stages of K
    and V tiles [2 bk][D' + 4], D' = ``flash_d_pad(d)``."""
    return ((2 * WARP_ROWS * warps + ring * 2 * flash_bk(d))
            * (flash_d_pad(d) + 4))


def flash_bwd_kv_smem_floats(d: int, warps: int, ring: int) -> int:
    """Shared memory of the dK/dV pass in floats (``fb::kv_smem_floats``):
    the block's K and V tiles [2][16 warps][D' + 4], the warps' dK and dV
    totals [2][16 warps][D' + 8], then ``ring`` stages of Q and dO tiles
    [2][32][D' + 4] with their rows' log-sum-exp and D [2][32]."""
    s = flash_d_pad(d) + 4
    return (2 * BWD_KEY_ROWS * warps * (s + flash_d_pad(d) + 8)
            + ring * (2 * BWD_BQ * s + 2 * BWD_BQ))


def _key_tile_rows(k0: int, sq: int, bq: int, causal: bool, q_offset: int,
                   kv_end: int) -> tuple[int, int]:
    """The q tiles [lo, n) of ``bq`` rows whose rows see a key in the tile
    that starts at key ``k0`` (``fb::kv_q_tiles``)."""
    n = _cdiv(sq, bq)
    if k0 >= kv_end:
        return 0, 0
    lo = max(0, k0 - q_offset) // bq if causal else 0
    return min(lo, n), n


def flash_bwd_pair_tiles(plan: FlashBwdPlan, p: int) -> tuple[int, ...]:
    """The key tiles of item slot ``p``: ``p`` and, paired, ``nkt - 1 -
    p`` where that is another tile."""
    other = plan.key_tiles - 1 - p
    return (p, other) if plan.pair and other != p else (p,)


def flash_bwd_kv_items(plan: FlashBwdPlan, b: int, hkv: int, g: int
                       ) -> list[list[tuple[int, int, int, int]]]:
    """Each dK/dV block's (batch, KV head, key tile, query head) items, in
    launch order: the kernel's decoding of ``blockIdx.x`` (item x // cluster
    heaviest first: slot x // cluster // (B Hkv) of (batch, KV head)
    x // cluster % (B Hkv); the rank x % cluster takes its contiguous run
    of the group's heads, ``tc::rank_range``)."""
    bhk_n = b * hkv
    out = []
    for x in range(plan.kv_blocks):
        item, rank = divmod(x, plan.cluster)
        p, bhk = divmod(item, bhk_n)
        bb, hk = divmod(bhk, hkv)
        h0, h1 = rank * g // plan.cluster, (rank + 1) * g // plan.cluster
        out.append([(bb, hk, kt, hk * g + h)
                    for kt in flash_bwd_pair_tiles(plan, p)
                    for h in range(h0, h1)])
    return out


def flash_bwd_q_items(plan: FlashBwdPlan, b: int, hq: int
                      ) -> list[tuple[int, int, int]]:
    """Each dQ block's (batch, head, q tile), in launch order: heaviest
    first, as the forward (``flash_items``)."""
    bh_n = b * hq
    return [((x % bh_n) // hq, x % hq, plan.q_tiles - 1 - x // bh_n)
            for x in range(plan.q_blocks)]


def flash_bwd_kv_costs(plan: FlashBwdPlan, b: int, hq: int, hkv: int,
                       sq: int, sk: int, causal: bool, q_offset: int,
                       sk_valid: int | None) -> list[float]:
    """Each dK/dV block's modelled cost in launch order: its serial (head,
    q tile) steps, plus one a key tile (its K / V load and its store) and
    ``BWD_MERGE_COST`` a key tile in a cluster."""
    kv_end = sk if sk_valid is None else max(0, min(sk, sk_valid))
    g = hq // hkv
    out = []
    for x in range(plan.kv_blocks):
        item, rank = divmod(x, plan.cluster)
        p = item // (b * hkv)
        heads = ((rank + 1) * g // plan.cluster
                 - rank * g // plan.cluster)
        cost = 0.0
        for kt in flash_bwd_pair_tiles(plan, p):
            lo, n = _key_tile_rows(kt * plan.kv_keys, sq, plan.kv_bq, causal,
                                   q_offset, kv_end)
            cost += heads * (n - lo) + 1 + (BWD_MERGE_COST
                                            if plan.cluster > 1 else 0)
        out.append(cost)
    return out


def flash_bwd_plain_costs(plan: FlashBwdPlan, b: int, hq: int, hkv: int,
                          sq: int, sk: int, causal: bool, q_offset: int,
                          sk_valid: int | None) -> list[float]:
    """The dK/dV blocks' costs in plain order (a block a (batch, KV head,
    key tile), its whole group, key tiles inner, as the kernel ran before
    its planner) at ``plan``'s key tile: the baseline the planner's
    balance is held against."""
    kv_end = sk if sk_valid is None else max(0, min(sk, sk_valid))
    g = hq // hkv
    costs = []
    for _bhk in range(b * hkv):
        for kt in range(plan.key_tiles):
            lo, n = _key_tile_rows(kt * plan.kv_keys, sq, plan.kv_bq, causal,
                                   q_offset, kv_end)
            costs.append(g * (n - lo) + 1.0)
    return costs


def _bwd_clusters(g: int) -> list[int]:
    return sorted({c for c in (*BWD_CLUSTERS, g) if c <= min(
        g, BWD_MAX_CLUSTER)})


def _flash_bwd_check(b: int, hq: int, hkv: int, sq: int, sk: int, d: int,
                     q_offset: int) -> None:
    if b < 1 or hkv < 1 or hq % hkv or sq < 1 or sk < 0 or q_offset < 0:
        raise ValueError(f"flash backward: shape B={b} Hq={hq} Hkv={hkv} "
                         f"Sq={sq} Sk={sk} q_offset={q_offset}")
    if not 1 <= d <= MAX_D:
        raise ValueError(f"flash backward: D={d} is past the kernel: D "
                         f"from 1 to {MAX_D}")


def flash_bwd_candidates(b: int, hq: int, hkv: int, sq: int, sk: int,
                         d: int, causal: bool, q_offset: int,
                         sk_valid: int | None
                         ) -> list[tuple[tuple, FlashBwdPlan]]:
    """Every option of each pass, each with its sort key (the plan is the
    least key).  The two passes are independent, so each dQ option is
    weighed beside the best dK/dV option and each dK/dV option beside the
    best dQ option: every option either pass offers is a candidate."""
    _flash_bwd_check(b, hq, hkv, sq, sk, d, q_offset)
    g = hq // hkv
    bk = flash_bk(d)
    qs = []
    for warps in BWD_Q_WARPS:
        rows = WARP_ROWS * warps
        n = _cdiv(sq, rows)
        tiles = [_cdiv(flash_tile_keys(t, rows, sq, sk, causal, q_offset,
                                       sk_valid), bk) for t in range(n)]
        for ring in BWD_RINGS:
            smem = 4 * flash_bwd_q_smem_floats(d, warps, ring)
            per_sm = flash_blocks_per_sm(warps, smem)
            blocks = b * hq * n
            if smem > MAX_SMEM or per_sm < 1 or blocks > MAX_GRID:
                continue
            cost = [tiles[t] + 1 for t in reversed(range(n))]
            span = _makespan([c for c in cost for _ in range(b * hq)],
                             per_sm, warps)
            qs.append(((span, warps, -ring), dict(
                q_warps=warps, q_ring=ring, q_bk=bk, q_tiles=n,
                q_blocks=blocks, q_per_sm=per_sm, q_smem_bytes=smem,
                q_makespan=span)))
    kvs = []
    for warps in BWD_KV_WARPS:
        nkt = _cdiv(sk, BWD_KEY_ROWS * warps)
        for pair in (False, True):
            if pair and nkt < 3:
                continue                # no tile has another to pair with
            slots = _cdiv(nkt, 2) if pair else nkt
            for cl in _bwd_clusters(g):
                for ring in BWD_RINGS:
                    smem = 4 * flash_bwd_kv_smem_floats(d, warps, ring)
                    per_sm = flash_blocks_per_sm(warps, smem)
                    items = b * hkv * slots
                    if (smem > MAX_SMEM or per_sm < 1
                            or items * cl > MAX_GRID):
                        continue
                    part = dict(kv_warps=warps, kv_ring=ring, kv_bq=BWD_BQ,
                                pair=pair, cluster=cl, key_tiles=nkt,
                                kv_items=items, kv_blocks=items * cl,
                                kv_per_sm=per_sm, kv_smem_bytes=smem,
                                kv_makespan=0.0)
                    kvs.append(part)
    if not qs or not kvs:
        raise ValueError(f"flash backward: no plan fits D={d}")
    keyed_kv = []
    for part in kvs:
        probe = FlashBwdPlan(**qs[0][1], **part)
        span = _makespan(flash_bwd_kv_costs(probe, b, hq, hkv, sq, sk,
                                            causal, q_offset, sk_valid),
                         probe.kv_per_sm, probe.kv_warps)
        part = dict(part, kv_makespan=span)
        keyed_kv.append(((span, part["cluster"], part["kv_warps"],
                          part["pair"], -part["kv_ring"]), part))
    best_q = min(qs, key=lambda kp: kp[0])
    best_kv = min(keyed_kv, key=lambda kp: kp[0])
    out = []
    for qk, qp in qs:
        out.append(((qk[0] + best_kv[0][0], qk, best_kv[0]),
                    FlashBwdPlan(**qp, **best_kv[1])))
    for kk, kp in keyed_kv:
        if kp is best_kv[1]:
            continue
        out.append(((best_q[0][0] + kk[0], best_q[0], kk),
                    FlashBwdPlan(**best_q[1], **kp)))
    return out


@functools.cache
def plan_flash_bwd(b: int, hq: int, hkv: int, sq: int, sk: int, d: int,
                   causal: bool = True, q_offset: int = 0,
                   sk_valid: int | None = None) -> FlashBwdPlan:
    """The flash backward kernels' plan for q (b, hq, sq, d) against (b,
    hkv, sk, d)."""
    return min(flash_bwd_candidates(b, hq, hkv, sq, sk, d, causal, q_offset,
                                    sk_valid), key=lambda kp: kp[0])[1]


# --------------------------------------------------------------------------
# the int8 kernels
# --------------------------------------------------------------------------
INT8_TK = 64                # keys a tile
INT8_ROWS = (16, 32, 64)    # rows a block
INT8_PW = INT8_TK // 4 + 4  # words a row of P and of V^T


@dataclass(frozen=True)
class Int8Plan:
    """One int8 call's plan: ``rows`` query rows a block (``tiles`` of them
    a (batch row, kv head)), ``cluster`` ranks splitting the keys, and the
    dynamic shared memory."""
    rows: int
    tiles: int
    cluster: int
    smem_bytes: int


def int8_smem_bytes(rows: int, d: int, cluster: int) -> int:
    """Shared memory of the int8 kernel in bytes (``i8::smem_bytes``):
    qq [rows][D/4 + 4] words, the K and V tiles [64][D/4 + 4], V^T [D][20],
    P [rows][20], the rows' (m, l) [rows][2]; with a cluster the partial
    outputs [rows][D]."""
    rw = d // 4 + 4
    words = rows * rw + 2 * INT8_TK * rw + d * INT8_PW + rows * INT8_PW \
        + 2 * rows
    if cluster > 1:
        words += rows * d
    return 4 * words


def _int8_check(b: int, hq: int, hkv: int, sq: int, d: int) -> None:
    if b < 1 or hkv < 1 or hq % hkv or sq < 1:
        raise ValueError(f"int8 attention: shape B={b} Hq={hq} Hkv={hkv} "
                         f"Sq={sq}")
    if d % 16 or not 16 <= d <= 128:
        raise ValueError(f"int8 attention: D={d} is past the kernel: a "
                         f"multiple of 16 from 16 to 128")
    if b * hkv > 65535 or _cdiv(hq // hkv * sq, INT8_ROWS[-1]) > 65535:
        raise ValueError(f"int8 attention: B={b} Hkv={hkv} G x Sq="
                         f"{hq // hkv * sq} is past the grid")


def _int8_rows(n: int) -> int:
    return next((r for r in INT8_ROWS if n <= r), INT8_ROWS[-1])


@functools.cache
def plan_flash_int8(b: int, hq: int, hkv: int, sq: int, sk: int,
                    d: int) -> Int8Plan:
    """The int8 flash kernel's plan for q (b, hq, sq, d) against (b, hkv,
    sk, d): no cluster."""
    _int8_check(b, hq, hkv, sq, d)
    rows = _int8_rows(hq // hkv * sq)
    return Int8Plan(rows=rows, tiles=_cdiv(hq // hkv * sq, rows), cluster=1,
                    smem_bytes=int8_smem_bytes(rows, d, 1))


@functools.cache
def plan_decode_int8(b: int, hq: int, hkv: int, sk: int,
                     d: int) -> Int8Plan:
    """The int8 decode kernel's plan for q (b, hq, 1, d) against (b, hkv,
    sk, d): a cluster of up to 16 ranks (one a 64-key tile at most) that
    brings the blocks to about two an SM."""
    _int8_check(b, hq, hkv, 1, d)
    rows = _int8_rows(hq // hkv)
    tiles = _cdiv(hq // hkv, rows)
    blocks = b * hkv * tiles
    cl = max(1, min(MAX_CLUSTER, _cdiv(max(sk, 1), INT8_TK),
                    _cdiv(2 * SMS, blocks)))
    return Int8Plan(rows=rows, tiles=tiles, cluster=cl,
                    smem_bytes=int8_smem_bytes(rows, d, cl))
