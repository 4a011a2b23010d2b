// K7: GQA attention with the online softmax, f32: the flash kernel on the
// tensor cores in 3xTF32, the decode of GQA groups up to 8 on the CUDA
// cores and wider groups' decode on the tensor cores (tc_common.cuh).
//
// Replaces the TPU kernel src/repro/kernels/attention/kernel.py
// `flash_attention` (body `_flash_kernel`) and its decode entry
// `decode_attention`, whose ragged `kv_len` case has no Pallas kernel there
// (it falls back to the jnp `masked_decode_ref`); here it is masked inside
// the decode kernel.
//
// Layouts, as the TPU kernel's: q and out (B, Hq, Sq, D) contiguous; k and
// v (B, Hkv, Sk, D) whose rows may be the first Sk of a cache holding
// `kv_cap` rows per (batch, kv head), so a cache cut to its filled prefix is
// read in place.  Query head h reads kv head h / G (G = Hq / Hkv): the GQA
// group is folded by index and no KV is duplicated.
//
// Masking: key position kp is visible to query row i when kp < min(Sk,
// sk_valid) and, if causal, kp <= q_offset + i.  At q_offset = 0 that is the
// TPU kernel's mask (query row 0 at key 0); at q_offset = Sk - Sq it is the
// bottom-right alignment of `attention_ref` and of the LM modules' chunked
// prefill against a cache.  Scores are dot * scale, masked to -inf; a row
// that sees no key yet keeps p = 0 and alpha = 1, and a row that sees no
// key at all is written as 0 (the TPU kernel's l == 0 rule).  For the
// backward (flash_attention_bwd.cu) the kernel also writes each row's
// log-sum-exp when it is given a pointer for it.
//
// Flash (prefill), bound on an H100: 4*D FLOPs per visible (query, key)
// pair against q, k, v and out read or written once: at Sq = Sk = 512,
// D = 64, G = 7 about 60 FLOPs a byte, so operations bound, at 165 TFLOP/s
// for 3xTF32 on the tensor cores.  Through mma.sync a warp issues about
// one m16n8k8 product in 16 cycles, and one in 26 with the splits beside
// it (tools/mma_rate.py), so the kernel keeps many warps on each SM and as
// few instructions as it can beside the products.  Design
// (flash_attention_kernel below; plan.py's plan_flash picks the warps,
// the ring and the key split per call):
//   * The TPU kernel walks a sequential k grid axis carrying (m, l, acc) in
//     VMEM scratch; blocks carry nothing here, so a block owns one q tile
//     of one (batch, q head) and loops over the key tiles
//     itself, FlashAttention-2 style: a warp owns 16 query rows and keeps
//     its score tile S, its output O and its (m, l) in registers.
//   * S = Q K^T and O += P V are m16n8k8 mma.sync products in 3xTF32 (each
//     operand split into tf32 hi and lo, lo*hi + hi*lo + hi*hi), the unit
//     and precision of K1, K3-K5 and the wide decode; the split is done in
//     integer operations (tc::split_tf32_bits, the bits of cvt.rna), since
//     the loops issue more splits than products.  The online softmax
//     reduces a row's max over the 4 lanes of a fragment row with shuffles;
//     each lane keeps a partial row sum, added across the 4 lanes once, at
//     the end.  P never leaves registers: S's n-tile j holds keys 8j + 2t
//     and 8j + 2t + 1 in lane (g, t), which are exactly the k = t and k =
//     t + 4 entries of P V's A fragment when its B fragment reads V rows
//     8j + 2t and 8j + 2t + 1; so the accumulator is the A operand, with no
//     shared memory, shuffle or barrier between the two products.
//   * K and V tiles (64 keys, 32 where D > 64) are staged by cp.async into
//     a ring of 2-3 stages: the copy of the next tile overlaps the products
//     on this one, one block barrier a tile.  Rows at or past min(Sk,
//     sk_valid) are zero-filled; the cache is read in place through kv_cap.
//     q, K and V sit in shared memory padded with zero columns to 32, 64
//     or 128 (every loop over features has a fixed count and no branch),
//     rows 4 floats apart beyond that, so every fragment load is free of
//     bank conflicts.
//   * Q sits in shared memory, each warp of the first group staging its own
//     rows once, before the key loop.  A warp skips the key tiles its rows
//     cannot see, and masks only the tiles that cross its causal edge or
//     sk_valid.
//   * Causal work is uneven (q tile i sees i + 1 key tiles).  The grid
//     runs the (batch, head, q tile) items heaviest first, decoded from
//     blockIdx.x alone; and where the heaviest tile's serial key tiles set
//     the time (the Qwen2-0.5B prefill), two groups of warps in one block
//     split a q tile's key tiles, each with a ring stage of its own and
//     both reading the same q rows, and the second group's (m, l, O) is
//     merged into the first's through shared memory at the end, in a fixed
//     order.
// Limits: D from 1 to 128.
//
// Decode (Sq = 1), bound on an H100: it reads every visible cache row once
// for G query heads, 4*G*D FLOPs against 8*D bytes a row: bytes bound at
// 3.35 TB/s while G stays under the f32 ridge (G about 20 at 67 TFLOP/s);
// at G = 48 (Granite's MQA) f32 on the CUDA cores would be operations
// bound.  Design (decode_attention_kernel below; plan.py's plan_decode
// picks the path, the cluster and the slots per call):
//   * One launch a call.  A thread-block cluster of up to 16 blocks owns a
//     (batch row, kv head) and splits its keys: rank r takes a contiguous
//     run of 32-key tiles (tc::rank_range).  The group's G query heads
//     share every K and V row, which leaves device memory once a group.
//   * G <= 8, on the CUDA cores: 16 warps, a pair of warps a tile slot.  A
//     slot's tile (K and V rows, zero past the row's visible keys) is
//     staged by cp.async; each warp of the pair takes 4 heads (q padded
//     with zero rows to 8, so no loop over heads branches): a lane a key
//     for the scores, the online softmax in registers, a lane a feature
//     for P.V with p read four keys at a time from shared memory.  All of
//     a rank's tiles are in flight at once when they fit (up to 8).
//   * G > 8, on the tensor cores in 3xTF32: 8 warps; q padded to a
//     multiple of 16 rows (at most 48), a cp.async ring of 2-4 tiles; S =
//     Q K^T in m16n8k8 fragments, the softmax a row a warp over S in
//     shared memory, leaving P there; P V accumulated in fragments,
//     rescaled a row at a time.
//   * Each partial softmax (m, l, acc) - a tile slot's, or a rank's on the
//     tensor cores - goes straight from registers into the shared memory
//     of the rank that merges its heads (distributed shared memory stores,
//     after a cluster barrier that every rank entered on starting).  After
//     one more barrier each rank merges its heads' states in order: no
//     scratch in device memory, no atomics, the same bits on every stream.
// `kv_len` (per batch row, may be NULL) is clamped to [0, Sk]; tiles past
// it are not loaded, and a row with no visible key is written as 0.
// Limits: G <= 48, D up to 128: a power of two from 4 (8 where G > 8),
// or a multiple of 8 (Zamba2's 80).
//
// No atomics: the result does not depend on the stream or the launch.
#include <math.h>

#include "tc_common.cuh"

namespace {

constexpr int MAX_D = 128;           // the widest head, flash and decode

namespace fl {

constexpr int MAX_WARPS = 8;
constexpr int WROWS = 16;            // query rows a warp: one m16 tile

// D padded with zero columns to the instance's width (32, 64 or 128), so
// that every loop over features has a fixed count and no branch
__host__ __device__ inline int d_pad(int D) {
  return D <= 32 ? 32 : D <= 64 ? 64 : 128;
}
__host__ __device__ inline int stride(int D) { return d_pad(D) + 4; }
// keys a tile: 64, or 32 where D > 64 (the ring's stages stay at 34 KB)
__host__ __device__ inline int bk(int D) { return D > 64 ? 32 : 64; }

// Shared memory in floats (plan.py's flash_smem_floats): the q tile's
// rows [16 warps][D' + 4] (a group's warps), then `ring` stages of kvs
// tiles of K and V rows [2 bk][D' + 4], D' = d_pad(D).
__host__ __device__ inline int smem_floats(int D, int warps, int ring,
                                           int kvs) {
  return (WROWS * warps + ring * kvs * 2 * bk(D)) * stride(D);
}

// q tiles of a (batch, head)
__host__ __device__ inline int q_tiles(int Sq, int warps) {
  return repro_cdiv(Sq, WROWS * warps);
}

// The keys [0, n) that any row below r1 sees: keys below kv_end, and, if
// causal, up to q_offset + row.
__device__ __forceinline__ int row_keys(int r1, int Sq, int kv_end,
                                        int causal, int q_offset) {
  return causal ? min(kv_end, q_offset + min(r1, Sq)) : kv_end;
}

// O / l for the warp's rows r0 + g and r0 + g + 8 (those below Sq) at
// columns below D; a row with l = 0 (no key seen) is written as 0.  l is
// the lane's partial sum, added over the 4 lanes of the fragment row here.
// With lb (the (batch, head)'s rows of the log-sum-exp; null when not
// asked) also each row's log-sum-exp of its scaled scores in natural
// units, (m + log2 l) ln 2 (m the row's max in log2 units), -inf for a row
// that sees no key; O's arithmetic is the same with or without it.
template <int ND>
__device__ __forceinline__ void store_rows(float* __restrict__ ob,
                                           float* __restrict__ lb,
                                           const float (&o)[ND][4],
                                           const float (&m)[2],
                                           const float (&l)[2], int r0,
                                           int Sq, int D) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float s = l[h] + __shfl_xor_sync(0xffffffffu, l[h], 1);
    s += __shfl_xor_sync(0xffffffffu, s, 2);
    const float inv = s == 0.f ? 0.f : 1.f / s;
    const int row = r0 + g + 8 * h;
    if (row >= Sq) continue;
    if (lb != nullptr && t4 == 0)
      lb[row] = s == 0.f ? -INFINITY
                         : (m[h] + log2f(s)) * 0.6931471805599453f;
    float* orow = ob + (size_t)row * D;
#pragma unroll
    for (int nd = 0; nd < ND; ++nd) {
      const int c = 8 * nd + 2 * t4;
      if (c < D) orow[c] = o[nd][2 * h] * inv;
      if (c + 1 < D) orow[c + 1] = o[nd][2 * h + 1] * inv;
    }
  }
}

// 2^x (ex2.approx.ftz: about 2 ulp; a result below 2^-126 is 0)
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// One (batch, q head) q tile a block, blockIdx.x decoded as bh = x % (B
// Hq) and q tile n - 1 - x / (B Hq): the grid runs the heaviest tiles
// first.  DM: d_pad(D), the width q, K and V take in shared memory (zero
// past D).  The block's warps form kvs groups of blockDim.x / 32 / kvs
// warps, 16 query rows each; with kvs = 2 the groups take the first and
// the second half of the q tile's key tiles at once, and the second
// group's softmax state is merged into the first's through shared memory
// at the end.
// scale_log2: softmax scale times log2(e) (the exponentials are exp2).
// vec: K and V rows may be staged in 16-byte copies.
template <int DM>
__global__ void __launch_bounds__(32 * MAX_WARPS)
flash_attention_kernel(const float* __restrict__ q,
                       const float* __restrict__ k,
                       const float* __restrict__ v, float* __restrict__ out,
                       float* __restrict__ lse, int B, int Hq, int Hkv,
                       int Sq, int Sk, int D,
                       int kv_cap, int causal, int q_offset, int sk_valid,
                       float scale_log2, int ring, int kvs, int vec) {
  constexpr int BK = DM > 64 ? 32 : 64;
  constexpr int NJ = BK / 8;           // S's n-tiles: 8 keys each
  constexpr int ND = DM / 8;           // S's k-steps, O's n-tiles
  constexpr int S = DM + 4;            // row stride of q, K and V
  constexpr int TF = 2 * BK * S;       // floats a K and V tile
  extern __shared__ __align__(16) float smem[];
  const int NW = (blockDim.x >> 5) / kvs;   // warps a group
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int grp = warp / NW, wg = warp - grp * NW;
  const int g = lane >> 2, t4 = lane & 3;
  float* qs = smem + wg * WROWS * S;   // the warp's q rows [WROWS][S]
  float* ring_base = smem + NW * WROWS * S;

  const int BQ = WROWS * NW;
  const int BH = B * Hq;
  const int bh = blockIdx.x % BH;
  const int qt = q_tiles(Sq, NW) - 1 - blockIdx.x / BH;
  const int b = bh / Hq, h = bh - b * Hq;
  const int hk = h / (Hq / Hkv);
  const float* qb = q + (size_t)bh * Sq * D;
  float* ob = out + (size_t)bh * Sq * D;
  float* lb = lse == nullptr ? nullptr : lse + (size_t)bh * Sq;
  const float* kb = k + ((size_t)b * Hkv + hk) * kv_cap * D;
  const float* vb = v + ((size_t)b * Hkv + hk) * kv_cap * D;
  const int kv_end = min(Sk, max(sk_valid, 0));

  // the q tile's rows see key tiles [0, nt); a tile no key reaches is 0
  const int nt = repro_cdiv(
      row_keys((qt + 1) * BQ, Sq, kv_end, causal, q_offset), BK);
  if (nt == 0) {
    const int rows = min(BQ, Sq - qt * BQ);
    for (int e = threadIdx.x; e < rows * D; e += blockDim.x)
      ob[(size_t)qt * BQ * D + e] = 0.f;
    if (lb != nullptr)
      for (int e = threadIdx.x; e < rows; e += blockDim.x)
        lb[qt * BQ + e] = -INFINITY;
    return;
  }
  // group gg takes key tiles [gg * steps, (gg + 1) * steps), one a step
  const int steps = kvs == 2 ? repro_cdiv(nt, 2) : nt;

  // step s: each group's key tile, if it has one, into its ring stage
  auto stage = [&](int s) {
    constexpr int QUADS = DM / 4;
    for (int gg = 0; gg < kvs; ++gg) {
      const int kt = gg * steps + s;
      if (kt >= nt) continue;
      float* dst = ring_base + ((s % ring) * kvs + gg) * TF;
      for (int idx = threadIdx.x; idx < 2 * BK * QUADS; idx += blockDim.x) {
        const int r = idx / QUADS;
        const int c4 = 4 * (idx - r * QUADS);
        const int isv = r >= BK;
        const int key = kt * BK + r - isv * BK;
        const int valid = key < kv_end ? min(4, max(0, D - c4)) : 0;
        tc::cp_quad(dst + r * S + c4, (isv ? vb : kb) + (size_t)key * D + c4,
                    valid, vec != 0, kb);
      }
    }
  };

  for (int j = 0; j < ring - 1; ++j) {
    if (j < steps) stage(j);
    tc::cp_commit();
  }

  // the warp's rows, the keys they see, and its q rows in shared memory
  // (staged by the first group; the loop's first barrier publishes them)
  const int r0 = qt * BQ + WROWS * wg;
  const int wkeys =
      r0 >= Sq ? 0 : row_keys(r0 + WROWS, Sq, kv_end, causal, q_offset);
  if (grp == 0) {
    float qv[DM / 2];                  // a lane's loads all in flight
#pragma unroll
    for (int i = 0; i < DM / 2; ++i) {
      const int r = (lane + 32 * i) / DM, c = (lane + 32 * i) % DM;
      qv[i] = r0 + r < Sq && c < D ? qb[(size_t)(r0 + r) * D + c] : 0.f;
    }
#pragma unroll
    for (int i = 0; i < DM / 2; ++i)
      qs[((lane + 32 * i) / DM) * S + (lane + 32 * i) % DM] = qv[i];
    __syncwarp();
  }

  float o[ND][4], m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
#pragma unroll
  for (int nd = 0; nd < ND; ++nd)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[nd][e] = 0.f;
  for (int s = 0; s < steps; ++s) {
    tc::cp_wait_n(ring - 2);           // step s has landed
    __syncthreads();                   // ... for all; step s - 1 is done
    if (s + ring - 1 < steps) stage(s + ring - 1);
    tc::cp_commit();
    const int kt = grp * steps + s;
    const int key0 = kt * BK;
    if (kt >= nt || key0 >= wkeys) continue;   // no key of it is visible
    const float* Ks = ring_base + ((s % ring) * kvs + grp) * TF;
    const float* Vs = Ks + BK * S;

    // S = Q K^T: A (16 x 8) from q, B(k = d, n = key) = K[key][d]
    float sc[NJ][4];
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < ND; ++kk) {
      const float* A = qs + 8 * kk;
      uint32_t ah[4], al[4];
      tc::split_tf32_bits(A[g * S + t4], ah[0], al[0]);
      tc::split_tf32_bits(A[(g + 8) * S + t4], ah[1], al[1]);
      tc::split_tf32_bits(A[g * S + t4 + 4], ah[2], al[2]);
      tc::split_tf32_bits(A[(g + 8) * S + t4 + 4], ah[3], al[3]);
      const float* Bk = Ks + g * S + 8 * kk + t4;
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        uint32_t bh2[2], bl2[2];
        tc::split_tf32_bits(Bk[8 * j * S], bh2[0], bl2[0]);
        tc::split_tf32_bits(Bk[8 * j * S + 4], bh2[1], bl2[1]);
        tc::mma_tf32(sc[j], al, bh2);
        tc::mma_tf32(sc[j], ah, bl2);
        tc::mma_tf32(sc[j], ah, bh2);
      }
    }

    // the online softmax, in log2 units: lane (g, t) holds rows g (e < 2)
    // and g + 8 (e >= 2) at keys key0 + 8j + 2t + (e & 1).  A tile that
    // every row of the warp sees whole needs no mask; else selects, not
    // branches: the key limit of row g + 8h is lim[h] past the lane's
    // first key.
    float mx[2] = {-INFINITY, -INFINITY};
    if (key0 + BK <= kv_end &&
        (!causal || key0 + BK - 1 <= q_offset + r0)) {
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          sc[j][e] *= scale_log2;
          mx[e >> 1] = fmaxf(mx[e >> 1], sc[j][e]);
        }
    } else {
      int lim[2];
#pragma unroll
      for (int hh = 0; hh < 2; ++hh)
        lim[hh] = (causal ? min(kv_end, q_offset + r0 + g + 8 * hh + 1)
                          : kv_end) - key0 - 2 * t4;
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float x = 8 * j + (e & 1) < lim[e >> 1]
                              ? sc[j][e] * scale_log2 : -INFINITY;
          sc[j][e] = x;
          mx[e >> 1] = fmaxf(mx[e >> 1], x);
        }
    }
    float alpha[2], rs[2] = {0.f, 0.f};
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      mx[hh] = fmaxf(mx[hh], __shfl_xor_sync(0xffffffffu, mx[hh], 1));
      mx[hh] = fmaxf(mx[hh], __shfl_xor_sync(0xffffffffu, mx[hh], 2));
      const float m_new = fmaxf(m[hh], mx[hh]);
      // a row with no key yet keeps m = -inf, l = 0, p = 0 and alpha = 1
      alpha[hh] = m_new == -INFINITY ? 1.f : fast_exp2(m[hh] - m_new);
      mx[hh] = m_new;
      m[hh] = m_new;
    }
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float mr = mx[e >> 1];
        const float p = mr == -INFINITY ? 0.f : fast_exp2(sc[j][e] - mr);
        sc[j][e] = p;
        rs[e >> 1] += p;
      }
    l[0] = l[0] * alpha[0] + rs[0];
    l[1] = l[1] * alpha[1] + rs[1];
#pragma unroll
    for (int nd = 0; nd < ND; ++nd) {
      o[nd][0] *= alpha[0];
      o[nd][1] *= alpha[0];
      o[nd][2] *= alpha[1];
      o[nd][3] *= alpha[1];
    }

    // O += P V: P's A fragment is S's accumulator (see the header), B(k,
    // n = d) = V[key][d] at keys 8j + 2t (k = t) and 8j + 2t + 1 (k = t + 4)
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      uint32_t ph[4], pl[4];
      tc::split_tf32_bits(sc[j][0], ph[0], pl[0]);
      tc::split_tf32_bits(sc[j][2], ph[1], pl[1]);
      tc::split_tf32_bits(sc[j][1], ph[2], pl[2]);
      tc::split_tf32_bits(sc[j][3], ph[3], pl[3]);
      const float* Bv = Vs + (8 * j + 2 * t4) * S + g;
#pragma unroll
      for (int nd = 0; nd < ND; ++nd) {
        uint32_t bh2[2], bl2[2];
        tc::split_tf32_bits(Bv[8 * nd], bh2[0], bl2[0]);
        tc::split_tf32_bits(Bv[S + 8 * nd], bh2[1], bl2[1]);
        tc::mma_tf32(o[nd], pl, bh2);
        tc::mma_tf32(o[nd], ph, bl2);
        tc::mma_tf32(o[nd], ph, bh2);
      }
    }
  }
  tc::cp_wait<0>();
  if (kvs == 2) {
    // the second group's (m, l, O) per lane, then merged into the first's
    float* mb = ring_base + (wg * 32 + lane) * (4 * ND + 4);
    __syncthreads();                   // the ring is free
    if (grp == 1) {
#pragma unroll
      for (int nd = 0; nd < ND; ++nd)
#pragma unroll
        for (int e = 0; e < 4; ++e) mb[4 * nd + e] = o[nd][e];
      mb[4 * ND] = m[0];
      mb[4 * ND + 1] = m[1];
      mb[4 * ND + 2] = l[0];
      mb[4 * ND + 3] = l[1];
    }
    __syncthreads();
    if (grp == 1) return;
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const float mo = mb[4 * ND + hh];
      const float mn = fmaxf(m[hh], mo);
      const float fa = m[hh] == -INFINITY ? 0.f : fast_exp2(m[hh] - mn);
      const float fb = mo == -INFINITY ? 0.f : fast_exp2(mo - mn);
      l[hh] = l[hh] * fa + mb[4 * ND + 2 + hh] * fb;
      m[hh] = mn;                      // (l, O) are now relative to mn
#pragma unroll
      for (int nd = 0; nd < ND; ++nd)
#pragma unroll
        for (int e = 2 * hh; e < 2 * hh + 2; ++e)
          o[nd][e] = o[nd][e] * fa + mb[4 * nd + e] * fb;
    }
  }
  store_rows(ob, lb, o, m, l, r0, Sq, D);
}

using Kernel = decltype(&flash_attention_kernel<64>);

Kernel pick(int D) {
  return D <= 32 ? flash_attention_kernel<32>
         : D <= 64 ? flash_attention_kernel<64>
                   : flash_attention_kernel<128>;
}

}  // namespace fl

// ------------------------------------------------------------------ decode
namespace dec {

constexpr int TK = 32;               // keys a tile: a lane each
constexpr int GM = 8;                // the CUDA cores' groups, padded
constexpr int HW = 4;                // ... heads a warp: two warps a tile
constexpr int WPT = GM / HW;
constexpr int CUDA_THREADS = 512;    // the CUDA cores' blocks: 16 warps
constexpr int TC_THREADS = 256;      // the tensor cores' blocks: 8 warps
constexpr int MAX_SLOTS = CUDA_THREADS / 32 / WPT;   // 8 tiles in flight
constexpr int MAX_G = 48;            // the tensor cores' rows, padded
constexpr int SS = TK + 4;           // row stride of the S / P tile
constexpr int MAX_CLUSTER = 16;

__host__ __device__ inline int kv_stride(int D) { return D + 4; }
// a tile's K and V rows, [2 TK][D + 4]
__host__ __device__ inline int tile_floats(int D) {
  return 2 * TK * kv_stride(D);
}
// q rows in shared memory: the group padded with zero rows to GM on the
// CUDA cores, to a multiple of 16 on the tensor cores, so that every loop
// over heads or m-tiles runs a fixed count without a branch
__host__ __device__ inline int q_rows(int G, bool tc) {
  return tc ? tc::round_up(G, 16) : GM;
}
// heads of a (batch row, kv head) whose outputs each rank merges
__host__ __device__ inline int head_share(int G, int cl) {
  return repro_cdiv(G, cl);
}
// partial softmax states of a (batch row, kv head): one a tile slot of
// every rank (CUDA cores), one a rank (tensor cores)
__host__ __device__ inline int states(int slots, int cl, bool tc) {
  return tc ? cl : cl * slots;
}

// Shared memory in floats (plan.py's decode_smem_floats): q [QR][D + 4]
// (QR = q_rows); `slots` tiles (the CUDA cores: a warp pair's tile each;
// the tensor cores: the ring's stages); the warps' p [warps][HW][TK], or S
// / P [QR][SS] and alpha [QR]; the inbox the cluster's states fill for the
// heads this rank merges: acc [states][share][D], m and l [states][share].
int smem_floats(int G, int D, int slots, int cl, bool tc) {
  const int qr = q_rows(G, tc);
  return qr * kv_stride(D) + slots * tile_floats(D) +
         (tc ? qr * SS + qr : CUDA_THREADS / 32 * HW * TK) +
         states(slots, cl, tc) * head_share(G, cl) * (D + 2);
}

// Stage tile `key0` .. + TK of K and V into dst ([2 TK][KS]: K rows, then
// V rows) with `n` threads, thread `t`; rows at or past nk are zero.  A
// thread copies quad t % quads of rows t / quads + k n / quads, quads = D /
// 4 <= n; where quads does not divide n (D = 80: 20 quads), the last n %
// quads threads copy nothing.
__device__ __forceinline__ void stage_tile(float* dst, const float* kb,
                                           const float* vb, int key0, int nk,
                                           int D, int KS, int t, int n,
                                           bool vec) {
  const int quads = D / 4;
  const int rstep = n / quads;
  if (t >= rstep * quads) return;
  const int qd = t % quads;
  for (int r = t / quads; r < 2 * TK; r += rstep) {
    const int half = r >= TK;
    const int rr = r - half * TK;
    tc::cp_quad(dst + r * KS + 4 * qd,
                (half ? vb : kb) + (size_t)(key0 + rr) * D + 4 * qd,
                rr < nk ? 4 : 0, vec, kb);
  }
}

// The max and the sum of N values over the warp, the N in step.
template <int N>
__device__ __forceinline__ void warp_max_n(float (&v)[N]) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
#pragma unroll
    for (int i = 0; i < N; ++i)
      v[i] = fmaxf(v[i], __shfl_xor_sync(0xffffffffu, v[i], o));
}

template <int N>
__device__ __forceinline__ void warp_sum_n(float (&v)[N]) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
#pragma unroll
    for (int i = 0; i < N; ++i) v[i] += __shfl_xor_sync(0xffffffffu, v[i], o);
}

// One tile's online-softmax step for N rows, a lane a key: s holds each
// row's scaled score at this lane's key (-inf where masked) and becomes p;
// m and l are updated, a is each row's rescale of its acc.  A row with no
// key yet keeps m = -inf, l = 0, p = 0 and a = 1.
template <int N>
__device__ __forceinline__ void softmax_step(float (&s)[N], float (&m)[N],
                                             float (&l)[N], float (&a)[N]) {
  float mx[N];
#pragma unroll
  for (int i = 0; i < N; ++i) mx[i] = s[i];
  warp_max_n(mx);
  float ps[N];
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const float m_new = fmaxf(m[i], mx[i]);
    a[i] = m_new == -INFINITY ? 1.f : expf(m[i] - m_new);
    s[i] = m_new == -INFINITY ? 0.f : expf(s[i] - m_new);
    m[i] = m_new;
    ps[i] = s[i];
  }
  warp_sum_n(ps);
#pragma unroll
  for (int i = 0; i < N; ++i) l[i] = l[i] * a[i] + ps[i];
}

__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}
// a barrier of the two warps of tile slot t (ids 1 ..; 0 is __syncthreads)
__device__ __forceinline__ void pair_sync(int t) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(1 + t), "r"(32 * WPT) : "memory");
}

// One (batch row, kv head) a cluster of gridDim.x ranks, blockIdx.y =
// b * Hkv + hk.  TC: the products on the tensor cores (TC_THREADS
// threads), P = MT m-tiles of 16 heads (G <= 16 MT), `slots` ring stages;
// else on the CUDA cores (CUDA_THREADS threads: a pair of warps a tile
// slot, HW heads each; G up to GM), `slots` tiles in flight, P = DPL
// features a lane (D <= 32 DPL).  vec: K and V may be staged in 16-byte
// copies.
template <bool TC, int P>
__global__ void __launch_bounds__(TC ? TC_THREADS : CUDA_THREADS,
                                  TC && P < 3 ? 2 : 1)
decode_attention_kernel(const float* __restrict__ q,
                        const float* __restrict__ k,
                        const float* __restrict__ v,
                        const int* __restrict__ kv_len,
                        float* __restrict__ out, int Hq, int Hkv, int Sk,
                        int D, int kv_cap, int slots, int vec, float scale) {
  namespace cg = cooperative_groups;
  constexpr int NT = TC ? TC_THREADS : CUDA_THREADS;
  cg::cluster_group cluster = cg::this_cluster();
  extern __shared__ __align__(16) float smem[];
  const int G = Hq / Hkv;
  const int QR = q_rows(G, TC);
  const int KS = kv_stride(D);
  const int TF = tile_floats(D);
  const int cl = gridDim.x, rank = blockIdx.x;
  const int HS = head_share(G, cl);
  const int S = states(slots, cl, TC);
  float* qs = smem;                          // [QR][KS]
  float* work = qs + QR * KS;                // the tiles
  float* extra = work + slots * TF;          // p, or S / P and alpha
  float* in_acc = extra + (TC ? QR * SS + QR : NT / 32 * HW * TK);
  float* in_m = in_acc + S * HS * D;         // [S][HS]
  float* in_l = in_m + S * HS;               // [S][HS]

  // the ranks' shared memory is written only once every rank has begun
  if (cl > 1) cluster_arrive_relaxed();

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int bh = blockIdx.y;
  const int b = bh / Hkv, hk = bh - b * Hkv;
  const float* qb = q + ((size_t)b * Hq + (size_t)hk * G) * D;
  const float* kb = k + (size_t)bh * kv_cap * D;
  const float* vb = v + (size_t)bh * kv_cap * D;
  int len = Sk;
  if (kv_len != nullptr) len = min(max(kv_len[b], 0), Sk);
  int t0, t1;
  tc::rank_range(repro_cdiv(Sk, TK), cl, rank, t0, t1);
  t1 = min(t1, repro_cdiv(len, TK));         // tiles past len: no key
  const int nloc = max(0, t1 - t0);

  // push(s, g, m, l, row): state s's softmax of head g to the inbox of the
  // rank that merges it; the acc row is written by the caller through dst
  auto inbox_row = [&](int s, int g) -> int {
    return s * HS + g - (g / HS) * HS;
  };
  auto remote = [&](float* p, int g) -> float* {
    return cl == 1 ? p : cluster.map_shared_rank(p, g / HS);
  };

  if constexpr (!TC) {
    constexpr int DPL = P;
    const int t = warp / WPT, hf = warp % WPT;   // tile slot, heads half
    float* ks = work + t * TF;
    const float* vs = ks + TK * KS;
    float* pw = extra + warp * HW * TK;          // [HW][TK]
    const float* qh = qs + hf * HW * KS;         // the warp's q rows
    float m[HW], l[HW], acc[HW][DPL];
#pragma unroll
    for (int i = 0; i < HW; ++i) {
      m[i] = -INFINITY;
      l[i] = 0.f;
#pragma unroll
      for (int j = 0; j < DPL; ++j) acc[i][j] = 0.f;
    }
    const int pt = hf * 32 + lane;               // thread in the pair
    if (t < slots && t < nloc) {                 // the slot's first tile
      stage_tile(ks, kb, vb, (t0 + t) * TK, min(TK, len - (t0 + t) * TK), D,
                 KS, pt, 32 * WPT, vec);
      tc::cp_commit();
    }
    for (int i = threadIdx.x; i < GM * D; i += NT) {
      const int r = i / D;
      qs[r * KS + i - r * D] = r < G ? qb[i] : 0.f;
    }
    __syncthreads();                             // q is in
    if (t < slots) {
      for (int j = t; j < nloc; j += slots) {
        const int key0 = (t0 + j) * TK;
        const int nk = min(TK, len - key0);      // >= 1
        if (j != t) {                            // the slot's next tile
          pair_sync(t);                          // ... once both are done
          stage_tile(ks, kb, vb, key0, nk, D, KS, pt, 32 * WPT, vec);
          tc::cp_commit();
        }
        tc::cp_wait<0>();
        pair_sync(t);                            // both halves have landed
        // scores: a lane a key, the warp's HW heads
        float s[HW];
#pragma unroll
        for (int i = 0; i < HW; ++i) s[i] = 0.f;
        const float* kr = ks + lane * KS;
#pragma unroll 4
        for (int d = 0; d < D; d += 4) {
          const float4 kk = *reinterpret_cast<const float4*>(kr + d);
#pragma unroll
          for (int i = 0; i < HW; ++i) {         // rows past G are zero
            const float4 qq =
                *reinterpret_cast<const float4*>(qh + i * KS + d);
            s[i] = fmaf(qq.x, kk.x, s[i]);
            s[i] = fmaf(qq.y, kk.y, s[i]);
            s[i] = fmaf(qq.z, kk.z, s[i]);
            s[i] = fmaf(qq.w, kk.w, s[i]);
          }
        }
        const bool ok = lane < nk;
#pragma unroll
        for (int i = 0; i < HW; ++i)
          s[i] = ok && hf * HW + i < G ? s[i] * scale : -INFINITY;
        float a[HW];
        softmax_step(s, m, l, a);
#pragma unroll
        for (int i = 0; i < HW; ++i) {
          pw[i * TK + lane] = s[i];
#pragma unroll
          for (int jd = 0; jd < DPL; ++jd) acc[i][jd] *= a[i];
        }
        __syncwarp();
        // P.V: a lane a feature, four keys a step (V rows past nk are
        // zero, as are their p)
#pragma unroll 4
        for (int c = 0; c < TK; c += 4) {
          float vv[4][DPL];
#pragma unroll
          for (int u = 0; u < 4; ++u)
#pragma unroll
            for (int jd = 0; jd < DPL; ++jd) {
              const int d = lane + 32 * jd;
              vv[u][jd] = d < D ? vs[(c + u) * KS + d] : 0.f;
            }
#pragma unroll
          for (int i = 0; i < HW; ++i) {         // p past G is zero
            const float4 pp =
                *reinterpret_cast<const float4*>(pw + i * TK + c);
#pragma unroll
            for (int jd = 0; jd < DPL; ++jd) {
              acc[i][jd] = fmaf(pp.x, vv[0][jd], acc[i][jd]);
              acc[i][jd] = fmaf(pp.y, vv[1][jd], acc[i][jd]);
              acc[i][jd] = fmaf(pp.z, vv[2][jd], acc[i][jd]);
              acc[i][jd] = fmaf(pp.w, vv[3][jd], acc[i][jd]);
            }
          }
        }
        __syncwarp();                            // p is free
      }
      // the slot's state, straight from registers to the merging ranks
      if (cl > 1) cluster_wait();                // every rank has begun
      const int st = rank * slots + t;
#pragma unroll
      for (int i = 0; i < HW; ++i) {
        const int g = hf * HW + i;
        if (g < G) {
          const int row = inbox_row(st, g);
          float* dst = remote(in_acc, g) + row * D;
#pragma unroll
          for (int jd = 0; jd < DPL; ++jd) {
            const int d = lane + 32 * jd;
            if (d < D) dst[d] = acc[i][jd];
          }
          if (lane == 0) {
            remote(in_m, g)[row] = m[i];
            remote(in_l, g)[row] = l[i];
          }
        }
      }
    } else if (cl > 1) {
      cluster_wait();
    }
  } else {
    constexpr int MT = P;                        // QR / 16
    constexpr int NW = TC_THREADS / 32;
    const int g8 = lane >> 2, t4 = lane & 3;
    const int ns = slots;
    float* sp = extra;                           // [QR][SS]
    float* alpha_s = sp + QR * SS;               // [QR]
    auto stage = [&](int tt, int buf) {
      stage_tile(work + buf * TF, kb, vb, tt * TK, min(TK, len - tt * TK),
                 D, KS, threadIdx.x, NT, vec);
    };
    for (int j = 0; j < ns - 1; ++j) {
      if (j < nloc) stage(t0 + j, j);
      tc::cp_commit();
    }
    for (int i = threadIdx.x; i < QR * D; i += NT) {
      const int r = i / D, d = i - r * D;
      qs[r * KS + d] = r < G ? qb[i] : 0.f;
    }
    for (int r = G + threadIdx.x; r < QR; r += NT) alpha_s[r] = 1.f;

    constexpr int RW = 2 * MT;                   // softmax rows a warp
    float m[RW], l[RW];
#pragma unroll
    for (int i = 0; i < RW; ++i) {
      m[i] = -INFINITY;
      l[i] = 0.f;
    }
    float acc[MT][2][4];                         // [m-tile][n-tile][frag]
#pragma unroll
    for (int a = 0; a < MT; ++a)
#pragma unroll
      for (int c = 0; c < 2; ++c)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[a][c][e] = 0.f;

    for (int i = 0; i < nloc; ++i) {
      tc::cp_wait_n(ns - 2);                     // tile i has landed
      __syncthreads();                           // ... for all; i - 1 done
      if (i + ns - 1 < nloc) stage(t0 + i + ns - 1, (i + ns - 1) % ns);
      tc::cp_commit();
      const float* ks = work + (i % ns) * TF;
      const float* vs = ks + TK * KS;
      const int nk = min(TK, len - (t0 + i) * TK);   // >= 1
      const bool ok = lane < nk;
      // S = Q K^T: warp w takes keys 8 (w % 4) .. + 8 of m-tiles w / 4 +
      // 2 fi, fi < NF, the B fragment (B(k = d, n = key) = K[key][d]) split
      // once for all; the correction terms in accumulators of their own.  A
      // warp past MT scores m-tile MT - 1 again and keeps nothing, so no
      // branch splits the loop.
      constexpr int NF = (4 * MT + NW - 1) / NW;
      const int nt = warp & 3, mt0 = warp >> 2;
      const float* Bk = ks + nt * 8 * KS;
      float hi[NF][4], la[NF][4], lb[NF][4];
#pragma unroll
      for (int fi = 0; fi < NF; ++fi)
#pragma unroll
        for (int e = 0; e < 4; ++e) hi[fi][e] = la[fi][e] = lb[fi][e] = 0.f;
#pragma unroll 2
      for (int k0 = 0; k0 < D; k0 += 8) {
        uint32_t bh[2], bl[2];
        tc::split_tf32(Bk[g8 * KS + k0 + t4], bh[0], bl[0]);
        tc::split_tf32(Bk[g8 * KS + k0 + t4 + 4], bh[1], bl[1]);
#pragma unroll
        for (int fi = 0; fi < NF; ++fi) {
          const float* A = qs + min(mt0 + 2 * fi, MT - 1) * 16 * KS + k0;
          uint32_t ah[4], al[4];
          tc::split_tf32(A[g8 * KS + t4], ah[0], al[0]);
          tc::split_tf32(A[(g8 + 8) * KS + t4], ah[1], al[1]);
          tc::split_tf32(A[g8 * KS + t4 + 4], ah[2], al[2]);
          tc::split_tf32(A[(g8 + 8) * KS + t4 + 4], ah[3], al[3]);
          tc::mma_tf32(la[fi], al, bh);
          tc::mma_tf32(lb[fi], ah, bl);
          tc::mma_tf32(hi[fi], ah, bh);
        }
      }
#pragma unroll
      for (int fi = 0; fi < NF; ++fi) {
        if (mt0 + 2 * fi < MT) {
          float* Sr = sp + ((mt0 + 2 * fi) * 16 + g8) * SS + nt * 8 + 2 * t4;
          Sr[0] = hi[fi][0] + (la[fi][0] + lb[fi][0]);
          Sr[1] = hi[fi][1] + (la[fi][1] + lb[fi][1]);
          Sr[8 * SS] = hi[fi][2] + (la[fi][2] + lb[fi][2]);
          Sr[8 * SS + 1] = hi[fi][3] + (la[fi][3] + lb[fi][3]);
        }
      }
      __syncthreads();
      // the online softmax of rows warp + 8 gi, a lane a key; P over S
      float p[RW], a[RW];
#pragma unroll
      for (int gi = 0; gi < RW; ++gi) {
        const int g = warp + NW * gi;
        p[gi] = ok && g < G ? sp[g * SS + lane] * scale : -INFINITY;
      }
      softmax_step(p, m, l, a);
#pragma unroll
      for (int gi = 0; gi < RW; ++gi) {
        const int g = warp + NW * gi;
        if (g < G) {
          sp[g * SS + lane] = p[gi];
          if (lane == 0) alpha_s[g] = a[gi];
        }
      }
      __syncthreads();
      // acc += P V: m-tiles mt < MT, features 8 (warp + 8 jn) ..; rows
      // rescaled by alpha first
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        const float a0 = alpha_s[mt * 16 + g8];
        const float a1 = alpha_s[mt * 16 + g8 + 8];
#pragma unroll
        for (int jn = 0; jn < 2; ++jn) {
          acc[mt][jn][0] *= a0;
          acc[mt][jn][1] *= a0;
          acc[mt][jn][2] *= a1;
          acc[mt][jn][3] *= a1;
        }
      }
#pragma unroll
      for (int k0 = 0; k0 < TK; k0 += 8) {
        uint32_t ah[MT][4], al[MT][4];
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          const float* A = sp + mt * 16 * SS + k0;
          tc::split_tf32(A[g8 * SS + t4], ah[mt][0], al[mt][0]);
          tc::split_tf32(A[(g8 + 8) * SS + t4], ah[mt][1], al[mt][1]);
          tc::split_tf32(A[g8 * SS + t4 + 4], ah[mt][2], al[mt][2]);
          tc::split_tf32(A[(g8 + 8) * SS + t4 + 4], ah[mt][3], al[mt][3]);
        }
#pragma unroll
        for (int jn = 0; jn < 2; ++jn) {
          const int n0 = 8 * (warp + NW * jn);
          if (n0 < D) {
            uint32_t bh[2], bl[2];
            tc::split_tf32(vs[(k0 + t4) * KS + n0 + g8], bh[0], bl[0]);
            tc::split_tf32(vs[(k0 + t4 + 4) * KS + n0 + g8], bh[1], bl[1]);
#pragma unroll
            for (int mt = 0; mt < MT; ++mt) {
              tc::mma_tf32(acc[mt][jn], al[mt], bh);
              tc::mma_tf32(acc[mt][jn], ah[mt], bl);
              tc::mma_tf32(acc[mt][jn], ah[mt], bh);
            }
          }
        }
      }
    }
    tc::cp_wait<0>();
    // the block's state, straight from registers to the merging ranks
    if (cl > 1) cluster_wait();                  // every rank has begun
#pragma unroll
    for (int gi = 0; gi < RW; ++gi) {
      const int g = warp + NW * gi;
      if (g < G && lane == 0) {
        const int row = inbox_row(rank, g);
        remote(in_m, g)[row] = m[gi];
        remote(in_l, g)[row] = l[gi];
      }
    }
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
      for (int jn = 0; jn < 2; ++jn) {
        const int c = 8 * (warp + NW * jn) + 2 * t4;
        if (c < D) {
#pragma unroll
          for (int h8 = 0; h8 < 2; ++h8) {
            const int g = mt * 16 + g8 + 8 * h8;
            if (g < G) {
              float* dst = remote(in_acc, g) + inbox_row(rank, g) * D + c;
              dst[0] = acc[mt][jn][2 * h8];
              dst[1] = acc[mt][jn][2 * h8 + 1];
            }
          }
        }
      }
    }
  }
  if (cl > 1)
    cluster.sync();                              // every push has landed
  else
    __syncthreads();

  // this rank's heads [g0, g1): the S states merged in order with weights
  // fr[s][h] = exp(m_s - m) / l, a warp a head and a lane a state, then
  // the outputs, all read from the inbox in this block's shared memory
  const int g0 = min(G, rank * HS), g1 = min(G, g0 + HS);
  float* fr = extra;                             // [S][HS]
  for (int h = warp; h < g1 - g0; h += NT / 32) {
    float mx = -INFINITY;
    for (int s = lane; s < S; s += 32) mx = fmaxf(mx, in_m[s * HS + h]);
    float mv[1] = {mx};
    warp_max_n(mv);
    float lsum[1] = {0.f};
    for (int s = lane; s < S; s += 32) {
      const float ms = in_m[s * HS + h];
      const float f = ms == -INFINITY ? 0.f : expf(ms - mv[0]);
      fr[s * HS + h] = f;
      lsum[0] = fmaf(in_l[s * HS + h], f, lsum[0]);
    }
    warp_sum_n(lsum);
    const float inv = lsum[0] == 0.f ? 0.f : 1.f / lsum[0];
    for (int s = lane; s < S; s += 32) fr[s * HS + h] *= inv;
  }
  __syncthreads();
  float* ob = out + ((size_t)b * Hq + (size_t)hk * G + g0) * D;
  for (int e = threadIdx.x; e < (g1 - g0) * D; e += NT) {
    const int h = e / D;
    float o = 0.f;
    for (int s = 0; s < S; ++s)
      o = fmaf(in_acc[s * HS * D + e], fr[s * HS + h], o);
    ob[e] = o;
  }
}

using Kernel = decltype(&decode_attention_kernel<false, 2>);

// The kernel compiled for the plan's path, or nullptr.
Kernel pick(bool tc, int G, int D) {
  if (tc)
    return G <= 16   ? decode_attention_kernel<true, 1>
           : G <= 32 ? decode_attention_kernel<true, 2>
           : G <= 48 ? decode_attention_kernel<true, 3>
                     : nullptr;
  return G > GM ? nullptr
         : D <= 64 ? decode_attention_kernel<false, 2>
                   : decode_attention_kernel<false, 4>;
}

}  // namespace dec
}  // namespace

// warps (4 or 8 a group), ring (2 or 3), kvs (1 or 2 groups splitting
// the keys; 8 warps at most) and smem come from plan_flash;
// smem must equal fl::smem_floats's bytes.  vec: k and v are 16-byte
// aligned (their rows too where D % 4 == 0).  lse: (B, Hq, Sq), each
// row's log-sum-exp for the backward, or null (serving).
extern "C" int repro_flash_attention(const float* q, const float* k,
                                     const float* v, float* out, float* lse,
                                     int B,
                                     int Hq, int Hkv, int Sq, int Sk, int D,
                                     int kv_cap, int causal, int q_offset,
                                     int sk_valid, float scale, int warps,
                                     int ring, int kvs, int smem, int vec,
                                     void* stream) {
  if (B <= 0 || Hq <= 0 || Hkv <= 0 || Hq % Hkv != 0 || Sq <= 0 || Sk < 0 ||
      D <= 0 || D > MAX_D || kv_cap < Sk || q_offset < 0 ||
      (warps != 4 && warps != 8) || ring < 2 || ring > 3 ||
      kvs < 1 || kvs > 2 || warps * kvs > fl::MAX_WARPS ||
      smem != 4 * fl::smem_floats(D, warps, ring, kvs))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long blocks = (long long)B * Hq * fl::q_tiles(Sq, warps);
  if (blocks > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidConfiguration);
  const fl::Kernel kernel = fl::pick(D);
  const int rc = tc::opt_in(kernel, (size_t)smem, false);
  if (rc != 0) return rc;
  kernel<<<(unsigned)blocks, 32 * warps * kvs, smem,
           static_cast<cudaStream_t>(stream)>>>(
      q, k, v, out, lse, B, Hq, Hkv, Sq, Sk, D, kv_cap, causal, q_offset,
      sk_valid, scale * 1.4426950408889634f, ring, kvs,
      vec != 0 && D % 4 == 0);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int repro_decode_attention(const float* q, const float* k,
                                      const float* v, const int* kv_len,
                                      float* out, int B, int Hq, int Hkv,
                                      int Sk, int D, int kv_cap, int use_tc,
                                      int cl, int slots, int smem, int vec,
                                      float scale, void* stream) {
  if (B <= 0 || Hq <= 0 || Hkv <= 0 || Hq % Hkv != 0 || Sk < 0 || D < 4 ||
      D > MAX_D || ((D & (D - 1)) != 0 && D % 8 != 0) || kv_cap < Sk ||
      cl < 1 ||
      cl > (Sk > 0 ? repro_cdiv(Sk, dec::TK) : 1) || B * Hkv > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const int G = Hq / Hkv;
  const bool tc = use_tc != 0;
  const dec::Kernel kernel = dec::pick(tc, G, D);
  if (kernel == nullptr || (tc && (G <= dec::GM || D < 8)) ||
      slots < (tc ? 2 : 1) ||
      slots > (tc ? tc::MAX_STAGES : dec::MAX_SLOTS) ||
      smem != 4 * dec::smem_floats(G, D, slots, cl, use_tc != 0))
    return static_cast<int>(cudaErrorInvalidValue);
  return tc::launch_clustered_n(
      kernel, tc ? dec::TC_THREADS : dec::CUDA_THREADS, cl, B * Hkv, 1,
      (size_t)smem, stream, false, q, k, v, kv_len, out, Hq, Hkv, Sk, D,
      kv_cap, slots, vec, scale);
}
