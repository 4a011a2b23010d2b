// K7 flash backward: dQ, dK and dV of the flash forward (flash_attention.cu),
// on the tensor cores in 3xTF32.
//
// Replaces no TPU kernel: the reference trains through XLA's attention
// (src/repro/lm/modules.py) and jax.value_and_grad, and never reaches its
// Pallas flash kernel (src/repro/kernels/attention/kernel.py:74) when it
// trains.  The port runs its flash kernel on every LM path, and that
// kernel's output, filled by a C call, has no gradient of its own; these
// kernels give it one.
//
// With s = scale q.k over the visible keys (the forward's mask: key kp is
// visible to query row i when kp < min(Sk, sk_valid) and, if causal,
// kp <= q_offset + i) and the forward's row log-sum-exp lse:
//   P = exp(s - lse),  D_i = rowsum(dO_i * O_i),  dS = P (dO V^T - D),
//   dQ = scale dS K,  dK = scale dS^T Q,  dV = P^T dO,
// dK and dV summed over the G query heads of a KV head (GQA).
//
// Bound on an H100: the gradient's own products, each once a visible
// (query, key) pair: S = Q K^T, dP = dO V^T, dV += P^T dO, dK += dS^T Q
// and dQ += dS K, 10 D FLOPs a pair, all f32 products the tensor cores
// carry in 3xTF32 at 165 TFLOP/s, against q, k, v, O, dO read and dQ, dK,
// dV written once.  At the training path's B 8, Hq 14, Hkv 2, S 512,
// D 64, causal: 9.4 GFLOP against 23 MB, so operations bound.  The two
// passes below recompute S and dP (14 D FLOPs a pair), the price of
// keeping no (query, key) tile in device memory.  Design:
//   * Every product in m16n8k8 mma.sync, 3xTF32 (each operand split into
//     tf32 hi and lo in integer operations, tc::split_tf32_bits; lo*hi +
//     hi*lo + hi*hi), the forward's unit and precision.  A warp owns 16
//     rows of the product it accumulates and keeps both of its score
//     tiles in registers; the forward's "the accumulator is the A
//     operand" step (flash_attention.cu's header) turns them into P and
//     dS in registers and feeds them straight into the next product: no
//     shared memory and no barrier between the products.
//   * The dQ pass runs first (flash_bwd_q_kernel): a block a (batch,
//     query head, q tile of 16 rows a warp), heaviest causal tiles first.
//     It stages its Q and dO rows once; a warp computes its rows' D =
//     rowsum(dO O) and lse in log2 units once and writes both to a (2, B,
//     Hq, Sq) scratch; K and V tiles stream through a cp.async ring of
//     2-3 stages, one block barrier a tile, the next tile's copy under
//     this one's products.  A warp: S = Q K^T and dP = dO V^T, then dS,
//     then dQ += dS K.
//   * The dK/dV pass (flash_bwd_kv_kernel): a warp owns 16 keys, a block
//     16 keys a warp, whose K and V rows it stages once.  Q and dO tiles
//     of 32 rows, with their rows' lse and D from the scratch (read once
//     a tile, not recomputed), stream through a ring of 2-3 stages over
//     the block's (query head, q tile) steps.  A warp: S^T = K Q^T and
//     dP^T = V dO^T, then P^T and dS^T, then dV += P^T dO and dK += dS^T Q.
//   * The tensor cores' f32 accumulation is not round-to-nearest: a
//     fragment that took a whole group's rows (3584 at G 7, S 512) drifted
//     past 1e-4 of the plain version.  So a dK/dV warp folds its
//     fragments into its own totals in shared memory every 64 rows, and a
//     dQ warp into registers every key tile, adding in f32 on the CUDA
//     cores.
//   * Causal work is uneven: key tile 0 is seen by every q tile, the last
//     by one.  plan.py's plan_flash_bwd models each block's serial steps
//     and picks the key tile (warps), the ring, whether a block takes key
//     tiles p and nkt - 1 - p in turn (pair), and a thread-block cluster
//     that splits the group's G heads between its ranks (contiguous runs,
//     tc::rank_range); items run heaviest first.  The ranks' partial dK
//     and dV meet over distributed shared memory, summed in rank order.
//   * No float atomics anywhere: GQA's sum runs over a block's heads in
//     order, then over the cluster's ranks in order; the bits do not
//     depend on the stream or the launch.
//   * Tiles sit in shared memory with D padded by zeros to 32, 64 or 128
//     and rows 4 floats apart beyond that, so every loop over features has
//     a fixed count and fragment loads are free of bank conflicts.  K and
//     V are read through kv_cap, as in the forward; dK and dV are written
//     contiguous (B, Hkv, Sk, D), 0 at keys no row sees.
// Limits: D from 1 to 128.
#include <math.h>

#include "tc_common.cuh"

namespace {
namespace fb {

namespace cg = cooperative_groups;

constexpr int WROWS = 16;            // rows of a warp's products: m16
constexpr int MAX_WARPS = 8;
constexpr int MAX_CLUSTER = 8;
constexpr int KV_BQ = 32;            // dK/dV: query rows a ring stage
constexpr int FOLD = 2;              // dK/dV: steps a fold of the fragments

__host__ __device__ inline int d_pad(int D) {
  return D <= 32 ? 32 : D <= 64 ? 64 : 128;
}
__host__ __device__ inline int stride(int D) { return d_pad(D) + 4; }
// keys a K / V tile of the dQ pass
__host__ __device__ inline int bk(int D) { return D > 64 ? 32 : 64; }

// Shared memory of the dQ pass in floats (plan.py's
// flash_bwd_q_smem_floats): Q and dO rows [2][16 warps][S], then `ring`
// stages of K and V tiles [2 bk][S].
__host__ __device__ inline int q_smem_floats(int D, int warps, int ring) {
  return (2 * WROWS * warps + ring * 2 * bk(D)) * stride(D);
}

// Shared memory of the dK/dV pass in floats (plan.py's
// flash_bwd_kv_smem_floats): K and V tiles [2][16 warps][S], the warps'
// dK and dV totals [2][16 warps][D' + 8] (a stride that keeps a fold's
// float2 accesses free of bank conflicts), then `ring` stages of Q and dO
// tiles [2 KV_BQ][S] with their rows' lse2 and D [2 KV_BQ].
__host__ __device__ inline int kv_smem_floats(int D, int warps, int ring) {
  const int s = stride(D);
  return 2 * WROWS * warps * (s + d_pad(D) + 8) +
         ring * (2 * KV_BQ * s + 2 * KV_BQ);
}

inline bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

struct Args {
  const float* q;
  const float* k;
  const float* v;
  const float* o;
  const float* dout;
  const float* lse;
  float* dq;
  float* dk;
  float* dv;
  float* rows;                       // [2][B Hq][Sq]: lse2, then D
  int B, Hq, Hkv, Sq, Sk, D, kv_cap, causal, q_offset, kv_end;
  float scale, scale_log2;
  int ring, pair, key_tiles, items;
  int vec_q, vec_kv;                 // 16-byte copies of q, dO / k, v
};

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// 2^x (ex2.approx.ftz, as the forward: about 2 ulp; 2^-inf = 0)
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// One float from src into dst, or a zero where !valid.
__device__ __forceinline__ void cp_one(float* dst, const float* src,
                                       bool valid, const float* safe) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   tc::smem_u32(dst)),
               "l"(valid ? src : safe), "r"(valid ? 4 : 0));
}

// Rows [0, n) of `rows` rows (row r at src + r D) into dst [rows][DM + 4],
// zero past n and past column D; all the block's threads.
template <int DM>
__device__ __forceinline__ void stage_tile(float* dst, const float* src,
                                           int rows, int n, int D, bool vec,
                                           const float* safe) {
  constexpr int QUADS = DM / 4, S = DM + 4;
  for (int idx = threadIdx.x; idx < rows * QUADS; idx += blockDim.x) {
    const int r = idx / QUADS;
    const int c4 = 4 * (idx - r * QUADS);
    const int valid = r < n ? min(4, max(0, D - c4)) : 0;
    tc::cp_quad(dst + r * S + c4, src + (size_t)r * D + c4, valid, vec,
                safe);
  }
}

// acc[j] = A B^T over the DM features: A is 16 rows at a (row stride
// DM + 4), B's rows 8j .. 8j + 7 at b; the m16n8k8 C fragment of n-tile j
// (lane (g, t): rows g, g + 8 at columns 8j + 2t, 8j + 2t + 1).
template <int DM, int NJ>
__device__ __forceinline__ void dots_abt(float (&acc)[NJ][4],
                                         const float* __restrict__ a,
                                         const float* __restrict__ b) {
  constexpr int S = DM + 4;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int j = 0; j < NJ; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < DM / 8; ++kk) {
    const float* A = a + 8 * kk;
    uint32_t ah[4], al[4];
    tc::split_tf32_bits(A[g * S + t], ah[0], al[0]);
    tc::split_tf32_bits(A[(g + 8) * S + t], ah[1], al[1]);
    tc::split_tf32_bits(A[g * S + t + 4], ah[2], al[2]);
    tc::split_tf32_bits(A[(g + 8) * S + t + 4], ah[3], al[3]);
    const float* B = b + g * S + 8 * kk + t;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      uint32_t bh[2], bl[2];
      tc::split_tf32_bits(B[8 * j * S], bh[0], bl[0]);
      tc::split_tf32_bits(B[8 * j * S + 4], bh[1], bl[1]);
      tc::mma_tf32(acc[j], al, bh);
      tc::mma_tf32(acc[j], ah, bl);
      tc::mma_tf32(acc[j], ah, bh);
    }
  }
}

// acc[nd] += P B over P's 8 NJ columns: P is in dots_abt's C fragments,
// which are the A fragments of this product when its k index t stands for
// column 8j + 2t and t + 4 for 8j + 2t + 1, so B's row k is read at rows
// 8j + 2t and 8j + 2t + 1 of b (row stride DM + 4); n is the feature.
template <int DM, int NJ>
__device__ __forceinline__ void dots_pb(float (&acc)[DM / 8][4],
                                        const float (&p)[NJ][4],
                                        const float* __restrict__ b) {
  constexpr int S = DM + 4;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    uint32_t ph[4], pl[4];
    tc::split_tf32_bits(p[j][0], ph[0], pl[0]);
    tc::split_tf32_bits(p[j][2], ph[1], pl[1]);
    tc::split_tf32_bits(p[j][1], ph[2], pl[2]);
    tc::split_tf32_bits(p[j][3], ph[3], pl[3]);
    const float* B = b + (8 * j + 2 * t) * S + g;
#pragma unroll
    for (int nd = 0; nd < DM / 8; ++nd) {
      uint32_t bh[2], bl[2];
      tc::split_tf32_bits(B[8 * nd], bh[0], bl[0]);
      tc::split_tf32_bits(B[S + 8 * nd], bh[1], bl[1]);
      tc::mma_tf32(acc[nd], pl, bh);
      tc::mma_tf32(acc[nd], ph, bl);
      tc::mma_tf32(acc[nd], ph, bh);
    }
  }
}

// A warp's fragments acc (rows r0 + g, r0 + g + 8 of out, row stride D)
// times mul at columns below D, rows below n.
template <int ND>
__device__ __forceinline__ void store_frags(float* __restrict__ out,
                                            const float (&acc)[ND][4],
                                            int r0, int n, int D,
                                            float mul) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = r0 + g + 8 * h;
    if (r >= n) continue;
    float* orow = out + (size_t)r * D;
#pragma unroll
    for (int nd = 0; nd < ND; ++nd) {
      const int c = 8 * nd + 2 * t;
      if (c < D) orow[c] = acc[nd][2 * h] * mul;
      if (c + 1 < D) orow[c + 1] = acc[nd][2 * h + 1] * mul;
    }
  }
}

// dQ of a (batch, query head, q tile of 16 rows a warp): blockIdx.x
// decoded as bh = x % (B Hq) and q tile nqt - 1 - x / (B Hq), the
// heaviest first.  Also writes the tile's rows' lse2 and D to a.rows.
template <int DM>
__global__ void __launch_bounds__(32 * MAX_WARPS)
flash_bwd_q_kernel(Args a) {
  constexpr int BK = DM > 64 ? 32 : 64;
  constexpr int NJ = BK / 8, ND = DM / 8, S = DM + 4, TF = 2 * BK * S;
  extern __shared__ __align__(16) float smem[];
  const int NW = blockDim.x >> 5;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int BQ = WROWS * NW;
  float* qs = smem;                      // [BQ][S]
  float* dos = qs + BQ * S;              // [BQ][S]
  float* ring_base = dos + BQ * S;

  const int BH = a.B * a.Hq;
  const int bh = blockIdx.x % BH;
  const int qt = repro_cdiv(a.Sq, BQ) - 1 - blockIdx.x / BH;
  const int b = bh / a.Hq, h = bh - b * a.Hq;
  const int hk = h / (a.Hq / a.Hkv), D = a.D;
  const int q0 = qt * BQ, valid = min(BQ, a.Sq - q0);
  const size_t qo = ((size_t)bh * a.Sq + q0) * D;
  const float* kb = a.k + ((size_t)b * a.Hkv + hk) * a.kv_cap * D;
  const float* vb = a.v + ((size_t)b * a.Hkv + hk) * a.kv_cap * D;
  // the keys [0, n) any row of the tile sees, in nt tiles
  const int n = a.causal ? min(a.kv_end, a.q_offset + q0 + valid)
                         : a.kv_end;
  const int nt = repro_cdiv(n, BK);

  stage_tile<DM>(qs, a.q + qo, BQ, valid, D, a.vec_q, a.q);
  stage_tile<DM>(dos, a.dout + qo, BQ, valid, D, a.vec_q, a.q);
  tc::cp_commit();
  auto stage = [&](int s) {
    float* dst = ring_base + (s % a.ring) * TF;
    const int k0 = s * BK, nk = min(BK, a.kv_end - k0);
    stage_tile<DM>(dst, kb + (size_t)k0 * D, BK, nk, D, a.vec_kv, a.k);
    stage_tile<DM>(dst + BK * S, vb + (size_t)k0 * D, BK, nk, D, a.vec_kv,
                   a.k);
  };
  for (int j = 0; j < a.ring - 1; ++j) {
    if (j < nt) stage(j);
    tc::cp_commit();
  }
  tc::cp_wait_n(a.ring - 1);             // Q and dO have landed
  __syncthreads();

  // the warp's rows r0 + i: D_i = rowsum(dO O) and lse in log2 units,
  // lane i's (i < 16), written to the scratch; then each lane's fragment
  // rows g and g + 8
  const int r0 = q0 + WROWS * warp;
  const float* qw = qs + WROWS * warp * S;
  const float* dow = dos + WROWS * warp * S;
  float dmine = 0.f, lmine = 0.f;
#pragma unroll 4
  for (int i = 0; i < WROWS; ++i) {
    float acc = 0.f;
    if (r0 + i < a.Sq) {
      const float* orow = a.o + ((size_t)bh * a.Sq + r0 + i) * D;
      for (int c = lane; c < D; c += 32)
        acc = fmaf(dow[i * S + c], orow[c], acc);
    }
    acc = warp_sum(acc);
    if (lane == i) dmine = acc;
  }
  if (lane < WROWS && r0 + lane < a.Sq) {
    const size_t ro = (size_t)bh * a.Sq + r0 + lane;
    lmine = a.lse[ro] * 1.4426950408889634f;
    a.rows[ro] = lmine;
    a.rows[(size_t)BH * a.Sq + ro] = dmine;
  }
  const float lse2[2] = {__shfl_sync(0xffffffffu, lmine, g),
                         __shfl_sync(0xffffffffu, lmine, g + 8)};
  const float Di[2] = {__shfl_sync(0xffffffffu, dmine, g),
                       __shfl_sync(0xffffffffu, dmine, g + 8)};
  const int wkeys =
      r0 >= a.Sq ? 0
      : a.causal ? min(a.kv_end, a.q_offset + min(r0 + WROWS, a.Sq))
                 : a.kv_end;

  float dq[ND][4];
#pragma unroll
  for (int nd = 0; nd < ND; ++nd)
#pragma unroll
    for (int e = 0; e < 4; ++e) dq[nd][e] = 0.f;
  for (int s = 0; s < nt; ++s) {
    tc::cp_wait_n(a.ring - 2);           // tile s has landed
    __syncthreads();                     // ... for all; tile s - 1 is done
    if (s + a.ring - 1 < nt) stage(s + a.ring - 1);
    tc::cp_commit();
    const int key0 = s * BK;
    if (key0 >= wkeys) continue;         // no key of it is visible
    const float* Ks = ring_base + (s % a.ring) * TF;
    const float* Vs = Ks + BK * S;
    float sc[NJ][4], dp[NJ][4];
    dots_abt<DM, NJ>(sc, qw, Ks);        // S = Q K^T
    dots_abt<DM, NJ>(dp, dow, Vs);       // dP = dO V^T
    // lane (g, t): rows r0 + g (e < 2), r0 + g + 8, keys key0 + 8j + 2t
    // + (e & 1); a tile every row of the warp sees whole needs no mask
    const bool whole = key0 + BK <= a.kv_end &&
                       (!a.causal || key0 + BK - 1 <= a.q_offset + r0);
    int lim[2];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh)
      lim[hh] = whole ? BK
                      : (a.causal ? min(a.kv_end,
                                        a.q_offset + r0 + g + 8 * hh + 1)
                                  : a.kv_end) - key0 - 2 * t4;
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float x = whole || 8 * j + (e & 1) < lim[e >> 1]
                            ? sc[j][e] * a.scale_log2 - lse2[e >> 1]
                            : -INFINITY;
        sc[j][e] = fast_exp2(x) * (dp[j][e] - Di[e >> 1]);     // dS
      }
    // dQ += dS K, a tile's products into fragments of their own, then
    // added in f32 on the CUDA cores (see FOLD)
    float dqt[ND][4];
#pragma unroll
    for (int nd = 0; nd < ND; ++nd)
#pragma unroll
      for (int e = 0; e < 4; ++e) dqt[nd][e] = 0.f;
    dots_pb<DM, NJ>(dqt, sc, Ks);
#pragma unroll
    for (int nd = 0; nd < ND; ++nd)
#pragma unroll
      for (int e = 0; e < 4; ++e) dq[nd][e] += dqt[nd][e];
  }
  tc::cp_wait<0>();
  store_frags(a.dq + qo - (size_t)q0 * D, dq, r0, a.Sq, D, a.scale);
}

// dK and dV of an item: blockIdx.y + gridDim.y blockIdx.z decoded as
// slot p = item / (B Hkv) of (batch, KV head) item % (B Hkv), key tiles p
// and, paired, key_tiles - 1 - p; the cluster's ranks (blockIdx.x) split
// the group's heads.
template <int DM>
__global__ void __launch_bounds__(32 * MAX_WARPS)
flash_bwd_kv_kernel(Args a) {
  constexpr int NQ = KV_BQ / 8, ND = DM / 8, S = DM + 4, T = DM + 8;
  constexpr int TQ = 2 * KV_BQ * S + 2 * KV_BQ;   // a ring stage
  extern __shared__ __align__(16) float smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int cl = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int NW = blockDim.x >> 5;
  const int BKV = WROWS * NW;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;
  float* ks = smem;                      // [BKV][S]
  float* vs = ks + BKV * S;              // [BKV][S]
  float* tot = vs + BKV * S;             // [2][BKV][T]: dK, then dV
  float* ring_base = tot + 2 * BKV * T;

  const int item = blockIdx.y + gridDim.y * blockIdx.z;
  if (item >= a.items) return;           // the whole cluster returns
  const int BHK = a.B * a.Hkv;
  const int p = item / BHK, bhk = item - p * BHK;
  const int b = bhk / a.Hkv, hk = bhk - b * a.Hkv;
  const int G = a.Hq / a.Hkv, D = a.D;
  int h0, h1;
  tc::rank_range(G, cl, rank, h0, h1);
  const size_t BHS = (size_t)a.B * a.Hq * a.Sq;
  const float* kb = a.k + (size_t)bhk * a.kv_cap * D;
  const float* vb = a.v + (size_t)bhk * a.kv_cap * D;
  const int other = a.key_tiles - 1 - p;
  const int ntile = a.pair && other != p ? 2 : 1;
  // the warp's fragment rows in the totals: keys r and r + 8 of the tile
  const int r = WROWS * warp + g;

  for (int u = 0; u < ntile; ++u) {
    const int k0 = (u == 0 ? p : other) * BKV;
    // the q tiles [qlo, nq) whose rows see a key of the tile
    const int nq = repro_cdiv(a.Sq, KV_BQ);
    const int qlo = k0 >= a.kv_end ? nq
                    : a.causal      ? min(nq, max(0, k0 - a.q_offset) / KV_BQ)
                                    : 0;
    const int nqs = nq - qlo;
    const int steps = (h1 - h0) * nqs;
    stage_tile<DM>(ks, kb + (size_t)k0 * D, BKV, min(BKV, a.kv_end - k0), D,
                   a.vec_kv, a.k);
    stage_tile<DM>(vs, vb + (size_t)k0 * D, BKV, min(BKV, a.kv_end - k0), D,
                   a.vec_kv, a.k);
    // step s: head h0 + s / nqs, q tile qlo + s % nqs
    auto stage = [&](int s) {
      float* dst = ring_base + (s % a.ring) * TQ;
      const int hh = h0 + s / nqs, row0 = (qlo + s % nqs) * KV_BQ;
      const size_t bh = (size_t)b * a.Hq + hk * G + hh;
      const size_t qo = (bh * a.Sq + row0) * D;
      const int nr = min(KV_BQ, a.Sq - row0);
      stage_tile<DM>(dst, a.q + qo, KV_BQ, nr, D, a.vec_q, a.q);
      stage_tile<DM>(dst + KV_BQ * S, a.dout + qo, KV_BQ, nr, D, a.vec_q,
                     a.q);
      for (int i = threadIdx.x; i < 2 * KV_BQ; i += blockDim.x) {
        const int rr = i % KV_BQ;
        cp_one(dst + 2 * KV_BQ * S + i,
               a.rows + (i / KV_BQ) * BHS + bh * a.Sq + row0 + rr, rr < nr,
               a.rows);
      }
    };
    // K and V ride with the first step's group
    for (int j = 0; j < a.ring - 1; ++j) {
      if (j < steps) stage(j);
      tc::cp_commit();
    }

    // the warp's running dK and dV: fragments a fold apart, summed into
    // its own elements of tot (no other lane touches them until the merge)
    float dk[ND][4], dv[ND][4];
#pragma unroll
    for (int nd = 0; nd < ND; ++nd) {
#pragma unroll
      for (int e = 0; e < 4; ++e) dk[nd][e] = dv[nd][e] = 0.f;
      const int c = 8 * nd + 2 * t4;
      const float2 z = make_float2(0.f, 0.f);
      *reinterpret_cast<float2*>(tot + r * T + c) = z;
      *reinterpret_cast<float2*>(tot + (r + 8) * T + c) = z;
      *reinterpret_cast<float2*>(tot + (BKV + r) * T + c) = z;
      *reinterpret_cast<float2*>(tot + (BKV + r + 8) * T + c) = z;
    }
    const int kw0 = k0 + WROWS * warp;   // the warp's first key
    const float* kw = ks + WROWS * warp * S;
    const float* vw = vs + WROWS * warp * S;
    for (int s = 0; s < steps; ++s) {
      tc::cp_wait_n(a.ring - 2);         // step s has landed
      __syncthreads();                   // ... for all; step s - 1 is done
      if (s + a.ring - 1 < steps) stage(s + a.ring - 1);
      tc::cp_commit();
      const int rlo = (qlo + s % nqs) * KV_BQ;   // the step's first row
      const int rhi = min(rlo + KV_BQ, a.Sq);
      // the warp's keys are all masked, or no row of the step sees them
      if (kw0 < a.kv_end && !(a.causal && a.q_offset + rhi - 1 < kw0)) {
        const float* Qs = ring_base + (s % a.ring) * TQ;
        const float* dOs = Qs + KV_BQ * S;
        const float* l2 = dOs + KV_BQ * S;
        const float* Dr = l2 + KV_BQ;
        float st[NQ][4], dpt[NQ][4];
        dots_abt<DM, NQ>(st, kw, Qs);       // S^T = K Q^T
        dots_abt<DM, NQ>(dpt, vw, dOs);     // dP^T = V dO^T
        // lane (g, t): keys kw0 + g (e < 2), kw0 + g + 8, rows rlo + 8j +
        // 2t + (e & 1)
        const bool whole =
            kw0 + WROWS <= a.kv_end && rlo + KV_BQ <= a.Sq &&
            (!a.causal || kw0 + WROWS - 1 <= a.q_offset + rlo);
#pragma unroll
        for (int j = 0; j < NQ; ++j) {
          const int rc = 8 * j + 2 * t4;
          const float2 L = *reinterpret_cast<const float2*>(l2 + rc);
          const float2 Dd = *reinterpret_cast<const float2*>(Dr + rc);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int key = kw0 + g + 8 * (e >> 1);
            const int row = rlo + rc + (e & 1);
            const bool vis =
                whole || (key < a.kv_end && row < a.Sq &&
                          (!a.causal || key <= a.q_offset + row));
            const float pv = fast_exp2(
                vis ? st[j][e] * a.scale_log2 - ((e & 1) ? L.y : L.x)
                    : -INFINITY);
            st[j][e] = pv;                                     // P^T
            dpt[j][e] = pv * (dpt[j][e] - ((e & 1) ? Dd.y : Dd.x));  // dS^T
          }
        }
        dots_pb<DM, NQ>(dv, st, dOs);       // dV += P^T dO
        dots_pb<DM, NQ>(dk, dpt, Qs);       // dK += dS^T Q
      }
      // Fold every FOLD steps: the tensor cores' f32 accumulation is not
      // round-to-nearest, so a fragment that took a group's every row
      // (3584 at G 7, S 512) drifts past 1e-4; a fold of FOLD * 32 rows
      // does not, and the totals add in f32 on the CUDA cores.
      if ((s + 1) % FOLD == 0 || s == steps - 1) {
#pragma unroll
        for (int nd = 0; nd < ND; ++nd) {
          const int c = 8 * nd + 2 * t4;
          float2* t0 = reinterpret_cast<float2*>(tot + r * T + c);
          float2* t1 = reinterpret_cast<float2*>(tot + (r + 8) * T + c);
          float2* t2 = reinterpret_cast<float2*>(tot + (BKV + r) * T + c);
          float2* t3 =
              reinterpret_cast<float2*>(tot + (BKV + r + 8) * T + c);
          const float2 o0 = *t0, o1 = *t1, o2 = *t2, o3 = *t3;
          *t0 = make_float2(o0.x + dk[nd][0], o0.y + dk[nd][1]);
          *t1 = make_float2(o1.x + dk[nd][2], o1.y + dk[nd][3]);
          *t2 = make_float2(o2.x + dv[nd][0], o2.y + dv[nd][1]);
          *t3 = make_float2(o3.x + dv[nd][2], o3.y + dv[nd][3]);
#pragma unroll
          for (int e = 0; e < 4; ++e) dk[nd][e] = dv[nd][e] = 0.f;
        }
      }
    }
    tc::cp_wait<0>();
    // the cluster's ranks sum their totals in rank order (a cluster of one
    // stores its own), four columns at a time
    if (cl > 1)
      cluster.sync();                    // every rank's totals are written
    else
      __syncthreads();
    const float* peer[MAX_CLUSTER];
#pragma unroll
    for (int q = 0; q < MAX_CLUSTER; ++q)
      peer[q] = cl == 1 ? tot : cluster.map_shared_rank(tot, q < cl ? q : 0);
    float* dkb = a.dk + (size_t)bhk * a.Sk * D;
    float* dvb = a.dv + (size_t)bhk * a.Sk * D;
    constexpr int QD = DM / 4;
    const int total = 2 * BKV * QD;
    for (int e = rank * blockDim.x + threadIdx.x; e < total;
         e += cl * blockDim.x) {
      const int rr = e / QD, c0 = 4 * (e - rr * QD);
      const int which = rr >= BKV, key = k0 + rr - which * BKV;
      if (key >= a.Sk || c0 >= D) continue;
      float4 part[MAX_CLUSTER];
#pragma unroll
      for (int q = 0; q < MAX_CLUSTER; ++q)
        if (q < cl)
          part[q] = *reinterpret_cast<const float4*>(peer[q] + rr * T + c0);
      float x[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int q = 0; q < MAX_CLUSTER; ++q)
        if (q < cl) {
          x[0] += part[q].x;
          x[1] += part[q].y;
          x[2] += part[q].z;
          x[3] += part[q].w;
        }
      const float mul = which ? 1.f : a.scale;
      float* orow = (which ? dvb : dkb) + (size_t)key * D;
#pragma unroll
      for (int u4 = 0; u4 < 4; ++u4)
        if (c0 + u4 < D) orow[c0 + u4] = x[u4] * mul;
    }
    if (cl > 1)                          // no block reuses its tiles or
      cluster.sync();                    // leaves while a peer reads them
    else
      __syncthreads();
  }
}

using Kernel = decltype(&flash_bwd_q_kernel<64>);

Kernel pick_q(int DM) {
  return DM == 32   ? flash_bwd_q_kernel<32>
         : DM == 64 ? flash_bwd_q_kernel<64>
                    : flash_bwd_q_kernel<128>;
}

Kernel pick_kv(int DM) {
  return DM == 32   ? flash_bwd_kv_kernel<32>
         : DM == 64 ? flash_bwd_kv_kernel<64>
                    : flash_bwd_kv_kernel<128>;
}

}  // namespace fb
}  // namespace

// q, o, dout, dq (B, Hq, Sq, D) contiguous; lse (B, Hq, Sq), the forward's;
// k and v (B, Hkv, Sk, D) rows of a cache of kv_cap rows a (batch, KV
// head), as the forward reads them; dk and dv (B, Hkv, Sk, D) contiguous;
// rows: a (2, B, Hq, Sq) scratch.  scale: the forward's softmax scale.
// The plan (plan.py's plan_flash_bwd): the dQ pass's warps (4 or 8) and
// ring (2 or 3); the dK/dV pass's warps (2, 4 or 8), ring, pairing and
// cluster (1 to min(G, 8)); each pass's dynamic shared memory, which must
// be the kernel's carve-up.  Two launches on `stream`: the dQ pass, then
// the dK/dV pass, which reads the scratch the dQ pass wrote.
extern "C" int repro_flash_attention_bwd(
    const float* q, const float* k, const float* v, const float* o,
    const float* dout, const float* lse, float* dq, float* dk, float* dv,
    float* rows, int B, int Hq, int Hkv, int Sq, int Sk, int D, int kv_cap,
    int causal, int q_offset, int sk_valid, float scale, int q_warps,
    int q_ring, int kv_warps, int kv_ring, int pair, int cluster,
    int q_smem, int kv_smem, void* stream) {
  if (B <= 0 || Hq <= 0 || Hkv <= 0 || Hq % Hkv != 0 || Sq <= 0 || Sk < 0 ||
      D <= 0 || D > 128 || kv_cap < Sk || q_offset < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if ((q_warps != 4 && q_warps != 8) || q_ring < 2 || q_ring > 3 ||
      (kv_warps != 2 && kv_warps != 4 && kv_warps != 8) || kv_ring < 2 ||
      kv_ring > 3 || cluster < 1 || cluster > fb::MAX_CLUSTER ||
      cluster > Hq / Hkv ||
      q_smem != (int)sizeof(float) * fb::q_smem_floats(D, q_warps, q_ring) ||
      kv_smem != (int)sizeof(float) *
                     fb::kv_smem_floats(D, kv_warps, kv_ring))
    return static_cast<int>(cudaErrorInvalidConfiguration);
  const int DM = fb::d_pad(D);
  const int key_tiles = repro_cdiv(Sk, fb::WROWS * kv_warps);
  const int slots = pair ? repro_cdiv(key_tiles, 2) : key_tiles;
  const long long items = (long long)B * Hkv * slots;
  const long long q_blocks =
      (long long)B * Hq * repro_cdiv(Sq, fb::WROWS * q_warps);
  if (items * cluster > 0x7fffffffLL || q_blocks > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidConfiguration);
  const bool d4 = D % 4 == 0;
  fb::Args a{q, k, v, o, dout, lse, dq, dk, dv, rows, B, Hq, Hkv, Sq, Sk, D,
             kv_cap, causal, q_offset,
             sk_valid < 0 ? 0 : sk_valid < Sk ? sk_valid : Sk, scale,
             scale * 1.4426950408889634f, q_ring, pair, key_tiles,
             (int)items,
             d4 && fb::aligned16(q) && fb::aligned16(dout),
             d4 && fb::aligned16(k) && fb::aligned16(v)};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const fb::Kernel qk = fb::pick_q(DM);
  int rc = tc::opt_in(qk, q_smem, false);
  if (rc != 0) return rc;
  qk<<<(unsigned)q_blocks, 32 * q_warps, q_smem, s>>>(a);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  if (items == 0) return 0;
  a.ring = kv_ring;
  // items over the grid's y (and z past 65535), ranks over x
  const int ty = (int)(items < 65535 ? items : 65535);
  const int tz = (int)((items + ty - 1) / ty);
  return tc::launch_clustered_n(fb::pick_kv(DM), 32 * kv_warps, cluster, ty,
                                tz, (size_t)kv_smem, stream, false, a);
}
