// K7 flash backward: dQ, dK and dV of the flash forward (flash_attention.cu),
// f32 on the CUDA cores.
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
// Bound on an H100: P and dP are recomputed, so a visible (query, key)
// pair costs five products of D multiply-adds between the two passes (S
// and dP in each, dV and dK in the first, dQ in the second): 14 D FLOPs
// a pair on the CUDA cores at 67 TFLOP/s, against q, k, v, O, dO read and
// dQ, dK, dV written once.  At the training path's B 8, Hq 14, Hkv 2,
// S 512, D 64, causal: 13.3 GFLOP against 23 MB, so operations bound.
// This first version is plain f32 FMAs on the CUDA cores (no tensor
// cores, no cp.async); speed comes later.  Design:
//   * dK/dV pass (flash_bwd_kv_kernel): a block per (batch, KV head, key
//     tile of 32 keys) keeps its K and V tiles in shared memory and its
//     dK and dV tiles in registers, and loops over the group's G query
//     heads and, for each, the 64-row query tiles that see its keys (a
//     causal tile starts at the first row that sees key k0); so GQA sums
//     inside the block, in a fixed order, with no atomics.  The block's
//     loop is serial and causal work uneven (the first key tile sees
//     every query tile, the last one), so the key tile is short: the path
//     gets 256 blocks, three to an SM, and the longest loop is half what
//     64 keys would give.
//   * dQ pass (flash_bwd_q_kernel): a block per (batch, query head, query
//     tile of 64 rows) keeps Q, dO and dQ, and loops over the 64-key
//     tiles its rows see; heaviest causal tiles first.
//   * Both passes recompute S and dP as 64-row tiles (a thread 4 rows x 2
//     or 4 keys, rows 16 apart so that a warp reads 16 rows of the padded
//     tile in 16 banks), then P from the saved lse (read in log2 units:
//     exp2(s log2e - lse log2e)) and dS, and compute D = rowsum(dO * O)
//     for their own query tile; the first pass stages P and dS in shared
//     memory for dV += P^T dO and dK += dS^T Q (a thread 4 keys x D/16
//     columns), the second dS for dQ += dS K.
//   * Tiles sit in shared memory with D padded by zeros to 32, 64 or 128
//     and rows one float apart beyond that (an odd stride), so every loop
//     over features has a fixed count and the reads are free of bank
//     conflicts.  K and V are read through kv_cap, as in the forward;
//     dK and dV are written contiguous (B, Hkv, Sk, D), 0 at keys no row
//     sees.
// Limits: D from 1 to 128.  No atomics: the bits do not depend on the
// stream or the launch.
#include <math.h>

#include "tc_common.cuh"

namespace {
namespace fb {

constexpr int THREADS = 256;
constexpr int BQ = 64;               // query rows a tile
constexpr int BK_Q = 64;             // keys a tile, the dQ pass
constexpr int BK_KV = 32;            // keys a block, the dK/dV pass

__host__ __device__ inline int d_pad(int D) {
  return D <= 32 ? 32 : D <= 64 ? 64 : 128;
}

// floats of shared memory: the K and V tiles [bk][DM + 1], the Q and dO
// tiles [64][DM + 1], then the P and dS tiles [64][bk + 1] (the dK/dV
// pass) or the dS tile (the dQ pass), then the query tile's lse and D
__host__ __device__ inline int smem_floats(int DM, bool kv) {
  const int bk = kv ? BK_KV : BK_Q;
  return 2 * (bk + BQ) * (DM + 1) + (kv ? 2 : 1) * BQ * (bk + 1) + 2 * BQ;
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
  int B, Hq, Hkv, Sq, Sk, D, kv_cap, causal, q_offset, kv_end;
  float scale, scale_log2;
};

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Rows [0, valid) of src (rows D floats apart) into dst [ROWS][DM + 1],
// zero past them and past column D.
template <int DM, int ROWS>
__device__ __forceinline__ void load_tile(float* __restrict__ dst,
                                          const float* __restrict__ src,
                                          int valid, int D) {
  constexpr int SD = DM + 1;
  for (int idx = threadIdx.x; idx < ROWS * DM; idx += THREADS) {
    const int r = idx / DM, c = idx - r * DM;
    dst[r * SD + c] = r < valid && c < D ? src[(size_t)r * D + c] : 0.f;
  }
}

// The query tile's D_i = rowsum(dO * O) (dO from shared memory, O from
// rows D floats apart) and lse in log2 units, a warp a row.
template <int DM>
__device__ __forceinline__ void load_rows(float* __restrict__ lse2,
                                          float* __restrict__ Di,
                                          const float* __restrict__ dOs,
                                          const float* __restrict__ ob,
                                          const float* __restrict__ lb,
                                          int valid, int D) {
  constexpr int SD = DM + 1;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int r = warp; r < BQ; r += THREADS / 32) {
    float acc = 0.f;
    if (r < valid)
      for (int c = lane; c < D; c += 32)
        acc = fmaf(dOs[r * SD + c], ob[(size_t)r * D + c], acc);
    acc = warp_sum(acc);
    if (lane == 0) {
      Di[r] = acc;
      lse2[r] = r < valid ? lb[r] * 1.4426950408889634f : 0.f;
    }
  }
}

// acc[ii][jj] = sum over features of A[rg + 16 ii][.] B[kg + 16 jj][.],
// 4 rows and NJ keys a thread
template <int DM, int NJ>
__device__ __forceinline__ void tile_dots(const float* __restrict__ As,
                                          const float* __restrict__ Bs,
                                          float (&acc)[4][NJ], int rg,
                                          int kg) {
  constexpr int SD = DM + 1;
#pragma unroll
  for (int ii = 0; ii < 4; ++ii)
#pragma unroll
    for (int jj = 0; jj < NJ; ++jj) acc[ii][jj] = 0.f;
#pragma unroll 4
  for (int c = 0; c < DM; ++c) {
    float a[4], b[NJ];
#pragma unroll
    for (int ii = 0; ii < 4; ++ii) a[ii] = As[(rg + 16 * ii) * SD + c];
#pragma unroll
    for (int jj = 0; jj < NJ; ++jj) b[jj] = Bs[(kg + 16 * jj) * SD + c];
#pragma unroll
    for (int ii = 0; ii < 4; ++ii)
#pragma unroll
      for (int jj = 0; jj < NJ; ++jj)
        acc[ii][jj] = fmaf(a[ii], b[jj], acc[ii][jj]);
  }
}

// S and dP of the thread's 4 x NJ (row, key) pairs into P and dS: rows
// q0 + rg + 16 ii, keys k0 + kg + 16 jj; a pair the mask hides is 0.
template <int NJ>
__device__ __forceinline__ void softmax_grad(const Args& a, float (&s)[4][NJ],
                                             float (&dp)[4][NJ],
                                             const float* __restrict__ lse2,
                                             const float* __restrict__ Di,
                                             int q0, int k0, int rg, int kg) {
#pragma unroll
  for (int ii = 0; ii < 4; ++ii) {
    const int lr = rg + 16 * ii, row = q0 + lr;
    const int lim = row >= a.Sq ? 0
                    : a.causal  ? min(a.kv_end, a.q_offset + row + 1)
                                : a.kv_end;
#pragma unroll
    for (int jj = 0; jj < NJ; ++jj) {
      const int key = k0 + kg + 16 * jj;
      const float p =
          key < lim ? exp2f(s[ii][jj] * a.scale_log2 - lse2[lr]) : 0.f;
      s[ii][jj] = p;
      dp[ii][jj] = p * (dp[ii][jj] - Di[lr]);
    }
  }
}

// dK and dV of a (batch, KV head, tile of BK_KV keys), blockIdx.x = (b
// Hkv + hk) nkt + kt.  A thread: S and dP at 4 rows x 2 keys, dK and dV
// at 2 keys x DM / 16 columns.
template <int DM>
__global__ void __launch_bounds__(THREADS) flash_bwd_kv_kernel(Args a) {
  constexpr int SD = DM + 1;
  constexpr int CC = DM / 16;          // columns a thread: 16 apart
  constexpr int BK = BK_KV, NJ = BK / 16, PS = BK + 1;
  extern __shared__ __align__(16) float sm[];
  float* Ks = sm;
  float* Vs = Ks + BK * SD;
  float* Qs = Vs + BK * SD;
  float* dOs = Qs + BQ * SD;
  float* Ps = dOs + BQ * SD;
  float* dSs = Ps + BQ * PS;
  float* lse2 = dSs + BQ * PS;
  float* Di = lse2 + BQ;

  const int nkt = repro_cdiv(a.Sk, BK);
  const int kt = blockIdx.x % nkt, bk = blockIdx.x / nkt;
  const int b = bk / a.Hkv, hk = bk - b * a.Hkv;
  const int G = a.Hq / a.Hkv, D = a.D;
  const int k0 = kt * BK;
  const int t = threadIdx.x;
  const int lo = t & 15, hi = t >> 4;  // S tiles: rows lo, keys hi;
                                       // dK/dV: keys hi, columns lo
  float dK[NJ][CC], dV[NJ][CC];
#pragma unroll
  for (int jj = 0; jj < NJ; ++jj)
#pragma unroll
    for (int cc = 0; cc < CC; ++cc) dK[jj][cc] = dV[jj][cc] = 0.f;

  if (k0 < a.kv_end) {
    const size_t kvo = ((size_t)bk * a.kv_cap + k0) * D;
    load_tile<DM, BK>(Ks, a.k + kvo, min(BK, a.kv_end - k0), D);
    load_tile<DM, BK>(Vs, a.v + kvo, min(BK, a.kv_end - k0), D);
    // the first query row that sees key k0
    const int qt0 = a.causal ? max(0, k0 - a.q_offset) / BQ : 0;
    const int nqt = repro_cdiv(a.Sq, BQ);
    for (int h = hk * G; h < (hk + 1) * G; ++h) {
      const size_t bh = (size_t)b * a.Hq + h;
      for (int qt = qt0; qt < nqt; ++qt) {
        const int q0 = qt * BQ, valid = min(BQ, a.Sq - q0);
        const size_t qo = (bh * a.Sq + q0) * D;
        __syncthreads();               // the last tile's reads are done
        load_tile<DM, BQ>(Qs, a.q + qo, valid, D);
        load_tile<DM, BQ>(dOs, a.dout + qo, valid, D);
        __syncthreads();
        load_rows<DM>(lse2, Di, dOs, a.o + qo, a.lse + bh * a.Sq + q0,
                      valid, D);
        __syncthreads();
        float s[4][NJ], dp[4][NJ];
        tile_dots<DM, NJ>(Qs, Ks, s, lo, hi);
        tile_dots<DM, NJ>(dOs, Vs, dp, lo, hi);
        softmax_grad<NJ>(a, s, dp, lse2, Di, q0, k0, lo, hi);
#pragma unroll
        for (int ii = 0; ii < 4; ++ii)
#pragma unroll
          for (int jj = 0; jj < NJ; ++jj) {
            Ps[(lo + 16 * ii) * PS + hi + 16 * jj] = s[ii][jj];
            dSs[(lo + 16 * ii) * PS + hi + 16 * jj] = dp[ii][jj];
          }
        __syncthreads();
        for (int i = 0; i < BQ; ++i) {
          float pv[NJ], sv[NJ], ov[CC], qv[CC];
#pragma unroll
          for (int jj = 0; jj < NJ; ++jj) {
            pv[jj] = Ps[i * PS + hi + 16 * jj];
            sv[jj] = dSs[i * PS + hi + 16 * jj];
          }
#pragma unroll
          for (int cc = 0; cc < CC; ++cc) {
            ov[cc] = dOs[i * SD + lo + 16 * cc];
            qv[cc] = Qs[i * SD + lo + 16 * cc];
          }
#pragma unroll
          for (int jj = 0; jj < NJ; ++jj)
#pragma unroll
            for (int cc = 0; cc < CC; ++cc) {
              dV[jj][cc] = fmaf(pv[jj], ov[cc], dV[jj][cc]);
              dK[jj][cc] = fmaf(sv[jj], qv[cc], dK[jj][cc]);
            }
        }
      }
    }
  }
  const int nk = min(BK, a.Sk - k0);
  float* dkb = a.dk + ((size_t)bk * a.Sk + k0) * D;
  float* dvb = a.dv + ((size_t)bk * a.Sk + k0) * D;
#pragma unroll
  for (int jj = 0; jj < NJ; ++jj) {
    const int key = hi + 16 * jj;
    if (key >= nk) continue;
#pragma unroll
    for (int cc = 0; cc < CC; ++cc) {
      const int c = lo + 16 * cc;
      if (c < D) {
        dkb[(size_t)key * D + c] = dK[jj][cc] * a.scale;
        dvb[(size_t)key * D + c] = dV[jj][cc];
      }
    }
  }
}

// dQ of a (batch, query head, query tile): blockIdx.x decoded as bh =
// x % (B Hq) and query tile nqt - 1 - x / (B Hq), the heaviest first.
template <int DM>
__global__ void __launch_bounds__(THREADS) flash_bwd_q_kernel(Args a) {
  constexpr int SD = DM + 1;
  constexpr int CC = DM / 16;
  constexpr int BK = BK_Q, NJ = BK / 16, PS = BK + 1;
  extern __shared__ __align__(16) float sm[];
  float* Ks = sm;
  float* Vs = Ks + BK * SD;
  float* Qs = Vs + BK * SD;
  float* dOs = Qs + BQ * SD;
  float* dSs = dOs + BQ * SD;
  float* lse2 = dSs + BQ * PS;
  float* Di = lse2 + BQ;

  const int BH = a.B * a.Hq;
  const int bh = blockIdx.x % BH;
  const int qt = repro_cdiv(a.Sq, BQ) - 1 - blockIdx.x / BH;
  const int b = bh / a.Hq, h = bh - b * a.Hq;
  const int hk = h / (a.Hq / a.Hkv), D = a.D;
  const int q0 = qt * BQ, valid = min(BQ, a.Sq - q0);
  const size_t qo = ((size_t)bh * a.Sq + q0) * D;
  const int t = threadIdx.x;
  const int lo = t & 15, hi = t >> 4;  // S tiles: rows lo, keys hi;
                                       // dQ: rows hi, columns lo
  load_tile<DM, BQ>(Qs, a.q + qo, valid, D);
  load_tile<DM, BQ>(dOs, a.dout + qo, valid, D);
  __syncthreads();
  load_rows<DM>(lse2, Di, dOs, a.o + qo, a.lse + (size_t)bh * a.Sq + q0,
                valid, D);
  // the keys [0, n) any row of the tile sees
  const int n = a.causal ? min(a.kv_end, a.q_offset + q0 + valid)
                         : a.kv_end;
  const int nkt = n > 0 ? repro_cdiv(n, BK) : 0;
  const size_t kvb = ((size_t)b * a.Hkv + hk) * a.kv_cap * D;

  float dQ[4][CC];
#pragma unroll
  for (int ii = 0; ii < 4; ++ii)
#pragma unroll
    for (int cc = 0; cc < CC; ++cc) dQ[ii][cc] = 0.f;
  for (int kt = 0; kt < nkt; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();                   // the last tile's reads are done
    load_tile<DM, BK>(Ks, a.k + kvb + (size_t)k0 * D,
                      min(BK, a.kv_end - k0), D);
    load_tile<DM, BK>(Vs, a.v + kvb + (size_t)k0 * D,
                      min(BK, a.kv_end - k0), D);
    __syncthreads();
    float s[4][NJ], dp[4][NJ];
    tile_dots<DM, NJ>(Qs, Ks, s, lo, hi);
    tile_dots<DM, NJ>(dOs, Vs, dp, lo, hi);
    softmax_grad<NJ>(a, s, dp, lse2, Di, q0, k0, lo, hi);
#pragma unroll
    for (int ii = 0; ii < 4; ++ii)
#pragma unroll
      for (int jj = 0; jj < NJ; ++jj)
        dSs[(lo + 16 * ii) * PS + hi + 16 * jj] = dp[ii][jj];
    __syncthreads();
    for (int j = 0; j < BK; ++j) {
      float sv[4], kv[CC];
#pragma unroll
      for (int ii = 0; ii < 4; ++ii) sv[ii] = dSs[(hi + 16 * ii) * PS + j];
#pragma unroll
      for (int cc = 0; cc < CC; ++cc) kv[cc] = Ks[j * SD + lo + 16 * cc];
#pragma unroll
      for (int ii = 0; ii < 4; ++ii)
#pragma unroll
        for (int cc = 0; cc < CC; ++cc)
          dQ[ii][cc] = fmaf(sv[ii], kv[cc], dQ[ii][cc]);
    }
  }
  float* dqb = a.dq + qo;
#pragma unroll
  for (int ii = 0; ii < 4; ++ii) {
    const int r = hi + 16 * ii;
    if (r >= valid) continue;
#pragma unroll
    for (int cc = 0; cc < CC; ++cc) {
      const int c = lo + 16 * cc;
      if (c < D) dqb[(size_t)r * D + c] = dQ[ii][cc] * a.scale;
    }
  }
}

using Kernel = decltype(&flash_bwd_kv_kernel<64>);

Kernel pick_kv(int DM) {
  return DM == 32   ? flash_bwd_kv_kernel<32>
         : DM == 64 ? flash_bwd_kv_kernel<64>
                    : flash_bwd_kv_kernel<128>;
}

Kernel pick_q(int DM) {
  return DM == 32   ? flash_bwd_q_kernel<32>
         : DM == 64 ? flash_bwd_q_kernel<64>
                    : flash_bwd_q_kernel<128>;
}

}  // namespace fb
}  // namespace

// q, o, dout, dq (B, Hq, Sq, D) contiguous; lse (B, Hq, Sq), the forward's;
// k and v (B, Hkv, Sk, D) rows of a cache of kv_cap rows a (batch, KV
// head), as the forward reads them; dk and dv (B, Hkv, Sk, D) contiguous.
// scale: the forward's softmax scale.  Two launches on `stream`: the dK/dV
// pass, then the dQ pass.
extern "C" int repro_flash_attention_bwd(
    const float* q, const float* k, const float* v, const float* o,
    const float* dout, const float* lse, float* dq, float* dk, float* dv,
    int B, int Hq, int Hkv, int Sq, int Sk, int D, int kv_cap, int causal,
    int q_offset, int sk_valid, float scale, void* stream) {
  if (B <= 0 || Hq <= 0 || Hkv <= 0 || Hq % Hkv != 0 || Sq <= 0 || Sk < 0 ||
      D <= 0 || D > 128 || kv_cap < Sk || q_offset < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int DM = fb::d_pad(D);
  const fb::Args a{q, k, v, o, dout, lse, dq, dk, dv, B, Hq, Hkv, Sq, Sk, D,
                   kv_cap, causal, q_offset,
                   sk_valid < 0 ? 0 : sk_valid < Sk ? sk_valid : Sk,
                   scale, scale * 1.4426950408889634f};
  const long long kv_blocks =
      (long long)B * Hkv * repro_cdiv(Sk, fb::BK_KV);
  const long long q_blocks = (long long)B * Hq * repro_cdiv(Sq, fb::BQ);
  if (kv_blocks > 0x7fffffffLL || q_blocks > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidConfiguration);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (kv_blocks > 0) {
    const size_t smem = sizeof(float) * fb::smem_floats(DM, true);
    const fb::Kernel kv = fb::pick_kv(DM);
    const int rc = tc::opt_in(kv, smem, false);
    if (rc != 0) return rc;
    kv<<<(unsigned)kv_blocks, fb::THREADS, smem, s>>>(a);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const size_t smem = sizeof(float) * fb::smem_floats(DM, false);
  const fb::Kernel qk = fb::pick_q(DM);
  const int rc = tc::opt_in(qk, smem, false);
  if (rc != 0) return rc;
  qk<<<(unsigned)q_blocks, fb::THREADS, smem, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}
