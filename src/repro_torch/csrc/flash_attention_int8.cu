// K7 over an int8 KV cache: GQA attention whose products are int8 x int8
// -> s32, with the reference's static scales, for a block of query rows
// (prefill or chunk, causal at q_offset) and for one decode row a query
// head (with kv_len).  One kernel, two entry points.
//
// Replaces no TPU kernel: the reference's int8 attention is jnp
// (repro/lm/modules.py `_attn_block` with an int8 cache, reached through
// `attention_scores`).  It is the port's own, so that an int8 cache runs
// its attention on the card as an f32 cache runs K7.  Its arithmetic is
// the reference's, step by step (kernels/attention/ref.py
// `int8_attention_ref` is the plain version):
//   qf = q / sqrt(D) (an IEEE division), qq = clip(rint(qf * 32), +-127);
//   s = (qq . k) / 1024, exact (an s32 dot, converted and scaled by 2^-10);
//   p = expf(s - max) / sum over the row's visible keys;
//   pq = rint(p * 127); out = (pq . v) / 4064 (an IEEE division).
// The reference quantizes the normalised probabilities, after the whole
// row's softmax, so the online softmax of the f32 kernel cannot be reused:
// quantizing tiles against a running max would give other integers.  So
// the kernel makes two passes over the keys:
//   * pass 1 scores every visible key and keeps each row's (max, sum of
//     expf(s - max)) online, in registers;
//   * pass 2 scores the keys again (the dots are integer, so S has the same
//     bits), normalises each p by a division, rounds it to an int8 and
//     accumulates pq . v in s32.
// p differs from the reference's only where the sums' order or expf's last
// bit differ, so pq can flip by one only where p * 127 sits on a rounding
// tie; chip_smoke.py counts those rows.
//
// Layouts: q and out (B, Hq, Sq, D) f32 contiguous; k and v (B, Hkv, Sk,
// D) int8 whose rows may be the first Sk of a cache holding kv_cap rows a
// (batch row, kv head), read in place.  A block takes RT = 16 RI rows of
// one (batch row, kv head): the G heads of the group times the Sq query
// rows, query-major (row r is query r / G of head r % G), so the rows of a
// block share their causal edge closely.  Key kp is visible to query i
// when kp < min(Sk, sk_valid, kv_len[b]) and, if causal, kp <= q_offset +
// i; a row that sees no key is written as 0.
//
// Bound on an H100: the decode reads the int8 cache once, 2 D bytes a key
// against 4 G D integer operations, so bytes bound at 3.35 TB/s; the
// prefill does 4 D operations a visible (query, key) pair, and its dots
// are integer, so its ceiling is the int8 rate.  This first version runs
// the dots with __dp4a on the CUDA cores (exact, like mma.sync's s8 ->
// s32, and simpler), 16-byte shared-memory reads laid out without bank
// conflicts; a decode cluster of up to 16 ranks splits the keys of a
// (batch row, kv head), merges the rows' (max, sum) over distributed
// shared memory between the passes (each rank merges all ranks' states in
// rank order, so every rank holds the same bits), and after pass 2 adds
// the ranks' s32 partial outputs, which is exact in any order.  No atomics:
// the same bits on every stream.
//
// Limits: D a multiple of 16 from 16 to 128; any GQA group G = Hq / Hkv
// (rows are tiled); B * Hkv and the row tiles at most 65535 each.
#include <math.h>
#include <stdint.h>

#include "tc_common.cuh"

namespace {
namespace i8 {

constexpr int NT = 256;          // threads a block: 16 row groups x 16
constexpr int TK = 64;           // keys a tile
constexpr int TKW = TK / 4;      // 32-bit words of a P row or a V^T row
constexpr int PAD = 4;           // words past every shared row
constexpr int PW = TKW + PAD;    // row stride of P and V^T, words
constexpr int MAX_D = 128;
constexpr int MAX_FJ = MAX_D / 16;   // features a thread

__host__ __device__ inline int row_words(int D) { return D / 4 + PAD; }

// Shared memory in bytes (plan.py's int8_smem_bytes): qq [RT][RW]; the K
// and V tiles [TK][RW]; V^T [D][PW]; P [RT][PW]; the rows' (m, l) [RT][2];
// with a cluster the partial outputs [RT][D] s32.  RW = D / 4 + 4 keeps
// every row 16-byte aligned and 16-byte reads of 8 neighbouring rows on
// distinct banks.
__host__ __device__ inline int smem_bytes(int RT, int D, int cl) {
  const int rw = row_words(D);
  int words = RT * rw + 2 * TK * rw + D * PW + RT * PW + 2 * RT;
  if (cl > 1) words += RT * D;
  return 4 * words;
}

__device__ __forceinline__ int dot4(int4 a, int4 b, int c) {
  c = __dp4a(a.x, b.x, c);
  c = __dp4a(a.y, b.y, c);
  c = __dp4a(a.z, b.z, c);
  return __dp4a(a.w, b.w, c);
}

__device__ __forceinline__ int quantize_q(float x, float sqrt_d) {
  const float r = rintf(__fdiv_rn(x, sqrt_d) * 32.f);
  return static_cast<int>(fminf(fmaxf(r, -127.f), 127.f));
}

__device__ __forceinline__ float half_max(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float half_sum(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Grid (cl, row tiles, B * Hkv), clusters of (cl, 1, 1).  Thread t takes
// rows t / 16 + 16 i (i < RI), keys t % 16 + 16 j (j < 4) of a tile, and
// output features t % 16 + 16 j (j < D / 16).
template <int RI>
__global__ void __launch_bounds__(NT, 2)
attention_int8_kernel(const float* __restrict__ q,
                      const int8_t* __restrict__ k,
                      const int8_t* __restrict__ v,
                      const int* __restrict__ kv_len,
                      float* __restrict__ out, int Hq, int Hkv, int Sq,
                      int Sk, int D, int kv_cap, int causal, int q_offset,
                      int sk_valid, float sqrt_d) {
  namespace cg = cooperative_groups;
  constexpr int RT = 16 * RI;
  cg::cluster_group cluster = cg::this_cluster();
  const int cl = gridDim.x, rank = blockIdx.x;
  extern __shared__ __align__(16) int smem[];
  const int RW = row_words(D), DW = D / 4, FJ = D / 16;
  int* qq = smem;                            // [RT][RW]
  int* ks = qq + RT * RW;                    // [TK][RW]
  int* vs = ks + TK * RW;                    // [TK][RW]
  int* vt = vs + TK * RW;                    // [D][PW]
  int* ps = vt + D * PW;                     // [RT][PW]
  float* ml = reinterpret_cast<float*>(ps + RT * PW);   // [RT][2]
  int* accs = reinterpret_cast<int*>(ml + 2 * RT);      // [RT][D]

  const int tid = threadIdx.x, kc = tid & 15, rg = tid >> 4;
  const int bh = blockIdx.z;
  const int b = bh / Hkv, hk = bh - b * Hkv;
  const int G = Hq / Hkv, rows = G * Sq;
  const int r0 = (gridDim.y - 1 - blockIdx.y) * RT;     // heaviest first
  const int8_t* kb = k + (size_t)bh * kv_cap * D;
  const int8_t* vb = v + (size_t)bh * kv_cap * D;

  int kv_end = min(Sk, sk_valid);
  if (kv_len != nullptr) kv_end = min(kv_end, max(kv_len[b], 0));
  kv_end = max(kv_end, 0);
  // the keys each of this thread's rows sees, and the block's
  int lim[RI];
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const int r = r0 + rg + 16 * i;
    lim[i] = r >= rows ? 0
             : causal ? min(kv_end, max(0, q_offset + r / G + 1))
                      : kv_end;
  }
  const int last = min(rows, r0 + RT) - 1;
  const int blk_end =
      causal ? min(kv_end, max(0, q_offset + last / G + 1)) : kv_end;
  int t0, t1;
  tc::rank_range(repro_cdiv(blk_end, TK), cl, rank, t0, t1);

  // q, quantized once: row r of the tile is query (r0 + r) / G of head
  // hk G + (r0 + r) % G
  for (int idx = tid; idx < RT * DW; idx += NT) {
    const int r = idx / DW, w = idx - r * DW;
    int word = 0;
    if (r0 + r < rows) {
      const int qi = (r0 + r) / G, g = (r0 + r) - qi * G;
      const float4 x = *reinterpret_cast<const float4*>(
          q + (((size_t)b * Hq + hk * G + g) * Sq + qi) * D + 4 * w);
      word = (quantize_q(x.x, sqrt_d) & 0xff) |
             (quantize_q(x.y, sqrt_d) & 0xff) << 8 |
             (quantize_q(x.z, sqrt_d) & 0xff) << 16 |
             (quantize_q(x.w, sqrt_d) & 0xff) << 24;
    }
    qq[r * RW + w] = word;
  }

  // stage rows [key0, key0 + TK) of K (and V) as 16-byte copies, zero
  // past nk
  const float* safe = reinterpret_cast<const float*>(kb);
  auto stage = [&](int key0, int nk, bool with_v) {
    const int quads = D / 16;
    const int n = (with_v ? 2 : 1) * TK * quads;
    for (int idx = tid; idx < n; idx += NT) {
      const int half = idx >= TK * quads;
      const int e = idx - half * TK * quads;
      const int row = e / quads, qd = e - row * quads;
      const int8_t* src = (half ? vb : kb) + (size_t)(key0 + row) * D +
                          16 * qd;
      tc::cp_quad(reinterpret_cast<float*>((half ? vs : ks) + row * RW +
                                           4 * qd),
                  reinterpret_cast<const float*>(src), row < nk ? 4 : 0,
                  true, safe);
    }
    tc::cp_commit();
  };
  // the tile's dots of this thread's rows and keys
  auto scores = [&](int (&acc)[RI][4]) {
#pragma unroll
    for (int i = 0; i < RI; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0;
    for (int w = 0; w < DW; w += 4) {
      int4 a[RI];
#pragma unroll
      for (int i = 0; i < RI; ++i)
        a[i] = *reinterpret_cast<const int4*>(qq + (rg + 16 * i) * RW + w);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int4 kk =
            *reinterpret_cast<const int4*>(ks + (kc + 16 * j) * RW + w);
#pragma unroll
        for (int i = 0; i < RI; ++i) acc[i][j] = dot4(a[i], kk, acc[i][j]);
      }
    }
  };

  // pass 1: each row's max and sum of expf(s - max), online
  float m[RI], l[RI];
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
  }
  for (int t = t0; t < t1; ++t) {
    const int key0 = t * TK;
    stage(key0, min(TK, blk_end - key0), false);
    tc::cp_wait<0>();
    __syncthreads();                             // the tile (and q) is in
    int dots[RI][4];
    scores(dots);
#pragma unroll
    for (int i = 0; i < RI; ++i) {
      float s[4];
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[j] = key0 + kc + 16 * j < lim[i]
                   ? static_cast<float>(dots[i][j]) * (1.f / 1024.f)
                   : -INFINITY;
        mx = fmaxf(mx, s[j]);
      }
      const float mn = fmaxf(m[i], half_max(mx));
      float e = 0.f;
      if (mn != -INFINITY) {
#pragma unroll
        for (int j = 0; j < 4; ++j) e += expf(s[j] - mn);
      }
      e = half_sum(e);
      if (mn != -INFINITY) {
        l[i] = l[i] * expf(m[i] - mn) + e;
        m[i] = mn;
      }
    }
    __syncthreads();                             // the tile is free
  }

  // the cluster's states merged in rank order, the same bits in every rank
  if (cl > 1) {
    if (kc == 0) {
#pragma unroll
      for (int i = 0; i < RI; ++i) {
        ml[2 * (rg + 16 * i)] = m[i];
        ml[2 * (rg + 16 * i) + 1] = l[i];
      }
    }
    cluster.sync();
#pragma unroll
    for (int i = 0; i < RI; ++i) {
      const int r = rg + 16 * i;
      float mg = -INFINITY;
      for (int j = 0; j < cl; ++j)
        mg = fmaxf(mg, cluster.map_shared_rank(ml, j)[2 * r]);
      float lg = 0.f;
      if (mg != -INFINITY) {
        for (int j = 0; j < cl; ++j) {
          const float* o = cluster.map_shared_rank(ml, j);
          if (o[2 * r] != -INFINITY)
            lg = fmaf(o[2 * r + 1], expf(o[2 * r] - mg), lg);
        }
      }
      m[i] = mg;
      l[i] = lg;
    }
  }

  // pass 2: S again, p normalised and rounded, acc += pq . v in s32
  int acc[RI][MAX_FJ];
#pragma unroll
  for (int i = 0; i < RI; ++i)
#pragma unroll
    for (int j = 0; j < MAX_FJ; ++j) acc[i][j] = 0;
  for (int t = t0; t < t1; ++t) {
    const int key0 = t * TK;
    stage(key0, min(TK, blk_end - key0), true);
    tc::cp_wait<0>();
    __syncthreads();                             // the tile is in
    // V^T: word (f, kw) holds features f of keys 4 kw .. 4 kw + 3
    for (int idx = tid; idx < TKW * DW; idx += NT) {
      const int kw = idx % TKW, wd = idx / TKW;
      uint32_t x[4];
#pragma unroll
      for (int e = 0; e < 4; ++e)
        x[e] = static_cast<uint32_t>(vs[(4 * kw + e) * RW + wd]);
#pragma unroll
      for (int f = 0; f < 4; ++f)
        vt[(4 * wd + f) * PW + kw] = static_cast<int>(
            (x[0] >> (8 * f) & 0xffu) | (x[1] >> (8 * f) & 0xffu) << 8 |
            (x[2] >> (8 * f) & 0xffu) << 16 | (x[3] >> (8 * f) & 0xffu) << 24);
    }
    int dots[RI][4];
    scores(dots);
    int8_t* pb = reinterpret_cast<int8_t*>(ps);
#pragma unroll
    for (int i = 0; i < RI; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int key = kc + 16 * j;
        int pq = 0;
        if (key0 + key < lim[i]) {
          const float s = static_cast<float>(dots[i][j]) * (1.f / 1024.f);
          const float p = __fdiv_rn(expf(s - m[i]), l[i]);
          pq = __float2int_rn(p * 127.f);
        }
        pb[(rg + 16 * i) * PW * 4 + key] = static_cast<int8_t>(pq);
      }
    }
    __syncthreads();                             // P and V^T are in
    for (int w = 0; w < TKW; w += 4) {
      int4 pa[RI];
#pragma unroll
      for (int i = 0; i < RI; ++i)
        pa[i] = *reinterpret_cast<const int4*>(ps + (rg + 16 * i) * PW + w);
#pragma unroll
      for (int j = 0; j < MAX_FJ; ++j) {
        if (j < FJ) {
          const int4 vv =
              *reinterpret_cast<const int4*>(vt + (kc + 16 * j) * PW + w);
#pragma unroll
          for (int i = 0; i < RI; ++i) acc[i][j] = dot4(pa[i], vv, acc[i][j]);
        }
      }
    }
    __syncthreads();                             // the tiles are free
  }

  // out = acc / (127 * 32), the ranks' partial sums added first
  if (cl == 1) {
#pragma unroll
    for (int i = 0; i < RI; ++i) {
      const int r = r0 + rg + 16 * i;
      if (r >= rows) continue;
      const int qi = r / G, g = r - qi * G;
      float* orow = out + (((size_t)b * Hq + hk * G + g) * Sq + qi) * D;
#pragma unroll
      for (int j = 0; j < MAX_FJ; ++j)
        if (j < FJ)
          orow[kc + 16 * j] =
              __fdiv_rn(static_cast<float>(acc[i][j]), 4064.f);
    }
    return;
  }
#pragma unroll
  for (int i = 0; i < RI; ++i)
#pragma unroll
    for (int j = 0; j < MAX_FJ; ++j)
      if (j < FJ) accs[(rg + 16 * i) * D + kc + 16 * j] = acc[i][j];
  cluster.sync();                                // every partial is in
  int e0, e1;
  tc::rank_range(RT * D, cl, rank, e0, e1);
  for (int e = e0 + tid; e < e1; e += NT) {
    const int r = r0 + e / D;
    if (r >= rows) continue;
    int sum = 0;
    for (int j = 0; j < cl; ++j) sum += cluster.map_shared_rank(accs, j)[e];
    const int qi = r / G, g = r - qi * G;
    out[(((size_t)b * Hq + hk * G + g) * Sq + qi) * D + e % D] =
        __fdiv_rn(static_cast<float>(sum), 4064.f);
  }
  cluster.sync();                                // no rank leaves early
}

using Kernel = decltype(&attention_int8_kernel<1>);

Kernel pick(int rt) {
  return rt == 16   ? attention_int8_kernel<1>
         : rt == 32 ? attention_int8_kernel<2>
         : rt == 64 ? attention_int8_kernel<4>
                    : nullptr;
}

int run(const float* q, const int8_t* k, const int8_t* v, const int* kv_len,
        float* out, int B, int Hq, int Hkv, int Sq, int Sk, int D,
        int kv_cap, int causal, int q_offset, int sk_valid, float sqrt_d,
        int rt, int cl, int smem, void* stream) {
  const Kernel kernel = pick(rt);
  if (kernel == nullptr || B <= 0 || Hq <= 0 || Hkv <= 0 || Hq % Hkv != 0 ||
      Sq <= 0 || Sk < 0 || D < 16 || D > MAX_D || D % 16 != 0 ||
      kv_cap < Sk || q_offset < 0 || cl < 1 || cl > 16 ||
      smem != smem_bytes(rt, D, cl))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long tiles = repro_cdiv(Hq / Hkv * Sq, rt);
  if (tiles > 65535 || (long long)B * Hkv > 65535)
    return static_cast<int>(cudaErrorInvalidConfiguration);
  return tc::launch_clustered_n(kernel, NT, cl, (int)tiles, B * Hkv,
                                (size_t)smem, stream, false, q, k, v, kv_len,
                                out, Hq, Hkv, Sq, Sk, D, kv_cap, causal,
                                q_offset, sk_valid, sqrt_d);
}

}  // namespace i8
}  // namespace

// Sq query rows a (batch, query head) against the int8 cache's first Sk
// rows, causal at q_offset, keys past sk_valid masked.  rt (16, 32 or 64
// rows a block) and smem come from plan.py's plan_flash_int8; smem must
// equal i8::smem_bytes.  k and v 16-byte aligned.
extern "C" int repro_flash_attention_int8(const float* q, const int8_t* k,
                                          const int8_t* v, float* out, int B,
                                          int Hq, int Hkv, int Sq, int Sk,
                                          int D, int kv_cap, int causal,
                                          int q_offset, int sk_valid,
                                          float sqrt_d, int rt, int smem,
                                          void* stream) {
  return i8::run(q, k, v, nullptr, out, B, Hq, Hkv, Sq, Sk, D, kv_cap,
                 causal, q_offset, sk_valid, sqrt_d, rt, 1, smem, stream);
}

// One query row a (batch, query head) against the first kv_len[b] rows of
// the int8 cache (kv_len may be NULL: all Sk).  rt, the cluster cl (ranks
// splitting the keys of a (batch row, kv head)) and smem come from
// plan.py's plan_decode_int8.
extern "C" int repro_decode_attention_int8(const float* q, const int8_t* k,
                                           const int8_t* v,
                                           const int* kv_len, float* out,
                                           int B, int Hq, int Hkv, int Sk,
                                           int D, int kv_cap, float sqrt_d,
                                           int rt, int cl, int smem,
                                           void* stream) {
  return i8::run(q, k, v, kv_len, out, B, Hq, Hkv, 1, Sk, D, kv_cap, 0, 0,
                 Sk, sqrt_d, rt, cl, smem, stream);
}
