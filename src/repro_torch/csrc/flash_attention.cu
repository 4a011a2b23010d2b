// K7: GQA attention with the online softmax, f32 on the CUDA cores.
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
// key at all is written as 0 (the TPU kernel's l == 0 rule).
//
// Flash (prefill), bound on an H100: 4*D FLOPs per visible (query, key)
// pair against q, k, v and out read or written once: at Sq = Sk = 512,
// D = 64, G = 7 about 60 FLOPs a byte, so operations bound at 67 TFLOP/s
// f32.  Design: the TPU kernel walks a sequential k grid axis carrying
// (m, l, acc) in VMEM scratch; blocks carry nothing here, so one block owns
// a 64-row q tile of one (batch, q head) and loops over 64-key tiles itself,
// (m, l, acc) in registers.  Q and the k tile sit transposed in shared
// memory (float4 reads along the tile), v row-major, and p goes through
// shared memory to the P.V product.  256 threads, each a 4x4 patch of the
// 64x64 score tile and 4 rows x D/16 columns of acc; the row max and sum
// are 16-lane shuffle reductions.  Key tiles past the tile's causal limit
// are skipped.  Plain f32 FMAs; wgmma and TMA come later.
//
// Decode (Sq = 1), bound on an H100: it reads every visible cache row once
// for G query heads, 4*G*D FLOPs against 8*D bytes a row: bytes bound at
// 3.35 TB/s.  Design: a block takes all G query heads of a (batch, kv head)
// group, so each KV row leaves device memory once per group.  The keys are
// split over blocks, 128 a block (split-K): at the LM path's 4 rows, 2 kv
// heads and some 540 cached keys that is 40 blocks where one block per
// group gave 8.  A block's 4 warps take a 32-key tile each, a lane per key
// for the scores (its whole key row loaded at once) and a lane per feature
// for P.V (8 value rows loaded at once), so many loads are in flight where
// one load at a time left the first design latency bound.  The warps merge
// their softmaxes in shared memory; with more than one split the blocks
// write (m, l, acc) per query head to a scratch the wrapper allocates, and
// a second kernel merges the splits in split order.  `kv_len` (per batch
// row, may be NULL) is clamped to [0, Sk].
//
// No atomics: the result does not depend on the stream or the launch.
#include <math.h>

#include "common.cuh"

namespace {

constexpr int BQ = 64;
constexpr int BK = 64;
constexpr int FLASH_THREADS = 256;   // 16 x 16, a 4x4 score patch each
constexpr int TS = BQ + 4;           // stride of the transposed q/k tiles
constexpr int PS = BK + 1;           // stride of the p tile
constexpr int MAX_D = 128;
constexpr int DPT = MAX_D / 16;      // acc columns a flash thread at most

constexpr int DEC_WARPS = 4;
constexpr int KEYS_PER_SPLIT = 32 * DEC_WARPS;   // a decode block's keys
constexpr int MAX_G = 8;
constexpr int DPL = MAX_D / 32;      // features a decode lane at most
constexpr int KVEC = 16;             // float4 of a key row in flight
constexpr int VCHUNK = 8;            // value rows in flight

// Key splits of a decode call: one block per KEYS_PER_SPLIT keys.
inline int repro_decode_splits(int Sk) {
  return Sk > 0 ? repro_cdiv(Sk, KEYS_PER_SPLIT) : 1;
}

__device__ __forceinline__ float half_warp_max(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float half_warp_sum(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__global__ void __launch_bounds__(FLASH_THREADS)
flash_attention_kernel(const float* __restrict__ q,
                       const float* __restrict__ k,
                       const float* __restrict__ v, float* __restrict__ out,
                       int Hq, int Hkv, int Sq, int Sk, int D, int kv_cap,
                       int causal, int q_offset, int sk_valid, float scale) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* qt = smem;                 // [D][TS]: q tile, transposed
  float* kt = qt + D * TS;          // [D][TS]: k tile, transposed
  float* vs = kt + D * TS;          // [BK][D]
  float* ps = vs + BK * D;          // [BQ][PS]

  const int tid = threadIdx.x;
  const int tx = tid & 15;          // score columns tx*4 .. +4
  const int ty = tid >> 4;          // score rows ty*4 .. +4
  const int q0 = blockIdx.x * BQ;
  const int bh = blockIdx.y;
  const int b = bh / Hq;
  const int h = bh % Hq;
  const int hk = h / (Hq / Hkv);
  const float* qb = q + ((size_t)bh * Sq) * D;
  const float* kb = k + ((size_t)b * Hkv + hk) * kv_cap * D;
  const float* vb = v + ((size_t)b * Hkv + hk) * kv_cap * D;

  const int kv_end = min(Sk, max(sk_valid, 0));
  int n_keys = kv_end;
  if (causal) n_keys = min(n_keys, max(q_offset + min(q0 + BQ, Sq), 0));

  for (int i = tid; i < BQ * D; i += FLASH_THREADS) {
    const int r = i / D, d = i - r * D;
    qt[d * TS + r] = (q0 + r < Sq) ? qb[(size_t)(q0 + r) * D + d] : 0.f;
  }

  float m[4], l[4], acc[4][DPT];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < DPT; ++j) acc[i][j] = 0.f;
  }

  for (int k0 = 0; k0 < n_keys; k0 += BK) {
    __syncthreads();   // the previous tile's readers are done (and q is in)
    for (int i = tid; i < BK * D; i += FLASH_THREADS) {
      const int c = i / D, d = i - c * D;
      const bool ok = k0 + c < kv_end;
      kt[d * TS + c] = ok ? kb[(size_t)(k0 + c) * D + d] : 0.f;
      vs[c * D + d] = ok ? vb[(size_t)(k0 + c) * D + d] : 0.f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
    for (int d = 0; d < D; ++d) {
      const float4 a = *reinterpret_cast<const float4*>(qt + d * TS + ty * 4);
      const float4 c = *reinterpret_cast<const float4*>(kt + d * TS + tx * 4);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float cv[4] = {c.x, c.y, c.z, c.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(av[i], cv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q_offset + q0 + ty * 4 + i;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kpos = k0 + tx * 4 + j;
        const bool ok = kpos < kv_end && (!causal || kpos <= qpos);
        s[i][j] = ok ? s[i][j] * scale : -INFINITY;
        mx = fmaxf(mx, s[i][j]);
      }
      mx = half_warp_max(mx);
      const float m_new = fmaxf(m[i], mx);
      float alpha = 1.f, rs = 0.f;
      if (m_new != -INFINITY) {
        alpha = expf(m[i] - m_new);    // 0 when m[i] is -inf
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = expf(s[i][j] - m_new);
          rs += s[i][j];
        }
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
      }
      rs = half_warp_sum(rs);
      l[i] = l[i] * alpha + rs;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < DPT; ++j) acc[i][j] *= alpha;
#pragma unroll
      for (int j = 0; j < 4; ++j) ps[(ty * 4 + i) * PS + tx * 4 + j] = s[i][j];
    }
    __syncthreads();

    const int kn = min(BK, kv_end - k0);
    for (int c = 0; c < kn; ++c) {
      float pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = ps[(ty * 4 + i) * PS + c];
#pragma unroll
      for (int j = 0; j < DPT; ++j) {
        const int d = tx + 16 * j;
        if (d < D) {
          const float vv = vs[c * D + d];
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(pv[i], vv, acc[i][j]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty * 4 + i;
    if (r >= Sq) continue;
    const float inv = l[i] == 0.f ? 0.f : 1.f / l[i];
#pragma unroll
    for (int j = 0; j < DPT; ++j) {
      const int d = tx + 16 * j;
      if (d < D) out[((size_t)bh * Sq + r) * D + d] = acc[i][j] * inv;
    }
  }
}

// One block per (batch, kv head, split of KEYS_PER_SPLIT keys): its warps
// take a 32-key tile each, and the block's merged softmax goes to
// `out` (one split) or to the split's slot of `part` for the combine.
__global__ void __launch_bounds__(32 * DEC_WARPS)
decode_attention_kernel(const float* __restrict__ q,
                        const float* __restrict__ k,
                        const float* __restrict__ v,
                        const int* __restrict__ kv_len,
                        float* __restrict__ out, float* __restrict__ part,
                        int Hq, int Hkv, int Sk, int D, int kv_cap,
                        float scale) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int G = Hq / Hkv;
  float* qs = smem;                        // [G][D]
  float* wm = qs + G * D;                  // [DEC_WARPS][G]
  float* wl = wm + DEC_WARPS * G;          // [DEC_WARPS][G]
  float* wacc = wl + DEC_WARPS * G;        // [DEC_WARPS][G][D]

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int bh = blockIdx.x;
  const int b = bh / Hkv;
  const int hk = bh % Hkv;
  const float* qb = q + ((size_t)b * Hq + (size_t)hk * G) * D;
  const float* kb = k + (size_t)bh * kv_cap * D;
  const float* vb = v + (size_t)bh * kv_cap * D;
  int len = Sk;
  if (kv_len != nullptr) len = min(max(kv_len[b], 0), Sk);
  const int t0 = blockIdx.y * KEYS_PER_SPLIT + warp * 32;   // this warp's
  const int key = t0 + lane;                                 // tile
  const bool ok = key < len;

  for (int i = threadIdx.x; i < G * D; i += 32 * DEC_WARPS) qs[i] = qb[i];
  __syncthreads();

  // scores: a lane per key, its row read with all loads in flight at once
  float s[MAX_G];
#pragma unroll
  for (int g = 0; g < MAX_G; ++g) s[g] = 0.f;
  const float* kr = kb + (size_t)key * D;
  if ((D & 3) == 0 && (reinterpret_cast<size_t>(k) & 15) == 0) {
    for (int d0 = 0; d0 < D; d0 += 4 * KVEC) {
      float4 kk[KVEC];
#pragma unroll
      for (int i = 0; i < KVEC; ++i)
        kk[i] = (ok && d0 + 4 * i < D)
                    ? *reinterpret_cast<const float4*>(kr + d0 + 4 * i)
                    : make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
      for (int i = 0; i < KVEC; ++i) {
        if (d0 + 4 * i >= D) break;
#pragma unroll
        for (int g = 0; g < MAX_G; ++g) {
          if (g < G) {
            const float* qg = qs + g * D + d0 + 4 * i;
            s[g] = fmaf(qg[0], kk[i].x, s[g]);
            s[g] = fmaf(qg[1], kk[i].y, s[g]);
            s[g] = fmaf(qg[2], kk[i].z, s[g]);
            s[g] = fmaf(qg[3], kk[i].w, s[g]);
          }
        }
      }
    }
  } else if (ok) {
    for (int d = 0; d < D; ++d) {
      const float kk = kr[d];
#pragma unroll
      for (int g = 0; g < MAX_G; ++g)
        if (g < G) s[g] = fmaf(qs[g * D + d], kk, s[g]);
    }
  }

  // the tile's softmax: m, l and p per query head (a warp with no key
  // keeps m = -inf, l = 0, acc = 0)
  float m[MAX_G], l[MAX_G], p[MAX_G], acc[MAX_G][DPL];
#pragma unroll
  for (int g = 0; g < MAX_G; ++g) {
    m[g] = -INFINITY;
    l[g] = 0.f;
    p[g] = 0.f;
#pragma unroll
    for (int j = 0; j < DPL; ++j) acc[g][j] = 0.f;
  }
  const int kn = max(0, min(32, len - t0));
  if (kn > 0) {
#pragma unroll
    for (int g = 0; g < MAX_G; ++g) {
      if (g >= G) break;
      const float sg = ok ? s[g] * scale : -INFINITY;
      m[g] = warp_max(sg);                  // finite: key t0 is ok
      p[g] = ok ? expf(sg - m[g]) : 0.f;
      l[g] = warp_sum(p[g]);
    }
    // P.V: a lane per feature, V rows read VCHUNK at a time
    for (int c0 = 0; c0 < kn; c0 += VCHUNK) {
      float vv[VCHUNK][DPL];
#pragma unroll
      for (int c = 0; c < VCHUNK; ++c)
#pragma unroll
        for (int j = 0; j < DPL; ++j) {
          const int d = lane + 32 * j;
          vv[c][j] = (c0 + c < kn && d < D)
                         ? vb[(size_t)(t0 + c0 + c) * D + d] : 0.f;
        }
#pragma unroll
      for (int c = 0; c < VCHUNK; ++c) {
        if (c0 + c >= kn) break;           // warp-uniform
#pragma unroll
        for (int g = 0; g < MAX_G; ++g) {
          if (g >= G) break;
          const float pc = __shfl_sync(0xffffffffu, p[g], c0 + c);
#pragma unroll
          for (int j = 0; j < DPL; ++j)
            acc[g][j] = fmaf(pc, vv[c][j], acc[g][j]);
        }
      }
    }
  }

  // merge the warps, in warp order
  for (int g = 0; g < G; ++g) {
    if (lane == 0) {
      wm[warp * G + g] = m[g];
      wl[warp * G + g] = l[g];
    }
#pragma unroll
    for (int j = 0; j < DPL; ++j) {
      const int d = lane + 32 * j;
      if (d < D) wacc[(warp * G + g) * D + d] = acc[g][j];
    }
  }
  __syncthreads();
  const int n_split = gridDim.y;
  for (int i = threadIdx.x; i < G * D; i += 32 * DEC_WARPS) {
    const int g = i / D, d = i - g * D;
    float mx = -INFINITY;
    for (int w = 0; w < DEC_WARPS; ++w) mx = fmaxf(mx, wm[w * G + g]);
    float lsum = 0.f, o = 0.f;
    if (mx != -INFINITY) {
      for (int w = 0; w < DEC_WARPS; ++w) {
        const float mw = wm[w * G + g];
        if (mw == -INFINITY) continue;
        const float f = expf(mw - mx);
        lsum = fmaf(wl[w * G + g], f, lsum);
        o = fmaf(wacc[(w * G + g) * D + d], f, o);
      }
    }
    if (n_split == 1) {
      out[((size_t)b * Hq + (size_t)hk * G + g) * D + d] =
          lsum == 0.f ? 0.f : o / lsum;
    } else {
      // part: per (bh, split, g) the row [m, l, acc[0..D)]
      float* slot = part + (((size_t)bh * n_split + blockIdx.y) * G + g)
                               * (D + 2);
      if (d == 0) {
        slot[0] = mx;
        slot[1] = lsum;
      }
      slot[2 + d] = o;
    }
  }
}

// The splits' softmaxes merged in split order: one block per (batch, kv
// head), a thread per (query head, feature).
__global__ void __launch_bounds__(256)
decode_combine_kernel(const float* __restrict__ part, float* __restrict__ out,
                      int Hq, int Hkv, int D, int n_split) {
  const int G = Hq / Hkv;
  const int bh = blockIdx.x;
  const int b = bh / Hkv;
  const int hk = bh % Hkv;
  for (int i = threadIdx.x; i < G * D; i += blockDim.x) {
    const int g = i / D, d = i - g * D;
    const float* row = part + ((size_t)bh * n_split * G + g) * (D + 2);
    const size_t step = (size_t)G * (D + 2);   // next split, same head
    float mx = -INFINITY;
    for (int sp = 0; sp < n_split; ++sp) mx = fmaxf(mx, row[sp * step]);
    float lsum = 0.f, o = 0.f;
    if (mx != -INFINITY) {
      for (int sp = 0; sp < n_split; ++sp) {
        const float* r = row + sp * step;
        if (r[0] == -INFINITY) continue;
        const float f = expf(r[0] - mx);
        lsum = fmaf(r[1], f, lsum);
        o = fmaf(r[2 + d], f, o);
      }
    }
    out[((size_t)b * Hq + (size_t)hk * G + g) * D + d] =
        lsum == 0.f ? 0.f : o / lsum;
  }
}

}  // namespace

extern "C" int repro_flash_attention(const float* q, const float* k,
                                     const float* v, float* out, int B,
                                     int Hq, int Hkv, int Sq, int Sk, int D,
                                     int kv_cap, int causal, int q_offset,
                                     int sk_valid, float scale,
                                     void* stream) {
  if (B <= 0 || Hq <= 0 || Hkv <= 0 || Hq % Hkv != 0 || Sq <= 0 || Sk < 0 ||
      D <= 0 || D > MAX_D || kv_cap < Sk || q_offset < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = (size_t)(2 * D * TS + BK * D + BQ * PS) * sizeof(float);
  cudaError_t err = repro_smem_opt_in(flash_attention_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(repro_cdiv(Sq, BQ), B * Hq);
  if (grid.y > 65535) return static_cast<int>(cudaErrorInvalidConfiguration);
  flash_attention_kernel<<<grid, FLASH_THREADS, smem,
                           static_cast<cudaStream_t>(stream)>>>(
      q, k, v, out, Hq, Hkv, Sq, Sk, D, kv_cap, causal, q_offset, sk_valid,
      scale);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int repro_decode_attention(const float* q, const float* k,
                                      const float* v, const int* kv_len,
                                      float* out, float* part, int B, int Hq,
                                      int Hkv, int Sk, int D, int kv_cap,
                                      int n_split, float scale,
                                      void* stream) {
  if (B <= 0 || Hq <= 0 || Hkv <= 0 || Hq % Hkv != 0 ||
      Hq / Hkv > MAX_G || Sk < 0 || D <= 0 || D > MAX_D || kv_cap < Sk ||
      n_split != repro_decode_splits(Sk) || (n_split > 1 && part == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const int G = Hq / Hkv;
  const size_t smem =
      (size_t)(G * D + 2 * DEC_WARPS * G + DEC_WARPS * G * D) * sizeof(float);
  cudaError_t err = repro_smem_opt_in(decode_attention_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n_split > 65535) return static_cast<int>(cudaErrorInvalidConfiguration);
  decode_attention_kernel<<<dim3(B * Hkv, n_split), 32 * DEC_WARPS, smem, s>>>(
      q, k, v, kv_len, out, part, Hq, Hkv, Sk, D, kv_cap, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess || n_split == 1) return static_cast<int>(err);
  decode_combine_kernel<<<B * Hkv, 256, 0, s>>>(part, out, Hq, Hkv, D,
                                                n_split);
  return static_cast<int>(cudaGetLastError());
}
