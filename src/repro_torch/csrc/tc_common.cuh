// Shared pieces of the tensor-core kernels K1 (matmul_bias_act.cu), K3
// (conv2d_implicit_gemm.cu), K4 (fused_dw_pw_conv.cu), K5
// (fused_pw_dw_pw_conv.cu) and K7 (flash_attention.cu), of K2's staging
// (depthwise_conv2d.cu) and of K6's launch (rmsnorm.cu): cp.async staging
// with zero fill, products on the tensor cores in 3xTF32, the contiguous
// split of a reduction between the ranks of a thread-block cluster, the
// cluster's rank-order sum of partial tiles over distributed shared
// memory, the clustered and the programmatic dependent launches, and the
// split-K GEMM tile that K1 and K3 share.
//
// 3xTF32: each f32 operand v is split into hi = tf32(v) and
// lo = tf32(v - hi), and a product is lo*hi + hi*lo + hi*hi, each an
// mma.sync.m16n8k8 accumulating in f32.  That keeps about 21 of f32's 24
// mantissa bits in every product (lo*lo, below 2^-22 relative, is dropped),
// so the kernels hold rtol = atol = 1e-4 against the plain f32 versions at
// K up to 1280.  3xTF32 was chosen over the same tiling with f32 FMAs on the
// CUDA cores: both held 1e-4, and 3xTF32 was 1.1-1.6x faster on every path
// of K4 and K5 (PERF.md).
#pragma once

#include <cooperative_groups.h>
#include <cstdint>

#include "common.cuh"

namespace tc {

namespace cg = cooperative_groups;

constexpr int NT = 256;       // threads a block
constexpr int MIN_BLOCKS = 2; // blocks an SM holds: at most 128 registers
constexpr int WARPS = NT / 32;
constexpr int MAX_STAGES = 4; // cp.async ring: up to 3 steps in flight

__host__ __device__ inline int round_up(int a, int b) {
  return repro_cdiv(a, b) * b;
}

// This rank's share [lo, hi) of n steps: contiguous runs in rank order.
__device__ __forceinline__ void rank_range(int n, int cl, int rank, int& lo,
                                           int& hi) {
  lo = rank * n / cl;
  hi = (rank + 1) * n / cl;
}

// ---------------------------------------------------------------- cp.async
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 4 floats from src into dst; only the first `valid` (0..4) are read, the
// rest are zero.  vec: src is 16-byte aligned (one 16-byte copy); else four
// 4-byte copies.  `safe` is any readable address, given when nothing is.
__device__ __forceinline__ void cp_quad(float* dst, const float* src,
                                        int valid, bool vec,
                                        const float* safe) {
  if (vec) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                     smem_u32(dst)),
                 "l"(valid > 0 ? src : safe),
                 "r"(4 * (valid > 0 ? valid : 0)));
  } else {
#pragma unroll
    for (int e = 0; e < 4; ++e)
      asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                       smem_u32(dst + e)),
                   "l"(e < valid ? src + e : safe), "r"(e < valid ? 4 : 0));
  }
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Wait until at most n (0..2) committed groups are still in flight.
__device__ __forceinline__ void cp_wait_n(int n) {
  if (n >= 2) cp_wait<2>();
  else if (n == 1) cp_wait<1>();
  else cp_wait<0>();
}

// Stage `rows` rows of `cols` floats (cols a multiple of 4) into dst (row
// stride ds).  Row r's source is row_src(r) or nullptr (all zero); its
// first row_valid(r) floats are real, the rest zero.
template <typename Src, typename Valid>
__device__ __forceinline__ void stage_rows(float* dst, int ds, int rows,
                                           int cols, Src row_src,
                                           Valid row_valid, bool vec,
                                           const float* safe) {
  const int quads = cols / 4;
  for (int idx = threadIdx.x; idx < rows * quads; idx += NT) {
    const int r = idx / quads;
    const int q = 4 * (idx % quads);
    const float* src = row_src(r);
    const int valid = src == nullptr ? 0 : min(4, max(0, row_valid(r) - q));
    cp_quad(dst + r * ds + q, src + q, valid, vec, safe);
  }
}

// ------------------------------------------------------------ the products
__device__ __forceinline__ uint32_t to_tf32(float v) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(v));
  return r;
}

__device__ __forceinline__ void split_tf32(float v, uint32_t& hi,
                                           uint32_t& lo) {
  hi = to_tf32(v);
  lo = to_tf32(v - __uint_as_float(hi));
}

// split_tf32 in integer operations: hi and lo get the bits cvt.rna gives
// (round to nearest, ties away from zero: half an ulp of tf32 added to
// the magnitude's bits, then the 13 low bits cleared) for every input but
// a NaN, in five instructions, where ptxas expands each cvt.rna.tf32.f32
// into a dozen (sm_90a has no instruction for it).  The flash kernel,
// whose inner loops split every operand, is bound by that issue.
__device__ __forceinline__ void split_tf32_bits(float v, uint32_t& hi,
                                                uint32_t& lo) {
  hi = (__float_as_uint(v) + 0x1000u) & 0xffffe000u;
  lo = (__float_as_uint(v - __uint_as_float(hi)) + 0x1000u) & 0xffffe000u;
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// One k-step of 8 with the 3xTF32 terms kept apart: hi[j] += a_hi b_hi
// and lo[j] += a_lo b_hi + a_hi b_lo, where A[0:16][0:8] (row stride as)
// and B[0:8][8 n_j : 8 n_j + 8] (row stride bs), for j < nj,
// n_j = nbase + j * nstride, are in shared memory.  Two accumulators make
// chains of dependent products a third and two thirds as long; the caller
// adds lo to hi once, at the end, in a fixed order.  Fragment layout of
// m16n8k8 (g = lane / 4, t = lane % 4): hi[j] = C[g][2t], C[g][2t+1],
// C[g+8][2t], C[g+8][2t+1].
template <int J>
__device__ __forceinline__ void mma_step_split(float (&hi)[J][4],
                                               float (&lo)[J][4],
                                               const float* A, int as,
                                               const float* B, int bs,
                                               int nbase, int nstride,
                                               int nj) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  uint32_t ah[4], al[4];
  split_tf32(A[g * as + t], ah[0], al[0]);
  split_tf32(A[(g + 8) * as + t], ah[1], al[1]);
  split_tf32(A[g * as + t + 4], ah[2], al[2]);
  split_tf32(A[(g + 8) * as + t + 4], ah[3], al[3]);
#pragma unroll
  for (int j = 0; j < J; ++j) {
    if (j < nj) {
      const int n0 = (nbase + j * nstride) * 8;
      uint32_t bh[2], bl[2];
      split_tf32(B[t * bs + n0 + g], bh[0], bl[0]);
      split_tf32(B[(t + 4) * bs + n0 + g], bh[1], bl[1]);
      mma_tf32(lo[j], al, bh);
      mma_tf32(lo[j], ah, bl);
      mma_tf32(hi[j], ah, bh);
    }
  }
}

// The same k-step into one accumulator: acc[j] += a_lo b_hi, then
// a_hi b_lo, then a_hi b_hi.
template <int J>
__device__ __forceinline__ void mma_step(float (&acc)[J][4], const float* A,
                                         int as, const float* B, int bs,
                                         int nbase, int nstride, int nj) {
  mma_step_split(acc, acc, A, as, B, bs, nbase, nstride, nj);
}

// The k-step of mma_step_split over I m-tiles at once (rows 16 i .. 16 i +
// 15 of A), each B fragment split once for all I m-tiles, with the two
// correction terms in accumulators of their own (la += a_lo b_hi,
// lb += a_hi b_lo): three independent chains of products, each as long as
// the k-steps, for warps that hold few tiles.
template <int I, int J>
__device__ __forceinline__ void mma_tile_split(float (&hi)[I][J][4],
                                               float (&la)[I][J][4],
                                               float (&lb)[I][J][4],
                                               const float* A, int as,
                                               const float* B, int bs,
                                               int nbase, int nstride,
                                               int nj) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  uint32_t ah[I][4], al[I][4];
#pragma unroll
  for (int i = 0; i < I; ++i) {
    const float* a = A + i * 16 * as;
    split_tf32(a[g * as + t], ah[i][0], al[i][0]);
    split_tf32(a[(g + 8) * as + t], ah[i][1], al[i][1]);
    split_tf32(a[g * as + t + 4], ah[i][2], al[i][2]);
    split_tf32(a[(g + 8) * as + t + 4], ah[i][3], al[i][3]);
  }
#pragma unroll
  for (int j = 0; j < J; ++j) {
    if (j < nj) {
      const int n0 = (nbase + j * nstride) * 8;
      uint32_t bh[2], bl[2];
      split_tf32(B[t * bs + n0 + g], bh[0], bl[0]);
      split_tf32(B[(t + 4) * bs + n0 + g], bh[1], bl[1]);
#pragma unroll
      for (int i = 0; i < I; ++i) {
        mma_tf32(la[i][j], al[i], bh);
        mma_tf32(lb[i][j], ah[i], bl);
        mma_tf32(hi[i][j], ah[i], bh);
      }
    }
  }
}

// Write a warp's fragments (m-tile mt, n-tiles nbase + j * nstride) into
// red (row stride rs): the block's partial sums.
template <int J>
__device__ __forceinline__ void store_partial(const float (&acc)[J][4],
                                              float* red, int rs, int mt,
                                              int nbase, int nstride,
                                              int nj) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = mt * 16 + g;
#pragma unroll
  for (int j = 0; j < J; ++j) {
    if (j < nj) {
      const int c = (nbase + j * nstride) * 8 + 2 * t;
      *reinterpret_cast<float2*>(red + r0 * rs + c) =
          make_float2(acc[j][0], acc[j][1]);
      *reinterpret_cast<float2*>(red + (r0 + 8) * rs + c) =
          make_float2(acc[j][2], acc[j][3]);
    }
  }
}

// The cluster's epilogue.  Every block's partial sums are in its `red`, a
// [rows][cols] tile (row stride rs, a multiple of 4).  Row p goes to
// out + row_out(p), or nowhere where row_out(p) < 0.  The ranks take turns
// over the tile, four columns at a time; each output sums the partials of
// ranks 0, 1, ..., CL-1 in that order (over distributed shared memory,
// every rank's load in flight at once), then adds bias[c], applies act,
// adds the residual res[row_out(p) + c] and stores, as one 16-byte access
// where vec4 (the caller's promise that every row offset, cols, out, res
// and bias are 16-byte aligned).  The fixed order makes the result the
// same bits on every run and stream.  A cluster of one reads its own
// shared memory and needs no cluster barrier.  ANY: act may be silu or
// sigmoid (repro_act_t).
template <bool ANY = false, typename RowOut>
__device__ __forceinline__ void cluster_reduce_store(
    cg::cluster_group& cluster, float* red, int rs, int cl, int rank,
    int rows, int cols, RowOut row_out, bool vec4,
    const float* __restrict__ bias, const float* __restrict__ res,
    float* __restrict__ out, int act) {
  if (cl > 1)
    cluster.sync();                // every partial is written
  else
    __syncthreads();
  const float* peer[16];
#pragma unroll
  for (int q = 0; q < 16; ++q)
    peer[q] = cl == 1 ? red : cluster.map_shared_rank(red, q < cl ? q : 0);
  const int cq = repro_cdiv(cols, 4);
  const int total = rows * cq;
  for (int e = rank * NT + threadIdx.x; e < total; e += cl * NT) {
    const int p = e / cq;
    const int c0 = 4 * (e - p * cq);
    const long long row = row_out(p);
    if (row < 0) continue;
    float4 part[16];
#pragma unroll
    for (int q = 0; q < 16; ++q)
      if (q < cl)
        part[q] = *reinterpret_cast<const float4*>(peer[q] + p * rs + c0);
    float v[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int q = 0; q < 16; ++q) {
      if (q < cl) {
        v[0] += part[q].x;
        v[1] += part[q].y;
        v[2] += part[q].z;
        v[3] += part[q].w;
      }
    }
    const size_t o = static_cast<size_t>(row) + c0;
    if (vec4) {
      if (bias != nullptr) {
        const float4 b = *reinterpret_cast<const float4*>(bias + c0);
        v[0] += b.x, v[1] += b.y, v[2] += b.z, v[3] += b.w;
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) v[u] = repro_act_t<ANY>(v[u], act);
      if (res != nullptr) {
        const float4 r = *reinterpret_cast<const float4*>(res + o);
        v[0] += r.x, v[1] += r.y, v[2] += r.z, v[3] += r.w;
      }
      *reinterpret_cast<float4*>(out + o) = make_float4(v[0], v[1], v[2],
                                                        v[3]);
      continue;
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      if (c0 + u >= cols) break;
      float r = v[u];
      if (bias != nullptr) r += bias[c0 + u];
      r = repro_act_t<ANY>(r, act);
      if (res != nullptr) r += res[o + u];
      out[o + u] = r;
    }
  }
  if (cl > 1) cluster.sync();      // no block leaves while a peer reads it
}

__device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// Let `kernel` take `smem` bytes of dynamic shared memory and, if wide,
// clusters above 8 blocks.  The attributes asked of each kernel on each
// device are remembered and only grow, so a call never undoes another's
// and a repeated call costs no CUDA call.  Returns CUDA's refusal.
template <typename Kernel>
static int opt_in(Kernel kernel, size_t smem, bool wide) {
  struct Asked {
    const void* fn;
    int dev;
    size_t smem;
    bool wide;
  };
  static Asked asked[256];
  static int n_asked = 0;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  const void* fn = reinterpret_cast<const void*>(kernel);
  Asked* a = nullptr;
  for (int i = 0; i < n_asked && a == nullptr; ++i)
    if (asked[i].fn == fn && asked[i].dev == dev) a = &asked[i];
  if (a == nullptr) {
    if (n_asked == 256) return static_cast<int>(cudaErrorMemoryAllocation);
    a = &asked[n_asked++];
    *a = Asked{fn, dev, 0, false};
  }
  if (smem > a->smem) {
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    a->smem = smem;
  }
  if (wide && !a->wide) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return static_cast<int>(err);
    a->wide = true;
  }
  return 0;
}

// Launch `kernel` with `threads` threads a block on grid (cl, tiles, nimg)
// in clusters of (cl, 1, 1) with `smem` bytes of dynamic shared memory.  A
// cluster above 8 opts in to the non-portable sizes; any refusal is
// returned, never worked around.  pdl: the launch may begin while the
// kernel before it in the stream finishes (programmatic dependent launch);
// the kernel must then run griddepcontrol.wait before it reads what that
// kernel wrote.
template <typename Kernel, typename... Args>
static int launch_clustered_n(Kernel kernel, int threads, int cl, int tiles,
                              int nimg, size_t smem, void* stream, bool pdl,
                              Args... args) {
  if (cl < 1 || cl > 16 || tiles < 1 || tiles > 65535 || nimg < 1 ||
      nimg > 65535 || smem > REPRO_MAX_SMEM)
    return static_cast<int>(cudaErrorInvalidConfiguration);
  const int rc = opt_in(kernel, smem, cl > 8);
  if (rc != 0) return rc;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cl, tiles, nimg);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[2];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cl;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  attr[1].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[1].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = pdl ? 2 : 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// Launch `kernel` on a plain grid of `blocks` blocks of `threads` threads
// as a programmatic dependent launch (see launch_clustered_n): the kernel
// must run griddepcontrol.wait before it reads what the kernel before it
// in the stream wrote.
template <typename Kernel, typename... Args>
static int launch_pdl(Kernel kernel, int blocks, int threads, size_t smem,
                      void* stream, Args... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// launch_clustered_n with NT threads a block.
template <typename Kernel, typename... Args>
static int launch_clustered(Kernel kernel, int cl, int tiles, int nimg,
                            size_t smem, void* stream, bool pdl,
                            Args... args) {
  return launch_clustered_n(kernel, NT, cl, tiles, nimg, smem, stream, pdl,
                            args...);
}

// ----------------------------------------------------- the split-K GEMM
// K1's and K3's output tile: out = act(A @ w + bias), A (M, K) and w (K, N)
// row-major.  Shared-memory row strides, floats: A [bm][bk + 4] and the
// partial sums [bm][round_up(bn, 8) + 4] keep fragment reads conflict-free
// and rows 16-byte aligned; w [bk][round_up(bn, 32) + 8] puts the four k
// rows a fragment reads in four bank groups.
__host__ __device__ inline int gemm_a_stride(int bk) { return bk + 4; }
__host__ __device__ inline int gemm_b_stride(int bn) {
  return round_up(bn, 32) + 8;
}
__host__ __device__ inline int gemm_c_stride(int bn) {
  return round_up(bn, 8) + 4;
}

// The tile's shared memory in floats: a ring of ns stages of (A, w); the
// partial sums reuse it.  plan.py's k1_smem_floats.
__host__ __device__ inline int gemm_smem_floats(int bm, int bn, int bk,
                                                int ns) {
  const int stage = bm * gemm_a_stride(bk) + bk * gemm_b_stride(bn);
  const int red = bm * gemm_c_stride(bn);
  return ns * stage > red ? ns * stage : red;
}

// The block's part of a bm x bn output tile at rows blockIdx.z * bm and
// columns blockIdx.y * bn; the blockIdx.x-th of gridDim.x cluster ranks
// takes a contiguous run of k-steps of BK (rank_range).  stage_a(as, AS,
// k0, rows) stages A's rows [m0, m0 + rows) and columns [k0, k0 + BK) into
// as (row stride AS), zero past K; the kernel supplies it, and w's rows
// are staged here (vb: 16-byte copies).  MI x NJ: the m16n8 tiles a warp
// holds, the 8 warps in wm rows.  Steps i + 1 .. i + ns - 1 are in flight
// while step i computes; the ranks' partial tiles meet over distributed
// shared memory in rank order (cluster_reduce_store).  The launch may be
// a programmatic dependent one: nothing is read before griddepcontrol.wait.
template <int MI, int NJ, int BK, typename StageA>
__device__ __forceinline__ void gemm_tile(
    float* smem, StageA stage_a, const float* __restrict__ w,
    const float* __restrict__ bias, float* __restrict__ out, int M, int N,
    int K, int bm, int bn, int wm, int ns, bool vb, int act) {
  constexpr int bk = BK;
  cg::cluster_group cluster = cg::this_cluster();
  const int cl = gridDim.x;                // cluster dims (cl, 1, 1)
  const int rank = blockIdx.x;
  const int n0 = blockIdx.y * bn;
  const int m0 = blockIdx.z * bm;
  const int AS = gemm_a_stride(bk);
  const int BS = gemm_b_stride(bn);
  const int STAGE = bm * AS + bk * BS;
  const int rows = min(bm, M - m0);        // rows of the tile inside M
  const int cols = min(bn, N - n0);        // ... and columns inside N
  const int cols8 = round_up(cols, 8);

  const int warp = threadIdx.x >> 5;
  const int wn = WARPS / wm;
  const int mt0 = (warp % wm) * MI;        // this warp's first m-tile
  const int nbase = warp / wm;             // ... and first n-tile
  const int nj = max(0, min(NJ, repro_cdiv(cols8 / 8 - nbase, wn)));
  const bool live = mt0 * 16 < rows && nj > 0;

  int s0, s1;
  rank_range(repro_cdiv(K, bk), cl, rank, s0, s1);

  auto stage = [&](int s, int buf) {
    float* as = smem + buf * STAGE;        // [bm][AS]
    float* bs = as + bm * AS;              // [bk][BS]
    const int k0 = s * bk;
    stage_a(as, AS, k0, rows);
    stage_rows(
        bs, BS, bk, cols8,
        [&](int r) -> const float* {
          return k0 + r < K ? w + (size_t)(k0 + r) * N + n0 : nullptr;
        },
        [&](int) { return cols; }, vb, w);
  };

  // a ring of ns stages: step i + ns - 1 is staged after the barrier that
  // ends step i - 1, into the stage step i - 1 has left.
  float hi[MI][NJ][4] = {};
  float la[MI][NJ][4] = {};
  float lb[MI][NJ][4] = {};
  const int nloc = s1 - s0;
  // the launch may overlap the end of the kernel before it in the stream:
  // wait for that kernel's results before the first load
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  for (int j = 0; j < ns - 1; ++j) {
    if (j < nloc) stage(s0 + j, j);
    cp_commit();
  }
  for (int i = 0; i < nloc; ++i) {
    cp_wait_n(ns - 2);                     // step i has landed
    __syncthreads();                       // ... for all; step i - 1 done
    if (i + ns - 1 < nloc) stage(s0 + i + ns - 1, (i + ns - 1) % ns);
    cp_commit();
    if (live) {
      const float* as = smem + (i % ns) * STAGE;
      const float* bs = as + bm * AS;
#pragma unroll
      for (int ks = 0; ks < BK; ks += 8)
        mma_tile_split(hi, la, lb, as + mt0 * 16 * AS + ks, AS,
                       bs + ks * BS, BS, nbase, wn, nj);
    }
  }
  cp_wait<0>();
  // the next kernel may begin its launch; it waits for this one's end
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  __syncthreads();

  const int RS = gemm_c_stride(bn);
  float* red = smem;                       // [bm][RS], over the stages
  if (live) {
#pragma unroll
    for (int i = 0; i < MI; ++i) {
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) hi[i][j][e] += la[i][j][e] + lb[i][j][e];
      store_partial(hi[i], red, RS, mt0 + i, nbase, wn, nj);
    }
  }
  const bool vec4 = (N & 3) == 0 && aligned16(out) &&
                    (bias == nullptr || aligned16(bias));
  const auto row_out = [&](int p) -> long long {
    return static_cast<long long>(m0 + p) * N + n0;
  };
  const float* b = bias == nullptr ? nullptr : bias + n0;
  if (act >= REPRO_ACT_SILU)
    cluster_reduce_store<true>(cluster, red, RS, cl, rank, rows, cols,
                               row_out, vec4, b, nullptr, out, act);
  else
    cluster_reduce_store<false>(cluster, red, RS, cl, rank, rows, cols,
                                row_out, vec4, b, nullptr, out, act);
}

}  // namespace tc
