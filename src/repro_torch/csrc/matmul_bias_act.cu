// K1: (M,K) @ (K,N) + bias, then relu / relu6; f32 in and out, the products
// on the tensor cores in 3xTF32 (tc_common.cuh), which keeps f32's accuracy.
//
// Replaces the TPU kernel src/repro/kernels/conv_gemm/kernel.py
// `matmul_bias_act` (body `_matmul_kernel`): every 1x1 conv and the fc head.
//
// Bound on an H100: at batch 2 the calls are small.  The wide expands
// (25088 x 16 x 96, 6272 x 24 x 144) move 4-11 MB and are bytes bound
// (1-3.4 us); the rest do 1-400 MFLOP (under 2.5 us at the 3xTF32 peak)
// on tiles of 2-392 rows.  What bounds them in practice is latency: a
// fixed 64x64 tile gave 6-56 blocks to the 132 SMs on the late maps and the
// fc heads, each walking K (up to 1280) in series through loads that were
// not in flight while it computed.
//
// Design (the tiling is chosen per call on the host: plan.py's plan_k1):
//   * A thread-block cluster of CL blocks (up to 16) owns a bm x bn output
//     tile (bm 16-128 rows, bn 32-128 columns or all of N) and splits K
//     between its blocks: rank r takes a contiguous run of k-steps of bk
//     (16, 32 or 64).  Small tiles and the K split put at least one block on
//     every SM where the shape allows it; a large-M, small-K call takes a
//     whole-N tile so that A is read once.
//   * cp.async stages the A and B tiles in a ring of 2-4 stages with
//     16-byte copies (4-byte ones for a ragged K or N), zero-filled past K
//     and N, so the next steps' loads are in flight while one computes; rows
//     past M are not loaded at all (each output row reads only its own).
//   * The 8 warps split the tile (wm rows of warps by 8/wm columns), each
//     holding MI m-tiles x NJ n-tiles of m16n8k8 in 3xTF32, the hi*hi and
//     correction terms in separate accumulators.
//   * The ranks' partial tiles meet over distributed shared memory, added
//     in rank order (no atomics, no second kernel); the epilogue adds the
//     bias and the activation and stores 16-byte, row-contiguous runs.
//   * A call is launched as a programmatic dependent launch: its blocks
//     may be placed while the kernel before it finishes, and wait for it
//     (griddepcontrol.wait) before the first load, so a run of GEMMs (the
//     1x1 convs of a block) pays less of each launch's latency.
#include "tc_common.cuh"

namespace {

using namespace tc;

// shared-memory row strides, floats: A [bm][bk + 4] and the partial sums
// [bm][round_up(bn, 8) + 4] keep fragment reads conflict-free and rows
// 16-byte aligned; B [bk][round_up(bn, 32) + 8] puts the four k rows a
// fragment reads in four bank groups
__host__ __device__ inline int a_stride(int bk) { return bk + 4; }
__host__ __device__ inline int b_stride(int bn) { return round_up(bn, 32) + 8; }
__host__ __device__ inline int c_stride(int bn) { return round_up(bn, 8) + 4; }

// Shared memory in floats; plan.py's k1_smem_floats.
size_t smem_floats(int bm, int bn, int bk, int ns) {
  const size_t stage = (size_t)bm * a_stride(bk) + (size_t)bk * b_stride(bn);
  const size_t red = (size_t)bm * c_stride(bn);
  return ns * stage > red ? ns * stage : red;
}

// MI, NJ: the m-tiles and n-tiles a warp holds; BK: floats of K a step.
// vec: bit 0, A may be staged in 16-byte copies (K % 4 == 0, x aligned);
// bit 1, B may (N % 4 == 0, w aligned).  Grid (cl, tiles_n, tiles_m) in
// clusters of (cl, 1, 1).
template <int MI, int NJ, int BK>
__global__ void __launch_bounds__(NT, MIN_BLOCKS)
matmul_bias_act_kernel(const float* __restrict__ x,
                       const float* __restrict__ w,
                       const float* __restrict__ bias,
                       float* __restrict__ out, int M, int N, int K, int bm,
                       int bn, int wm, int ns, int vec, int act) {
  constexpr int bk = BK;
  cg::cluster_group cluster = cg::this_cluster();
  extern __shared__ __align__(16) float smem[];
  const int cl = gridDim.x;                // cluster dims (cl, 1, 1)
  const int rank = blockIdx.x;
  const int n0 = blockIdx.y * bn;
  const int m0 = blockIdx.z * bm;
  const int AS = a_stride(bk);
  const int BS = b_stride(bn);
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
  const bool va = (vec & 1) != 0, vb = (vec & 2) != 0;
  const int qpr = bk / 4;                  // A quads a row

  auto stage = [&](int s, int buf) {
    float* as = smem + buf * STAGE;        // [bm][AS]
    float* bs = as + bm * AS;              // [bk][BS]
    const int k0 = s * bk;
    for (int idx = threadIdx.x; idx < rows * qpr; idx += NT) {
      const int r = idx / qpr;
      const int q = 4 * (idx - r * qpr);
      cp_quad(as + r * AS + q, x + (size_t)(m0 + r) * K + k0 + q,
              min(4, max(0, K - k0 - q)), va, x);
    }
    stage_rows(
        bs, BS, bk, cols8,
        [&](int r) -> const float* {
          return k0 + r < K ? w + (size_t)(k0 + r) * N + n0 : nullptr;
        },
        [&](int) { return cols; }, vb, w);
  };

  // a ring of ns stages: steps i + 1 .. i + ns - 1 are in flight while
  // step i computes.  Step i + ns - 1 is issued after the barrier that
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

  const int RS = c_stride(bn);
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
  cluster_reduce_store(
      cluster, red, RS, cl, rank, rows, cols,
      [&](int p) -> long long {
        return static_cast<long long>(m0 + p) * N + n0;
      },
      vec4, bias == nullptr ? nullptr : bias + n0, nullptr, out, act);
}

using Kernel = decltype(&matmul_bias_act_kernel<1, 1, 16>);

template <int BK>
Kernel pick_bk(int mi, int nj) {
  if (mi == 1 && nj == 1) return matmul_bias_act_kernel<1, 1, BK>;
  if (mi == 2 && nj == 2) return matmul_bias_act_kernel<2, 2, BK>;
  if (mi == 2 && nj == 4) return matmul_bias_act_kernel<2, 4, BK>;
  return nullptr;
}

// The kernel compiled for (MI, NJ, BK), or nullptr: plan.py's COMPILED
// pairs at each of plan.py's BKS.
Kernel pick(int mi, int nj, int bk) {
  return bk == 16   ? pick_bk<16>(mi, nj)
         : bk == 32 ? pick_bk<32>(mi, nj)
         : bk == 64 ? pick_bk<64>(mi, nj)
                    : nullptr;
}

int nj_class(int nj) { return nj <= 1 ? 1 : nj <= 2 ? 2 : nj <= 4 ? 4 : 8; }

}  // namespace

// The plan (bm, bn, bk, wm, cl, ns, smem) comes from plan.py's plan_k1; a
// plan the kernels were not compiled for, or whose shared memory disagrees
// with smem_floats, is refused.
extern "C" int repro_matmul_bias_act(const float* x, const float* w,
                                     const float* bias, float* out, int M,
                                     int N, int K, int act, int bm, int bn,
                                     int bk, int wm, int cl, int ns,
                                     int smem, int vec, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || bn <= 0 ||
      bn > 128 || (bn % 4 != 0 && bn != N) || bm % 16 != 0 || wm <= 0 ||
      WARPS % wm != 0 || (bm / 16) % wm != 0 || cl < 1 ||
      cl > repro_cdiv(K, bk) || ns < 2 || ns > MAX_STAGES)
    return static_cast<int>(cudaErrorInvalidValue);
  const int mi = bm / 16 / wm;
  const int nj = repro_cdiv(repro_cdiv(bn, 8), WARPS / wm);
  const Kernel kernel = pick(mi, nj_class(nj), bk);
  if (kernel == nullptr || nj > 8 ||
      (size_t)smem != 4 * smem_floats(bm, bn, bk, ns))
    return static_cast<int>(cudaErrorInvalidValue);
  return launch_clustered(kernel, cl, repro_cdiv(N, bn), repro_cdiv(M, bm),
                          (size_t)smem, stream, true, x, w, bias, out, M, N,
                          K, bm, bn, wm, ns, vec, act);
}

extern "C" const char* repro_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
