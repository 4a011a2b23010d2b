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

// MI, NJ: the m-tiles and n-tiles a warp holds; BK: floats of K a step.
// vec: bit 0, A may be staged in 16-byte copies (K % 4 == 0, x aligned);
// bit 1, B may (N % 4 == 0, w aligned).  Grid (cl, tiles_n, tiles_m) in
// clusters of (cl, 1, 1); the tile is tc_common.cuh's gemm_tile, whose A
// rows are rows of x.
template <int MI, int NJ, int BK>
__global__ void __launch_bounds__(NT, MIN_BLOCKS)
matmul_bias_act_kernel(const float* __restrict__ x,
                       const float* __restrict__ w,
                       const float* __restrict__ bias,
                       float* __restrict__ out, int M, int N, int K, int bm,
                       int bn, int wm, int ns, int vec, int act) {
  extern __shared__ __align__(16) float smem[];
  const int m0 = blockIdx.z * bm;
  const bool va = (vec & 1) != 0;
  constexpr int qpr = BK / 4;              // A quads a row
  gemm_tile<MI, NJ, BK>(
      smem,
      [&](float* as, int AS, int k0, int rows) {
        for (int idx = threadIdx.x; idx < rows * qpr; idx += NT) {
          const int r = idx / qpr;
          const int q = 4 * (idx - r * qpr);
          cp_quad(as + r * AS + q, x + (size_t)(m0 + r) * K + k0 + q,
                  min(4, max(0, K - k0 - q)), va, x);
        }
      },
      w, bias, out, M, N, K, bm, bn, wm, ns, (vec & 2) != 0, act);
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
// with gemm_smem_floats, is refused.
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
      smem != 4 * gemm_smem_floats(bm, bn, bk, ns))
    return static_cast<int>(cudaErrorInvalidValue);
  return launch_clustered(kernel, cl, repro_cdiv(N, bn), repro_cdiv(M, bm),
                          (size_t)smem, stream, true, x, w, bias, out, M, N,
                          K, bm, bn, wm, ns, vec, act);
}

extern "C" const char* repro_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
