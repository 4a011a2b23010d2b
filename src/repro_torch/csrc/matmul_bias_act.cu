// K1: (M,K) @ (K,N) + bias, then relu / relu6, in f32.
//
// Replaces the TPU kernel src/repro/kernels/conv_gemm/kernel.py
// `matmul_bias_act` (body `_matmul_kernel`): every 1x1 conv and the fc head.
//
// Bound on an H100: on the main path K is small (16..1280) and the largest
// calls are the 1x1 expands at M = batch*112*112 with K = 16..24, so most
// calls move more bytes than the f32 CUDA cores need time for: bytes bound
// (x read once, out written once).  The larger-K projections and conv_last
// sit near the f32 ridge (67 TFLOP/s over 3.35 TB/s, about 20 FLOP/byte).
//
// Design: a 64x64 output tile per block of 256 threads, each thread owning a
// 4x4 sub-tile strided by 16 so that neighbouring threads store neighbouring
// columns (coalesced).  K is walked in steps of 16 through shared memory,
// with the A tile stored k-major (padded by one column against bank
// conflicts).  Ragged M/N/K tails are masked in the loads and the store: no
// padded copies in device memory.  Bias and activation are fused into the
// store.  Later PRs may move this to wgmma/TMA; this one keeps full f32.
#include "common.cuh"

namespace {

constexpr int BM = 64;
constexpr int BN = 64;
constexpr int BK = 16;
constexpr int NT = 256;

__global__ void __launch_bounds__(NT)
matmul_bias_act_kernel(const float* __restrict__ x,
                       const float* __restrict__ w,
                       const float* __restrict__ bias,
                       float* __restrict__ out, int M, int N, int K,
                       int act) {
  __shared__ float As[BK][BM + 1];
  __shared__ float Bs[BK][BN];
  const int t = threadIdx.x;
  const int tx = t % 16;
  const int ty = t / 16;
  const int m0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  float acc[4][4] = {};

  for (int k0 = 0; k0 < K; k0 += BK) {
#pragma unroll
    for (int r = 0; r < BM * BK / NT; ++r) {
      const int idx = t + r * NT;
      const int m = idx / BK;
      const int k = idx % BK;
      const int gm = m0 + m;
      const int gk = k0 + k;
      As[k][m] = (gm < M && gk < K) ? x[(size_t)gm * K + gk] : 0.f;
    }
#pragma unroll
    for (int r = 0; r < BK * BN / NT; ++r) {
      const int idx = t + r * NT;
      const int k = idx / BN;
      const int n = idx % BN;
      const int gk = k0 + k;
      const int gn = n0 + n;
      Bs[k][n] = (gk < K && gn < N) ? w[(size_t)gk * N + gn] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < BK; ++k) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = As[k][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = Bs[k][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int gm = m0 + ty + 16 * i;
    if (gm >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int gn = n0 + tx + 16 * j;
      if (gn >= N) continue;
      float v = acc[i][j];
      if (bias != nullptr) v += bias[gn];
      out[(size_t)gm * N + gn] = repro_act(v, act);
    }
  }
}

}  // namespace

extern "C" int repro_matmul_bias_act(const float* x, const float* w,
                                     const float* bias, float* out, int M,
                                     int N, int K, int act, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(repro_cdiv(M, BM), repro_cdiv(N, BN));
  if (grid.y > 65535) return static_cast<int>(cudaErrorInvalidConfiguration);
  matmul_bias_act_kernel<<<grid, NT, 0, static_cast<cudaStream_t>(stream)>>>(
      x, w, bias, out, M, N, K, act);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* repro_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
