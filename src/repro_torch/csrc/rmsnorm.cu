// K6: row RMSNorm, out = x * rsqrt(mean(x^2) + eps) * w, f32 throughout.
//
// Replaces the TPU kernel src/repro/kernels/rmsnorm/kernel.py `rmsnorm`
// (body `_rmsnorm_kernel`): one VMEM row block per grid step, the feature
// dim whole.
//
// Bound on an H100: about 4 FLOPs per element against 8 bytes (one read,
// one write), so bytes bound by far: the least time is the input read once
// plus the output written once (plus w) over 3.35 TB/s.
//
// Design: a row is what a TPU grid step holds; here a warp owns a row, so
// the sum of squares is a warp-shuffle reduction with no shared memory and
// no block barrier.  For d <= 1024 and d % 4 == 0 (the LM path's d = 896)
// each lane reads its share of the row once with float4 loads into
// registers (at most 8 float4 a lane), reduces, then scales and writes from
// the registers: x leaves device memory once.  Any other d (odd, or wider)
// takes the general kernel: one 256-thread block per row, a shared-memory
// reduction, and a second pass that reads x again from L2.  Four rows per
// block keep a one-row call to one block.  The sum runs in a fixed order
// per lane and per shuffle tree, so the result does not depend on the
// stream or the launch.
#include "common.cuh"

namespace {

constexpr int ROWS_PER_BLOCK = 4;   // one warp each
constexpr int MAX_VEC = 8;          // float4 a lane: d <= 32 * 4 * 8
constexpr int GEN_THREADS = 256;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__global__ void __launch_bounds__(32 * ROWS_PER_BLOCK)
rmsnorm_vec_kernel(const float* __restrict__ x, const float* __restrict__ w,
                   float* __restrict__ out, int rows, int d, float eps) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * ROWS_PER_BLOCK + (threadIdx.x >> 5);
  if (row >= rows) return;
  const int nv = d >> 2;   // float4 per row
  const float4* xr = reinterpret_cast<const float4*>(x + (size_t)row * d);
  const float4* wr = reinterpret_cast<const float4*>(w);
  float4* orow = reinterpret_cast<float4*>(out + (size_t)row * d);
  float4 v[MAX_VEC];
  float ss = 0.f;
#pragma unroll
  for (int i = 0; i < MAX_VEC; ++i) {
    const int j = lane + 32 * i;
    if (j < nv) {
      v[i] = xr[j];
      ss = fmaf(v[i].x, v[i].x, ss);
      ss = fmaf(v[i].y, v[i].y, ss);
      ss = fmaf(v[i].z, v[i].z, ss);
      ss = fmaf(v[i].w, v[i].w, ss);
    }
  }
  ss = warp_sum(ss);
  const float r = rsqrtf(ss / (float)d + eps);
#pragma unroll
  for (int i = 0; i < MAX_VEC; ++i) {
    const int j = lane + 32 * i;
    if (j < nv) {
      const float4 g = wr[j];
      orow[j] = make_float4(v[i].x * r * g.x, v[i].y * r * g.y,
                            v[i].z * r * g.z, v[i].w * r * g.w);
    }
  }
}

__global__ void __launch_bounds__(GEN_THREADS)
rmsnorm_general_kernel(const float* __restrict__ x,
                       const float* __restrict__ w, float* __restrict__ out,
                       int d, float eps) {
  __shared__ float part[GEN_THREADS / 32];
  const size_t row = blockIdx.x;
  const float* xr = x + row * d;
  float ss = 0.f;
  for (int j = threadIdx.x; j < d; j += GEN_THREADS)
    ss = fmaf(xr[j], xr[j], ss);
  ss = warp_sum(ss);
  if ((threadIdx.x & 31) == 0) part[threadIdx.x >> 5] = ss;
  __syncthreads();
  float tot = 0.f;
#pragma unroll
  for (int i = 0; i < GEN_THREADS / 32; ++i) tot += part[i];
  const float r = rsqrtf(tot / (float)d + eps);
  for (int j = threadIdx.x; j < d; j += GEN_THREADS)
    out[row * d + j] = xr[j] * r * w[j];
}

}  // namespace

extern "C" int repro_rmsnorm(const float* x, const float* w, float* out,
                             int rows, int d, float eps, void* stream) {
  if (rows <= 0 || d <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool aligned =
      ((reinterpret_cast<size_t>(x) | reinterpret_cast<size_t>(w) |
        reinterpret_cast<size_t>(out)) & 15) == 0;
  if (d % 4 == 0 && d <= 32 * 4 * MAX_VEC && aligned) {
    const int blocks = repro_cdiv(rows, ROWS_PER_BLOCK);
    rmsnorm_vec_kernel<<<blocks, 32 * ROWS_PER_BLOCK, 0, s>>>(x, w, out,
                                                              rows, d, eps);
  } else {
    rmsnorm_general_kernel<<<rows, GEN_THREADS, 0, s>>>(x, w, out, d, eps);
  }
  return static_cast<int>(cudaGetLastError());
}
