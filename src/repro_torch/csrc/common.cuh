// Shared helpers of the hand-written f32 kernels (K1-K7).
//
// Every kernel takes and gives f32.  K2, K6 and K7 (but the decode of GQA
// groups above 8) compute on the CUDA cores in f32; K1, K3, K4, K5 and
// that decode run their products on the tensor cores in 3xTF32
// (tc_common.cuh), which keeps f32's accuracy.  Every kernel sums
// in a fixed order and uses no atomics, so it gives the same bits for the
// same inputs on any stream.
#pragma once

#include <cuda_runtime.h>

#define REPRO_ACT_NONE 0
#define REPRO_ACT_RELU 1
#define REPRO_ACT_RELU6 2

__device__ __forceinline__ float repro_act(float v, int act) {
  if (act == REPRO_ACT_RELU) return fmaxf(v, 0.f);
  if (act == REPRO_ACT_RELU6) return fminf(fmaxf(v, 0.f), 6.f);
  return v;
}

__host__ __device__ inline int repro_cdiv(int a, int b) {
  return (a + b - 1) / b;
}

// Dynamic shared memory above 48 KB needs an explicit opt-in per kernel.
template <typename Kernel>
static cudaError_t repro_smem_opt_in(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

// Largest block the card grants: 227 KB (232,448 bytes) of dynamic smem.
constexpr size_t REPRO_MAX_SMEM = 232448;
