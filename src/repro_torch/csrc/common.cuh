// Shared helpers of the hand-written f32 kernels (K1-K7 and the SE gate).
//
// Every kernel takes and gives f32.  K2, K6 and K7 (but the decode of GQA
// groups above 8) compute on the CUDA cores in f32; K1, K3, K4, K5 and
// that decode run their products on the tensor cores in 3xTF32
// (tc_common.cuh), which keeps f32's accuracy.  Every kernel sums
// in a fixed order and uses no atomics, so it gives the same bits for the
// same inputs on any stream.
//
// The fused epilogues' activations: none, relu, relu6 (the paper's CNNs;
// repro_act, every kernel), and silu and sigmoid (EfficientNet's layers;
// repro_act_any, the epilogues of K1, K2 and K3 alone), the last two with
// expf, not __expf, so they stay within f32's accuracy.
#pragma once

#include <cuda_runtime.h>

#define REPRO_ACT_NONE 0
#define REPRO_ACT_RELU 1
#define REPRO_ACT_RELU6 2
#define REPRO_ACT_SILU 3
#define REPRO_ACT_SIGMOID 4

__device__ __forceinline__ float repro_act(float v, int act) {
  if (act == REPRO_ACT_RELU) return fmaxf(v, 0.f);
  if (act == REPRO_ACT_RELU6) return fminf(fmaxf(v, 0.f), 6.f);
  return v;
}

// Every activation.  A kernel that takes silu or sigmoid compiles its
// epilogue twice, over repro_act_t<false> and <true>, and branches to one
// once a call (act >= REPRO_ACT_SILU): inlined into the other kernels'
// loops, expf's code had slowed the MobileNets' K1, K4 and K5 by 3-4%.
__device__ __forceinline__ float repro_act_any(float v, int act) {
  if (act == REPRO_ACT_SILU) return v / (1.f + expf(-v));
  if (act == REPRO_ACT_SIGMOID) return 1.f / (1.f + expf(-v));
  return repro_act(v, act);
}

template <bool ANY>
__device__ __forceinline__ float repro_act_t(float v, int act) {
  if constexpr (ANY) return repro_act_any(v, act);
  return repro_act(v, act);
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
