// The squeeze-and-excitation (SE) gate of an EfficientNet block, in two
// launches: repro_se_gate gives the gate (N, C) of an NHWC map x,
//   gate = sigmoid(silu(mean_hw(x) @ w1 + b1) @ w2 + b2),
// and repro_se_scale multiplies the map by it in place, x[n, p, c] *=
// gate[n, c].  The port's own kernel: the TPU system runs no SE gate.
//
// Bound on an H100: the pool reads the map once (4 bytes a float, one add),
// the scale reads and writes it once more; the two FCs are at most
// 2688 x 112 multiply-adds an image on 1.2 MB of weights, read from L2
// after the first image.  So both launches are bytes bound: about 12 bytes
// a map element at 3.35 TB/s, 2-40 us a call at batch 16 on B4's maps
// (12x12x2688 to 190x190x48).  What bounds the gate in practice is that the
// FCs need every channel's mean of an image before they start, so one
// image's pool cannot be spread over blocks that do not meet.
//
// Design:
//   * One thread-block cluster of cl blocks (1-8, chosen on the host from
//     the map's size: kernels/se/kernel.py's se_cluster) owns one image.
//     Rank r pools a contiguous run of the image's pixels for every
//     channel, its threads laid out as lanes of pixels times channel
//     units (16-byte quads where C % 4 == 0 and x is aligned), four
//     accumulators a thread so that four loads are in flight.  A block
//     adds its lanes in lane order, then every rank adds the ranks' sums
//     over distributed shared memory in rank order: each rank holds the
//     same means, with no atomics and no second kernel.
//   * Rank r computes its contiguous share of the reduce FC's outputs
//     (chunks of C summed in chunk order, then the bias and silu); the
//     ranks gather the whole reduced vector over distributed shared
//     memory, and rank r computes the expand FC and the sigmoid for its
//     share of the channels, one channel a thread, reading w2 along C.
//   * The scale is one float4 (or float) a thread, in place.
//   Every sum runs in an order fixed by the shape and cl alone, so the
//   gate has the same bits on any stream.
#include <cooperative_groups.h>

#include "common.cuh"

namespace {

namespace cg = cooperative_groups;

constexpr int NT = 256;       // threads a block
constexpr int MAX_CL = 8;     // blocks a cluster (portable cluster sizes)

// Shared memory of the gate kernel, in floats: the lanes' partial sums
// [max(4 * NT, C)], the block's sums [C], the means [C], the reduce FC's
// chunk partials [max(NT, S)], this rank's reduced outputs [S] and the
// whole reduced vector [S].  kernels/se/kernel.py's se_smem_floats.
size_t gate_smem_floats(int C, int S) {
  return (size_t)(C > 4 * NT ? C : 4 * NT) + 2 * C + (S > NT ? S : NT) +
         2 * S;
}

template <int V>
struct Vec;
template <>
struct Vec<1> {
  using T = float;
  __device__ static T zero() { return 0.f; }
  __device__ static void add(T& a, const T& b) { a += b; }
  __device__ static void put(float* dst, const T& v) { dst[0] = v; }
};
template <>
struct Vec<4> {
  using T = float4;
  __device__ static T zero() { return make_float4(0.f, 0.f, 0.f, 0.f); }
  __device__ static void add(T& a, const T& b) {
    a.x += b.x, a.y += b.y, a.z += b.z, a.w += b.w;
  }
  __device__ static void put(float* dst, const T& v) {
    dst[0] = v.x, dst[1] = v.y, dst[2] = v.z, dst[3] = v.w;
  }
};

// V: floats a load (4: C % 4 == 0 and x 16-byte aligned; else 1).  Grid
// (cl, 1, N) in clusters of (cl, 1, 1), NT threads a block.
template <int V>
__global__ void __launch_bounds__(NT)
se_gate_kernel(const float* __restrict__ x, const float* __restrict__ w1,
               const float* __restrict__ b1, const float* __restrict__ w2,
               const float* __restrict__ b2, float* __restrict__ gate,
               int HW, int C, int S) {
  using T = typename Vec<V>::T;
  extern __shared__ __align__(16) float smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int cl = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int n = blockIdx.z;
  const int t = threadIdx.x;
  float* part = smem;                          // [L][C] lanes' sums
  float* bsum = part + max(4 * NT, C);         // [C] this block's sums
  float* mean = bsum + C;                      // [C]
  float* part2 = mean + C;                     // [Kc][Sr] FC chunk sums
  float* red = part2 + max(NT, S);             // [Sr] this rank's outputs
  float* rv = red + S;                         // [S] the reduced vector

  // ---- the pool: this rank's pixels [p0, p1), every channel
  const int U = C / V;                         // channel units
  const int Ue = min(U, NT);
  const int L = NT / Ue;                       // pixel lanes
  const int p0 = rank * HW / cl, p1 = (rank + 1) * HW / cl;
  const T* xn = reinterpret_cast<const T*>(x + (size_t)n * HW * C);
  if (t < L * Ue) {
    const int lane = t / Ue;
    for (int u = t % Ue; u < U; u += Ue) {
      T acc[4] = {Vec<V>::zero(), Vec<V>::zero(), Vec<V>::zero(),
                  Vec<V>::zero()};
      int p = p0 + lane;
      for (; p + 3 * L < p1; p += 4 * L) {
        T v[4];
#pragma unroll
        for (int k = 0; k < 4; ++k) v[k] = xn[(size_t)(p + k * L) * U + u];
#pragma unroll
        for (int k = 0; k < 4; ++k) Vec<V>::add(acc[k], v[k]);
      }
#pragma unroll
      for (int k = 0; k < 3; ++k)              // at most 3 left
        if (p + k * L < p1)
          Vec<V>::add(acc[k], xn[(size_t)(p + k * L) * U + u]);
      Vec<V>::add(acc[0], acc[1]);
      Vec<V>::add(acc[2], acc[3]);
      Vec<V>::add(acc[0], acc[2]);
      Vec<V>::put(part + lane * C + u * V, acc[0]);
    }
  }
  __syncthreads();
  for (int c = t; c < C; c += NT) {
    float s = 0.f;
    for (int l = 0; l < L; ++l) s += part[l * C + c];
    bsum[c] = s;
  }
  cluster.sync();                              // every rank's sums written
  for (int c = t; c < C; c += NT) {
    float s = 0.f;
    for (int q = 0; q < cl; ++q) s += cluster.map_shared_rank(bsum, q)[c];
    mean[c] = s / (float)HW;
  }
  __syncthreads();

  // ---- the reduce FC: this rank's outputs [s0, s1), then silu
  const int s0 = rank * S / cl, s1 = (rank + 1) * S / cl;
  const int Sr = s1 - s0;
  if (Sr > 0) {
    const int Se = min(Sr, NT);
    const int Kc = NT / Se;                    // chunks of C
    if (t < Kc * Se) {
      const int chunk = t / Se;
      const int c0 = chunk * C / Kc, c1 = (chunk + 1) * C / Kc;
      for (int j = t % Se; j < Sr; j += Se) {
        float acc = 0.f;
        for (int c = c0; c < c1; ++c)
          acc = fmaf(mean[c], w1[(size_t)c * S + s0 + j], acc);
        part2[chunk * Sr + j] = acc;
      }
    }
    __syncthreads();
    for (int j = t; j < Sr; j += NT) {
      float v = b1 != nullptr ? b1[s0 + j] : 0.f;
      for (int k = 0; k < Kc; ++k) v += part2[k * Sr + j];
      red[j] = repro_act_any(v, REPRO_ACT_SILU);
    }
  }
  cluster.sync();                              // every rank's outputs
  for (int s = t; s < S; s += NT) {
    int q = 0;
    while ((q + 1) * S / cl <= s) ++q;         // the rank that owns s
    rv[s] = cluster.map_shared_rank(red, q)[s - q * S / cl];
  }
  cluster.sync();                 // no block leaves while a peer reads it

  // ---- the expand FC and the sigmoid: this rank's channels
  const int c0 = rank * C / cl, c1 = (rank + 1) * C / cl;
  for (int c = c0 + t; c < c1; c += NT) {
    float v = 0.f;
    for (int s = 0; s < S; ++s) v = fmaf(rv[s], w2[(size_t)s * C + c], v);
    if (b2 != nullptr) v += b2[c];
    gate[(size_t)n * C + c] = repro_act_any(v, REPRO_ACT_SIGMOID);
  }
}

// x[n, p, c] *= gate[n, c] for V floats a thread.  Grid (blocks, N).
template <int V>
__global__ void __launch_bounds__(NT)
se_scale_kernel(float* __restrict__ x, const float* __restrict__ gate,
                int HW, int C) {
  using T = typename Vec<V>::T;
  const int U = C / V;
  const int n = blockIdx.y;
  const long long units = (long long)HW * U;
  T* xn = reinterpret_cast<T*>(x + (size_t)n * HW * C);
  const T* g = reinterpret_cast<const T*>(gate + (size_t)n * C);
  for (long long i = (long long)blockIdx.x * NT + threadIdx.x; i < units;
       i += (long long)gridDim.x * NT) {
    T v = xn[i];
    const T s = g[i % U];
    if constexpr (V == 4) {
      v.x *= s.x, v.y *= s.y, v.z *= s.z, v.w *= s.w;
    } else {
      v *= s;
    }
    xn[i] = v;
  }
}

using GateKernel = decltype(&se_gate_kernel<1>);

int launch_gate(GateKernel kernel, int cl, int N, size_t smem, void* stream,
                const float* x, const float* w1, const float* b1,
                const float* w2, const float* b2, float* gate, int HW, int C,
                int S) {
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cl, 1, N);
  cfg.blockDim = dim3(NT);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cl;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, x, w1, b1, w2, b2,
                                             gate, HW, C, S);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The gate (N, C) of the NHWC map x (N, HW, C): w1 (C, S), b1 (S), w2
// (S, C), b2 (C); b1 and b2 may be NULL.  cl (1-8) blocks an image;
// smem must be 4 * gate_smem_floats(C, S).  vec: C % 4 == 0 and x 16-byte
// aligned.
extern "C" int repro_se_gate(const float* x, const float* w1,
                             const float* b1, const float* w2,
                             const float* b2, float* gate, int N, int HW,
                             int C, int S, int cl, int smem, int vec,
                             void* stream) {
  if (N <= 0 || N > 65535 || HW <= 0 || C <= 0 || S <= 0 || cl < 1 ||
      cl > MAX_CL || (vec && C % 4 != 0))
    return static_cast<int>(cudaErrorInvalidValue);
  if ((size_t)smem != 4 * gate_smem_floats(C, S) ||
      (size_t)smem > REPRO_MAX_SMEM)
    return static_cast<int>(cudaErrorInvalidValue);
  const GateKernel kernel = vec ? se_gate_kernel<4> : se_gate_kernel<1>;
  return launch_gate(kernel, cl, N, smem, stream, x, w1, b1, w2, b2, gate,
                     HW, C, S);
}

// x (N, HW, C) *= gate (N, C), in place.  vec: C % 4 == 0 and both
// pointers 16-byte aligned.
extern "C" int repro_se_scale(float* x, const float* gate, int N, int HW,
                              int C, int vec, void* stream) {
  if (N <= 0 || N > 65535 || HW <= 0 || C <= 0 || (vec && C % 4 != 0))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long units = (long long)HW * (vec ? C / 4 : C);
  const long long need = (units + NT - 1) / NT;
  const int blocks = (int)(need < 65535 ? need : 65535);
  const dim3 grid(blocks, N);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (vec)
    se_scale_kernel<4><<<grid, NT, 0, s>>>(x, gate, HW, C);
  else
    se_scale_kernel<1><<<grid, NT, 0, s>>>(x, gate, HW, C);
  return static_cast<int>(cudaGetLastError());
}
