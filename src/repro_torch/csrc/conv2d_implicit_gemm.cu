// K3: NHWC KxK convolution as an implicit GEMM, bias and relu / relu6; f32
// in and out, the products on the tensor cores in 3xTF32 (tc_common.cuh),
// which keeps f32's accuracy.
//
// Replaces the TPU kernel src/repro/kernels/conv_gemm/kernel.py
// `conv2d_implicit_gemm` (body `_implicit_gemm_kernel`): the MobileNet stems
// (224x224x3 -> 32, 3x3, stride 2, pad 1), SqueezeNet's conv1 (-> 64) and
// its e3x3 layers (56^2 to 14^2, Ci 16-64, Co 64-256).
//
// The GEMM is M = N*Ho*Wo output pixels, K = Kh*Kw*Ci taps in (i, j, c)
// order, N = Co, with B the HWIO weight read as a (Kh*Kw*Ci, Co) matrix.
//
// Bound on an H100: a stem reads 1.2 MB and writes 3.2 MB a batch of two
// for 43 MFLOP: bytes bound (1.3 us).  SqueezeNet's e3x3 layers do 65-116
// MFLOP on 0.3-1.8 MB: operations bound at the 3xTF32 rate (0.4-0.7 us).
// What held the first design back was latency: a fixed 64x64 tile gave the
// 14^2 layers (M = 392) 21-28 blocks for 132 SMs, each walking K = 432-576
// through synchronous 4-byte loads with a division and a modulo per k.
//
// Design: K1's split-K GEMM tile (tc_common.cuh's gemm_tile: a cluster of
// up to 16 blocks splitting K in rank order, a cp.async ring, 3xTF32
// mma.sync, the rank-order sum over distributed shared memory, no atomics,
// a programmatic dependent launch), tiled per call by plan.py's plan_k3,
// with a patch-row A loader.  Before its first load each block writes two
// tables into shared memory: for each of its pixel rows the offset of tap
// (0, 0) in x and its (ih, iw); for each k (or each quad of 4 k) of its
// rank's range the offset of its tap and channel from tap (0, 0) and the
// tap's (i, j).  A staged element is then one add and two bounds checks,
// with no division in the k loop, and the patch matrix never reaches
// device memory.  Where Ci % 4 == 0 (every e3x3) a quad of 4 k is 4
// channels of one pixel and one tap: one 16-byte cp.async.  The stems (Ci
// = 3, K = 27) stage 4-byte copies; taps outside the image are zero-filled.
#include "tc_common.cuh"

namespace {

using namespace tc;

// Shared memory in floats: the GEMM tile's, then the pixel rows' table (3
// ints a row) and the k table (an int2 an entry).  plan.py's
// k3_smem_floats.
int smem_floats(int bm, int bn, int bk, int ns, int entries) {
  return gemm_smem_floats(bm, bn, bk, ns) + 3 * bm + 2 * entries;
}

// One float of x (src) into dst, or zero (4-byte cp.async).
__device__ __forceinline__ void cp_one(float* dst, const float* src,
                                       bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(ok ? 4 : 0));
}

// VEC: Ci % 4 == 0 and x 16-byte aligned, so a k-table entry is a quad of
// 4 k staged by one 16-byte copy; else an entry is one k.  vb: w may be
// staged in 16-byte copies.  Grid (cl, tiles_n, tiles_m) in clusters of
// (cl, 1, 1).
template <int MI, int NJ, int BK, bool VEC>
__global__ void __launch_bounds__(NT, MIN_BLOCKS)
conv2d_implicit_gemm_kernel(const float* __restrict__ x,
                            const float* __restrict__ w,
                            const float* __restrict__ bias,
                            float* __restrict__ out, int H, int W, int Ci,
                            int KW, int stride, int pad, int Ho, int Wo,
                            int M, int N, int K, int bm, int bn, int wm,
                            int ns, int vb, int act) {
  constexpr int E = VEC ? 4 : 1;           // k a table entry
  constexpr int QPR = BK / 4;              // A quads a row a step
  extern __shared__ __align__(16) float smem[];
  const int m0 = blockIdx.z * bm;
  const int rows = min(bm, M - m0);
  int s0, s1;
  rank_range(repro_cdiv(K, BK), gridDim.x, blockIdx.x, s0, s1);
  const int kbase = s0 * BK;
  const int entries = (s1 - s0) * BK / E;
  int* rowtab = reinterpret_cast<int*>(smem + gemm_smem_floats(bm, bn, BK,
                                                                 ns));
  int2* ktab = reinterpret_cast<int2*>(rowtab + 3 * bm);

  // The tables, from the shape alone (before griddepcontrol.wait, so they
  // overlap the end of the kernel before this one).  A pixel row: the
  // offset of its tap (0, 0) in x, ih, iw.  A k entry: the offset of its
  // tap (i, j) and channel c from tap (0, 0), and (i << 16) | j; -1 past K.
  const int hw = Ho * Wo;
  for (int r = threadIdx.x; r < rows; r += NT) {
    const int m = m0 + r;
    const int img = m / hw;
    const int rem = m - img * hw;
    const int oh = rem / Wo;
    const int ih = oh * stride - pad;
    const int iw = (rem - oh * Wo) * stride - pad;
    rowtab[3 * r] = ((img * H + ih) * W + iw) * Ci;
    rowtab[3 * r + 1] = ih;
    rowtab[3 * r + 2] = iw;
  }
  for (int e = threadIdx.x; e < entries; e += NT) {
    const int k = kbase + e * E;
    int2 t = make_int2(0, -1);
    if (k < K) {
      const int tap = k / Ci;
      const int i = tap / KW;
      const int j = tap - i * KW;
      t = make_int2((i * W + j) * Ci + (k - tap * Ci), (i << 16) | j);
    }
    ktab[e] = t;
  }
  __syncthreads();

  gemm_tile<MI, NJ, BK>(
      smem,
      [&](float* as, int AS, int k0, int nrows) {
        const int2* kt = ktab + (k0 - kbase) / E;
        for (int idx = threadIdx.x; idx < nrows * QPR; idx += NT) {
          const int r = idx / QPR;
          const int q = idx - r * QPR;
          const int base = rowtab[3 * r];
          const int ih = rowtab[3 * r + 1];
          const int iw = rowtab[3 * r + 2];
          float* dst = as + r * AS + 4 * q;
          if constexpr (VEC) {
            const int2 t = kt[q];
            const bool ok =
                t.y >= 0 &&
                static_cast<unsigned>(ih + (t.y >> 16)) <
                    static_cast<unsigned>(H) &&
                static_cast<unsigned>(iw + (t.y & 0xffff)) <
                    static_cast<unsigned>(W);
            cp_quad(dst, x + (ok ? base + t.x : 0), ok ? 4 : 0, true, x);
          } else {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int2 t = kt[4 * q + e];
              const bool ok =
                  t.y >= 0 &&
                  static_cast<unsigned>(ih + (t.y >> 16)) <
                      static_cast<unsigned>(H) &&
                  static_cast<unsigned>(iw + (t.y & 0xffff)) <
                      static_cast<unsigned>(W);
              cp_one(dst + e, x + (ok ? base + t.x : 0), ok);
            }
          }
        }
      },
      w, bias, out, M, N, K, bm, bn, wm, ns, vb != 0, act);
}

using Kernel = decltype(&conv2d_implicit_gemm_kernel<1, 1, 16, true>);

template <int BK, bool VEC>
Kernel pick_layout(int mi, int nj) {
  if (mi == 1 && nj == 1) return conv2d_implicit_gemm_kernel<1, 1, BK, VEC>;
  if (mi == 2 && nj == 2) return conv2d_implicit_gemm_kernel<2, 2, BK, VEC>;
  if (mi == 2 && nj == 4) return conv2d_implicit_gemm_kernel<2, 4, BK, VEC>;
  return nullptr;
}

// The kernel compiled for (MI, NJ, BK, VEC), or nullptr: plan.py's
// COMPILED pairs at its K3_BKS (16, 32, 64 with 16-byte copies; 16, 32
// with 4-byte ones).
Kernel pick(int mi, int nj, int bk, bool vec) {
  if (vec)
    return bk == 16   ? pick_layout<16, true>(mi, nj)
           : bk == 32 ? pick_layout<32, true>(mi, nj)
           : bk == 64 ? pick_layout<64, true>(mi, nj)
                      : nullptr;
  return bk == 16   ? pick_layout<16, false>(mi, nj)
         : bk == 32 ? pick_layout<32, false>(mi, nj)
                    : nullptr;
}

int nj_class(int nj) { return nj <= 1 ? 1 : nj <= 2 ? 2 : nj <= 4 ? 4 : 8; }

}  // namespace

// The plan (bm, bn, bk, wm, cl, ns, smem) comes from plan.py's plan_k3;
// vec: bit 0, A in 16-byte copies (Ci % 4 == 0, x aligned); bit 1, the
// weight (Co % 4 == 0, w aligned).  A plan the kernels were not compiled
// for, or whose shared memory disagrees with smem_floats, is refused.
extern "C" int repro_conv2d_implicit_gemm(
    const float* x, const float* w, const float* bias, float* out, int Nimg,
    int H, int W, int Ci, int Co, int KH, int KW, int stride, int pad,
    int Ho, int Wo, int act, int bm, int bn, int bk, int wm, int cl, int ns,
    int smem, int vec, void* stream) {
  const long long m = static_cast<long long>(Nimg) * Ho * Wo;
  if (Nimg <= 0 || Ho <= 0 || Wo <= 0 || Co <= 0 || Ci <= 0 || KH <= 0 ||
      KW <= 0 || KW >= 65536 || stride <= 0 || pad < 0 || m >= (1LL << 31) ||
      bn <= 0 || bn > 128 || (bn % 4 != 0 && bn != Co) || bm % 16 != 0 ||
      wm <= 0 || WARPS % wm != 0 || (bm / 16) % wm != 0 || ns < 2 ||
      ns > MAX_STAGES || ((vec & 1) != 0 && Ci % 4 != 0))
    return static_cast<int>(cudaErrorInvalidValue);
  const int M = static_cast<int>(m);
  const int K = KH * KW * Ci;
  const bool va = (vec & 1) != 0;
  const int steps = repro_cdiv(K, bk > 0 ? bk : 1);
  if (bk <= 0 || cl < 1 || cl > steps)
    return static_cast<int>(cudaErrorInvalidValue);
  const int mi = bm / 16 / wm;
  const int nj = repro_cdiv(repro_cdiv(bn, 8), WARPS / wm);
  const Kernel kernel = pick(mi, nj_class(nj), bk, va);
  const int entries = repro_cdiv(steps, cl) * bk / (va ? 4 : 1);
  if (kernel == nullptr || nj > 8 ||
      smem != 4 * smem_floats(bm, bn, bk, ns, entries))
    return static_cast<int>(cudaErrorInvalidValue);
  return launch_clustered(kernel, cl, repro_cdiv(Co, bn), repro_cdiv(M, bm),
                          (size_t)smem, stream, true, x, w, bias, out, H, W,
                          Ci, KW, stride, pad, Ho, Wo, M, Co, K, bm, bn, wm,
                          ns, (vec >> 1) & 1, act);
}
