// K3: NHWC KxK convolution as an implicit GEMM, bias and relu / relu6, f32.
//
// Replaces the TPU kernel src/repro/kernels/conv_gemm/kernel.py
// `conv2d_implicit_gemm` (body `_implicit_gemm_kernel`): the MobileNet stems
// (224x224x3 -> 32, 3x3, stride 2, pad 1) and SqueezeNet's conv1 and e3x3.
//
// The GEMM is M = N*Ho*Wo output pixels, K = Kh*Kw*Ci taps in (i, j, c)
// order, N = Co, with B the HWIO weight read as a (Kh*Kw*Ci, Co) matrix.
//
// Bound on an H100: the stem reads 1.2 MB and writes 3.2 MB per batch of two
// for 43 MFLOP (about 10 FLOP/byte), below the f32 ridge (67 TFLOP/s over
// 3.35 TB/s, about 20 FLOP/byte): bytes bound.  SqueezeNet's e3x3 layers
// (K = 9*Ci up to 576) lie above the ridge: operations bound.
//
// Design: the TPU kernel pads the image in HBM and keeps a whole padded
// image in VMEM; 227 KB of shared memory holds no such thing.  Here each
// block owns a 64-pixel x 64-channel output tile and gathers its A tile
// (the patch rows of its pixels) straight from the unpadded NHWC input,
// masking taps that fall outside the image, so no padded or im2col copy
// ever reaches device memory.  Each thread decodes its four pixel rows once,
// outside the K loop.  Ci = 3 works like any other Ci: K is just 27.
#include "common.cuh"

namespace {

constexpr int BM = 64;
constexpr int BN = 64;
constexpr int BK = 16;
constexpr int NT = 256;

__global__ void __launch_bounds__(NT)
conv2d_implicit_gemm_kernel(const float* __restrict__ x,
                            const float* __restrict__ w,
                            const float* __restrict__ bias,
                            float* __restrict__ out, int Nimg, int H, int W,
                            int Ci, int Co, int KH, int KW, int stride,
                            int pad, int Ho, int Wo, int act) {
  __shared__ float As[BK][BM + 1];
  __shared__ float Bs[BK][BN];
  const int t = threadIdx.x;
  const int tx = t % 16;
  const int ty = t / 16;
  const int M = Nimg * Ho * Wo;
  const int Kt = KH * KW * Ci;
  const int m0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;

  // The A loads of this thread: rows t/BK + 16*r of the tile, column t%BK.
  const int a_k = t % BK;
  int row_img[BM * BK / NT], row_ih[BM * BK / NT], row_iw[BM * BK / NT];
#pragma unroll
  for (int r = 0; r < BM * BK / NT; ++r) {
    const int gm = m0 + t / BK + 16 * r;
    if (gm < M) {
      const int ow = gm % Wo;
      const int rest = gm / Wo;
      row_img[r] = rest / Ho;
      row_ih[r] = (rest % Ho) * stride - pad;
      row_iw[r] = ow * stride - pad;
    } else {
      row_img[r] = -1;
      row_ih[r] = 0;
      row_iw[r] = 0;
    }
  }

  float acc[4][4] = {};
  for (int k0 = 0; k0 < Kt; k0 += BK) {
    const int gk = k0 + a_k;
    int ti = 0, tj = 0, c = 0;
    if (gk < Kt) {
      c = gk % Ci;
      const int tap = gk / Ci;
      tj = tap % KW;
      ti = tap / KW;
    }
#pragma unroll
    for (int r = 0; r < BM * BK / NT; ++r) {
      const int ih = row_ih[r] + ti;
      const int iw = row_iw[r] + tj;
      float v = 0.f;
      if (gk < Kt && row_img[r] >= 0 && ih >= 0 && ih < H && iw >= 0 &&
          iw < W)
        v = x[(((size_t)row_img[r] * H + ih) * W + iw) * Ci + c];
      As[a_k][t / BK + 16 * r] = v;
    }
#pragma unroll
    for (int r = 0; r < BK * BN / NT; ++r) {
      const int idx = t + r * NT;
      const int k = idx / BN;
      const int n = idx % BN;
      const int gkk = k0 + k;
      const int gn = n0 + n;
      Bs[k][n] = (gkk < Kt && gn < Co) ? w[(size_t)gkk * Co + gn] : 0.f;
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
      if (gn >= Co) continue;
      float v = acc[i][j];
      if (bias != nullptr) v += bias[gn];
      out[(size_t)gm * Co + gn] = repro_act(v, act);
    }
  }
}

}  // namespace

extern "C" int repro_conv2d_implicit_gemm(const float* x, const float* w,
                                          const float* bias, float* out,
                                          int Nimg, int H, int W, int Ci,
                                          int Co, int KH, int KW, int stride,
                                          int pad, int Ho, int Wo, int act,
                                          void* stream) {
  if (Nimg <= 0 || Ho <= 0 || Wo <= 0 || Co <= 0 || Ci <= 0 || stride <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int M = Nimg * Ho * Wo;
  const dim3 grid(repro_cdiv(M, BM), repro_cdiv(Co, BN));
  if (grid.y > 65535) return static_cast<int>(cudaErrorInvalidConfiguration);
  conv2d_implicit_gemm_kernel<<<grid, NT, 0,
                                static_cast<cudaStream_t>(stream)>>>(
      x, w, bias, out, Nimg, H, W, Ci, Co, KH, KW, stride, pad, Ho, Wo, act);
  return static_cast<int>(cudaGetLastError());
}
