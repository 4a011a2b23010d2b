// K4: depthwise KxK -> act -> pointwise 1x1 -> act (+ residual), f32, with
// the depthwise map kept on chip.
//
// Replaces the TPU kernel src/repro/kernels/fused_block/kernel.py
// `fused_dw_pw_conv` (bodies `_fused_dw_pw_kernel` and `_dw_tile`): the
// dw -> project pairs the dual-core runtime fuses inside one exec group
// (MobileNet v2: b1, and each stride-2 block's dw -> project).
//
// Bound on an H100: the pw half does 2*C*Co FLOPs per output pixel against
// C input floats and Co output floats; with C = 32..960 and Co = 16..320 the
// calls of the main path lie around the f32 ridge (about 20 FLOP/byte), the
// early wide-map ones bytes bound, the late narrow-map ones operations bound.
//
// Design: the TPU kernel keeps the whole image's dw result, (ho*wo, C) f32,
// in VMEM (1.6 MB for 112x112x32), which 227 KB of shared memory cannot
// hold.  Here a block owns an 8x8 tile of output pixels times 64 output
// channels and walks the input channels in chunks of 16.  Per chunk it loads
// the input halo of its pixels into shared memory (zero outside the image,
// no padded copy in device memory), computes the dw values of its 64 pixels
// x 16 channels from that halo into shared memory (dw bias and act applied
// there), and multiplies them into its 64x64 pw accumulators (each thread a
// 4x4 register sub-tile).  The dw map never reaches device memory, which is
// the point of the TPU kernel.  A block recomputes the dw values for its
// output-channel tile; with Co <= 320 that is at most five times.  No
// atomics: the K loop is private to the block.
#include "common.cuh"

namespace {

constexpr int TH = 8;
constexpr int TW = 8;
constexpr int P = TH * TW;  // output pixels per block
constexpr int BN = 64;      // output channels per block
constexpr int CK = 16;      // input channels per chunk
constexpr int XS = CK + 1;  // halo row stride in floats (bank-conflict pad)
constexpr int NT = 256;

__global__ void __launch_bounds__(NT)
fused_dw_pw_kernel(const float* __restrict__ x,
                   const float* __restrict__ dw_w,
                   const float* __restrict__ dw_b,
                   const float* __restrict__ pw_w,
                   const float* __restrict__ pw_b,
                   const float* __restrict__ res, float* __restrict__ out,
                   int H, int W, int C, int Co, int KH, int KW, int stride,
                   int pad, int Ho, int Wo, int tiles_w, int dw_act,
                   int pw_act) {
  extern __shared__ float smem[];
  const int hh = (TH - 1) * stride + KH;
  const int hw = (TW - 1) * stride + KW;
  float* xs = smem;             // [hh*hw][XS]   input halo of the chunk
  float* ds = xs + hh * hw * XS;  // [CK][P]       dw values of the chunk
  float* ws = ds + CK * P;      // [CK][BN]      pw weights of the chunk
  float* dww = ws + CK * BN;    // [KH*KW][CK]   dw weights of the chunk

  const int t = threadIdx.x;
  const int tx = t % 16;
  const int ty = t / 16;
  const int tile = blockIdx.x;
  const int co0 = blockIdx.y * BN;
  const int n = blockIdx.z;
  const int oh0 = (tile / tiles_w) * TH;
  const int ow0 = (tile % tiles_w) * TW;
  const int ih0 = oh0 * stride - pad;
  const int iw0 = ow0 * stride - pad;

  float acc[4][4] = {};
  for (int c0 = 0; c0 < C; c0 += CK) {
    for (int idx = t; idx < hh * hw * CK; idx += NT) {
      const int k = idx % CK;
      const int p = idx / CK;
      const int ih = ih0 + p / hw;
      const int iw = iw0 + p % hw;
      const int gc = c0 + k;
      float v = 0.f;
      if (gc < C && ih >= 0 && ih < H && iw >= 0 && iw < W)
        v = x[(((size_t)n * H + ih) * W + iw) * C + gc];
      xs[p * XS + k] = v;
    }
    for (int idx = t; idx < KH * KW * CK; idx += NT) {
      const int k = idx % CK;
      const int q = idx / CK;
      const int gc = c0 + k;
      dww[q * CK + k] = gc < C ? dw_w[(size_t)q * C + gc] : 0.f;
    }
    for (int idx = t; idx < CK * BN; idx += NT) {
      const int nn = idx % BN;
      const int k = idx / BN;
      const int gc = c0 + k;
      const int gn = co0 + nn;
      ws[k * BN + nn] = (gc < C && gn < Co) ? pw_w[(size_t)gc * Co + gn] : 0.f;
    }
    __syncthreads();

    for (int idx = t; idx < CK * P; idx += NT) {
      const int p = idx % P;
      const int k = idx / P;
      const int gc = c0 + k;
      float v = 0.f;
      if (gc < C) {
        const int ph = p / TW;
        const int pw = p % TW;
        float a = 0.f;
        for (int i = 0; i < KH; ++i)
          for (int j = 0; j < KW; ++j)
            a = fmaf(xs[((ph * stride + i) * hw + pw * stride + j) * XS + k],
                     dww[(i * KW + j) * CK + k], a);
        if (dw_b != nullptr) a += dw_b[gc];
        v = repro_act(a, dw_act);
      }
      ds[k * P + p] = v;
    }
    __syncthreads();

#pragma unroll
    for (int k = 0; k < CK; ++k) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = ds[k * P + ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = ws[k * BN + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int p = ty + 16 * i;
    const int oh = oh0 + p / TW;
    const int ow = ow0 + p % TW;
    if (oh >= Ho || ow >= Wo) continue;
    const size_t row = (((size_t)n * Ho + oh) * Wo + ow) * Co;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int gn = co0 + tx + 16 * j;
      if (gn >= Co) continue;
      float v = acc[i][j];
      if (pw_b != nullptr) v += pw_b[gn];
      v = repro_act(v, pw_act);
      if (res != nullptr) v += res[row + gn];
      out[row + gn] = v;
    }
  }
}

}  // namespace

extern "C" int repro_fused_dw_pw_conv(const float* x, const float* dw_w,
                                      const float* dw_b, const float* pw_w,
                                      const float* pw_b, const float* res,
                                      float* out, int Nimg, int H, int W,
                                      int C, int Co, int KH, int KW,
                                      int stride, int pad, int Ho, int Wo,
                                      int dw_act, int pw_act, void* stream) {
  if (Nimg <= 0 || Ho <= 0 || Wo <= 0 || C <= 0 || Co <= 0 || stride <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int hh = (TH - 1) * stride + KH;
  const int hw = (TW - 1) * stride + KW;
  const size_t smem =
      ((size_t)hh * hw * XS + CK * P + CK * BN + KH * KW * CK) * sizeof(float);
  if (smem > REPRO_MAX_SMEM) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = repro_smem_opt_in(fused_dw_pw_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int tiles_w = repro_cdiv(Wo, TW);
  const dim3 grid(repro_cdiv(Ho, TH) * tiles_w, repro_cdiv(Co, BN), Nimg);
  if (grid.y > 65535 || grid.z > 65535)
    return static_cast<int>(cudaErrorInvalidConfiguration);
  fused_dw_pw_kernel<<<grid, NT, smem, static_cast<cudaStream_t>(stream)>>>(
      x, dw_w, dw_b, pw_w, pw_b, res, out, H, W, C, Co, KH, KW, stride, pad,
      Ho, Wo, tiles_w, dw_act, pw_act);
  return static_cast<int>(cudaGetLastError());
}
