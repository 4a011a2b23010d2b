// K2: NHWC depthwise KxK convolution, stride s, pad p, bias, relu / relu6.
//
// Replaces the TPU kernel src/repro/kernels/depthwise/kernel.py
// `depthwise_conv2d` (body `_dw_kernel`): the p-core's line-buffer op.
//
// Bound on an H100: 2*Kh*Kw FLOPs per output against one input and one
// output float, i.e. 2-4.5 FLOP/byte for 3x3 at stride 1-2: bytes bound by
// far.  The least time is the input read once plus the output written once.
//
// Design: the TPU kernel brings a whole padded image (times a channel block)
// into VMEM; for 112x112x96 that is about 5 MB, which 227 KB of shared
// memory cannot hold.  Here a block owns an 8x8 tile of output pixels times
// 32 channels.  It loads the tile's input halo ((8-1)*s+Kh rows by
// (8-1)*s+Kw columns, zero outside the image: the pad never exists in device
// memory) into shared memory once, with a warp reading 32 consecutive
// channels of one pixel (128-byte coalesced loads), then every tap of every
// output reads the halo from shared memory: each input byte leaves device
// memory about once, as the line buffer intends.  Lane = channel, so the
// shared-memory reads are conflict-free.  Taps accumulate in (i, j) order
// like the TPU kernel; bias and activation are fused into the store.
#include "common.cuh"

namespace {

constexpr int TH = 8;
constexpr int TW = 8;
constexpr int CB = 32;  // channels per block == lanes of a warp
constexpr int NY = 8;   // warps per block

__global__ void __launch_bounds__(CB * NY)
depthwise_conv2d_kernel(const float* __restrict__ x,
                        const float* __restrict__ w,
                        const float* __restrict__ bias,
                        float* __restrict__ out, int H, int W, int C,
                        int KH, int KW, int stride, int pad, int Ho, int Wo,
                        int tiles_w, int act) {
  extern __shared__ float smem[];
  const int hh = (TH - 1) * stride + KH;
  const int hw = (TW - 1) * stride + KW;
  float* xs = smem;                // [hh*hw][CB]
  float* ws = smem + hh * hw * CB;  // [KH*KW][CB]

  const int lane = threadIdx.x;
  const int ty = threadIdx.y;
  const int gc = blockIdx.x * CB + lane;
  const bool c_ok = gc < C;
  const int tile = blockIdx.y;
  const int n = blockIdx.z;
  const int oh0 = (tile / tiles_w) * TH;
  const int ow0 = (tile % tiles_w) * TW;
  const int ih0 = oh0 * stride - pad;
  const int iw0 = ow0 * stride - pad;

  for (int p = ty; p < hh * hw; p += NY) {
    const int ih = ih0 + p / hw;
    const int iw = iw0 + p % hw;
    float v = 0.f;
    if (c_ok && ih >= 0 && ih < H && iw >= 0 && iw < W)
      v = x[(((size_t)n * H + ih) * W + iw) * C + gc];
    xs[p * CB + lane] = v;
  }
  for (int q = ty; q < KH * KW; q += NY)
    ws[q * CB + lane] = c_ok ? w[(size_t)q * C + gc] : 0.f;
  __syncthreads();
  if (!c_ok) return;

  for (int p = ty; p < TH * TW; p += NY) {
    const int ph = p / TW;
    const int pw = p % TW;
    const int oh = oh0 + ph;
    const int ow = ow0 + pw;
    if (oh >= Ho || ow >= Wo) continue;
    float acc = 0.f;
    for (int i = 0; i < KH; ++i)
      for (int j = 0; j < KW; ++j)
        acc = fmaf(xs[((ph * stride + i) * hw + pw * stride + j) * CB + lane],
                   ws[(i * KW + j) * CB + lane], acc);
    if (bias != nullptr) acc += bias[gc];
    out[(((size_t)n * Ho + oh) * Wo + ow) * C + gc] = repro_act(acc, act);
  }
}

}  // namespace

extern "C" int repro_depthwise_conv2d(const float* x, const float* w,
                                      const float* bias, float* out,
                                      int Nimg, int H, int W, int C, int KH,
                                      int KW, int stride, int pad, int Ho,
                                      int Wo, int act, void* stream) {
  if (Nimg <= 0 || Ho <= 0 || Wo <= 0 || C <= 0 || stride <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int hh = (TH - 1) * stride + KH;
  const int hw = (TW - 1) * stride + KW;
  const size_t smem = (size_t)(hh * hw + KH * KW) * CB * sizeof(float);
  if (smem > REPRO_MAX_SMEM) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = repro_smem_opt_in(depthwise_conv2d_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int tiles_w = repro_cdiv(Wo, TW);
  const dim3 grid(repro_cdiv(C, CB), repro_cdiv(Ho, TH) * tiles_w, Nimg);
  if (grid.y > 65535 || grid.z > 65535)
    return static_cast<int>(cudaErrorInvalidConfiguration);
  depthwise_conv2d_kernel<<<grid, dim3(CB, NY), smem,
                            static_cast<cudaStream_t>(stream)>>>(
      x, w, bias, out, H, W, C, KH, KW, stride, pad, Ho, Wo, tiles_w, act);
  return static_cast<int>(cudaGetLastError());
}
