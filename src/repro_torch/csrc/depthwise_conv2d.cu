// K2: NHWC depthwise KxK convolution, stride s, pad p, bias, relu / relu6.
//
// Replaces the TPU kernel src/repro/kernels/depthwise/kernel.py
// `depthwise_conv2d` (body `_dw_kernel`): the p-core's line-buffer op.
//
// Bound on an H100: 2*Kh*Kw FLOPs per output against one input and one
// output float, i.e. 2-4.5 FLOP/byte for 3x3 at stride 1-2: bytes bound by
// far.  The least time is the input read once plus the output written once:
// 0.2-3.6 us at the main path's shapes (batch 2).  What bounds the calls in
// practice is latency: a block that loads its halo 4 bytes a thread, one
// load waiting on the last, spends microseconds in round trips.
//
// Design (the tiling is chosen per call on the host: plan.py's plan_k2):
//   * The TPU kernel brings a whole padded image (times a channel block)
//     into VMEM; 227 KB of shared memory holds no such thing.  A block owns
//     a th x tw tile of output pixels times a block of 4 * cq channels, so
//     that the small late maps (14x14, 7x7) still give every SM a block.
//   * cp.async stages the tile's input halo (zero outside the image: the
//     pad never exists in device memory), the window's weights and the
//     bias in 16-byte copies (4-byte ones for a ragged C), every copy in
//     flight at once; each input byte leaves device memory about once, as
//     the line buffer intends.
//   * A thread owns 4 channels of ow (1 or 4) neighbouring outputs along
//     W.  Per window row it loads the (ow - 1) * s + Kw input pixels the
//     outputs share into registers once, as 16-byte shared-memory reads
//     (neighbouring threads, neighbouring channels: conflict-free).
//   * Taps accumulate in (i, j) order like the TPU kernel; bias and
//     activation are fused into 16-byte stores.
#include <type_traits>

#include "tc_common.cuh"

namespace {

using namespace tc;

// Shared memory in floats; plan.py's k2_smem_floats.
size_t smem_floats(int th, int tw, int cq, int ow, int KH, int KW,
                   int stride) {
  const int hh = (th - 1) * stride + KH;
  const int hw = (repro_cdiv(tw, ow) * ow - 1) * stride + KW;
  return (size_t)(hh * hw + KH * KW + 1) * 4 * cq;
}

__device__ __forceinline__ void fma4(float4& acc, const float4& a,
                                     const float4& b) {
  acc.x = fmaf(a.x, b.x, acc.x);
  acc.y = fmaf(a.y, b.y, acc.y);
  acc.z = fmaf(a.z, b.z, acc.z);
  acc.w = fmaf(a.w, b.w, acc.w);
}

// KS: the window's size when it is KS x KS (3 on every path), 0 for any;
// S: the stride (1 or 2), 0 for any; OW: the outputs a thread along W.
// The input rows go through registers only where KS and S are known.
// vec: C % 4 == 0 and every pointer 16-byte aligned.  Grid
// (tiles_h * tiles_w, cdiv(cdiv(C, 4), cq), N); cq * th * cdiv(tw, OW)
// threads a block, channel quad fastest.
template <int KS, int S, int OW>
__global__ void __launch_bounds__(256)
depthwise_conv2d_kernel(const float* __restrict__ x,
                        const float* __restrict__ w,
                        const float* __restrict__ bias,
                        float* __restrict__ out, int H, int W, int C,
                        int KH_, int KW_, int stride_, int pad, int Ho,
                        int Wo, int th, int tw, int cq, int tiles_w, int vec,
                        int act) {
  const int KH = KS ? KS : KH_;
  const int KW = KS ? KS : KW_;
  const int st = S ? S : stride_;
  extern __shared__ __align__(16) float smem[];
  const int CB = 4 * cq;
  const int sw = repro_cdiv(tw, OW);       // strips of OW outputs a row
  const int hh = (th - 1) * st + KH;
  const int hw = (sw * OW - 1) * st + KW;
  float* xs = smem;                        // [hh * hw][CB] input halo
  float* ws = xs + hh * hw * CB;           // [KH * KW][CB] weights
  float* bs = ws + KH * KW * CB;           // [CB]          bias
  const int oh0 = (blockIdx.x / tiles_w) * th;
  const int ow0 = (blockIdx.x % tiles_w) * tw;
  const int c0 = blockIdx.y * CB;
  const int n = blockIdx.z;
  const int ih0 = oh0 * st - pad;
  const int iw0 = ow0 * st - pad;
  const int cv = min(CB, C - c0);          // channels of the block inside C
  const bool vx = vec != 0;
  const int nthr = blockDim.x;
  const float* xn = x + (size_t)n * H * W * C + c0;

  for (int idx = threadIdx.x; idx < hh * hw * cq; idx += nthr) {
    const int p = idx / cq;
    const int q = 4 * (idx - p * cq);
    const int ih = ih0 + p / hw;
    const int iw = iw0 + p % hw;
    const bool in = ih >= 0 && ih < H && iw >= 0 && iw < W;
    cp_quad(xs + p * CB + q, in ? xn + ((size_t)ih * W + iw) * C + q : x,
            in ? max(0, min(4, cv - q)) : 0, vx, x);
  }
  for (int idx = threadIdx.x; idx < KH * KW * cq; idx += nthr) {
    const int tap = idx / cq;
    const int q = 4 * (idx - tap * cq);
    cp_quad(ws + tap * CB + q, w + (size_t)tap * C + c0 + q,
            max(0, min(4, cv - q)), vx, x);
  }
  if (bias != nullptr)
    for (int q = 4 * threadIdx.x; q < CB; q += 4 * nthr)
      cp_quad(bs + q, bias + c0 + q, max(0, min(4, cv - q)), vx, x);
  cp_commit();
  cp_wait<0>();
  __syncthreads();

  const int t = threadIdx.x;
  const int c = 4 * (t % cq);
  const int strip = (t / cq) % sw;
  const int row = t / (cq * sw);
  const int oh = oh0 + row;
  const int owf = ow0 + strip * OW;        // the thread's first output
  if (row >= th || oh >= Ho || owf >= Wo || c >= cv) return;

  float4 acc[OW];
#pragma unroll
  for (int u = 0; u < OW; ++u) acc[u] = make_float4(0.f, 0.f, 0.f, 0.f);
  // the thread's input pixel (row * st + i, strip * OW * st + jj) of the halo
  const float* xt = xs + ((row * st) * hw + strip * OW * st) * CB + c;
  if constexpr (KS != 0 && S != 0) {
    constexpr int NIN = (OW - 1) * S + KS;
#pragma unroll
    for (int i = 0; i < KS; ++i) {
      float4 in[NIN];
#pragma unroll
      for (int jj = 0; jj < NIN; ++jj)
        in[jj] = *reinterpret_cast<const float4*>(xt + (i * hw + jj) * CB);
#pragma unroll
      for (int j = 0; j < KS; ++j) {
        const float4 wv =
            *reinterpret_cast<const float4*>(ws + (i * KS + j) * CB + c);
#pragma unroll
        for (int u = 0; u < OW; ++u) fma4(acc[u], in[u * S + j], wv);
      }
    }
  } else {
    for (int i = 0; i < KH; ++i)
      for (int j = 0; j < KW; ++j) {
        const float4 wv =
            *reinterpret_cast<const float4*>(ws + (i * KW + j) * CB + c);
#pragma unroll
        for (int u = 0; u < OW; ++u)
          fma4(acc[u],
               *reinterpret_cast<const float4*>(
                   xt + (i * hw + u * st + j) * CB),
               wv);
      }
  }

  const float4 b = bias != nullptr
                       ? *reinterpret_cast<const float4*>(bs + c)
                       : make_float4(0.f, 0.f, 0.f, 0.f);
  const bool full = vx && c + 4 <= cv;
  // the stores, compiled for repro_act and for repro_act_any (common.cuh)
  const auto store = [&](auto any) {
#pragma unroll
    for (int u = 0; u < OW; ++u) {
      if (owf + u >= Wo) break;
      float v[4] = {acc[u].x, acc[u].y, acc[u].z, acc[u].w};
      if (bias != nullptr) {
        v[0] += b.x, v[1] += b.y, v[2] += b.z, v[3] += b.w;
      }
#pragma unroll
      for (int e = 0; e < 4; ++e)
        v[e] = repro_act_t<decltype(any)::value>(v[e], act);
      float* o = out + (((size_t)n * Ho + oh) * Wo + owf + u) * C + c0 + c;
      if (full) {
        *reinterpret_cast<float4*>(o) = make_float4(v[0], v[1], v[2], v[3]);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (c + e < cv) o[e] = v[e];
      }
    }
  };
  if (act >= REPRO_ACT_SILU)
    store(std::true_type{});
  else
    store(std::false_type{});
}

using Kernel = decltype(&depthwise_conv2d_kernel<3, 1, 1>);

// The kernel compiled for the call, or nullptr: 3x3 windows at stride 1
// or 2 for OW 1 and 4; any other window for OW 1 (plan.py's
// compiled_ows).
Kernel pick(int KH, int KW, int stride, int ow) {
  if (KH == 3 && KW == 3 && stride == 1) {
    switch (ow) {
      case 1: return depthwise_conv2d_kernel<3, 1, 1>;
      case 4: return depthwise_conv2d_kernel<3, 1, 4>;
    }
  } else if (KH == 3 && KW == 3 && stride == 2) {
    switch (ow) {
      case 1: return depthwise_conv2d_kernel<3, 2, 1>;
      case 4: return depthwise_conv2d_kernel<3, 2, 4>;
    }
  } else if (ow == 1) {
    return depthwise_conv2d_kernel<0, 0, 1>;
  }
  return nullptr;
}

}  // namespace

// The plan (th, tw, cq, ow, smem) comes from plan.py's plan_k2; a plan the
// kernel was not compiled for, or whose shared memory disagrees with
// smem_floats, is refused.
extern "C" int repro_depthwise_conv2d(const float* x, const float* w,
                                      const float* bias, float* out,
                                      int Nimg, int H, int W, int C, int KH,
                                      int KW, int stride, int pad, int Ho,
                                      int Wo, int act, int th, int tw, int cq,
                                      int ow, int smem, int vec,
                                      void* stream) {
  if (Nimg <= 0 || Nimg > 65535 || Ho <= 0 || Wo <= 0 || C <= 0 ||
      KH <= 0 || KW <= 0 || stride <= 0 || th <= 0 || tw <= 0 || cq <= 0 ||
      ow <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const Kernel kernel = pick(KH, KW, stride, ow);
  const long long threads = (long long)cq * th * repro_cdiv(tw, ow);
  if (kernel == nullptr || threads > 256 ||
      (size_t)smem != 4 * smem_floats(th, tw, cq, ow, KH, KW, stride) ||
      (size_t)smem > REPRO_MAX_SMEM)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long tiles =
      (long long)repro_cdiv(Ho, th) * repro_cdiv(Wo, tw);
  const int cblocks = repro_cdiv(repro_cdiv(C, 4), cq);
  if (tiles > 2147483647LL || cblocks > 65535)
    return static_cast<int>(cudaErrorInvalidConfiguration);
  const int rc = opt_in(kernel, (size_t)smem, false);
  if (rc != 0) return rc;
  kernel<<<dim3((unsigned)tiles, cblocks, Nimg), (unsigned)threads, smem,
           static_cast<cudaStream_t>(stream)>>>(
      x, w, bias, out, H, W, C, KH, KW, stride, pad, Ho, Wo, th, tw, cq,
      repro_cdiv(Wo, tw), vec, act);
  return static_cast<int>(cudaGetLastError());
}
