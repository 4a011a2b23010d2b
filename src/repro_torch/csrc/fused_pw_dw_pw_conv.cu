// K5: pointwise expand -> act -> depthwise KxK -> act -> pointwise project
// -> act (+ residual), f32, with neither the expanded map nor the dw map in
// device memory.
//
// Replaces the TPU kernel src/repro/kernels/fused_block/kernel.py
// `fused_pw_dw_pw_conv` (body `_fused_pw_dw_pw_kernel`): the inverted
// residuals of MobileNet v2's fused forward and the pw -> dw -> pw chains the
// dual-core runtime fuses inside one exec group (MobileNet v1 `balanced`).
//
// Bound on an H100: two 1x1 GEMMs (2*Ci*Cm and 2*Cm*Co FLOPs per pixel)
// against one read of the block input and one write of its output.  At
// MobileNet v1's shapes (batch 2) each call does 310-415 MFLOP against
// 3-5 MB, far past the f32 ridge (about 20 FLOP/byte): operations bound.
//
// Design: the TPU kernel computes expand and dw once per image into a
// (ho*wo, Cm) VMEM scratch at the first C_out grid step and reuses it for
// every C_out tile.  Hopper's blocks run in no order and carry nothing from
// one to the next, and 227 KB of shared memory cannot hold a whole image's
// expanded map (112x112x96 f32 is 4.8 MB).  Here one thread-block cluster
// of CL blocks (8, or 4/2/1 when Cm has fewer chunks of 32) owns an 8x8
// tile of output pixels, and the expanded channels Cm are split between its
// blocks in chunks of 32:
//   1. each block, for each of its chunks, computes the expand over the
//      part of the tile's input halo ((7s+K)^2 pixels) that lies inside the
//      image, reducing over Ci in steps of 16 staged through shared memory
//      (the next step's global loads in flight while the current one
//      computes), with the expand bias and act; halo pixels outside the
//      image stay ZERO, since the dw pads the expanded map after its bias
//      and act (0, not act(exp_b));
//   2. the dw values of the tile's 64 pixels for that chunk (dw bias and
//      act) go into the block's own slice of the dw map in shared memory;
//   3. after a cluster barrier, each block projects its own 64-channel
//      C_out tiles, reading every peer's slice through distributed shared
//      memory in a fixed order, into 4x4 register tiles per thread.
// Recompute factor: 1 across C_out tiles (each expand and dw value is
// computed once per tile), times the halo overlap: the expand covers
// (7s+K)^2 / (64 s^2) of the tile's own input pixels inside the image (1.56
// at K=3, s=1; 1.13 at s=2).  No atomics: every sum has one owner and a
// fixed order, so equal inputs give equal bits on any stream.
#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int TH = 8;
constexpr int TW = 8;
constexpr int P = TH * TW;  // output pixels per cluster
constexpr int BN = 64;      // output channels per project tile
constexpr int CK = 32;      // expanded channels per chunk
constexpr int KC = 16;      // input channels per expand step
constexpr int PP = 128;     // halo pixels per expand pass
constexpr int XS = PP + 1;  // expand staging row stride (bank-conflict pad)
constexpr int ES = CK + 1;  // expanded halo row stride (bank-conflict pad)
constexpr int NT = 256;
constexpr int XR = PP * KC / NT;  // staged x values per thread and step (8)
constexpr int WR = KC * CK / NT;  // staged expand weights per thread (2)

__global__ void __launch_bounds__(NT)
fused_pw_dw_pw_kernel(const float* __restrict__ x,
                      const float* __restrict__ exp_w,
                      const float* __restrict__ exp_b,
                      const float* __restrict__ dw_w,
                      const float* __restrict__ dw_b,
                      const float* __restrict__ proj_w,
                      const float* __restrict__ proj_b,
                      const float* __restrict__ res, float* __restrict__ out,
                      int H, int W, int Ci, int Cm, int Co, int KH, int KW,
                      int stride, int pad, int Ho, int Wo, int tiles_w,
                      int CL, int cpr, int exp_act, int dw_act,
                      int proj_act) {
  cg::cluster_group cluster = cg::this_cluster();
  extern __shared__ float smem[];
  const int hh = (TH - 1) * stride + KH;
  const int hw = (TW - 1) * stride + KW;
  const int HP = hh * hw;
  float* ds = smem;                 // [cpr*CK][P]  this block's dw slice
  float* dsl = ds + cpr * CK * P;   // [CK][P]      a chunk read from a peer
  float* xs = dsl + CK * P;         // [KC][XS]     x of one expand step
  float* wes = xs + KC * XS;        // [KC][CK]     expand weights of the step
  float* es = wes + KC * CK;        // [HP][ES]     expanded halo of a chunk
  float* dww = es + HP * ES;        // [KH*KW][CK]  dw weights of a chunk
  float* wps = dww + KH * KW * CK;  // [CK][BN]     project weights of a chunk

  const int t = threadIdx.x;
  const int tile = blockIdx.x;
  const int rank = blockIdx.y;  // cluster dims (1, CL, 1), grid.y == CL
  const int n = blockIdx.z;
  const int oh0 = (tile / tiles_w) * TH;
  const int ow0 = (tile % tiles_w) * TW;
  const int ih0 = oh0 * stride - pad;
  const int iw0 = ow0 * stride - pad;
  const float* xn = x + (size_t)n * H * W * Ci;
  // the halo's rows and columns inside the image
  const int vr0 = max(0, -ih0), vr1 = min(hh, H - ih0);
  const int vc0 = max(0, -iw0), vc1 = min(hw, W - iw0);
  const int vw = max(0, vc1 - vc0);
  const int VH = max(0, vr1 - vr0) * vw;

  // expand: thread = 4 halo pixels (pl + 32 i) x 4 channels (cg8 + 8 j)
  const int cg8 = t % 8;
  const int pl = t / 8;
  // staging: thread loads x channel xk of halo pixels xp + 16 r, and
  // expand weights channel wc of input channels wk + 8 r
  const int xk = t % KC;
  const int xp = t / KC;
  const int wc = t % CK;
  const int wk = t / CK;
  // project: thread = 4 pixels (ty + 16 i) x 4 channels (tx + 16 j)
  const int tx = t % 16;
  const int ty = t / 16;

  const int n_ci = repro_cdiv(Ci, KC);
  const int n_steps = repro_cdiv(VH, PP) * n_ci;

  // halo rows outside the image stay 0 for every chunk
  for (int idx = t; idx < HP * ES; idx += NT) es[idx] = 0.f;

  // 1. expand and dw of this block's chunks of Cm
  for (int lc = 0; lc < cpr; ++lc) {
    const int c0 = (rank * cpr + lc) * CK;
    if (c0 >= Cm) break;
    for (int idx = t; idx < KH * KW * CK; idx += NT) {
      const int k = idx % CK;
      const int q = idx / CK;
      const int gc = c0 + k;
      dww[q * CK + k] = gc < Cm ? dw_w[(size_t)q * Cm + gc] : 0.f;
    }
    // expand steps s = (pass over the valid halo, input-channel step);
    // the loads of step s are in flight while step s-1 computes
    float xr[XR], wr[WR];
    float ea[4][4] = {};
    for (int s = 0; s <= n_steps; ++s) {
      if (s > 0) {
#pragma unroll
        for (int r = 0; r < XR; ++r) xs[xk * XS + xp + 16 * r] = xr[r];
#pragma unroll
        for (int r = 0; r < WR; ++r) wes[(wk + 8 * r) * CK + wc] = wr[r];
        __syncthreads();
      }
      if (s < n_steps) {
        const int base = (s / n_ci) * PP;
        const int ci0 = (s % n_ci) * KC;
#pragma unroll
        for (int r = 0; r < XR; ++r) {
          const int v = base + xp + 16 * r;
          float val = 0.f;
          if (v < VH && ci0 + xk < Ci) {
            const int ih = ih0 + vr0 + v / vw;
            const int iw = iw0 + vc0 + v % vw;
            val = xn[((size_t)ih * W + iw) * Ci + ci0 + xk];
          }
          xr[r] = val;
        }
#pragma unroll
        for (int r = 0; r < WR; ++r) {
          const int gci = ci0 + wk + 8 * r;
          const int gc = c0 + wc;
          wr[r] =
              (gci < Ci && gc < Cm) ? exp_w[(size_t)gci * Cm + gc] : 0.f;
        }
      }
      if (s == 0) continue;
      const int sp = s - 1;               // the step in shared memory
#pragma unroll
      for (int k = 0; k < KC; ++k) {
        float a[4], b[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = xs[k * XS + pl + 32 * i];
#pragma unroll
        for (int j = 0; j < 4; ++j) b[j] = wes[k * CK + cg8 + 8 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) ea[i][j] = fmaf(a[i], b[j], ea[i][j]);
      }
      if (sp % n_ci == n_ci - 1) {        // a pass is done: its halo rows
        const int base = (sp / n_ci) * PP;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int v = base + pl + 32 * i;
          if (v < VH) {
            const int hp = (vr0 + v / vw) * hw + vc0 + v % vw;
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              const int c = cg8 + 8 * j;
              const int gc = c0 + c;
              float val = 0.f;
              if (gc < Cm) {
                val = ea[i][j];
                if (exp_b != nullptr) val += exp_b[gc];
                val = repro_act(val, exp_act);
              }
              es[hp * ES + c] = val;
            }
          }
#pragma unroll
          for (int j = 0; j < 4; ++j) ea[i][j] = 0.f;
        }
      }
      __syncthreads();
    }

    // 2. dw of the chunk over the expanded halo, into the slice
    for (int idx = t; idx < CK * P; idx += NT) {
      const int p = idx % P;
      const int k = idx / P;
      const int gc = c0 + k;
      float v = 0.f;
      if (gc < Cm) {
        const int ph = p / TW;
        const int pw = p % TW;
        float a = 0.f;
        for (int i = 0; i < KH; ++i)
          for (int j = 0; j < KW; ++j)
            a = fmaf(es[((ph * stride + i) * hw + pw * stride + j) * ES + k],
                     dww[(i * KW + j) * CK + k], a);
        if (dw_b != nullptr) a += dw_b[gc];
        v = repro_act(a, dw_act);
      }
      ds[(lc * CK + k) * P + p] = v;
    }
    __syncthreads();
  }

  cluster.sync();   // every slice of the dw map is written

  // 3. project this block's C_out tiles from every slice, peers in order
  const int n_co = repro_cdiv(Co, BN);
  for (int ct = rank; ct < n_co; ct += CL) {
    const int co0 = ct * BN;
    float acc[4][4] = {};
    for (int q = 0; q < CL; ++q) {
      const float* rds = cluster.map_shared_rank(ds, q);
      for (int lc = 0; lc < cpr; ++lc) {
        const int c0 = (q * cpr + lc) * CK;
        if (c0 >= Cm) break;
        for (int idx = t; idx < CK * P / 4; idx += NT)
          reinterpret_cast<float4*>(dsl)[idx] =
              reinterpret_cast<const float4*>(rds + lc * CK * P)[idx];
        for (int idx = t; idx < CK * BN; idx += NT) {
          const int nn = idx % BN;
          const int k = idx / BN;
          const int gc = c0 + k;
          const int gn = co0 + nn;
          wps[k * BN + nn] =
              (gc < Cm && gn < Co) ? proj_w[(size_t)gc * Co + gn] : 0.f;
        }
        __syncthreads();
#pragma unroll 8
        for (int k = 0; k < CK; ++k) {
          float a[4], b[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) a[i] = dsl[k * P + ty + 16 * i];
#pragma unroll
          for (int j = 0; j < 4; ++j) b[j] = wps[k * BN + tx + 16 * j];
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j)
              acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
        }
        __syncthreads();
      }
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
        if (proj_b != nullptr) v += proj_b[gn];
        v = repro_act(v, proj_act);
        if (res != nullptr) v += res[row + gn];
        out[row + gn] = v;
      }
    }
  }

  cluster.sync();   // no block leaves while a peer may read its slice
}

}  // namespace

extern "C" int repro_fused_pw_dw_pw_conv(
    const float* x, const float* exp_w, const float* exp_b,
    const float* dw_w, const float* dw_b, const float* proj_w,
    const float* proj_b, const float* res, float* out, int Nimg, int H,
    int W, int Ci, int Cm, int Co, int KH, int KW, int stride, int pad,
    int Ho, int Wo, int exp_act, int dw_act, int proj_act, void* stream) {
  if (Nimg <= 0 || Ho <= 0 || Wo <= 0 || Ci <= 0 || Cm <= 0 || Co <= 0 ||
      stride <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int n_chunks = repro_cdiv(Cm, CK);
  const int CL =
      n_chunks >= 8 ? 8 : n_chunks >= 4 ? 4 : n_chunks >= 2 ? 2 : 1;
  const int cpr = repro_cdiv(n_chunks, CL);
  const int hh = (TH - 1) * stride + KH;
  const int hw = (TW - 1) * stride + KW;
  const size_t smem = ((size_t)cpr * CK * P + CK * P + KC * XS + KC * CK +
                       (size_t)hh * hw * ES + KH * KW * CK + CK * BN) *
                      sizeof(float);
  if (smem > REPRO_MAX_SMEM) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = repro_smem_opt_in(fused_pw_dw_pw_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int tiles_w = repro_cdiv(Wo, TW);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(repro_cdiv(Ho, TH) * tiles_w, CL, Nimg);
  cfg.blockDim = dim3(NT);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = CL;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  if (cfg.gridDim.z > 65535)
    return static_cast<int>(cudaErrorInvalidConfiguration);
  err = cudaLaunchKernelEx(&cfg, fused_pw_dw_pw_kernel, x, exp_w, exp_b,
                           dw_w, dw_b, proj_w, proj_b, res, out, H, W, Ci,
                           Cm, Co, KH, KW, stride, pad, Ho, Wo, tiles_w, CL,
                           cpr, exp_act, dw_act, proj_act);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
