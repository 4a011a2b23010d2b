// K4: depthwise KxK -> act -> pointwise 1x1 -> act (+ residual), f32 in and
// out, with the depthwise map kept on chip.
//
// Replaces the TPU kernel src/repro/kernels/fused_block/kernel.py
// `fused_dw_pw_conv` (bodies `_fused_dw_pw_kernel` and `_dw_tile`): the
// dw -> project pairs the dual-core runtime fuses inside one exec group
// (MobileNet v2 and v1 `balanced`) and the first block of MobileNet v2's
// fused forward.
//
// Bound on an H100: per output pixel the pw half does 2*C*Co operations
// against C input and Co output floats.  At the main path's shapes (batch
// 2) a call moves 0.1-3.2 MB and does 2-100 MFLOP: a few microseconds of
// bytes or operations at most.  What bounds it in practice is filling the
// card: on the late maps (7x7 to 28x28) there are few output pixels and
// many channels, so a design that gives each block a whole channel
// reduction leaves most of the 132 SMs idle (the first design ran 6 to 64
// blocks there) and walks up to 60 chunks serially.
//
// Design (the tiling is chosen per call on the host: plan.py's plan_k4):
//   * A thread-block cluster of CL blocks (up to 16) owns a th x tw tile
//     of output pixels of one image and all Co output channels; its
//     blocks split the input channels C in chunks of 16, rank r taking a
//     contiguous run.  Small tiles (7x2 .. 8x8) and the cluster put at
//     least one block on every SM where the shape allows it.
//   * Per chunk, cp.async stages the input halo of the tile (zero-filled
//     outside the image: no padded copy in device memory), the chunk's dw
//     weights and its 16 pw weight rows into a ring of 2-4 stages, so the
//     next chunks' loads are in flight while this one computes.
//   * Each dw value of the tile is computed once (f32 on the CUDA cores,
//     bias and act applied) into a [pixel][16] tile in shared memory; the
//     dw map never reaches device memory, which is the TPU kernel's point.
//   * The pw product [tile x 16] @ [16 x Co] runs on the tensor cores in
//     3xTF32 (fused_common.cuh), each warp holding up to 16 n-tiles of a
//     16-row m-tile in registers.
//   * The ranks' partial [tile x Co] sums meet over distributed shared
//     memory, added in rank order (no atomics, no second kernel), and the
//     epilogue adds the pw bias, act and the residual with 16-byte
//     stores; a cluster of one (the wide early maps) skips the cluster
//     barriers.
#include "fused_common.cuh"

namespace {

using namespace fused;

// KS: the dw window's size when it is KS x KS (3 on every path: its loops
// unroll), 0 for any KH x KW.  NJ: the n-tiles a warp may hold
// (nj_class of the call's).
template <int KS, int NJ>
__global__ void __launch_bounds__(NT, MIN_BLOCKS)
fused_dw_pw_kernel(const float* __restrict__ x,
                   const float* __restrict__ dw_w,
                   const float* __restrict__ dw_b,
                   const float* __restrict__ pw_w,
                   const float* __restrict__ pw_b,
                   const float* __restrict__ res, float* __restrict__ out,
                   int H, int W, int C, int Co, int KH_, int KW_,
                   int stride, int pad, int Ho, int Wo, int dw_act,
                   int pw_act, int th, int tw, int ns, int vec) {
  const int KH = KS ? KS : KH_;
  const int KW = KS ? KS : KW_;
  cg::cluster_group cluster = cg::this_cluster();
  extern __shared__ __align__(16) float smem[];
  const int cl = gridDim.x;                // cluster dims (cl, 1, 1)
  const int rank = blockIdx.x;
  const int tiles_w = repro_cdiv(Wo, tw);
  const int oh0 = (blockIdx.y / tiles_w) * th;
  const int ow0 = (blockIdx.y % tiles_w) * tw;
  const int n = blockIdx.z;
  const int ih0 = oh0 * stride - pad;
  const int iw0 = ow0 * stride - pad;
  const int hh = (th - 1) * stride + KH;
  const int hw = (tw - 1) * stride + KW;
  const int HP = hh * hw;
  const int KK = KH * KW;
  const int TP = th * tw;
  const ProductShape ps(TP, Co);
  const int BS = weight_stride(Co);
  const int STAGE = HP * AS + KK * CK + CK * BS;
  float* ds = smem + ns * STAGE;           // [MT*16][AS] dw values
  int* rowoff = reinterpret_cast<int*>(ds + ps.MT * 16 * AS);  // [HP]
  const float* xn = x + (size_t)n * H * W * C;

  const int warp = threadIdx.x >> 5;
  const int mt = warp % ps.MTP;            // this warp's m-tile
  const int nbase = warp / ps.MTP;         // ... and first n-tile
  // n-tiles nbase, nbase + WN, ... below cdiv(Co, 8): a ragged last row
  // of warps holds fewer
  const int nj = max(0, min(NJ, repro_cdiv(repro_cdiv(Co, 8) - nbase,
                                           ps.WN)));

  int ch0, ch1;
  rank_chunks(C, cl, rank, ch0, ch1);
  const bool vx = vec != 0;

  // the dw: a thread takes channel k of pixels pk, pk + 16, pk + 32, pk + 48
  const int k = threadIdx.x % CK;
  const int pk = threadIdx.x / CK;
  int xoff[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int p = pk + 16 * i;
    xoff[i] = ((p / tw) * stride * hw + (p % tw) * stride) * AS + k;
  }

  auto stage = [&](int ch, int buf) {
    float* xs = smem + buf * STAGE;        // [HP][AS]   input halo
    float* dww = xs + HP * AS;             // [KK][CK]   dw weights
    float* wp = dww + KK * CK;             // [CK][BS]   pw weight rows
    const int c0 = ch * CK;
    const int cv = min(CK, C - c0);
    stage_halo<CK / 4>(xs, AS, HP, rowoff, xn + c0, cv, vx, x);
    stage_rows(
        dww, CK, KK, CK,
        [&](int q) -> const float* { return dw_w + (size_t)q * C + c0; },
        [&](int) { return cv; }, vx, x);
    stage_rows(
        wp, BS, CK, round_up(Co, 8),
        [&](int r) -> const float* {
          return r < cv ? pw_w + (size_t)(c0 + r) * Co : nullptr;
        },
        [&](int) { return Co; }, vx, x);
  };

  halo_offsets(rowoff, HP, hh, hw, ih0, iw0, H, W, C);
  __syncthreads();

  // a ring of ns stages: chunks i + 1 .. i + ns - 1 are in flight while
  // chunk i computes.  Chunk i + ns - 1 is issued after the barrier that
  // ends chunk i - 1, into the stage chunk i - 1 has left.
  float acc[NJ][4] = {};
  const int nloc = ch1 - ch0;
  for (int j = 0; j < ns - 1; ++j) {
    if (j < nloc) stage(ch0 + j, j);
    cp_commit();
  }
  for (int i = 0; i < nloc; ++i) {
    cp_wait_n(ns - 2);                     // chunk i has landed
    __syncthreads();                       // ... for all; chunk i - 1 done
    if (i + ns - 1 < nloc) stage(ch0 + i + ns - 1, (i + ns - 1) % ns);
    cp_commit();
    const float* xs = smem + (i % ns) * STAGE;
    const float* dww = xs + HP * AS;
    const float* wp = dww + KK * CK;
    const int c0 = (ch0 + i) * CK;
    // dw of the chunk: every pixel of the tile once, f32
    {
      const bool live = c0 + k < C;
      const float bias = live && dw_b != nullptr ? dw_b[c0 + k] : 0.f;
      float a[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int r = 0; r < KH; ++r)
#pragma unroll
        for (int s = 0; s < KW; ++s) {
          const float wv = dww[(r * KW + s) * CK + k];
#pragma unroll
          for (int u = 0; u < 4; ++u)
            if (pk + 16 * u < TP)
              a[u] = fmaf(xs[xoff[u] + (r * hw + s) * AS], wv, a[u]);
        }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int p = pk + 16 * u;
        if (p < ps.MT * 16)
          ds[p * AS + k] =
              p < TP && live ? repro_act(a[u] + bias, dw_act) : 0.f;
      }
    }
    __syncthreads();
    // pw: [tile x 16] @ [16 x Co] on the tensor cores
    if (mt < ps.MT) {
#pragma unroll
      for (int ks = 0; ks < CK; ks += 8)
        mma_step(acc, ds + mt * 16 * AS + ks, AS, wp + ks * BS, BS, nbase,
                 ps.WN, nj);
    }
  }
  cp_wait<0>();
  __syncthreads();

  const int RS = red_stride(Co);
  float* red = smem;                       // [MT*16][RS], over the stages
  if (mt < ps.MT) store_partial(acc, red, RS, mt, nbase, ps.WN, nj);
  cluster_epilogue(cluster, red, RS, cl, rank, th, tw, oh0, ow0, Ho, Wo, Co,
                   n, pw_b, res, out, pw_act);
}

using Kernel = decltype(&fused_dw_pw_kernel<3, 1>);

// The kernel compiled for the call: 3x3 windows by NJ class, any other
// window at NJ 16.
Kernel pick(int KH, int KW, int nj) {
  if (KH != 3 || KW != 3) return fused_dw_pw_kernel<0, 16>;
  switch (nj_class(nj)) {
    case 1: return fused_dw_pw_kernel<3, 1>;
    case 2: return fused_dw_pw_kernel<3, 2>;
    case 4: return fused_dw_pw_kernel<3, 4>;
    case 8: return fused_dw_pw_kernel<3, 8>;
    default: return fused_dw_pw_kernel<3, 16>;
  }
}

// Shared memory in floats; plan.py's k4_smem_floats.
size_t smem_floats(int th, int tw, int Co, int KH, int KW, int stride,
                   int ns) {
  const int hh = (th - 1) * stride + KH;
  const int hw = (tw - 1) * stride + KW;
  const ProductShape ps(th * tw, Co);
  const size_t stage =
      (size_t)hh * hw * AS + KH * KW * CK + CK * weight_stride(Co);
  const size_t main =
      ns * stage + ps.MT * 16 * AS + round_up(hh * hw, 4);  // + row table
  const size_t red = (size_t)ps.MT * 16 * red_stride(Co);
  return main > red ? main : red;
}

}  // namespace

extern "C" int repro_fused_dw_pw_conv(
    const float* x, const float* dw_w, const float* dw_b, const float* pw_w,
    const float* pw_b, const float* res, float* out, int Nimg, int H, int W,
    int C, int Co, int KH, int KW, int stride, int pad, int Ho, int Wo,
    int dw_act, int pw_act, int th, int tw, int cl, int ns, int smem,
    int vec, void* stream) {
  if (Nimg <= 0 || Ho <= 0 || Wo <= 0 || C <= 0 || Co <= 0 || stride <= 0 ||
      th <= 0 || tw <= 0 || th * tw > 64 || cl > repro_cdiv(C, CK) ||
      ns < 2 || ns > MAX_STAGES)
    return static_cast<int>(cudaErrorInvalidValue);
  const ProductShape ps(th * tw, Co);
  if (ps.NJ > NJ_MAX ||
      (size_t)smem != 4 * smem_floats(th, tw, Co, KH, KW, stride, ns))
    return static_cast<int>(cudaErrorInvalidValue);
  const int tiles = repro_cdiv(Ho, th) * repro_cdiv(Wo, tw);
  return launch_clustered(pick(KH, KW, ps.NJ), cl, tiles, Nimg,
                          (size_t)smem, stream, false, x, dw_w, dw_b, pw_w,
                          pw_b,
                          res, out, H, W, C, Co, KH, KW, stride, pad, Ho, Wo,
                          dw_act, pw_act, th, tw, ns, vec);
}
