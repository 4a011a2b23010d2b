// K5: pointwise expand -> act -> depthwise KxK -> act -> pointwise project
// -> act (+ residual), f32 in and out, with neither the expanded map nor
// the dw map in device memory.
//
// Replaces the TPU kernel src/repro/kernels/fused_block/kernel.py
// `fused_pw_dw_pw_conv` (body `_fused_pw_dw_pw_kernel`): the inverted
// residuals of MobileNet v2's fused forward and the pw -> dw -> pw chains
// the dual-core runtime fuses inside one exec group (MobileNet v1
// `balanced`).
//
// Bound on an H100: two 1x1 products (2*Ci*Cm and 2*Cm*Co operations a
// pixel) against one read of the block input and one write of its output.
// At the main path's shapes a call does 20-415 MFLOP against 0.3-5 MB: by
// the card's peaks, operations (a few microseconds).  As for K4, what
// bounds it in practice is filling the card: the late maps are small, the
// channels wide, and a cluster per 8x8 tile (the first design) ran 8-64
// blocks there, each walking its expand over every input channel alone.
//
// Design (the tiling is chosen per call on the host: plan.py's plan_k5):
//   * A thread-block cluster of CL blocks (up to 16) owns a th x tw tile
//     of output pixels of one image and all Co outputs; its blocks split
//     the expanded channels Cm in chunks of 16, rank r a contiguous run.
//   * Per pass of G chunks (G = 1, 2 or 4, the planner's choice), a block
//     expands the tile's input halo ((th-1)s+K by (tw-1)s+K pixels) to
//     those 16 G channels: [halo x Ci] @ [Ci x 16 G] on the tensor cores
//     in 3xTF32, Ci in steps of 32 or 64 staged by cp.async in a ring of
//     2-4 stages (the next steps' loads in flight while this one computes,
//     one barrier a step).  One staged halo serves G chunks, so the input
//     is read from L2 cdiv(Cm, 16 G) times per tile, not cdiv(Cm, 16).
//     Halo pixels outside the image hold ZERO after the expand's bias and
//     act, as the dw pads the expanded map (0, not act(exp_b)).
//   * Per chunk of the pass: the dw of the tile's pixels (f32, CUDA
//     cores), then the project [tile x 16] @ [16 x Co] on the tensor cores
//     into the block's partial sums, the chunk's dw weights and project
//     rows staged beside.  Each expand and dw value is computed once per
//     tile (recompute factor 1 across output channels); the expand covers
//     the halo, ((th-1)s+K)((tw-1)s+K) / (th tw s^2) times the tile's own
//     input pixels.
//   * The ranks' partial [tile x Co] sums meet over distributed shared
//     memory, added in rank order (no atomics, no second kernel), and the
//     epilogue adds the project bias, act and the residual.
// What still bounds it: where Ci and Cm are wide (MobileNet v1's 512) a
// block walks cdiv(Ci, KC) staged steps a pass, and those steps' latency
// and the halo's L2 traffic, not the products, set its time (PERF.md,
// PR 14).  A resident input halo or wgmma with TMA are the next designs to
// try.
#include "fused_common.cuh"

namespace {

using namespace fused;

// KC: input channels an expand step stages, 32 or 64 (halos of at most 128
// pixels, Ci above 64; of at most 64 pixels, only with G = 4); the staged
// halo rows have stride KC + 4.
constexpr int EMAX = 2;       // expand m-tiles a warp holds
constexpr int GMAX = 4;       // chunks one expand pass covers

// How the 8 warps share the expand's [halo x 16 G] product (G chunks of
// 16 expanded channels, G > 1 only for EM 0), by EM:
//   0  (at most 4 m-tiles)  warp w: m-tile w % 4, n-tile w / 4 of each chunk
//   1  (at most 8)          warp w: m-tile w, both n-tiles
//   2  (at most 16)         warp w: m-tiles w and w + 8, both n-tiles
template <int EM, int G>
struct ExpandShare {
  static_assert(EM == 0 || G == 1, "several chunks a pass only for EM 0");
  static constexpr int MT = EM == 0 ? 1 : EM;     // m-tiles a warp holds
  static constexpr int NN = EM == 0 ? G : 2;      // n-tiles a warp holds
  static constexpr int NSTRIDE = EM == 0 ? 2 : 1; // between its n-tiles
  // accumulator sets the k-steps alternate between: two where a warp
  // holds one n-tile (shorter chains), else one (registers)
  static constexpr int PAR = NN == 1 ? 2 : 1;
  __device__ static int m(int warp, int e) {
    return EM == 0 ? warp % 4 : warp + WARPS * e;
  }
  __device__ static int n0(int warp) { return EM == 0 ? warp / 4 : 0; }
};

// The EM a halo of hp pixels takes.
__host__ __device__ inline int expand_class(int hp) {
  const int mte = repro_cdiv(hp, 16);
  return mte <= 4 ? 0 : repro_cdiv(mte, WARPS);
}

// KS: the dw window's size when it is KS x KS (3 on every path: its loops
// unroll), 0 for any KH x KW.  NJ: the project n-tiles a warp may hold
// (nj_class of the call's).  EM: how the warps share the expand
// (ExpandShare, expand_class of the halo).  G: the chunks one expand pass
// covers, so the staged input halo serves G chunks.
template <int KS, int NJ, int EM, int KC, int G>
__global__ void __launch_bounds__(NT, MIN_BLOCKS)
fused_pw_dw_pw_kernel(const float* __restrict__ x,
                      const float* __restrict__ exp_w,
                      const float* __restrict__ exp_b,
                      const float* __restrict__ dw_w,
                      const float* __restrict__ dw_b,
                      const float* __restrict__ proj_w,
                      const float* __restrict__ proj_b,
                      const float* __restrict__ res, float* __restrict__ out,
                      int H, int W, int Ci, int Cm, int Co, int KH_,
                      int KW_, int stride, int pad, int Ho, int Wo,
                      int exp_act, int dw_act, int proj_act, int th, int tw,
                      int ns, int vec) {
  constexpr int XS = KC + 4;
  constexpr int EW = CK * G;                // expanded channels a pass
  constexpr int ES = EW + 4;                // row stride of the expanded halo
  constexpr int WES = EW + 8;               // row stride of expand weights
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
  const int MTE = repro_cdiv(HP, 16);      // expand m-tiles
  const int KK = KH * KW;
  const int TP = th * tw;
  const ProductShape ps(TP, Co);
  const int BS = weight_stride(Co);
  const int ESTAGE = MTE * 16 * XS + KC * WES;
  float* es = smem + ns * ESTAGE;          // [HP][ES]     expanded halo
  float* dww = es + HP * ES;               // [KK][CK]     dw weights
  float* ds = dww + KK * CK;               // [MT*16][AS]  dw values
  float* wp = ds + ps.MT * 16 * AS;        // [CK][BS]     project rows
  int* rowoff = reinterpret_cast<int*>(wp + CK * BS);  // [MTE*16]
  using Share = ExpandShare<EM, G>;
  const float* xn = x + (size_t)n * H * W * Ci;

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int mt = warp % ps.MTP;
  const int nbase = warp / ps.MTP;
  // n-tiles nbase, nbase + WN, ... below cdiv(Co, 8): a ragged last row
  // of warps holds fewer
  const int nj = max(0, min(NJ, repro_cdiv(repro_cdiv(Co, 8) - nbase,
                                           ps.WN)));

  int ch0, ch1;
  rank_chunks(Cm, cl, rank, ch0, ch1);
  const bool vx = vec != 0;
  const int n_ci = repro_cdiv(Ci, KC);

  auto in_image = [&](int hp) {
    const int ih = ih0 + hp / hw, iw = iw0 + hp % hw;
    return hp < HP && ih >= 0 && ih < H && iw >= 0 && iw < W;
  };
  // the expanded halo rows this thread writes: rows lane / 4 and
  // lane / 4 + 8 of its m-tiles; -1 past the halo, -2 - hp outside the
  // image (kept 0)
  int erow[Share::MT][2];
#pragma unroll
  for (int e = 0; e < Share::MT; ++e)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int hp = Share::m(warp, e) * 16 + (lane >> 2) + 8 * h;
      erow[e][h] = hp >= HP ? -1 : in_image(hp) ? hp : -2 - hp;
    }
  // the dw: a thread takes channel k of pixels pk, pk + 16, pk + 32, pk + 48
  const int k = threadIdx.x % CK;
  const int pk = threadIdx.x / CK;
  int eoff[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int p = pk + 16 * i;
    eoff[i] = ((p / tw) * stride * hw + (p % tw) * stride) * ES + k;
  }

  // expand step s of a pass from channel p0: the halo's input channels
  // [KC s, KC s + KC) and their expand weight columns [p0, p0 + 16 G)
  auto stage_expand = [&](int p0, int pv, int s, int buf) {
    float* xs = smem + buf * ESTAGE;       // [MTE*16][XS]
    float* we = xs + MTE * 16 * XS;        // [KC][WES]
    const int ci0 = s * KC;
    stage_halo<KC / 4>(xs, XS, MTE * 16, rowoff, xn + ci0, Ci - ci0, vx, x);
    stage_rows(
        we, WES, KC, EW,
        [&](int r) -> const float* {
          return ci0 + r < Ci ? exp_w + (size_t)(ci0 + r) * Cm + p0
                              : nullptr;
        },
        [&](int) { return pv; }, vx, x);
  };
  // a chunk's dw weights and project rows
  auto stage_chunk = [&](int c0, int cv) {
    stage_rows(
        dww, CK, KK, CK,
        [&](int q) -> const float* { return dw_w + (size_t)q * Cm + c0; },
        [&](int) { return cv; }, vx, x);
    stage_rows(
        wp, BS, CK, round_up(Co, 8),
        [&](int r) -> const float* {
          return r < cv ? proj_w + (size_t)(c0 + r) * Co : nullptr;
        },
        [&](int) { return Co; }, vx, x);
  };

  halo_offsets(rowoff, MTE * 16, hh, hw, ih0, iw0, H, W, Ci);
  __syncthreads();

  float acc[NJ][4] = {};
  for (int pc = ch0; pc < ch1; pc += G) {  // a pass: chunks pc .. pc+np-1
    const int np = min(G, ch1 - pc);
    const int p0 = pc * CK;
    const int pv = min(np * CK, Cm - p0);  // the pass's expanded channels
    // the first chunk's dw weights and project rows, in flight during
    // the expand
    stage_chunk(p0, min(CK, Cm - p0));
    cp_commit();

    // 1. expand the halo to the pass's 16 G channels, 3xTF32, through a
    // ring of ns stages: steps s + 1 .. s + ns - 1 are in flight while
    // step s computes.  Step s + ns - 1 is issued after the barrier that
    // ends step s - 1, into the stage step s - 1 has left.  The hi*hi and
    // the correction terms are summed apart.
    float eh[Share::PAR][Share::MT][Share::NN][4] = {};
    float el[Share::PAR][Share::MT][Share::NN][4] = {};
    for (int j = 0; j < ns - 1; ++j) {
      if (j < n_ci) stage_expand(p0, pv, j, j);
      cp_commit();
    }
    for (int s = 0; s < n_ci; ++s) {
      cp_wait_n(ns - 2);                   // step s (and the rows) landed
      __syncthreads();                     // ... for all; step s - 1 done
      if (s + ns - 1 < n_ci)
        stage_expand(p0, pv, s + ns - 1, (s + ns - 1) % ns);
      cp_commit();
      const float* xs = smem + (s % ns) * ESTAGE;
      const float* we = xs + MTE * 16 * XS;
#pragma unroll
      for (int e = 0; e < Share::MT; ++e) {
        const int m = Share::m(warp, e);
        if (m < MTE) {
#pragma unroll
          for (int ks = 0; ks < KC; ks += 8)
            mma_step_split(eh[(ks / 8) % Share::PAR][e],
                           el[(ks / 8) % Share::PAR][e],
                           xs + m * 16 * XS + ks, XS, we + ks * WES, WES,
                           Share::n0(warp), Share::NSTRIDE, Share::NN);
        }
      }
    }
    // the expanded halo: bias and act inside the image, 0 outside
#pragma unroll
    for (int e = 0; e < Share::MT; ++e)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int hp = erow[e][h];
        if (hp == -1 || Share::m(warp, e) >= MTE) continue;
#pragma unroll
        for (int j = 0; j < Share::NN; ++j)
#pragma unroll
          for (int u = 0; u < 2; ++u) {
            const int c = 8 * (Share::n0(warp) + Share::NSTRIDE * j) +
                          2 * (lane & 3) + u;
            float v = 0.f;
            if (hp >= 0 && c < pv) {
              const int f = 2 * h + u;
              float big = eh[0][e][j][f], small = el[0][e][j][f];
#pragma unroll
              for (int q = 1; q < Share::PAR; ++q) {
                big += eh[q][e][j][f];
                small += el[q][e][j][f];
              }
              v = big + small;
              if (exp_b != nullptr) v += exp_b[p0 + c];
              v = repro_act(v, exp_act);
            }
            es[(hp >= 0 ? hp : -2 - hp) * ES + c] = v;
          }
      }

    for (int j = 0; j < np; ++j) {
      const int c0 = p0 + j * CK;
      const int cv = min(CK, Cm - c0);
      if (j > 0) {                         // wp, dww free since the barrier
        stage_chunk(c0, cv);               // that ended chunk j - 1
        cp_commit();
      }
      cp_wait<0>();
      __syncthreads();

      // 2. dw of chunk j over its columns of the expanded halo, f32
      {
        const bool live = k < cv;
        const float bias = live && dw_b != nullptr ? dw_b[c0 + k] : 0.f;
        float a[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int r = 0; r < KH; ++r)
#pragma unroll
          for (int q = 0; q < KW; ++q) {
            const float wv = dww[(r * KW + q) * CK + k];
#pragma unroll
            for (int u = 0; u < 4; ++u)
              if (pk + 16 * u < TP)
                a[u] = fmaf(es[eoff[u] + (r * hw + q) * ES + j * CK], wv,
                            a[u]);
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

      // 3. project: [tile x 16] @ [16 x Co] into the partial sums, 3xTF32
      if (mt < ps.MT) {
#pragma unroll
        for (int ks = 0; ks < CK; ks += 8)
          mma_step(acc, ds + mt * 16 * AS + ks, AS, wp + ks * BS, BS, nbase,
                   ps.WN, nj);
      }
      __syncthreads();                     // es, ds and wp are free again
    }
  }

  const int RS = red_stride(Co);
  float* red = smem;                       // [MT*16][RS], over the stages
  if (mt < ps.MT) store_partial(acc, red, RS, mt, nbase, ps.WN, nj);
  cluster_epilogue(cluster, red, RS, cl, rank, th, tw, oh0, ow0, Ho, Wo, Co,
                   n, proj_b, res, out, proj_act);
}

using Kernel = decltype(&fused_pw_dw_pw_kernel<3, 4, 1, 32, 1>);

// The kernel compiled for the call, one of 22.  3x3 windows: by NJ class,
// 4 at the least (builds for 1 and 2 n-tiles a warp ran within noise of 4
// on every path), then by expand share, step and pass: EM 0 with KC 32 and
// G 1, 2 or 4, or KC 64 and G 4; EM 1 with KC 32 or 64; EM 2 with KC 32.
// Each of these was the fastest at some path shape, and no other pair was
// (PERF.md, PR 14, call 16).  Any other window: NJ 16, EM 2, KC 32, G 1.
template <int EM, int KC, int G>
Kernel pick_nj(int nj) {
  switch (nj_class(nj)) {
    case 1:
    case 2:
    case 4: return fused_pw_dw_pw_kernel<3, 4, EM, KC, G>;
    case 8: return fused_pw_dw_pw_kernel<3, 8, EM, KC, G>;
    default: return fused_pw_dw_pw_kernel<3, 16, EM, KC, G>;
  }
}

Kernel pick(int KH, int KW, int nj, int em, int kc, int g) {
  if (KH != 3 || KW != 3) return fused_pw_dw_pw_kernel<0, 16, EMAX, 32, 1>;
  if (em == 0) {
    if (kc == 64) return pick_nj<0, 64, GMAX>(nj);
    return g == 4   ? pick_nj<0, 32, 4>(nj)
           : g == 2 ? pick_nj<0, 32, 2>(nj)
                    : pick_nj<0, 32, 1>(nj);
  }
  if (em == 1)
    return kc == 64 ? pick_nj<1, 64, 1>(nj) : pick_nj<1, 32, 1>(nj);
  return pick_nj<2, 32, 1>(nj);
}

// Shared memory in floats; plan.py's k5_smem_floats.
size_t smem_floats(int th, int tw, int Co, int KH, int KW, int stride,
                   int ns, int KC, int G) {
  const int hh = (th - 1) * stride + KH;
  const int hw = (tw - 1) * stride + KW;
  const int HP = hh * hw;
  const ProductShape ps(th * tw, Co);
  const size_t estage =
      (size_t)repro_cdiv(HP, 16) * 16 * (KC + 4) + KC * (CK * G + 8);
  const size_t main = ns * estage + (size_t)HP * (CK * G + 4) +
                      KH * KW * CK + ps.MT * 16 * AS +
                      CK * weight_stride(Co) +
                      repro_cdiv(HP, 16) * 16;             // + row table
  const size_t red = (size_t)ps.MT * 16 * red_stride(Co);
  return main > red ? main : red;
}

}  // namespace

extern "C" int repro_fused_pw_dw_pw_conv(
    const float* x, const float* exp_w, const float* exp_b,
    const float* dw_w, const float* dw_b, const float* proj_w,
    const float* proj_b, const float* res, float* out, int Nimg, int H,
    int W, int Ci, int Cm, int Co, int KH, int KW, int stride, int pad,
    int Ho, int Wo, int exp_act, int dw_act, int proj_act, int th, int tw,
    int cl, int ns, int kc, int g, int smem, int vec, void* stream) {
  if (Nimg <= 0 || Ho <= 0 || Wo <= 0 || Ci <= 0 || Cm <= 0 || Co <= 0 ||
      stride <= 0 || th <= 0 || tw <= 0 || th * tw > 64 ||
      cl > repro_cdiv(Cm, CK) || ns < 2 || ns > MAX_STAGES)
    return static_cast<int>(cudaErrorInvalidValue);
  const int HP = ((th - 1) * stride + KH) * ((tw - 1) * stride + KW);
  const int em = expand_class(HP);
  const ProductShape ps(th * tw, Co);
  if (ps.NJ > NJ_MAX || em > EMAX || (kc != 32 && kc != 64) ||
      (kc == 64 && (em > 1 || KH != 3 || KW != 3 ||
                    (em == 0 && g != GMAX))) ||
      (g != 1 && g != 2 && g != GMAX) ||
      (g > 1 && (em != 0 || KH != 3 || KW != 3)) ||
      (size_t)smem !=
          4 * smem_floats(th, tw, Co, KH, KW, stride, ns, kc, g))
    return static_cast<int>(cudaErrorInvalidValue);
  const int tiles = repro_cdiv(Ho, th) * repro_cdiv(Wo, tw);
  return launch_clustered(pick(KH, KW, ps.NJ, em, kc, g), cl, tiles, Nimg,
                          (size_t)smem, stream, false, x, exp_w, exp_b, dw_w,
                          dw_b,
                          proj_w, proj_b, res, out, H, W, Ci, Cm, Co, KH, KW,
                          stride, pad, Ho, Wo, exp_act, dw_act, proj_act, th,
                          tw, ns, vec);
}
