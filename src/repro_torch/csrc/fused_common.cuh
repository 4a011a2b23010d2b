// Shared pieces of the fused-block kernels K4 (fused_dw_pw_conv.cu) and K5
// (fused_pw_dw_pw_conv.cu): the [pixel tile x Co] product's shape, the
// halo's staging and the cluster's epilogue over a pixel tile.  The generic
// pieces (cp.async staging, the 3xTF32 products, the rank-order reduction
// over distributed shared memory, the clustered launch) are tc_common.cuh's,
// shared with K1.
//
// The constants and layout formulas match
// src/repro_torch/kernels/fused_block/plan.py, which plans every call on
// the host; the C entry points refuse a shared-memory size that disagrees.
#pragma once

#include "tc_common.cuh"

namespace fused {

using namespace tc;

constexpr int CK = 16;        // channels a chunk (K4: C, K5: Cm)
constexpr int AS = CK + 4;    // row stride of a [pixel][CK] tile, floats
constexpr int NJ_MAX = 16;    // 8-wide n-tiles a warp holds (64 floats)

// The [tile x Co] product's shape: MT m-tiles of 16 rows; the 8 warps form
// MTP (1, 2 or 4) m-tile rows of WN warps, each warp NJ n-tiles of 8.  K4
// is compiled for NJ up to 1, 2, 4, 8 and 16 (nj_class), K5 for 4, 8, 16.
struct ProductShape {
  int MT, MTP, WN, NJ;
  __host__ __device__ ProductShape(int tp, int co) {
    MT = repro_cdiv(tp, 16);
    MTP = MT <= 1 ? 1 : MT <= 2 ? 2 : 4;
    WN = WARPS / MTP;
    NJ = repro_cdiv(repro_cdiv(co, 8), WN);
  }
};

// The compiled NJ a call takes: NJ rounded up to a power of two.
__host__ __device__ inline int nj_class(int nj) {
  return nj <= 1 ? 1 : nj <= 2 ? 2 : nj <= 4 ? 4 : nj <= 8 ? 8 : 16;
}

// weight row stride: Co rounded to 32, plus 8 (B fragments conflict-free)
__host__ __device__ inline int weight_stride(int co) {
  return round_up(co, 32) + 8;
}
// partial-sum row stride: float4 rows
__host__ __device__ inline int red_stride(int co) {
  return round_up(co, 8) + 4;
}

// This rank's chunks of CK channels: [ch0, ch1) of cdiv(C, CK).
__device__ __forceinline__ void rank_chunks(int channels, int cl, int rank,
                                            int& ch0, int& ch1) {
  rank_range(repro_cdiv(channels, CK), cl, rank, ch0, ch1);
}

// Stage QUADS quads of 4 floats of each halo row r < rows into dst (row
// stride ds) from base + rowoff[r]; a row with rowoff[r] < 0 lies outside
// the image and is zero, as is every float past `valid` in a row.  The
// offsets are computed once per block, so a step spends no divisions.
template <int QUADS>
__device__ __forceinline__ void stage_halo(float* dst, int ds, int rows,
                                           const int* rowoff,
                                           const float* base, int valid,
                                           bool vec, const float* safe) {
  for (int idx = threadIdx.x; idx < rows * QUADS; idx += NT) {
    const int r = idx / QUADS;
    const int q = 4 * (idx % QUADS);
    const int off = rowoff[r];
    const int v = off < 0 ? 0 : min(4, max(0, valid - q));
    cp_quad(dst + r * ds + q, base + (off < 0 ? 0 : off) + q, v, vec, safe);
  }
}

// The halo's row offsets in x (pixel * channels), -1 outside the image or
// past the halo's hh x hw pixels; rows up to `rows`.
__device__ __forceinline__ void halo_offsets(int* rowoff, int rows, int hh,
                                             int hw, int ih0, int iw0, int H,
                                             int W, int C) {
  for (int r = threadIdx.x; r < rows; r += NT) {
    const int ih = ih0 + r / hw, iw = iw0 + r % hw;
    rowoff[r] = r < hh * hw && ih >= 0 && ih < H && iw >= 0 && iw < W
                    ? (ih * W + iw) * C
                    : -1;
  }
}

// The cluster's epilogue over a th x tw pixel tile of image img: every
// block's partial [tile x Co] sums are in its `red` (row stride rs), and
// cluster_reduce_store sums them in rank order, adds the bias, applies
// act, adds the residual and stores.
__device__ __forceinline__ void cluster_epilogue(
    cg::cluster_group& cluster, float* red, int rs, int cl, int rank,
    int th, int tw, int oh0, int ow0, int Ho, int Wo, int Co, size_t img,
    const float* __restrict__ bias, const float* __restrict__ res,
    float* __restrict__ out, int act) {
  const bool vec4 = (Co & 3) == 0 && aligned16(out) &&
                    (res == nullptr || aligned16(res)) &&
                    (bias == nullptr || aligned16(bias));
  cluster_reduce_store(
      cluster, red, rs, cl, rank, th * tw, Co,
      [&](int p) -> long long {
        const int oh = oh0 + p / tw;
        const int ow = ow0 + p % tw;
        if (oh >= Ho || ow >= Wo) return -1;
        return static_cast<long long>(((img * Ho + oh) * Wo + ow) * Co);
      },
      vec4, bias, res, out, act);
}

}  // namespace fused
