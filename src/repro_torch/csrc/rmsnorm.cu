// K6: row RMSNorm, out = x * rsqrt(mean(x^2) + eps) * w, f32 throughout.
//
// Replaces the TPU kernel src/repro/kernels/rmsnorm/kernel.py `rmsnorm`
// (body `_rmsnorm_kernel`): one VMEM row block per grid step, the feature
// dim whole.
//
// Bound on an H100: about 4 FLOPs per element against 8 bytes (one read,
// one write), so bytes bound by far: the least time is the input read once
// plus the output written once (plus w) over 3.35 TB/s.  On the LM path a
// call moves 57 KB (16 decode rows) to 7.3 MB (1024 prefill rows), so it
// takes a few microseconds at most, and its launch and its memory round
// trips, not its bytes, set its time.  The design is shaped for that:
//   * A warp owns a row, so the sum of squares is a warp-shuffle reduction
//     with no shared memory and no block barrier.  For d <= 1024 and
//     d % 4 == 0 (the LM path's d = 896) each lane reads its share of the
//     row once with float4 loads into registers (at most 8 float4 a lane),
//     reduces, then scales and writes from the registers: x leaves device
//     memory once.
//   * w is read into registers first, beside x, so a call waits on one
//     memory round trip, not on x's and then w's.
//   * The launch is programmatic dependent (tc::launch_pdl) when the
//     caller says w is a weight no kernel writes (pdl = 1, serving): the
//     kernel may begin while the kernel before it in the stream drains.
//     It loads w and sets up, runs griddepcontrol.wait before its first
//     read of x, and runs griddepcontrol.launch_dependents once x is in
//     registers.  A kernel after it that reads its output either is
//     launched the plain way (the stream orders it) or runs
//     griddepcontrol.wait itself (K1).  In training the optimizer writes
//     every w, and the kernel before a K6 launch could be the one that
//     wrote it; so there (pdl = 0, the wrapper's choice wherever w
//     requires grad) the launch is plain and starts after every earlier
//     kernel of the stream; the backward below launches its rows pass
//     the plain way, and its dw pass reads only what the rows pass wrote,
//     after griddepcontrol.wait: no K6 launch reads a w that the kernel
//     it overlaps may write.
//
// Backward (repro_rmsnorm_bwd; no TPU counterpart: the reference trains
// through rmsnorm_ref and jax.grad).  With r = rsqrt(mean(x^2) + eps) and
// g = dy * w: dx = r g - x r^3 mean(g x), and dw = sum over rows of
// dy x r.  It reads x and dy once and writes dx: bytes bound, like the
// forward (the path's (4096, 896) moves 44 MB: 0.013 ms at 3.35 TB/s).
// Design, the forward's layout:
//   * A warp owns a row where d % 4 == 0 and d <= 1024 (the path's 896):
//     each lane keeps its float4s of x and dy in registers (7 each at
//     d = 896); w is read into registers once a warp, not once a row;
//     both sums (x^2 and g x) are shuffle reductions, with no block
//     barrier; each lane adds its columns' dy x r into registers across
//     the warp's rows.  A block's 8 warps take a contiguous run of rows,
//     at most one block an SM (kernel.py's bwd_blocks: 128 blocks of 32
//     rows on the path), and sum their partials in warp order through
//     shared memory into one partial row of dw a block.
//   * The cross-block sum of dw is a second kernel spread over the card:
//     a block takes 32 columns, its 8 warps contiguous runs of the
//     partial rows, each summed in order, then the runs in warp order (28
//     blocks at d = 896, about 16 partials a warp).  It is a programmatic
//     dependent launch (tc::launch_pdl) behind the rows pass and runs
//     griddepcontrol.wait before its first read; the rows pass itself is
//     launched the plain way.  No float atomics, so the bits repeat.
//   * Any other d (odd, or wider; 1023, 2560 and 8192 on the edges) takes
//     the general rows pass: a 256-thread block a row at a time, a
//     shared-memory reduction, each thread keeping up to 4 elements of x
//     and dy in registers and reading the rest again; up to 264 blocks.
// The forward's calls of up to 132 rows (a decode step's 16) take a block
// a row, so their rows spread over as many SMs; a longer one (a prefill's
// 1024) takes 4 rows a block; any other d takes one 256-thread block a
// row, a shared-memory reduction, each thread keeping up to 8 of its
// elements of x and w in registers (d <= 2048) and reading the rest
// again, from L2, for the scale.
// The sum runs in a fixed order per lane and per shuffle tree, so the
// result does not depend on the stream or the launch.
#include "tc_common.cuh"

namespace {

constexpr int MAX_VEC = 8;          // float4 a lane: d <= 32 * 4 * 8
constexpr int WIDE_ROWS = 4;        // rows (warps) a block past SPREAD rows
constexpr int SPREAD = 132;         // up to this many rows: a row a block
constexpr int GEN_THREADS = 256;
constexpr int GEN_REG = 8;          // elements a thread keeps: d <= 2048

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// the kernel before this one in the stream has finished and its writes
// are visible (a no-op for a launch without the programmatic attribute)
__device__ __forceinline__ void wait_for_producer() {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
}

// the next kernel in the stream may begin its launch
__device__ __forceinline__ void release_dependents() {
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
}

__global__ void __launch_bounds__(32 * WIDE_ROWS)
rmsnorm_vec_kernel(const float* __restrict__ x, const float* __restrict__ w,
                   float* __restrict__ out, int rows, int d, float eps) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  const int nv = d >> 2;   // float4 per row
  const float4* wr = reinterpret_cast<const float4*>(w);
  float4 g[MAX_VEC];
#pragma unroll
  for (int i = 0; i < MAX_VEC; ++i) {
    const int j = lane + 32 * i;
    if (j < nv) g[i] = wr[j];
  }
  wait_for_producer();
  if (row >= rows) return;
  const float4* xr = reinterpret_cast<const float4*>(x + (size_t)row * d);
  float4* orow = reinterpret_cast<float4*>(out + (size_t)row * d);
  float4 v[MAX_VEC];
#pragma unroll
  for (int i = 0; i < MAX_VEC; ++i) {
    const int j = lane + 32 * i;
    if (j < nv) v[i] = xr[j];
  }
  release_dependents();
  float ss = 0.f;
#pragma unroll
  for (int i = 0; i < MAX_VEC; ++i) {
    const int j = lane + 32 * i;
    if (j < nv) {
      ss = fmaf(v[i].x, v[i].x, ss);
      ss = fmaf(v[i].y, v[i].y, ss);
      ss = fmaf(v[i].z, v[i].z, ss);
      ss = fmaf(v[i].w, v[i].w, ss);
    }
  }
  ss = warp_sum(ss);
  const float r = rsqrtf(ss / (float)d + eps);
#pragma unroll
  for (int i = 0; i < MAX_VEC; ++i) {
    const int j = lane + 32 * i;
    if (j < nv)
      orow[j] = make_float4(v[i].x * r * g[i].x, v[i].y * r * g[i].y,
                            v[i].z * r * g[i].z, v[i].w * r * g[i].w);
  }
}

__global__ void __launch_bounds__(GEN_THREADS)
rmsnorm_general_kernel(const float* __restrict__ x,
                       const float* __restrict__ w, float* __restrict__ out,
                       int d, float eps) {
  __shared__ float part[GEN_THREADS / 32];
  const size_t row = blockIdx.x;
  const float* xr = x + row * d;
  float xv[GEN_REG], wv[GEN_REG];
#pragma unroll
  for (int i = 0; i < GEN_REG; ++i) {
    const int j = threadIdx.x + GEN_THREADS * i;
    wv[i] = j < d ? w[j] : 0.f;
  }
  wait_for_producer();
  float ss = 0.f;
#pragma unroll
  for (int i = 0; i < GEN_REG; ++i) {
    const int j = threadIdx.x + GEN_THREADS * i;
    xv[i] = j < d ? xr[j] : 0.f;
  }
#pragma unroll
  for (int i = 0; i < GEN_REG; ++i) ss = fmaf(xv[i], xv[i], ss);
  for (int j = threadIdx.x + GEN_THREADS * GEN_REG; j < d; j += GEN_THREADS)
    ss = fmaf(xr[j], xr[j], ss);
  release_dependents();
  ss = warp_sum(ss);
  if ((threadIdx.x & 31) == 0) part[threadIdx.x >> 5] = ss;
  __syncthreads();
  float tot = 0.f;
#pragma unroll
  for (int i = 0; i < GEN_THREADS / 32; ++i) tot += part[i];
  const float r = rsqrtf(tot / (float)d + eps);
#pragma unroll
  for (int i = 0; i < GEN_REG; ++i) {
    const int j = threadIdx.x + GEN_THREADS * i;
    if (j < d) out[row * d + j] = xv[i] * r * wv[i];
  }
  for (int j = threadIdx.x + GEN_THREADS * GEN_REG; j < d; j += GEN_THREADS)
    out[row * d + j] = xr[j] * r * w[j];
}

constexpr int BWD_THREADS = 256;
constexpr int BWD_WARPS = BWD_THREADS / 32;
constexpr int BWD_REG = 4;          // the general path: elements a thread
                                    // keeps, d <= 1024
constexpr int DW_COLS = 32;         // the dw pass: columns a block, a lane
constexpr int DW_WARPS = 8;         // ... each; its warps split the partials

// The warp-per-row rows pass (d % 4 == 0, d <= 1024, 16-byte aligned):
// rows [blockIdx.x * per, +per), warp w taking rows w, w + 8, ... of them.
// A lane keeps its float4s of w (read once), x and dy in registers and
// its columns' dw partial across the warp's rows; both row sums are
// shuffle reductions.  The block's partial dw, its warps' summed in warp
// order through shared memory, goes to part[blockIdx.x][:].
__global__ void __launch_bounds__(BWD_THREADS)
rmsnorm_bwd_vec_kernel(const float* __restrict__ x,
                       const float* __restrict__ w,
                       const float* __restrict__ dy, float* __restrict__ dx,
                       float* __restrict__ part, int rows, int d, int per,
                       float eps) {
  extern __shared__ float4 acc_s[];            // [BWD_WARPS][d / 4]
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nv = d >> 2;
  const int r0 = blockIdx.x * per, r1 = min(rows, r0 + per);
  const float4* w4 = reinterpret_cast<const float4*>(w);
  float4 wv[MAX_VEC], acc[MAX_VEC];
#pragma unroll
  for (int i = 0; i < MAX_VEC; ++i) {
    const int j = lane + 32 * i;
    acc[i] = make_float4(0.f, 0.f, 0.f, 0.f);
    if (j < nv) wv[i] = w4[j];
  }
  for (int row = r0 + warp; row < r1; row += BWD_WARPS) {
    const float4* xr = reinterpret_cast<const float4*>(x + (size_t)row * d);
    const float4* gr = reinterpret_cast<const float4*>(dy + (size_t)row * d);
    float4 xv[MAX_VEC], gv[MAX_VEC];
#pragma unroll
    for (int i = 0; i < MAX_VEC; ++i) {
      const int j = lane + 32 * i;
      if (j < nv) {
        xv[i] = xr[j];
        gv[i] = gr[j];
      }
    }
    float ss = 0.f, dot = 0.f;
#pragma unroll
    for (int i = 0; i < MAX_VEC; ++i) {
      if (lane + 32 * i < nv) {
        ss = fmaf(xv[i].x, xv[i].x, ss);
        ss = fmaf(xv[i].y, xv[i].y, ss);
        ss = fmaf(xv[i].z, xv[i].z, ss);
        ss = fmaf(xv[i].w, xv[i].w, ss);
        dot = fmaf(gv[i].x * wv[i].x, xv[i].x, dot);
        dot = fmaf(gv[i].y * wv[i].y, xv[i].y, dot);
        dot = fmaf(gv[i].z * wv[i].z, xv[i].z, dot);
        dot = fmaf(gv[i].w * wv[i].w, xv[i].w, dot);
      }
    }
    ss = warp_sum(ss);
    dot = warp_sum(dot);
    const float r = rsqrtf(ss / (float)d + eps);
    const float c = r * r * r * (dot / (float)d);
    float4* dxr = reinterpret_cast<float4*>(dx + (size_t)row * d);
#pragma unroll
    for (int i = 0; i < MAX_VEC; ++i) {
      const int j = lane + 32 * i;
      if (j < nv) {
        const float4 a = xv[i], g = gv[i], ww = wv[i];
        dxr[j] = make_float4(g.x * ww.x * r - a.x * c,
                             g.y * ww.y * r - a.y * c,
                             g.z * ww.z * r - a.z * c,
                             g.w * ww.w * r - a.w * c);
        acc[i].x = fmaf(g.x * a.x, r, acc[i].x);
        acc[i].y = fmaf(g.y * a.y, r, acc[i].y);
        acc[i].z = fmaf(g.z * a.z, r, acc[i].z);
        acc[i].w = fmaf(g.w * a.w, r, acc[i].w);
      }
    }
  }
  release_dependents();
#pragma unroll
  for (int i = 0; i < MAX_VEC; ++i) {
    const int j = lane + 32 * i;
    if (j < nv) acc_s[warp * nv + j] = acc[i];
  }
  __syncthreads();
  float4* p4 = reinterpret_cast<float4*>(part + (size_t)blockIdx.x * d);
  for (int j = threadIdx.x; j < nv; j += BWD_THREADS) {
    float4 t = acc_s[j];
#pragma unroll
    for (int q = 1; q < BWD_WARPS; ++q) {
      const float4 u = acc_s[q * nv + j];
      t.x += u.x, t.y += u.y, t.z += u.z, t.w += u.w;
    }
    p4[j] = t;
  }
}

// The general rows pass (any other d): rows [blockIdx.x * per, +per) of
// dx, one row at a time across the block, and the block's partial dw (the
// sum of dy x r over those rows) into part[blockIdx.x][:].
__global__ void __launch_bounds__(BWD_THREADS)
rmsnorm_bwd_rows_kernel(const float* __restrict__ x,
                        const float* __restrict__ w,
                        const float* __restrict__ dy, float* __restrict__ dx,
                        float* __restrict__ part, int rows, int d, int per,
                        float eps) {
  extern __shared__ float acc[];               // [d] the block's dw
  __shared__ float red[2][BWD_WARPS];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r0 = blockIdx.x * per, r1 = min(rows, r0 + per);
  for (int j = threadIdx.x; j < d; j += BWD_THREADS) acc[j] = 0.f;
  for (int row = r0; row < r1; ++row) {
    const float* xr = x + (size_t)row * d;
    const float* dyr = dy + (size_t)row * d;
    float xv[BWD_REG], dv[BWD_REG];
    float ss = 0.f, dot = 0.f;
#pragma unroll
    for (int i = 0; i < BWD_REG; ++i) {
      const int j = threadIdx.x + BWD_THREADS * i;
      xv[i] = j < d ? xr[j] : 0.f;
      dv[i] = j < d ? dyr[j] : 0.f;
    }
#pragma unroll
    for (int i = 0; i < BWD_REG; ++i) {
      const int j = threadIdx.x + BWD_THREADS * i;
      const float g = j < d ? dv[i] * w[j] : 0.f;
      ss = fmaf(xv[i], xv[i], ss);
      dot = fmaf(g, xv[i], dot);
    }
    for (int j = threadIdx.x + BWD_THREADS * BWD_REG; j < d;
         j += BWD_THREADS) {
      const float xx = xr[j];
      ss = fmaf(xx, xx, ss);
      dot = fmaf(dyr[j] * w[j], xx, dot);
    }
    ss = warp_sum(ss);
    dot = warp_sum(dot);
    if (lane == 0) {
      red[0][warp] = ss;
      red[1][warp] = dot;
    }
    __syncthreads();
    float tss = 0.f, tdot = 0.f;
#pragma unroll
    for (int i = 0; i < BWD_WARPS; ++i) {
      tss += red[0][i];
      tdot += red[1][i];
    }
    __syncthreads();                           // red is free for the next row
    const float r = rsqrtf(tss / (float)d + eps);
    const float c = r * r * r * (tdot / (float)d);
    float* dxr = dx + (size_t)row * d;
#pragma unroll
    for (int i = 0; i < BWD_REG; ++i) {
      const int j = threadIdx.x + BWD_THREADS * i;
      if (j < d) {
        dxr[j] = dv[i] * w[j] * r - xv[i] * c;
        acc[j] = fmaf(dv[i] * xv[i], r, acc[j]);
      }
    }
    for (int j = threadIdx.x + BWD_THREADS * BWD_REG; j < d;
         j += BWD_THREADS) {
      const float xx = xr[j], dd = dyr[j];
      dxr[j] = dd * w[j] * r - xx * c;
      acc[j] = fmaf(dd * xx, r, acc[j]);
    }
  }
  release_dependents();
  for (int j = threadIdx.x; j < d; j += BWD_THREADS)
    part[(size_t)blockIdx.x * d + j] = acc[j];
}

// The dw pass: dw[j] = the blocks' partials of column j.  A block takes
// DW_COLS columns, a lane each; its warps take contiguous runs of the
// partial rows (tc::rank_range), each summed in row order, then warp 0
// sums the runs in warp order: a fixed tree.  Launched as a programmatic
// dependent of the rows pass: it waits for it before its first read.
__global__ void __launch_bounds__(32 * DW_WARPS)
rmsnorm_dw_kernel(const float* __restrict__ part, float* __restrict__ dw,
                  int blocks, int d) {
  __shared__ float red[DW_WARPS][DW_COLS];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int j = blockIdx.x * DW_COLS + lane;
  int b0, b1;
  tc::rank_range(blocks, DW_WARPS, warp, b0, b1);
  wait_for_producer();
  float s = 0.f;
  if (j < d) {
#pragma unroll 4
    for (int b = b0; b < b1; ++b) s += part[(size_t)b * d + j];
  }
  red[warp][lane] = s;
  __syncthreads();
  if (warp == 0 && j < d) {
    float t = red[0][lane];
#pragma unroll
    for (int q = 1; q < DW_WARPS; ++q) t += red[q][lane];
    dw[j] = t;
  }
}

}  // namespace

// pdl: w is a weight that no kernel writes, so the launch may overlap the
// kernel before it (see the header); 0 launches the plain way.
extern "C" int repro_rmsnorm(const float* x, const float* w, float* out,
                             int rows, int d, float eps, int pdl,
                             void* stream) {
  if (rows <= 0 || d <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const bool aligned =
      ((reinterpret_cast<size_t>(x) | reinterpret_cast<size_t>(w) |
        reinterpret_cast<size_t>(out)) & 15) == 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d % 4 == 0 && d <= 32 * 4 * MAX_VEC && aligned) {
    const int per = rows <= SPREAD ? 1 : WIDE_ROWS;
    if (pdl)
      return tc::launch_pdl(rmsnorm_vec_kernel, repro_cdiv(rows, per),
                            32 * per, 0, stream, x, w, out, rows, d, eps);
    rmsnorm_vec_kernel<<<repro_cdiv(rows, per), 32 * per, 0, s>>>(
        x, w, out, rows, d, eps);
    return static_cast<int>(cudaGetLastError());
  }
  if (pdl)
    return tc::launch_pdl(rmsnorm_general_kernel, rows, GEN_THREADS, 0,
                          stream, x, w, out, d, eps);
  rmsnorm_general_kernel<<<rows, GEN_THREADS, 0, s>>>(x, w, out, d, eps);
  return static_cast<int>(cudaGetLastError());
}

// blocks: row blocks (kernel.py's bwd_blocks), each cdiv(rows, blocks)
// rows; part: [blocks][d] scratch for their partial dw.  Two launches on
// `stream`: the rows pass, the plain way (it starts after every earlier
// kernel), then the dw pass, a programmatic dependent that waits for it.
extern "C" int repro_rmsnorm_bwd(const float* x, const float* w,
                                 const float* dy, float* dx, float* part,
                                 float* dw, int rows, int d, int blocks,
                                 float eps, void* stream) {
  if (rows <= 0 || d <= 0 || blocks <= 0 || blocks > rows)
    return static_cast<int>(cudaErrorInvalidValue);
  const bool vec =
      d % 4 == 0 && d <= 32 * 4 * MAX_VEC &&
      ((reinterpret_cast<size_t>(x) | reinterpret_cast<size_t>(w) |
        reinterpret_cast<size_t>(dy) | reinterpret_cast<size_t>(dx) |
        reinterpret_cast<size_t>(part)) & 15) == 0;
  const size_t smem =
      vec ? sizeof(float) * (size_t)BWD_WARPS * d : sizeof(float) * (size_t)d;
  if (smem > REPRO_MAX_SMEM)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto rows_kernel =
      vec ? rmsnorm_bwd_vec_kernel : rmsnorm_bwd_rows_kernel;
  const int rc = tc::opt_in(rows_kernel, smem, false);
  if (rc != 0) return rc;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  rows_kernel<<<blocks, BWD_THREADS, smem, s>>>(
      x, w, dy, dx, part, rows, d, repro_cdiv(rows, blocks), eps);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return tc::launch_pdl(rmsnorm_dw_kernel, repro_cdiv(d, DW_COLS),
                        32 * DW_WARPS, 0, stream, (const float*)part, dw,
                        blocks, d);
}
