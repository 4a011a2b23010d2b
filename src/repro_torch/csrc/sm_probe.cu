// The SM probe: which SMs a stream's work runs on.
//
// Not a port of a TPU kernel: it checks the c/p split of the card's SMs
// (kernels/green.py).  Each block holds an SM to itself (a block takes
// more than half of an SM's shared memory), spins for `spin` cycles so
// the launch's blocks spread over every SM the stream may use, and writes
// the SM it ran on (%smid) to out[block].  repro_sm_probe_clusters asks
// the occupancy calculator how many clusters of `cluster` probe blocks the
// stream's SMs hold at once.
#include <cuda_runtime.h>

namespace {

constexpr int PROBE_THREADS = 128;
constexpr size_t PROBE_SMEM = 160 * 1024;   // over half an SM's 228 KB

__global__ void sm_probe_kernel(int* out, long long spin) {
  extern __shared__ int scratch[];
  unsigned smid;
  asm volatile("mov.u32 %0, %%smid;" : "=r"(smid));
  const long long t0 = clock64();
  while (clock64() - t0 < spin) {
  }
  if (threadIdx.x == 0) {
    scratch[0] = static_cast<int>(smid);
    out[blockIdx.x] = scratch[0];
  }
}

int probe_attributes(bool wide) {
  cudaError_t err = cudaFuncSetAttribute(
      sm_probe_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(PROBE_SMEM));
  if (err == cudaSuccess && wide)
    err = cudaFuncSetAttribute(
        sm_probe_kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  return static_cast<int>(err);
}

}  // namespace

// `blocks` probe blocks of `spin` cycles each on `stream`, in clusters of
// `cluster` blocks (1: no cluster); out[b] is the SM block b ran on.
extern "C" int repro_sm_probe(int* out, int blocks, int cluster,
                              long long spin, void* stream) {
  if (blocks < 1 || cluster < 1 || cluster > 16 || blocks % cluster != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int rc = probe_attributes(cluster > 8);
  if (rc != 0) return rc;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks);
  cfg.blockDim = dim3(PROBE_THREADS);
  cfg.dynamicSmemBytes = PROBE_SMEM;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = cluster > 1 ? 1 : 0;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, sm_probe_kernel, out,
                                             spin);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// *count = the clusters of `cluster` probe blocks (one an SM) that the
// SMs of `stream` hold at once, by cudaOccupancyMaxActiveClusters.
extern "C" int repro_sm_probe_clusters(int cluster, int* count,
                                       void* stream) {
  if (cluster < 1 || cluster > 16)
    return static_cast<int>(cudaErrorInvalidValue);
  const int rc = probe_attributes(cluster > 8);
  if (rc != 0) return rc;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster);
  cfg.blockDim = dim3(PROBE_THREADS);
  cfg.dynamicSmemBytes = PROBE_SMEM;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return static_cast<int>(
      cudaOccupancyMaxActiveClusters(count, sm_probe_kernel, &cfg));
}
