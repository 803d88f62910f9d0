// An empty kernel: a yardstick, not a port of any TPU kernel.  It does
// nothing, so its device time is the least any launch of the given grid
// takes on this card, and its time per back-to-back call the least the
// host's launch path takes.  chip_smoke.py times it beside the port's
// kernels, so a kernel of a few microseconds (rmsnorm at a decode step,
// say) can be judged against this floor rather than against its bytes
// bound alone.  The same kernel answers the card's occupancy for
// clusters (rt_max_active_clusters): how many clusters of a given size
// run at once when shared memory allows one block an SM, as it does for
// the wide attention bodies, whose split rules are fitted to it
// (tools/torch_split_sweep.py prints it).
#include "common.cuh"

namespace {

__global__ void empty_kernel() {}

}  // namespace

extern "C" int rt_empty(int blocks, int threads, void* stream) {
  if (blocks <= 0) return 0;
  empty_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}

// Clusters of `cluster` blocks of `threads` threads with `smem` bytes of
// dynamic shared memory each that the card holds at once, into *out.
extern "C" int rt_max_active_clusters(int cluster, int threads, int smem,
                                      int* out) {
  cudaError_t err = rt::allow_smem(empty_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = cluster;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  return static_cast<int>(
      cudaOccupancyMaxActiveClusters(out, empty_kernel, &cfg));
}
