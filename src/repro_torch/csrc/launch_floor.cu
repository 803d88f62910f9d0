// An empty kernel: a yardstick, not a port of any TPU kernel.  It does
// nothing, so its device time is the least any launch of the given grid
// takes on this card, and its time per back-to-back call the least the
// host's launch path takes.  chip_smoke.py times it beside the port's
// kernels, so a kernel of a few microseconds (rmsnorm at a decode step,
// say) can be judged against this floor rather than against its bytes
// bound alone.
#include "common.cuh"

namespace {

__global__ void empty_kernel() {}

}  // namespace

extern "C" int rt_empty(int blocks, int threads, void* stream) {
  if (blocks <= 0) return 0;
  empty_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}
