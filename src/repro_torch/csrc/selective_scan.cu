// Mamba1 selective scan: for each (batch row b, channel d) and t = 0..T-1
//   h[s] = exp(dt[t] * a[d, s]) * h[s] + (dt[t] * x[t]) * B[t, s]
//   y[t] = sum_s h[s] * C[t, s]
// in f32, with h read from h0 before the first step and written to h_out
// after the last (h0 and h_out may be the same buffer: each thread reads
// and writes only its own channel's state, so the update is in place).
//
// Replaces the TPU kernel src/repro/kernels/selective_scan.py::
// selective_scan_pallas (body _scan_kernel), i.e. the lax.scan of
// _mamba1_scan_step that the reference model runs in mamba1_seq (a prefill
// chunk, T = C) and mamba1_step (a decode step, T = 1).
//
// Bound on the H100: bytes.  dt and x are read and y written once per
// (b, t, d), B and C once per (b, t), h twice per (b, d); the arithmetic is
// d_state multiply-adds and exps per element.  The Pallas kernel tiles a
// sequential grid axis over T chunks with h in VMEM scratch; here the
// recurrence runs in one thread per (b, d) channel instead, its d_state
// values of h and a in registers across all T steps, so h never leaves
// the chip between steps.  Threads of a block are consecutive channels,
// so the per-step loads of dt and x and the store of y are coalesced
// along d; B and C, shared by every channel of a batch row, are staged a
// tile of steps at a time in shared memory.  The grid is (ceil(DI/128), B):
// at a prefill chunk of one row (B = 1, DI = 8192) that is 64 blocks on
// 132 SMs; splitting d_state across lanes would fill more of the card.
//
// The h update rounds each product and the sum separately (__fmul_rn,
// __fadd_rn, no fused multiply-add), as the plain PyTorch version and the
// reference do, and exp is the accurate expf, not __expf: the card's f32
// token streams must equal the CPU's.
#include "common.cuh"

namespace {

constexpr int kThreads = 128;   // channels per block
constexpr int kTileT = 32;      // steps of B and C staged per tile

template <int DS>
__global__ void __launch_bounds__(kThreads)
selective_scan_kernel(const float* __restrict__ dt, const float* __restrict__ bm,
                      const float* __restrict__ cm, const float* __restrict__ x,
                      const float* __restrict__ a_neg, const float* h0,
                      float* __restrict__ y, float* h_out, int T, int DI,
                      long long bc_sb, long long bc_st) {
  __shared__ float sb[kTileT][DS];
  __shared__ float sc[kTileT][DS];
  const int b = blockIdx.y;
  const int d = blockIdx.x * kThreads + threadIdx.x;
  const bool live = d < DI;

  float h[DS], a[DS];
  if (live) {
    const float* hp = h0 + (static_cast<long long>(b) * DI + d) * DS;
    const float* ap = a_neg + static_cast<long long>(d) * DS;
#pragma unroll
    for (int s = 0; s < DS; ++s) {
      h[s] = hp[s];
      a[s] = ap[s];
    }
  }
  const float* bb = bm + b * bc_sb;
  const float* cb = cm + b * bc_sb;
  const long long row0 = static_cast<long long>(b) * T;

  for (int t0 = 0; t0 < T; t0 += kTileT) {
    const int nt = min(kTileT, T - t0);
    __syncthreads();   // the previous tile is consumed
    for (int i = threadIdx.x; i < nt * DS; i += kThreads) {
      const int tt = i / DS, s = i - tt * DS;
      sb[tt][s] = bb[(t0 + tt) * bc_st + s];
      sc[tt][s] = cb[(t0 + tt) * bc_st + s];
    }
    __syncthreads();
    if (live) {
#pragma unroll 4
      for (int tt = 0; tt < nt; ++tt) {
        const long long off = (row0 + t0 + tt) * DI + d;
        const float dt_t = dt[off];
        const float dx = __fmul_rn(dt_t, x[off]);
        float acc = 0.f;
#pragma unroll
        for (int s = 0; s < DS; ++s) {
          const float decay = expf(__fmul_rn(dt_t, a[s]));
          h[s] = __fadd_rn(__fmul_rn(decay, h[s]), __fmul_rn(dx, sb[tt][s]));
          acc = __fadd_rn(acc, __fmul_rn(h[s], sc[tt][s]));
        }
        y[off] = acc;
      }
    }
  }

  if (live) {
    float* hp = h_out + (static_cast<long long>(b) * DI + d) * DS;
#pragma unroll
    for (int s = 0; s < DS; ++s) hp[s] = h[s];
  }
}

template <int DS>
cudaError_t launch(const void* dt, const void* bm, const void* cm,
                   const void* x, const void* a_neg, const void* h0, void* y,
                   void* h_out, int B, int T, int DI, long long bc_sb,
                   long long bc_st, cudaStream_t stream) {
  const dim3 grid((DI + kThreads - 1) / kThreads, B);
  selective_scan_kernel<DS><<<grid, kThreads, 0, stream>>>(
      static_cast<const float*>(dt), static_cast<const float*>(bm),
      static_cast<const float*>(cm), static_cast<const float*>(x),
      static_cast<const float*>(a_neg), static_cast<const float*>(h0),
      static_cast<float*>(y), static_cast<float*>(h_out), T, DI, bc_sb,
      bc_st);
  return cudaGetLastError();
}

}  // namespace

// dt, x, y: (B, T, DI) contiguous f32; B and C: (B, T, DS) f32 with unit
// stride along DS and element strides bc_sb (batch) and bc_st (time), as a
// column slice of x_proj's output has; a_neg: (DI, DS); h0, h_out:
// (B, DI, DS), possibly the same buffer.  DS from 1 to 16.
extern "C" int rt_selective_scan(const void* dt, const void* bm,
                                 const void* cm, const void* x,
                                 const void* a_neg, const void* h0, void* y,
                                 void* h_out, int B, int T, int DI, int DS,
                                 long long bc_sb, long long bc_st,
                                 void* stream) {
  if (B <= 0 || DI <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define RT_SCAN_CASE(N)                                                      \
  case N:                                                                    \
    return static_cast<int>(launch<N>(dt, bm, cm, x, a_neg, h0, y, h_out, B, \
                                      T, DI, bc_sb, bc_st, s));
  switch (DS) {
    RT_SCAN_CASE(1) RT_SCAN_CASE(2) RT_SCAN_CASE(3) RT_SCAN_CASE(4)
    RT_SCAN_CASE(5) RT_SCAN_CASE(6) RT_SCAN_CASE(7) RT_SCAN_CASE(8)
    RT_SCAN_CASE(9) RT_SCAN_CASE(10) RT_SCAN_CASE(11) RT_SCAN_CASE(12)
    RT_SCAN_CASE(13) RT_SCAN_CASE(14) RT_SCAN_CASE(15) RT_SCAN_CASE(16)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef RT_SCAN_CASE
}
