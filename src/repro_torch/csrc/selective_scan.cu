// Mamba1 selective scan: for each (batch row b, channel d) and t = 0..T-1
//   h[s] = exp(dt[t] * a[d, s]) * h[s] + (dt[t] * x[t]) * B[t, s]
//   y[t] = sum_s h[s] * C[t, s]
// in f32, with h read from h0 before the first step and written to h_out
// after the last (h0 and h_out may be the same buffer: each thread reads
// and writes only the state elements it owns, so the update is in place).
//
// Replaces the TPU kernel src/repro/kernels/selective_scan.py::
// selective_scan_pallas (body _scan_kernel), i.e. the lax.scan of
// _mamba1_scan_step that the reference model runs in mamba1_seq (a prefill
// chunk, T = C) and mamba1_step (a decode step, T = 1).
//
// Two bodies (kernels/selective_scan.py::scan_body names the one a launch
// takes):
//
// * state_lanes (every launch the model makes).  Each (b, d) channel's
//   d_state values are split across G consecutive lanes of a warp
//   (G = 4, 8 or 16, kernels/selective_scan.py::scan_lanes), each lane
//   holding S consecutive states of h and a in registers across all T
//   steps: S = ceil(DS / G), rounded up to one of the instantiated
//   widths (up to 16 at G 4, 8 at G 8 and 4 at G 16, so d_state up to
//   64; lanes past DS hold zeros).  B and C are staged in rows of W = 16
//   floats where G * S <= 16 (every d_state up to 16, as falcon-mamba-7b
//   runs them) and of 64 otherwise (zamba2-7b's d_state 64).  Lanes run in (b, d, s) order, so a warp's loads
//   of h0 and a_neg and its store of h_out are whole contiguous segments
//   (16- or 8-byte vectors when G * S = DS).  The grid covers B * DI * G
//   threads in blocks of 128: a one-row prefill chunk (B 1, DI 8192) at
//   G 4 is 256 blocks, where the previous body had 64.  A decode step (T = 1) reads dt, x, B and C straight
//   from global memory with no barrier and sums y across the G lanes by
//   a __shfl_xor_sync tree.  A chunk stages dt and x for the block's
//   channels, and B and C for its row, a tile of 32 steps at a time,
//   coalesced along d, and fetches the next tile into registers while it
//   computes this one; each lane writes its share of y (its S products
//   summed in s order) to shared memory, and after the tile y is summed
//   over the lanes in lane order and stored coalesced along d, so the
//   step loop holds no shuffle chain.  Bound: bytes at a decode step (h
//   read and written is most of them); instruction issue over a chunk
//   (an accurate expf and five rounded products and adds per state
//   element and step, and the staged loads).
// * cuda_core (the previous body; d_state 1 to 16 and 64).  One thread
//   per (b, d) channel with all d_state values of h and a in its
//   registers; B and C staged a tile
//   of 32 steps at a time in shared memory, with two barriers a tile.  A
//   warp's state loads lie 64 bytes apart, and a one-row prefill chunk is
//   64 blocks of 128 threads on 132 SMs.
//
// Checkpoints (training: kernels/selective_scan.py::SelectiveScanFn).
// With a non-null ck, the state_lanes body also writes the state before
// every kCkptSteps = 32 steps, at the start of each staged tile (and
// before a decode step's one step), to ck (B, ceil(T / 32), DI, DS):
// one store of the lane's registers outside the step loop.  Serving
// passes null and launches the code it launched before.
//
// The backward (rt_selective_scan_backward; no TPU kernel: the reference
// differentiates its lax.scan with jax.grad).  For each (row b, channel
// d, state s), with a_t = exp(dt_t * A), the state gradient runs in
// reverse, g_t = C_t * dy_t + a_{t+1} * g_{t+1} from g = dh_T, and
//   dx_t   = dt_t * sum_s g_t * B_t
//   ddt_t  = sum_s g_t * (h_{t-1} * a_t * A + x_t * B_t)
//   dB_t   = sum_d g_t * dt_t * x_t,   dC_t = sum_d h_t * dy_t
//   dA     = sum_{b,t} g_t * h_{t-1} * a_t * dt_t,   dh0 = a_0 * g_0.
// It keeps the forward's lane layout with 4 states a lane (G = 1 to 16
// lanes a channel, 256 threads a block, a block 256 / G channels of one
// row) and walks the checkpoints' chunks of 32 steps in reverse.  A
// chunk's rows of B and C are staged in shared memory, coalesced, once
// for the block's channels (B as float for the recompute, B and C as
// double for the algebra, so no step converts them); its states are
// recomputed from the checkpoint (the forward's operations, so the
// forward's bits) once forward, keeping the first state of each
// sub-chunk of 4 steps (32 KB), then each sub-chunk's 4 states and decays
// again, into registers, and the sub-chunk is stepped back through, its
// dt, x and dy loaded up front.  The gradient algebra runs in double on
// the forward's float states and decays (each gradient sums terms that
// cancel: d(dt) sixteen to 64 states of g * (h * a * A + x * B), dB and
// dC thousands of channels, dA thousands of steps; two float sums of
// them in different orders differ by several 1e-5 of the result), and
// each gradient is rounded to float once.  dx and ddt are summed over the
// G lanes of a channel, and dB and dC over the channels of a warp, by
// shuffles that halve the values a lane holds each round (LaneSum: 8
// shuffles of doubles a step at G 16 where whole sums took 16), then dB
// and dC over the block's 8 warps in shared memory a sub-chunk at a time,
// one partial a block and step; dA stays in registers over t, one
// partial a row.  104 KB of shared
// memory a block at G 16, so two blocks (16 warps) an SM.  A second
// kernel sums the partials in double in a fixed order (blocks, then
// rows): no atomics, so the same inputs give the same bits.  Bound: the
// instructions issued (the forward's update is recomputed twice, and the
// backward's takes about twice its operations in double, with warp
// shuffles for every state and step); the partials of dB and dC are most
// of its bytes (PERF.md §6).
//
// The h update rounds each product and the sum separately (__fmul_rn,
// __fadd_rn, no fused multiply-add), as the plain PyTorch version and the
// reference do, and exp is the accurate expf, not __expf: the card's f32
// token streams must equal the CPU's.  Both bodies apply the same
// operations in the same order to each state element, so their h_T are
// bit-equal; only y's summation order over d_state differs.
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

// ---------------------------------------------------------------------------
// state_lanes body
// ---------------------------------------------------------------------------
constexpr int kLanesThreads = 128;   // threads per block: 128 / G channels
constexpr int kLanesTileT = 32;      // steps of dt, x, B, C and y staged
constexpr int kMaxState = 64;

// A lane's S consecutive states from p (n of them live, n <= S): 16-byte
// vectors (S a multiple of 4) or one 8-byte vector (S 2) when the caller
// found the rows whole and aligned.
template <int S>
__device__ __forceinline__ void load_lane(float (&v)[S], const float* p,
                                          int n, bool vec) {
  if constexpr (S % 4 == 0) {
    if (vec) {
#pragma unroll
      for (int j = 0; j < S; j += 4) {
        const float4 q = *reinterpret_cast<const float4*>(p + j);
        v[j] = q.x; v[j + 1] = q.y; v[j + 2] = q.z; v[j + 3] = q.w;
      }
      return;
    }
  } else if constexpr (S == 2) {
    if (vec) {
      const float2 q = *reinterpret_cast<const float2*>(p);
      v[0] = q.x; v[1] = q.y;
      return;
    }
  }
#pragma unroll
  for (int j = 0; j < S; ++j) v[j] = j < n ? p[j] : 0.f;
}

template <int S>
__device__ __forceinline__ void store_lane(float* p, const float (&v)[S],
                                           int n, bool vec) {
  if constexpr (S % 4 == 0) {
    if (vec) {
#pragma unroll
      for (int j = 0; j < S; j += 4)
        *reinterpret_cast<float4*>(p + j) =
            make_float4(v[j], v[j + 1], v[j + 2], v[j + 3]);
      return;
    }
  } else if constexpr (S == 2) {
    if (vec) {
      *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
      return;
    }
  }
#pragma unroll
  for (int j = 0; j < S; ++j)
    if (j < n) p[j] = v[j];
}

// One step of a lane's S states; returns the lane's share of y, its
// products summed in s order (states past DS hold h = a = 0, b = c = 0).
template <int S>
__device__ __forceinline__ float lane_step(float (&h)[S], const float (&a)[S],
                                           float dt_t, float dx,
                                           const float (&bv)[S],
                                           const float (&cv)[S]) {
  float part = 0.f;
#pragma unroll
  for (int j = 0; j < S; ++j) {
    const float decay = expf(__fmul_rn(dt_t, a[j]));
    h[j] = __fadd_rn(__fmul_rn(decay, h[j]), __fmul_rn(dx, bv[j]));
    part = __fadd_rn(part, __fmul_rn(h[j], cv[j]));
  }
  return part;
}

// y over the G lanes of a channel (consecutive lanes of one warp): every
// lane of the warp takes part, live or not.
template <int G>
__device__ __forceinline__ float lane_sum(float v) {
#pragma unroll
  for (int o = G / 2; o > 0; o >>= 1)
    v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// A lane's S staged values of B or C at step tt (the staged rows are
// zero past DS, and G * S <= W, so every lane reads inside the row).
template <int S>
__device__ __forceinline__ void lane_row(float (&v)[S], const float* row) {
  if constexpr (S % 4 == 0) {
#pragma unroll
    for (int j = 0; j < S; j += 4) {
      const float4 q = *reinterpret_cast<const float4*>(row + j);
      v[j] = q.x; v[j + 1] = q.y; v[j + 2] = q.z; v[j + 3] = q.w;
    }
  } else if constexpr (S == 2) {
    const float2 q = *reinterpret_cast<const float2*>(row);
    v[0] = q.x; v[1] = q.y;
  } else {
#pragma unroll
    for (int j = 0; j < S; ++j) v[j] = row[j];
  }
}

// The steps of one staged tile: each lane's share of y per step into
// sp[tt][thread].  A full tile (kFull) is unrolled whole with the shares
// held in registers and stored after the last step, so no shared store
// sits between one step's loads and the next and the compiler can
// overlap the exps of several steps with the h chain.  A partial tile
// (the end of a chunk of another length) runs step by step: unrolled
// whole as well, with a guard on each step, it doubles the kernel's code,
// and full 128-step chunks then ran slower between the model's other
// kernels on the H100, though as fast alone.
template <int G, int S, int W, bool kFull>
__device__ __forceinline__ void tile_steps(
    float (&h)[S], const float (&a)[S], int nt, int c, int s0,
    const float (*sb)[W], const float (*sc)[W],
    const float (*sdt)[kLanesThreads / G], const float (*sx)[kLanesThreads / G],
    float (*sp)[kLanesThreads]) {
  if constexpr (kFull) {
    float part[kLanesTileT];
#pragma unroll
    for (int tt = 0; tt < kLanesTileT; ++tt) {
      float bv[S], cv[S];
      lane_row<S>(bv, &sb[tt][s0]);
      lane_row<S>(cv, &sc[tt][s0]);
      const float dt_t = sdt[tt][c];
      const float dx = __fmul_rn(dt_t, sx[tt][c]);
      part[tt] = lane_step<S>(h, a, dt_t, dx, bv, cv);
    }
#pragma unroll
    for (int tt = 0; tt < kLanesTileT; ++tt) sp[tt][threadIdx.x] = part[tt];
  } else {
#pragma unroll 4
    for (int tt = 0; tt < nt; ++tt) {
      float bv[S], cv[S];
      lane_row<S>(bv, &sb[tt][s0]);
      lane_row<S>(cv, &sc[tt][s0]);
      const float dt_t = sdt[tt][c];
      const float dx = __fmul_rn(dt_t, sx[tt][c]);
      sp[tt][threadIdx.x] = lane_step<S>(h, a, dt_t, dx, bv, cv);
    }
  }
}

// Grid (ceil(DI / (128 / G)), B): a block is 128 / G consecutive channels
// of one batch row; thread = channel * G + lane.
template <int G, int S, bool kOneStep>
__global__ void __launch_bounds__(kLanesThreads)
scan_lanes_kernel(const float* __restrict__ dt, const float* __restrict__ bm,
                  const float* __restrict__ cm, const float* __restrict__ x,
                  const float* __restrict__ a_neg, const float* h0,
                  float* __restrict__ y, float* h_out,
                  float* __restrict__ ck, int T, int DI, int DS,
                  long long bc_sb, long long bc_st, bool vec) {
  constexpr int kChannels = kLanesThreads / G;
  const int b = blockIdx.y;
  const int c = threadIdx.x / G;            // channel within the block
  const int lane = threadIdx.x - c * G;
  const int d0 = blockIdx.x * kChannels;
  const int d = d0 + c;
  const bool live = d < DI;
  const int s0 = lane * S;                  // this lane's first state
  const int n = live ? max(0, min(S, DS - s0)) : 0;   // live states

  const long long hrow = (static_cast<long long>(b) * DI + d) * DS + s0;
  float h[S], a[S];
  load_lane<S>(h, h0 + hrow, n, vec && n == S);
  load_lane<S>(a, a_neg + static_cast<long long>(d) * DS + s0, n,
               vec && n == S);
  const float* bb = bm + b * bc_sb;
  const float* cb = cm + b * bc_sb;
  const long long row0 = static_cast<long long>(b) * T;
  const int n_ck = (T + kLanesTileT - 1) / kLanesTileT;
  // the state before step t0 (a multiple of 32) into checkpoint t0 / 32
  auto checkpoint = [&](int t0) {
    store_lane<S>(ck + ((static_cast<long long>(b) * n_ck + t0 / kLanesTileT)
                        * DI + d) * DS + s0,
                  h, n, vec && n == S);
  };

  if constexpr (kOneStep) {
    if (ck != nullptr) checkpoint(0);
    // a decode step: no staging, no barrier; y by a shuffle tree
    float bv[S], cv[S];
#pragma unroll
    for (int j = 0; j < S; ++j) {
      bv[j] = j < n ? bb[s0 + j] : 0.f;
      cv[j] = j < n ? cb[s0 + j] : 0.f;
    }
    const long long off = row0 * DI + d;
    const float dt_t = live ? dt[off] : 0.f;
    const float dx = __fmul_rn(dt_t, live ? x[off] : 0.f);
    const float yv = lane_sum<G>(lane_step<S>(h, a, dt_t, dx, bv, cv));
    if (live && lane == 0) y[off] = yv;
  } else {
    // a chunk: tiles of 32 steps staged in shared memory, the next tile
    // fetched into registers while this one is computed; each lane's
    // share of y goes to shared memory and is summed in lane order (so
    // in s order) after the tile, with no shuffle chain in the step loop
    // B and C staged in rows of 16 floats for d_state up to 16, else 64
    constexpr int kW = G * S <= 16 ? 16 : kMaxState;
    constexpr int kDX = kLanesTileT * kChannels / kLanesThreads;  // dt, x
    constexpr int kBC = kLanesTileT * kW / kLanesThreads;         // B, C
    __shared__ __align__(16) float sb[kLanesTileT][kW];
    __shared__ __align__(16) float sc[kLanesTileT][kW];
    __shared__ float sdt[kLanesTileT][kChannels];
    __shared__ float sx[kLanesTileT][kChannels];
    __shared__ __align__(16) float sp[kLanesTileT][kLanesThreads];
    const int nd = min(kChannels, DI - d0);   // live channels of the block
    float pdt[kDX], px[kDX], pb[kBC], pc[kBC];
    auto fetch = [&](int t0) {
      const int nt = min(kLanesTileT, T - t0);
#pragma unroll
      for (int k = 0; k < kDX; ++k) {
        const int i = threadIdx.x + k * kLanesThreads;
        const int tt = i / kChannels, cc = i - tt * kChannels;
        const long long off = (row0 + t0 + tt) * DI + d0 + cc;
        const bool ok = tt < nt && cc < nd;
        pdt[k] = ok ? dt[off] : 0.f;
        px[k] = ok ? x[off] : 0.f;
      }
#pragma unroll
      for (int k = 0; k < kBC; ++k) {
        const int i = threadIdx.x + k * kLanesThreads;
        const int tt = i / kW, s = i - tt * kW;
        const bool ok = tt < nt && s < DS;
        pb[k] = ok ? bb[(t0 + tt) * bc_st + s] : 0.f;
        pc[k] = ok ? cb[(t0 + tt) * bc_st + s] : 0.f;
      }
    };
    fetch(0);
    for (int t0 = 0; t0 < T; t0 += kLanesTileT) {
      const int nt = min(kLanesTileT, T - t0);
      // the previous tile's compute ended at a barrier, so its staged
      // inputs are free; its sp was summed before the barrier below
#pragma unroll
      for (int k = 0; k < kDX; ++k) {
        const int i = threadIdx.x + k * kLanesThreads;
        sdt[i / kChannels][i % kChannels] = pdt[k];
        sx[i / kChannels][i % kChannels] = px[k];
      }
#pragma unroll
      for (int k = 0; k < kBC; ++k) {
        const int i = threadIdx.x + k * kLanesThreads;
        sb[i / kW][i % kW] = pb[k];
        sc[i / kW][i % kW] = pc[k];
      }
      __syncthreads();
      if (t0 + kLanesTileT < T) fetch(t0 + kLanesTileT);
      if (ck != nullptr) checkpoint(t0);
      if (nt == kLanesTileT)
        tile_steps<G, S, kW, true>(h, a, nt, c, s0, sb, sc, sdt, sx, sp);
      else
        tile_steps<G, S, kW, false>(h, a, nt, c, s0, sb, sc, sdt, sx, sp);
      __syncthreads();
      for (int i = threadIdx.x; i < nt * kChannels; i += kLanesThreads) {
        const int tt = i / kChannels, cc = i - tt * kChannels;
        const float4* p = reinterpret_cast<const float4*>(&sp[tt][cc * G]);
        float acc = 0.f;
#pragma unroll
        for (int q = 0; q < G / 4; ++q) {   // lanes in order: 4 at a time
          const float4 v = p[q];
          acc = __fadd_rn(__fadd_rn(__fadd_rn(__fadd_rn(acc, v.x), v.y), v.z),
                          v.w);
        }
        if (cc < nd) y[(row0 + t0 + tt) * DI + d0 + cc] = acc;
      }
    }
  }
  store_lane<S>(h_out + hrow, h, n, vec && n == S);
}

template <int G, int S>
cudaError_t launch_lanes(const void* dt, const void* bm, const void* cm,
                         const void* x, const void* a_neg, const void* h0,
                         void* y, void* h_out, void* ck, int B, int T, int DI,
                         int DS, long long bc_sb, long long bc_st,
                         cudaStream_t stream) {
  constexpr int kChannels = kLanesThreads / G;
  // whole rows of G * S states and vector-aligned bases: vector loads
  // (16 bytes for S a multiple of 4, 8 for S 2); a null ck adds no bits
  const size_t bits = reinterpret_cast<size_t>(h0) |
                      reinterpret_cast<size_t>(h_out) |
                      reinterpret_cast<size_t>(a_neg) |
                      reinterpret_cast<size_t>(ck);
  const bool vec = (S == 2 || S % 4 == 0) && DS == G * S &&
                   (bits & (S == 2 ? 7 : 15)) == 0;
  const dim3 grid((DI + kChannels - 1) / kChannels, B);
  auto kernel = T == 1 ? scan_lanes_kernel<G, S, true>
                       : scan_lanes_kernel<G, S, false>;
  kernel<<<grid, kLanesThreads, 0, stream>>>(
      static_cast<const float*>(dt), static_cast<const float*>(bm),
      static_cast<const float*>(cm), static_cast<const float*>(x),
      static_cast<const float*>(a_neg), static_cast<const float*>(h0),
      static_cast<float*>(y), static_cast<float*>(h_out),
      static_cast<float*>(ck), T, DI, DS, bc_sb, bc_st, vec);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// backward
// ---------------------------------------------------------------------------
// tools/torch_scan_sweep.py --backward builds variants of the kernel by
// these macros, to time what sets its pace; the library takes the defaults.
#ifndef RT_BWD_REAL
#define RT_BWD_REAL double   // the gradient algebra's type
#endif
#ifndef RT_BWD_PART
#define RT_BWD_PART double   // the type of a block's partial of dB and dC
#endif
#ifndef RT_BWD_SMEM_PAD
#define RT_BWD_SMEM_PAD 0    // shared memory a block takes beyond its own
#endif
#ifndef RT_BWD_MIN_BLOCKS
#define RT_BWD_MIN_BLOCKS 2  // blocks an SM the registers are capped for
#endif
using BwdReal = RT_BWD_REAL;
using BwdPart = RT_BWD_PART;

constexpr int kBwdThreads = 256;   // a block: 256 / G channels of one row
constexpr int kBwdMinBlocks = RT_BWD_MIN_BLOCKS;
constexpr int kBwdS = 4;           // states a lane
constexpr int kCkptSteps = kLanesTileT;   // steps between two checkpoints
constexpr int kBwdSub = 4;         // steps a sub-chunk, held in registers
constexpr int kBwdSubs = kCkptSteps / kBwdSub;
constexpr int kBwdWarps = kBwdThreads / 32;

// A block's shared memory at G lanes a channel: the chunk's rows of B (as
// the recompute reads them) and of B and C (as the algebra does), each
// sub-chunk's first state, and the warps' sums of dB and dC for a
// sub-chunk's steps (104 KB at G 16, so two blocks an SM).
template <int G>
struct BwdSmem {
  static constexpr int W = G * kBwdS;
  float bf[kCkptSteps][W];
  BwdReal br[kCkptSteps][W];
  BwdReal cr[kCkptSteps][W];
  float hs[kBwdSubs][kBwdS][kBwdThreads];
  BwdReal red[kBwdSub][2][kBwdWarps][W];
};

template <int G>
constexpr size_t bwd_smem_bytes() {
  return sizeof(BwdSmem<G>) + RT_BWD_SMEM_PAD;
}

// Sums each of a lane's first N of V values over the lanes whose warp
// index differs from its own in bit O, then 2 O, .. up to E (exclusive),
// in a fixed order.  While a lane holds more than one value, a round
// halves them: the lane with the round's bit set keeps the upper half and
// sends the lower, its partner the reverse, each adding what it gets to
// what it keeps; with one value left, a round adds the partner's.  first
// counts the values below the ones the lane ends with.
template <int V, int N, int O, int E>
struct LaneSum {
  template <typename T>
  static __device__ __forceinline__ void run(T (&v)[V], int wl, int& first) {
    if constexpr (O < E) {
      constexpr int H = N > 1 ? N / 2 : 1;
      if constexpr (N > 1) {
        const bool hi = (wl & O) != 0;
#pragma unroll
        for (int k = 0; k < H; ++k) {
          const T send = hi ? v[k] : v[k + H];
          const T keep = hi ? v[k + H] : v[k];
          v[k] = keep + __shfl_xor_sync(0xffffffffu, send, O);
        }
        if (hi) first += H;
      } else {
        v[0] += __shfl_xor_sync(0xffffffffu, v[0], O);
      }
      LaneSum<V, H, 2 * O, E>::run(v, wl, first);
    }
  }
};

// Grid (nblk = ceil(DI / (256 / G)), B); thread = channel * G + lane, the
// lane holding states [lane * 4, lane * 4 + 4).  Lanes past DI or DS hold
// zeros and take part in every shuffle.
template <int G>
__global__ void __launch_bounds__(kBwdThreads, kBwdMinBlocks)
scan_backward_kernel(const float* __restrict__ dt, const float* __restrict__ bm,
                     const float* __restrict__ cm, const float* __restrict__ x,
                     const float* __restrict__ a_neg,
                     const float* __restrict__ ck,
                     const float* __restrict__ dy,
                     const float* __restrict__ dh_t,
                     float* __restrict__ ddt, float* __restrict__ dx,
                     float* __restrict__ dh0, BwdPart* __restrict__ part_b,
                     BwdPart* __restrict__ part_c, double* __restrict__ part_a,
                     int T, int DI, int DS, long long bc_sb, long long bc_st) {
  using R = BwdReal;
  constexpr int S = kBwdS, W = G * kBwdS, kChannels = kBwdThreads / G;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  BwdSmem<G>& sm = *reinterpret_cast<BwdSmem<G>*>(smem_raw);
  const int b = blockIdx.y;
  const int c = threadIdx.x / G;
  const int lane = threadIdx.x - c * G;
  const int d = blockIdx.x * kChannels + c;
  const bool live = d < DI;
  const int s0 = lane * S;
  const int n = live ? max(0, min(S, DS - s0)) : 0;
  const int warp = threadIdx.x / 32, wl = threadIdx.x % 32;
  const long long hrow = (static_cast<long long>(b) * DI + d) * DS + s0;

  float a[S];
  R ar[S], gn[S];   // A; the state gradient, carried over t
  double da[S];     // dA, summed over t
#pragma unroll
  for (int j = 0; j < S; ++j) {
    a[j] = j < n ? a_neg[static_cast<long long>(d) * DS + s0 + j] : 0.f;
    ar[j] = a[j];
    gn[j] = (j < n && dh_t != nullptr) ? dh_t[hrow + j] : 0.f;
    da[j] = 0.0;
  }
  const float* bb = bm + b * bc_sb;
  const float* cb = cm + b * bc_sb;
  const long long row0 = static_cast<long long>(b) * T;
  const long long prow = (static_cast<long long>(b) * gridDim.x + blockIdx.x)
                         * T;
  const int n_ck = (T + kCkptSteps - 1) / kCkptSteps;

  for (int ci = n_ck - 1; ci >= 0; --ci) {
    const int t0 = ci * kCkptSteps;
    const int nt = min(kCkptSteps, T - t0);
    const int nsub = (nt + kBwdSub - 1) / kBwdSub;
    // the chunk's rows of B and C, coalesced (zeros past nt and DS)
    __syncthreads();   // the previous chunk's rows are read
    for (int i = threadIdx.x; i < kCkptSteps * W; i += kBwdThreads) {
      const int tt = i / W, s = i - tt * W;
      const bool ok = tt < nt && s < DS;
      const float bv = ok ? bb[(t0 + tt) * bc_st + s] : 0.f;
      const float cv = ok ? cb[(t0 + tt) * bc_st + s] : 0.f;
      sm.bf[tt][s] = bv;
      sm.br[tt][s] = bv;
      sm.cr[tt][s] = cv;
    }
    __syncthreads();
    // the chunk's states forward from its checkpoint, as the forward
    // computes them, keeping each sub-chunk's first (every sub-chunk but
    // the last is whole)
    float h[S];
    const long long crow =
        ((static_cast<long long>(b) * n_ck + ci) * DI + d) * DS + s0;
#pragma unroll
    for (int j = 0; j < S; ++j) h[j] = j < n ? ck[crow + j] : 0.f;
    for (int k = 0; k < nsub; ++k) {
#pragma unroll
      for (int j = 0; j < S; ++j) sm.hs[k][j][threadIdx.x] = h[j];
      if (k == nsub - 1) break;
#pragma unroll
      for (int i = 0; i < kBwdSub; ++i) {
        const int tt = k * kBwdSub + i;
        const long long off = (row0 + t0 + tt) * DI + d;
        const float dt_t = live ? dt[off] : 0.f;
        const float dxv = __fmul_rn(dt_t, live ? x[off] : 0.f);
#pragma unroll
        for (int j = 0; j < S; ++j) {
          const float decay = expf(__fmul_rn(dt_t, a[j]));
          h[j] = __fadd_rn(__fmul_rn(decay, h[j]),
                           __fmul_rn(dxv, sm.bf[tt][s0 + j]));
        }
      }
    }
    // the sub-chunks in reverse: each one's states and decays recomputed
    // into registers, then stepped back through, the gradient algebra in
    // R on the forward's float states and decays
    for (int k = nsub - 1; k >= 0; --k) {
      const int tb = k * kBwdSub;
      const int ns = min(kBwdSub, nt - tb);
      float dtv[kBwdSub], xv[kBwdSub], dyv[kBwdSub];
#pragma unroll
      for (int i = 0; i < kBwdSub; ++i) {
        const bool ok = live && i < ns;
        const long long off = (row0 + t0 + tb + i) * DI + d;
        dtv[i] = ok ? dt[off] : 0.f;
        xv[i] = ok ? x[off] : 0.f;
        dyv[i] = ok ? dy[off] : 0.f;
      }
      float hv[kBwdSub + 1][S], dec[kBwdSub][S];
#pragma unroll
      for (int j = 0; j < S; ++j) hv[0][j] = sm.hs[k][j][threadIdx.x];
#pragma unroll
      for (int i = 0; i < kBwdSub; ++i) {
        const float dxv = __fmul_rn(dtv[i], xv[i]);
#pragma unroll
        for (int j = 0; j < S; ++j) {
          dec[i][j] = expf(__fmul_rn(dtv[i], a[j]));
          hv[i + 1][j] = __fadd_rn(__fmul_rn(dec[i][j], hv[i][j]),
                                   __fmul_rn(dxv, sm.bf[tb + i][s0 + j]));
        }
      }
#pragma unroll
      for (int i = kBwdSub - 1; i >= 0; --i) {
        if (i >= ns) continue;
        const int tt = tb + i;
        const R dtr = dtv[i], xr = xv[i], dyr = dyv[i];
        const R dtx = dtr * xr;
        R u[2] = {0, 0}, v[2 * S];   // (sum_s g B, ddt); (dB, dC) terms
#pragma unroll
        for (int j = 0; j < S; ++j) {
          const R bv = sm.br[tt][s0 + j], cv = sm.cr[tt][s0 + j];
          const R decay = dec[i][j];
          const R g = cv * dyr + gn[j];
          const R hda = static_cast<R>(hv[i][j]) * decay;
          u[0] += g * bv;
          u[1] += g * (hda * ar[j] + xr * bv);
          v[j] = g * dtx;
          v[S + j] = static_cast<R>(hv[i + 1][j]) * dyr;
          da[j] += g * hda * dtr;
          gn[j] = decay * g;
        }
        // over the G lanes of the channel: lane 0 ends with sum_s g B,
        // lane 1 with ddt (lane 0 with both at G 1)
        int fu = 0;
        LaneSum<2, 2, 1, G>::run(u, wl, fu);
        if (live && lane < 2) {
          const long long off = (row0 + t0 + tt) * DI + d;
#pragma unroll
          for (int k = 0; k < (G > 1 ? 1 : 2); ++k) {
            if (fu + k == 0)
              dx[off] = static_cast<float>(dtr * u[k]);
            else
              ddt[off] = static_cast<float>(u[k]);
          }
        }
        // over the channels of the warp: each lane ends with the warp's
        // sums of (2 S) >> rounds of the dB and dC terms of its states
        int fv = 0;
        LaneSum<2 * S, 2 * S, G, 32>::run(v, wl, fv);
        constexpr int kHeld = (2 * S * G) / 32 > 0 ? (2 * S * G) / 32 : 1;
        constexpr int kCopies = 32 - 8 * G > 0 ? 32 - 8 * G : 0;
        if ((wl & kCopies) == 0) {
#pragma unroll
          for (int k = 0; k < kHeld; ++k) {
            const int e = fv + k;
            sm.red[i][e / S][warp][s0 + e % S] = v[k];
          }
        }
      }
      __syncthreads();
      // the block's partial of each step's dB and dC: its warps in order
      for (int e = threadIdx.x; e < ns * 2 * W; e += kBwdThreads) {
        const int i = e / (2 * W), r = e - i * 2 * W;
        const int which = r / W, s = r - which * W;
        if (s >= DS) continue;
        R v = 0;
#pragma unroll
        for (int w = 0; w < kBwdWarps; ++w) v += sm.red[i][which][w][s];
        (which ? part_c : part_b)[(prow + t0 + tb + i) * DS + s] =
            static_cast<BwdPart>(v);
      }
      __syncthreads();   // red is free for the next sub-chunk
    }
  }
#pragma unroll
  for (int j = 0; j < S; ++j) {
    if (j < n) {
      dh0[hrow + j] = static_cast<float>(gn[j]);
      part_a[hrow + j] = da[j];
    }
  }
}

// dB, dC (B, T, DS): the row's block partials summed in block order; dA
// (DI, DS): the row partials summed in row order, in double, each rounded
// to float once.
__global__ void scan_backward_sum(const BwdPart* __restrict__ part_b,
                                  const BwdPart* __restrict__ part_c,
                                  const double* __restrict__ part_a,
                                  float* __restrict__ db,
                                  float* __restrict__ dc,
                                  float* __restrict__ da, int B, int T,
                                  int DI, int DS, int nblk) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  const long long row = static_cast<long long>(T) * DS;
  const long long n_bc = B * row;
  if (i < n_bc) {
    const long long b = i / row, r = i - b * row;
    double vb = 0.0, vc = 0.0;
    for (int k = 0; k < nblk; ++k) {
      const long long o = (b * nblk + k) * row + r;
      vb += part_b[o];
      vc += part_c[o];
    }
    db[i] = static_cast<float>(vb);
    dc[i] = static_cast<float>(vc);
  } else if (i < n_bc + static_cast<long long>(DI) * DS) {
    const long long j = i - n_bc;
    double v = 0.0;
    for (int b = 0; b < B; ++b)
      v += part_a[b * static_cast<long long>(DI) * DS + j];
    da[j] = static_cast<float>(v);
  }
}

template <int G>
cudaError_t launch_backward(const void* dt, const void* bm, const void* cm,
                            const void* x, const void* a_neg, const void* ck,
                            const void* dy, const void* dh_t, void* ddt,
                            void* db, void* dc, void* dx, void* da, void* dh0,
                            void* part_b, void* part_c, void* part_a, int B,
                            int T, int DI, int DS, long long bc_sb,
                            long long bc_st, int nblk, cudaStream_t stream) {
  constexpr size_t smem = bwd_smem_bytes<G>();
  static const cudaError_t opted =   // above 48 KB only by opting in
      rt::allow_smem(scan_backward_kernel<G>, smem);
  if (opted != cudaSuccess) return opted;
  if (nblk != (DI + kBwdThreads / G - 1) / (kBwdThreads / G))
    return cudaErrorInvalidValue;
  scan_backward_kernel<G><<<dim3(nblk, B), kBwdThreads, smem, stream>>>(
      static_cast<const float*>(dt), static_cast<const float*>(bm),
      static_cast<const float*>(cm), static_cast<const float*>(x),
      static_cast<const float*>(a_neg), static_cast<const float*>(ck),
      static_cast<const float*>(dy), static_cast<const float*>(dh_t),
      static_cast<float*>(ddt), static_cast<float*>(dx),
      static_cast<float*>(dh0), static_cast<BwdPart*>(part_b),
      static_cast<BwdPart*>(part_c), static_cast<double*>(part_a), T, DI, DS,
      bc_sb, bc_st);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const long long total = static_cast<long long>(B) * T * DS +
                          static_cast<long long>(DI) * DS;
  const int threads = 256;
  scan_backward_sum<<<static_cast<unsigned>((total + threads - 1) / threads),
                      threads, 0, stream>>>(
      static_cast<const BwdPart*>(part_b), static_cast<const BwdPart*>(part_c),
      static_cast<const double*>(part_a), static_cast<float*>(db),
      static_cast<float*>(dc), static_cast<float*>(da), B, T, DI, DS, nblk);
  return cudaGetLastError();
}

}  // namespace

// dt, x, y: (B, T, DI) contiguous f32; B and C: (B, T, DS) f32 with unit
// stride along DS and element strides bc_sb (batch) and bc_st (time), as a
// column slice of x_proj's output has; a_neg: (DI, DS); h0, h_out:
// (B, DI, DS), possibly the same buffer; ck (state_lanes only): null, or
// (B, ceil(T / 32), DI, DS) for the checkpoints.  DS from 1 to 64.  body:
// rt::kBodyStateLanes with lanes G = 4, 8 or 16, or rt::kBodyCudaCore
// (lanes unused; DS 1 to 16 and 64).
extern "C" int rt_selective_scan(const void* dt, const void* bm,
                                 const void* cm, const void* x,
                                 const void* a_neg, const void* h0, void* y,
                                 void* h_out, void* ck, int B, int T, int DI,
                                 int DS, long long bc_sb, long long bc_st,
                                 int body, int lanes, void* stream) {
  if (DS < 1 || DS > kMaxState) return static_cast<int>(cudaErrorInvalidValue);
  if (B <= 0 || DI <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (body == rt::kBodyStateLanes) {
    // states per lane: ceil(DS / G), up to the next instantiated width
    // (a d_state up to 16 takes the widths it always took)
    const int per = (DS + lanes - 1) / lanes;
#define RT_LANES_CASE(G, S)                                                  \
  if (lanes == G && per <= S)                                                \
    return static_cast<int>(launch_lanes<G, S>(dt, bm, cm, x, a_neg, h0, y,  \
                                               h_out, ck, B, T, DI, DS,      \
                                               bc_sb, bc_st, s));
    RT_LANES_CASE(4, 1) RT_LANES_CASE(4, 2) RT_LANES_CASE(4, 3)
    RT_LANES_CASE(4, 4) RT_LANES_CASE(4, 8) RT_LANES_CASE(4, 16)
    RT_LANES_CASE(8, 1) RT_LANES_CASE(8, 2) RT_LANES_CASE(8, 4)
    RT_LANES_CASE(8, 8) RT_LANES_CASE(16, 1) RT_LANES_CASE(16, 2)
    RT_LANES_CASE(16, 4)
#undef RT_LANES_CASE
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (body != rt::kBodyCudaCore || ck != nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
#define RT_SCAN_CASE(N)                                                      \
  case N:                                                                    \
    return static_cast<int>(launch<N>(dt, bm, cm, x, a_neg, h0, y, h_out, B, \
                                      T, DI, bc_sb, bc_st, s));
  switch (DS) {
    RT_SCAN_CASE(1) RT_SCAN_CASE(2) RT_SCAN_CASE(3) RT_SCAN_CASE(4)
    RT_SCAN_CASE(5) RT_SCAN_CASE(6) RT_SCAN_CASE(7) RT_SCAN_CASE(8)
    RT_SCAN_CASE(9) RT_SCAN_CASE(10) RT_SCAN_CASE(11) RT_SCAN_CASE(12)
    RT_SCAN_CASE(13) RT_SCAN_CASE(14) RT_SCAN_CASE(15) RT_SCAN_CASE(16)
    RT_SCAN_CASE(64)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef RT_SCAN_CASE
}

// The scan's gradient.  dt, x, dy, ddt, dx: (B, T, DI) contiguous f32; B
// and C as the forward takes them (bc_sb, bc_st); a_neg, da: (DI, DS);
// ck: (B, ceil(T / 32), DI, DS), the forward's checkpoints; dh_t (null
// for zero) and dh0: (B, DI, DS); db, dc: (B, T, DS) contiguous; part_b,
// part_c: (B, nblk, T, DS) and part_a (B, DI, DS), double scratch.
// lanes G = 1, 2, 4, 8 or 16 with G * 4 >= DS (kernels/selective_scan.py::
// bwd_lanes), nblk = ceil(DI / (256 / G)).
extern "C" int rt_selective_scan_backward(
    const void* dt, const void* bm, const void* cm, const void* x,
    const void* a_neg, const void* ck, const void* dy, const void* dh_t,
    void* ddt, void* db, void* dc, void* dx, void* da, void* dh0,
    void* part_b, void* part_c, void* part_a, int B, int T, int DI, int DS,
    long long bc_sb, long long bc_st, int lanes, int nblk, void* stream) {
  if (DS < 1 || DS > lanes * kBwdS || DS > kMaxState)
    return static_cast<int>(cudaErrorInvalidValue);
  if (B <= 0 || DI <= 0 || T <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define RT_BWD_CASE(G)                                                        \
  if (lanes == G)                                                             \
    return static_cast<int>(launch_backward<G>(                               \
        dt, bm, cm, x, a_neg, ck, dy, dh_t, ddt, db, dc, dx, da, dh0, part_b, \
        part_c, part_a, B, T, DI, DS, bc_sb, bc_st, nblk, s));
  RT_BWD_CASE(1) RT_BWD_CASE(2) RT_BWD_CASE(4) RT_BWD_CASE(8) RT_BWD_CASE(16)
#undef RT_BWD_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}

// The blocks of the backward kernel at lanes G a channel an SM of this
// card holds (registers and shared memory, from the occupancy calculator
// on the kernel itself), into *blocks, and its dynamic shared memory,
// into *smem.
extern "C" int rt_selective_scan_backward_occupancy(int lanes, int* blocks,
                                                    int* smem) {
#define RT_BWD_OCC(G)                                                        \
  if (lanes == G) {                                                          \
    *smem = static_cast<int>(bwd_smem_bytes<G>());                           \
    cudaError_t e = rt::allow_smem(scan_backward_kernel<G>, *smem);          \
    if (e == cudaSuccess)                                                    \
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(                     \
          blocks, scan_backward_kernel<G>, kBwdThreads, *smem);              \
    return static_cast<int>(e);                                              \
  }
  RT_BWD_OCC(1) RT_BWD_OCC(2) RT_BWD_OCC(4) RT_BWD_OCC(8) RT_BWD_OCC(16)
#undef RT_BWD_OCC
  return static_cast<int>(cudaErrorInvalidValue);
}
