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
// lanes a channel, 128 threads a block, a block 128 / G channels of one
// row) and walks the checkpoints' chunks of 32 steps in reverse: each
// chunk's states are recomputed from its checkpoint (the forward's
// operations, so the forward's bits) into shared memory (128 threads x
// 32 steps x 4 states x 4 B = 64 KB), then the chunk is stepped back
// through.  The gradient algebra runs in double on the forward's float
// states and decays (each gradient sums terms that cancel: d(dt) sixteen
// to 64 states of g * (h * a * A + x * B), dB and dC thousands of
// channels, dA thousands of steps; two float sums of them in different
// orders differ by several 1e-5 of the result), and each gradient is
// rounded to float once.  dx and ddt are summed over the G lanes of a
// channel by shuffles; dB and dC over the channels of a warp by shuffles,
// then over the block's 4 warps in shared memory, one partial a block
// and step; dA stays in registers over t, one partial a row.  A second
// kernel sums the partials in a fixed order (blocks, then rows): no
// atomics, so the same inputs give the same bits.  Bound: instruction issue (the
// forward's update is recomputed, and the backward's takes about twice
// its operations, with warp shuffles for every state and step); the
// partials of dB and dC are most of its bytes.
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
constexpr int kBwdThreads = 128;   // a block: 128 / G channels of one row
constexpr int kBwdS = 4;           // states a lane
constexpr int kCkptSteps = kLanesTileT;   // steps between two checkpoints
constexpr int kBwdWarps = kBwdThreads / 32;

// dynamic shared memory of the backward kernel at G lanes a channel: the
// chunk's states, and the warps' sums of dB and dC for each step
template <int G>
constexpr size_t bwd_smem_bytes() {
  return sizeof(float) * static_cast<size_t>(kCkptSteps) * kBwdS * kBwdThreads +
         sizeof(double) * 2 * kCkptSteps * kBwdWarps * G * kBwdS;
}

// Grid (nblk = ceil(DI / (128 / G)), B); thread = channel * G + lane, the
// lane holding states [lane * 4, lane * 4 + 4).  Lanes past DI or DS hold
// zeros and take part in every shuffle.
template <int G>
__global__ void __launch_bounds__(kBwdThreads)
scan_backward_kernel(const float* __restrict__ dt, const float* __restrict__ bm,
                     const float* __restrict__ cm, const float* __restrict__ x,
                     const float* __restrict__ a_neg,
                     const float* __restrict__ ck,
                     const float* __restrict__ dy,
                     const float* __restrict__ dh_t,
                     float* __restrict__ ddt, float* __restrict__ dx,
                     float* __restrict__ dh0, double* __restrict__ part_b,
                     double* __restrict__ part_c, double* __restrict__ part_a,
                     int T, int DI, int DS, long long bc_sb, long long bc_st) {
  constexpr int S = kBwdS, W = G * kBwdS, kChannels = kBwdThreads / G;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* sh = reinterpret_cast<float*>(smem_raw);     // [32][S][128]
  double* sdb = reinterpret_cast<double*>(            // [32][warps][W]
      sh + kCkptSteps * S * kBwdThreads);
  double* sdc = sdb + kCkptSteps * kBwdWarps * W;
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
  double gn[S], da[S];   // the state gradient and dA, carried over t
#pragma unroll
  for (int j = 0; j < S; ++j) {
    a[j] = j < n ? a_neg[static_cast<long long>(d) * DS + s0 + j] : 0.f;
    gn[j] = (j < n && dh_t != nullptr) ? dh_t[hrow + j] : 0.0;
    da[j] = 0.0;
  }
  const float* bb = bm + b * bc_sb;
  const float* cb = cm + b * bc_sb;
  const long long row0 = static_cast<long long>(b) * T;
  const int n_ck = (T + kCkptSteps - 1) / kCkptSteps;

  for (int ci = n_ck - 1; ci >= 0; --ci) {
    const int t0 = ci * kCkptSteps;
    const int nt = min(kCkptSteps, T - t0);
    float hc[S], h[S];
    const long long crow =
        ((static_cast<long long>(b) * n_ck + ci) * DI + d) * DS + s0;
#pragma unroll
    for (int j = 0; j < S; ++j) {
      hc[j] = j < n ? ck[crow + j] : 0.f;
      h[j] = hc[j];
    }
    // the chunk's states, as the forward computes them
    for (int tt = 0; tt < nt; ++tt) {
      const long long off = (row0 + t0 + tt) * DI + d;
      const float dt_t = live ? dt[off] : 0.f;
      const float dxv = __fmul_rn(dt_t, live ? x[off] : 0.f);
      const float* brow = bb + (t0 + tt) * bc_st + s0;
#pragma unroll
      for (int j = 0; j < S; ++j) {
        const float bv = j < n ? brow[j] : 0.f;
        const float decay = expf(__fmul_rn(dt_t, a[j]));
        h[j] = __fadd_rn(__fmul_rn(decay, h[j]), __fmul_rn(dxv, bv));
        sh[(tt * S + j) * kBwdThreads + threadIdx.x] = h[j];
      }
    }
    // back through the chunk, the gradient algebra in double on the
    // forward's float states and decays
    for (int tt = nt - 1; tt >= 0; --tt) {
      const long long off = (row0 + t0 + tt) * DI + d;
      const float dt_t = live ? dt[off] : 0.f;
      const double dtv = dt_t;
      const double xv = live ? x[off] : 0.f;
      const double dyv = live ? dy[off] : 0.f;
      const double dtx = dtv * xv;
      const float* brow = bb + (t0 + tt) * bc_st + s0;
      const float* crow_c = cb + (t0 + tt) * bc_st + s0;
      double sgb = 0.0, sdt = 0.0, pb[S], pc[S];
#pragma unroll
      for (int j = 0; j < S; ++j) {
        const double bv = j < n ? brow[j] : 0.f;
        const double cv = j < n ? crow_c[j] : 0.f;
        const double hcur = sh[(tt * S + j) * kBwdThreads + threadIdx.x];
        const double hprev =
            tt > 0 ? sh[((tt - 1) * S + j) * kBwdThreads + threadIdx.x]
                   : hc[j];
        const double decay = expf(__fmul_rn(dt_t, a[j]));
        const double g = cv * dyv + gn[j];
        const double hda = hprev * decay;
        sgb += g * bv;
        sdt += g * (hda * a[j] + xv * bv);
        pb[j] = g * dtx;
        pc[j] = hcur * dyv;
        da[j] += g * hda * dtv;
        gn[j] = decay * g;
      }
      // over the G lanes of the channel
#pragma unroll
      for (int o = G / 2; o > 0; o >>= 1) {
        sgb += __shfl_xor_sync(0xffffffffu, sgb, o);
        sdt += __shfl_xor_sync(0xffffffffu, sdt, o);
      }
      if (live && lane == 0) {
        dx[off] = static_cast<float>(dtv * sgb);
        ddt[off] = static_cast<float>(sdt);
      }
      // over the channels of the warp: lanes 0..G-1 hold the warp's sums
#pragma unroll
      for (int o = G; o < 32; o <<= 1) {
#pragma unroll
        for (int j = 0; j < S; ++j) {
          pb[j] += __shfl_xor_sync(0xffffffffu, pb[j], o);
          pc[j] += __shfl_xor_sync(0xffffffffu, pc[j], o);
        }
      }
      if (wl < G) {
#pragma unroll
        for (int j = 0; j < S; ++j) {
          sdb[(tt * kBwdWarps + warp) * W + s0 + j] = pb[j];
          sdc[(tt * kBwdWarps + warp) * W + s0 + j] = pc[j];
        }
      }
    }
    __syncthreads();
    // the block's partial of each step's dB and dC: the warps in order
    for (int i = threadIdx.x; i < nt * W; i += kBwdThreads) {
      const int tt = i / W, s = i - tt * W;
      if (s >= DS) continue;
      double vb = 0.0, vc = 0.0;
#pragma unroll
      for (int w = 0; w < kBwdWarps; ++w) {
        vb += sdb[(tt * kBwdWarps + w) * W + s];
        vc += sdc[(tt * kBwdWarps + w) * W + s];
      }
      const long long o =
          ((static_cast<long long>(b) * gridDim.x + blockIdx.x) * T + t0 + tt)
              * DS + s;
      part_b[o] = vb;
      part_c[o] = vc;
    }
    __syncthreads();   // sh, sdb and sdc are free for the next chunk
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
__global__ void scan_backward_sum(const double* __restrict__ part_b,
                                  const double* __restrict__ part_c,
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
  static bool opted = false;   // above 48 KB only by opting in
  if (!opted) {
    const cudaError_t e = cudaFuncSetAttribute(
        scan_backward_kernel<G>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
    opted = true;
  }
  if (nblk != (DI + kBwdThreads / G - 1) / (kBwdThreads / G))
    return cudaErrorInvalidValue;
  scan_backward_kernel<G><<<dim3(nblk, B), kBwdThreads, smem, stream>>>(
      static_cast<const float*>(dt), static_cast<const float*>(bm),
      static_cast<const float*>(cm), static_cast<const float*>(x),
      static_cast<const float*>(a_neg), static_cast<const float*>(ck),
      static_cast<const float*>(dy), static_cast<const float*>(dh_t),
      static_cast<float*>(ddt), static_cast<float*>(dx),
      static_cast<float*>(dh0), static_cast<double*>(part_b),
      static_cast<double*>(part_c), static_cast<double*>(part_a), T, DI, DS,
      bc_sb, bc_st);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const long long total = static_cast<long long>(B) * T * DS +
                          static_cast<long long>(DI) * DS;
  const int threads = 256;
  scan_backward_sum<<<static_cast<unsigned>((total + threads - 1) / threads),
                      threads, 0, stream>>>(
      static_cast<const double*>(part_b), static_cast<const double*>(part_c),
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
// part_c: (B, nblk, T, DS) and part_a (B, DI, DS), double scratch.  lanes G =
// 1, 2, 4, 8 or 16 with G * 4 >= DS (kernels/selective_scan.py::
// bwd_lanes), nblk = ceil(DI / (128 / G)).
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
