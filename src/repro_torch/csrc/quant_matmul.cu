// Weight-only int8 / int4 dequantize-matmul: out (M, N) = x (M, K) @
// dequant(q, s), accumulated in f32, written in x's dtype.
//
// Replaces the TPU kernel quant_matmul_pallas
// (src/repro/kernels/quant_matmul.py:54, bodies _qmm_int8_kernel and
// _qmm_int4_kernel), i.e. the reference model's qdot on a packed weight
// (src/repro/models/quantize.py::_qdot_int8 and _qdot_int4) at the seven
// projection sites of every layer.
//
//   int8: q (K, N) int8, s (1, N) f32;  out = (x @ q) * s, the scale
//         applied once after the sum over K.
//   int4: q (K/2, N) uint8, packed row r holding k = 2r in the low nibble
//         and k = 2r + 1 in the high one, both biased by +8; s (K/G, N)
//         f32;  out = x @ ((nibble - 8) * s[k / G]), the scale inside the
//         sum as the reference's dequantize-then-dot has it.
//
// Bound on the H100: bytes, at decode (M = 8: each weight byte is used 8
// times, far below the bf16 tensor cores' 295 flops per byte) and at a
// prefill chunk (M = 128); in practice latency and SM fill, since a
// decode-sized product is 5 to 40 output tiles.
//
// Bodies (int4: the wrapper names one by its rule,
// kernels/quant_matmul.py::int4_body, and rt_quant_matmul_int4 launches
// it, refusing a body the shape cannot take):
//
// * cuda_core (int8 always; int4 in float32 at every shape, and in bf16
//   where G % 16 != 0 or N % 16 != 0).  Grid (ceil(N / 128),
//   ceil(M / 8)): a block owns 8 rows of x and 128 output columns, 4
//   consecutive columns per lane, so one 32-bit load brings a lane its 4
//   weight bytes of one (packed) row.  The 8 warps split each K stage of
//   128 between them, with x staged in shared memory as f32, FMAs on the
//   f32 CUDA cores; the 8 per-warp partial sums of every output are
//   added in warp order, so the result does not depend on timing.
//   float32 stays here because the card's float32 streams must equal the
//   CPU's: TF32 tensor cores would round x.
// * mma (int4, bf16, G % 16 == 0, N % 16 == 0, 16-byte aligned x and q).
//   The transposed product out^T (N x M) = W^T (N x K) . x^T (K x M) on
//   mma.sync m16n8k16 with f32 accumulators: the weight's N fills the m16
//   side and x's M the n8 side, so a decode step's M = 8 is one n8 tile
//   and a chunk of M <= 128 is up to 16, ragged M masked.  A CTA of 4
//   warps owns 64 output columns (16 per warp) and up to 64 rows of x
//   (8 n8 tiles; 128 rows in one CTA measured slower, at 255 registers).  A thread's A-fragment register holds the pair
//   k = 2r, 2r + 1 of one n: exactly one packed byte, turned into the
//   bf16 integers -8..7 (exact) by OR-ing the nibbles into the mantissa
//   of 128.0 and subtracting 136; a stage's four A fragments are built
//   before its mma chain, and B comes from x by ldmatrix.  Each scale
//   group's partial sum runs in its own f32 fragment and is added to the
//   output fragment times s[g, n] in f32; products of integers and bf16
//   x are exact, so only the f32 summation order differs from the plain
//   version.  Packed weight rows, x and the stage's scale rows are
//   copied with 16-byte cp.async into a ring of 4 K stages of 64 in
//   shared memory; every weight byte is read once.  Split-K fills the
//   card: the wrapper's int4_splits(M, K, N) cuts the K stages into up
//   to 8 slices, launched as one thread-block cluster per output tile
//   (at decode 5 to 40 tiles become 40 to 200 CTAs on the main path's
//   shapes).  Each slice keeps its f32 partial tile in its own shared
//   memory, and after a cluster barrier the slices sum the tile's
//   partials in slice order through distributed shared memory, each a
//   share of the tile: no workspace, no atomics, no second launch.  The
//   split depends on M, K and N alone and the sum's order is fixed, so
//   the result does not depend on timing.
#include <cstdint>

#include "common.cuh"
#include "mma.cuh"

#include <cooperative_groups.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 8;                 // rows of x per block
constexpr int kCols = 4;                 // output columns per lane
constexpr int kTileN = 32 * kCols;       // output columns per block
constexpr int kTileK = 128;              // K per stage
constexpr int kWarpK = kTileK / kWarps;  // K per warp per stage

// Bytes [n0, n0 + 4) of one weight row of width N, packed little-endian;
// bytes at or past N read as 0.
__device__ __forceinline__ uint32_t load4(const uint8_t* __restrict__ row,
                                          int n0, int N, bool vec) {
  if (vec) return n0 < N ? *reinterpret_cast<const uint32_t*>(row + n0) : 0u;
  uint32_t v = 0u;
#pragma unroll
  for (int j = 0; j < kCols; ++j)
    if (n0 + j < N) v |= static_cast<uint32_t>(row[n0 + j]) << (8 * j);
  return v;
}

template <typename T, bool kInt4>
__global__ void __launch_bounds__(kThreads)
quant_matmul_kernel(const T* __restrict__ x, const uint8_t* __restrict__ q,
                    const float* __restrict__ s, T* __restrict__ out, int M,
                    int K, int N, int G, bool vec) {
  __shared__ float xs[kRows][kTileK];
  __shared__ float part[kWarps][kRows][kTileN];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int m0 = blockIdx.y * kRows;
  const int n0 = blockIdx.x * kTileN + lane * kCols;

  float acc[kRows][kCols];
#pragma unroll
  for (int r = 0; r < kRows; ++r)
#pragma unroll
    for (int j = 0; j < kCols; ++j) acc[r][j] = 0.f;
  int g_cur = -1;           // int4: the scale group held in sc
  float sc[kCols];
#pragma unroll
  for (int j = 0; j < kCols; ++j) sc[j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += kTileK) {
    const int kw = k0 + warp * kWarpK;   // this warp's first k
    // this warp's weight rows of the stage, in flight during the staging
    constexpr int kLoads = kInt4 ? kWarpK / 2 : kWarpK;
    uint32_t w[kLoads];
#pragma unroll
    for (int i = 0; i < kLoads; ++i) {
      const int r = kInt4 ? kw / 2 + i : kw + i;    // (packed) weight row
      const bool live = kInt4 ? 2 * r < K : r < K;
      w[i] = live ? load4(q + static_cast<size_t>(r) * N, n0, N, vec) : 0u;
    }
    for (int e = threadIdx.x; e < kRows * kTileK; e += kThreads) {
      const int r = e / kTileK;
      const int kk = e - r * kTileK;
      const int m = m0 + r;
      const int k = k0 + kk;
      xs[r][kk] = (m < M && k < K)
          ? rt::to_f32<T>(x[static_cast<size_t>(m) * K + k]) : 0.f;
    }
    __syncthreads();

    const float* xw = &xs[0][warp * kWarpK];
    if constexpr (!kInt4) {
#pragma unroll
      for (int i = 0; i < kLoads; ++i) {
        float wf[kCols];
#pragma unroll
        for (int j = 0; j < kCols; ++j)
          wf[j] = static_cast<float>(static_cast<int8_t>((w[i] >> (8 * j)) & 0xffu));
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          const float xv = xw[r * kTileK + i];
#pragma unroll
          for (int j = 0; j < kCols; ++j) acc[r][j] = fmaf(xv, wf[j], acc[r][j]);
        }
      }
    } else {
#pragma unroll
      for (int i = 0; i < kLoads; ++i) {
        const int k = kw + 2 * i;        // the low nibble's k; k + 1 is in
        if (k < K) {                     // the same group (G is even)
          const int gi = k / G;
          if (gi != g_cur) {
            g_cur = gi;
            const float* srow = s + static_cast<size_t>(gi) * N;
#pragma unroll
            for (int j = 0; j < kCols; ++j)
              sc[j] = n0 + j < N ? srow[n0 + j] : 0.f;
          }
          float lo[kCols], hi[kCols];
#pragma unroll
          for (int j = 0; j < kCols; ++j) {
            const uint32_t byte = (w[i] >> (8 * j)) & 0xffu;
            lo[j] = static_cast<float>(static_cast<int>(byte & 0xfu) - 8) * sc[j];
            hi[j] = static_cast<float>(static_cast<int>(byte >> 4) - 8) * sc[j];
          }
#pragma unroll
          for (int r = 0; r < kRows; ++r) {
            const float x0 = xw[r * kTileK + 2 * i];
            const float x1 = xw[r * kTileK + 2 * i + 1];
#pragma unroll
            for (int j = 0; j < kCols; ++j) {
              acc[r][j] = fmaf(x0, lo[j], acc[r][j]);
              acc[r][j] = fmaf(x1, hi[j], acc[r][j]);
            }
          }
        }
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int r = 0; r < kRows; ++r)
#pragma unroll
    for (int j = 0; j < kCols; ++j) part[warp][r][lane * kCols + j] = acc[r][j];
  __syncthreads();
  for (int e = threadIdx.x; e < kRows * kTileN; e += kThreads) {
    const int r = e / kTileN;
    const int c = e - r * kTileN;
    const int m = m0 + r;
    const int n = blockIdx.x * kTileN + c;
    if (m >= M || n >= N) continue;
    float v = 0.f;
#pragma unroll
    for (int wi = 0; wi < kWarps; ++wi) v += part[wi][r][c];
    if constexpr (!kInt4) v *= s[n];
    out[static_cast<size_t>(m) * N + n] = rt::from_f32<T>(v);
  }
}

template <typename T, bool kInt4>
cudaError_t launch(const void* x, const void* q, const void* s, void* out,
                   int M, int K, int N, int G, cudaStream_t stream) {
  const bool vec = (N % 4 == 0) &&
                   ((reinterpret_cast<uintptr_t>(q) & 3u) == 0);
  const dim3 grid((N + kTileN - 1) / kTileN, (M + kRows - 1) / kRows);
  quant_matmul_kernel<T, kInt4><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const uint8_t*>(q),
      static_cast<const float*>(s), static_cast<T*>(out), M, K, N, G, vec);
  return cudaGetLastError();
}

template <bool kInt4>
int dispatch(const void* x, const void* q, const void* s, void* out, int M,
             int K, int N, int G, int dtype, void* stream) {
  if (M <= 0 || N <= 0) return 0;
  if (K <= 0 || (M + kRows - 1) / kRows > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  if (kInt4 && (K % 2 != 0 || G <= 0 || G % 2 != 0 || K % G != 0))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return static_cast<int>(launch<float, kInt4>(x, q, s, out, M, K, N, G, st));
  if (dtype == 1)
    return static_cast<int>(
        launch<__nv_bfloat16, kInt4>(x, q, s, out, M, K, N, G, st));
  return static_cast<int>(cudaErrorInvalidValue);
}


// ---------------------------------------------------------------------------
// mma body (int4, bf16)
// ---------------------------------------------------------------------------
namespace mma {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kTileN = 16 * kWarps;   // output columns per CTA
constexpr int kTileK = 64;            // K per stage (32 packed rows)
constexpr int kWRow = kTileN + 16;    // bytes per packed row in smem
constexpr int kXRow = kTileK + 8;     // bf16 per row of x in smem
constexpr int kSteps = kTileK / 16;   // k16 steps per stage
constexpr int kStages = 4;            // K stages in flight
constexpr int kMaxSplits = 8;         // slices of K: a portable cluster

// One stage of the shared ring: packed weight rows, rows of x, scales.
template <int MT>
struct Stage {
  uint8_t w[kTileK / 2][kWRow];
  __nv_bfloat16 x[8 * MT][kXRow];
  float s[kSteps][kTileN];   // per k16 step: its group's scales
};

// The bf16 pair (low nibble - 8, high nibble - 8) of one packed byte:
// 0x4300 | v is the bf16 of 128 + v, and 128 + v - 136 is exact.
__device__ __forceinline__ uint32_t nibbles(uint32_t b) {
  const uint32_t v = (b & 0xFu) | ((b & 0xF0u) << 12) | 0x43004300u;
  const __nv_bfloat162 r =
      __hsub2(*reinterpret_cast<const __nv_bfloat162*>(&v),
              __floats2bfloat162_rn(136.f, 136.f));
  return rt::bf162_bits(r);
}

template <int MT>   // n8 tiles of x rows per CTA
__global__ void __launch_bounds__(kThreads)
int4_kernel(const __nv_bfloat16* __restrict__ x, const uint8_t* __restrict__ q,
            const float* __restrict__ s, __nv_bfloat16* __restrict__ out,
            int M, int K, int N, int G, int per_split) {
  constexpr int kRowsM = 8 * MT;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Stage<MT>* ring = reinterpret_cast<Stage<MT>*>(smem_raw);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int grp = lane >> 2;
  const int tig = lane & 3;
  const int n0 = blockIdx.x * kTileN;
  const int m0 = blockIdx.y * kRowsM;
  const int split = blockIdx.z;
  const int splits = gridDim.z;
  const int stages = (K + kTileK - 1) / kTileK;
  const int st0 = split * per_split;
  const int st1 = min(st0 + per_split, stages);
  const int kend = min(st1 * kTileK, K);

  auto load = [&](int st, Stage<MT>& dst) {
    const int k0 = st * kTileK;
    {   // 32 packed rows of 64 bytes: one 16-byte chunk per thread
      const int r = tid >> 2;
      const int c = (tid & 3) * 16;
      const int gr = k0 / 2 + r;
      const bool ok = 2 * gr < K && n0 + c < N;
      rt::cp_async16(&dst.w[r][c],
                     ok ? q + static_cast<size_t>(gr) * N + n0 + c : q,
                     ok ? 16 : 0);
    }
    for (int e = tid; e < kRowsM * (kTileK / 8); e += kThreads) {
      const int r = e / (kTileK / 8);
      const int c = (e - r * (kTileK / 8)) * 8;
      const int m = m0 + r;
      const int k = k0 + c;
      const bool ok = m < M && k < K;
      rt::cp_async16(&dst.x[r][c],
                     ok ? x + static_cast<size_t>(m) * K + k : x, ok ? 16 : 0);
    }
    if (tid < kSteps * (kTileN / 4)) {
      // slot j: the scale row of the group that k16 step j lies in
      const int j = tid / (kTileN / 4);
      const int c = (tid - j * (kTileN / 4)) * 4;
      const int k = k0 + 16 * j;
      const bool ok = k < K && n0 + c < N;
      rt::cp_async16(&dst.s[j][c],
                     ok ? s + static_cast<size_t>(k / G) * N + n0 + c : s,
                     ok ? 16 : 0);
    }
  };

  float acc[MT][4], part[MT][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[mt][e] = part[mt][e] = 0.f;
  const int nw = warp * 16;
  const int na = n0 + nw + grp;        // this lane's columns na, na + 8
  // k16 steps left in the current scale group
  const int group_steps = G / 16;
  int left = group_steps - (st0 * kTileK % G) / 16;

  // a ring of kStages stages: kStages - 1 in flight while one computes;
  // one commit group per stage, empty past the slice
#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) {
    if (st0 + i < st1) load(st0 + i, ring[i]);
    rt::cp_async_commit();
  }
  for (int st = st0; st < st1; ++st) {
    rt::cp_async_wait<kStages - 2>();
    __syncthreads();     // stage st landed; stage st - 1's slot is free
    const int nxt = st + kStages - 1;
    if (nxt < st1) load(nxt, ring[(nxt - st0) % kStages]);
    rt::cp_async_commit();
    const Stage<MT>& cur = ring[(st - st0) % kStages];
    const int steps = min(kSteps, (kend - st * kTileK) / 16);
    // all of the stage's A fragments first, off the mma chain
    uint32_t a[kSteps][4];
#pragma unroll
    for (int kk = 0; kk < kSteps; ++kk) {
      const uint8_t* wr = &cur.w[kk * 8 + tig][nw + grp];
      a[kk][0] = nibbles(wr[0]);
      a[kk][1] = nibbles(wr[8]);
      a[kk][2] = nibbles(wr[4 * kWRow]);
      a[kk][3] = nibbles(wr[4 * kWRow + 8]);
    }
#pragma unroll
    for (int kk = 0; kk < kSteps; ++kk) {
      if (kk < steps) {
        if constexpr (MT == 1) {
          const __nv_bfloat16* xr = &cur.x[grp][kk * 16 + 2 * tig];
          rt::mma_bf16(part[0], a[kk], *reinterpret_cast<const uint32_t*>(xr),
                       *reinterpret_cast<const uint32_t*>(xr + 8));
        } else {
#pragma unroll
          for (int mt = 0; mt < MT; mt += 2) {
            // B fragments of n8 tiles mt and mt + 1 in one ldmatrix
            uint32_t b[4];
            rt::ldmatrix_x4(b, &cur.x[mt * 8 + (lane & 7) + ((lane >> 4) << 3)]
                                     [kk * 16 + ((lane >> 3) & 1) * 8]);
            rt::mma_bf16(part[mt], a[kk], b[0], b[1]);
            rt::mma_bf16(part[mt + 1], a[kk], b[2], b[3]);
          }
        }
        // the group ends here (or the slice does): fold it in, scaled
        if (--left == 0 || st * kTileK + 16 * (kk + 1) == kend) {
          left = group_steps;
          const float sa = cur.s[kk][nw + grp];
          const float sb = cur.s[kk][nw + grp + 8];
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
            acc[mt][0] = fmaf(sa, part[mt][0], acc[mt][0]);
            acc[mt][1] = fmaf(sa, part[mt][1], acc[mt][1]);
            acc[mt][2] = fmaf(sb, part[mt][2], acc[mt][2]);
            acc[mt][3] = fmaf(sb, part[mt][3], acc[mt][3]);
#pragma unroll
            for (int e = 0; e < 4; ++e) part[mt][e] = 0.f;
          }
        }
      }
    }
  }

  // fragment element e of n8 tile mt: row m0 + 8 mt + 2 tig + (e & 1) of
  // x, output column na + 8 (e >> 1)
  if (splits == 1) {
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int m = m0 + mt * 8 + 2 * tig + (e & 1);
        const int n = na + 8 * (e >> 1);
        if (m < M && n < N)
          out[static_cast<size_t>(m) * N + n] = __float2bfloat16(acc[mt][e]);
      }
    return;
  }
  // Split K: the slices of a tile are one cluster.  Each writes its f32
  // partial tile into its own shared memory (the ring is free now), and
  // after a cluster barrier every slice sums a share of the tile's float4
  // granules over all slices' partials, read through distributed shared
  // memory in slice order.  The second barrier keeps each partial alive
  // until all its readers are done.
  constexpr int kPRow = kTileN + 4;    // partial row, in floats
  constexpr int kQuads = kTileN / 4;   // float4 granules per row
  rt::cp_async_wait<0>();
  __syncthreads();
  float* partial = reinterpret_cast<float*>(smem_raw);
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      partial[(mt * 8 + 2 * tig + (e & 1)) * kPRow + nw + grp + 8 * (e >> 1)] =
          acc[mt][e];
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  for (int gi = split * kThreads + tid; gi < kRowsM * kQuads;
       gi += splits * kThreads) {
    const int r = gi / kQuads;
    const int c = (gi - r * kQuads) * 4;
    float4 p[kMaxSplits];   // all slices' loads in flight, then the sum
#pragma unroll
    for (int sp = 0; sp < kMaxSplits; ++sp)
      if (sp < splits)
        p[sp] = *reinterpret_cast<const float4*>(
            cluster.map_shared_rank(partial, sp) + r * kPRow + c);
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int sp = 0; sp < kMaxSplits; ++sp)
      if (sp < splits) {
        v.x += p[sp].x;
        v.y += p[sp].y;
        v.z += p[sp].z;
        v.w += p[sp].w;
      }
    const int m = m0 + r;
    const int n = n0 + c;
    if (m < M && n < N) {
      uint2 pair;
      pair.x = rt::bf162_bits(__floats2bfloat162_rn(v.x, v.y));
      pair.y = rt::bf162_bits(__floats2bfloat162_rn(v.z, v.w));
      *reinterpret_cast<uint2*>(out + static_cast<size_t>(m) * N + n) = pair;
    }
  }
  cluster.sync();
}

template <int MT>
cudaError_t launch(const void* x, const void* q, const void* s, void* out,
                   int M, int K, int N, int G, int splits,
                   cudaStream_t stream) {
  const int stages = (K + kTileK - 1) / kTileK;
  const int per_split = (stages + splits - 1) / splits;
  const size_t bytes = kStages * sizeof(Stage<MT>);
  cudaError_t err = rt::allow_smem(int4_kernel<MT>, bytes);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((N + kTileN - 1) / kTileN, (M + 8 * MT - 1) / (8 * MT),
                     splits);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = bytes;
  cfg.stream = stream;
  cudaLaunchAttribute cluster;
  cluster.id = cudaLaunchAttributeClusterDimension;
  cluster.val.clusterDim.x = 1;   // the slices of one tile
  cluster.val.clusterDim.y = 1;
  cluster.val.clusterDim.z = splits;
  cfg.attrs = &cluster;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, int4_kernel<MT>,
                           static_cast<const __nv_bfloat16*>(x),
                           static_cast<const uint8_t*>(q),
                           static_cast<const float*>(s),
                           static_cast<__nv_bfloat16*>(out), M, K, N, G,
                           per_split);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

cudaError_t dispatch(const void* x, const void* q, const void* s, void* out,
                     int M, int K, int N, int G, int splits,
                     cudaStream_t st) {
  if (M <= 8) return launch<1>(x, q, s, out, M, K, N, G, splits, st);
  if (M <= 16) return launch<2>(x, q, s, out, M, K, N, G, splits, st);
  if (M <= 32) return launch<4>(x, q, s, out, M, K, N, G, splits, st);
  return launch<8>(x, q, s, out, M, K, N, G, splits, st);
}

}  // namespace mma

}  // namespace

extern "C" int rt_quant_matmul_int8(const void* x, const void* q,
                                    const void* s, void* out, int M, int K,
                                    int N, int group, int dtype,
                                    void* stream) {
  (void)group;
  return dispatch<false>(x, q, s, out, M, K, N, 0, dtype, stream);
}

// body: kBodyCudaCore or kBodyMma; splits (1 to kMaxSplits) is read by
// the mma body only.
extern "C" int rt_quant_matmul_int4(const void* x, const void* q,
                                    const void* s, void* out, int M, int K,
                                    int N, int group, int dtype, int body,
                                    int splits, void* stream) {
  if (body == rt::kBodyCudaCore)
    return dispatch<true>(x, q, s, out, M, K, N, group, dtype, stream);
  if (body != rt::kBodyMma) return static_cast<int>(cudaErrorInvalidValue);
  if (M <= 0 || N <= 0) return 0;
  const int stages = (K + mma::kTileK - 1) / mma::kTileK;
  const bool aligned = ((reinterpret_cast<uintptr_t>(x) |
                         reinterpret_cast<uintptr_t>(q)) & 15u) == 0;
  if (dtype != 1 || K <= 0 || group <= 0 || group % 16 != 0 ||
      K % group != 0 || N % 16 != 0 || !aligned || splits < 1 ||
      splits > stages || splits > mma::kMaxSplits || (M + 7) / 8 > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(mma::dispatch(x, q, s, out, M, K, N, group, splits,
                                        static_cast<cudaStream_t>(stream)));
}
