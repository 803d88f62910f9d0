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
// Bodies (the wrapper names one by its rule,
// kernels/quant_matmul.py::int8_body / int4_body, and the entry point
// launches it, refusing a body the shape cannot take):
//
// * wgmma (bf16, both formats; every bf16 launch of the served models
//   but smollm-360m's int8 sites, under WGMMA_INT8_MIN_BYTES of weight,
//   and its int4 attention projections above 64 rows of x, under
//   WGMMA_INT4_CHUNK_MIN values): the warp-specialised Hopper body of quant_wgmma.cu, entered below for
//   body code kBodyWgmma: one producer warp feeding K stages of weight, x
//   and scale rows by TMA, two consumer warpgroups turning the weight
//   bytes into the register A operand of wgmma (its header has the
//   design).
// * cuda_core (float32 at every shape, as the card's float32 streams
//   must equal the CPU's and TF32 tensor cores would round x; bf16 where
//   N % 16 != 0, K % 16 != 0, int4's G % 16 != 0 or x / q are not 16-byte
//   aligned).  Grid (ceil(N / 128), ceil(M / 8)): a block owns 8 rows of
//   x and 128 output columns, 4 consecutive columns per lane, so one
//   32-bit load brings a lane its 4 weight bytes of one (packed) row.
//   The 8 warps split each K stage of 128 between them, with x staged in
//   shared memory as f32, FMAs on the f32 CUDA cores; the 8 per-warp
//   partial sums of every output are added in warp order, so the result
//   does not depend on timing.
// * mma (bf16, both formats; one body templated on the weight format;
//   the main path's body before wgmma, kept where the rules name it
//   (the sites above, and int4 whose s is not 16-byte aligned) and for
//   timing in turns).
//   Replaces _qmm_int8_kernel (src/repro/kernels/quant_matmul.py:38) and
//   _qmm_int4_kernel.  The transposed product out^T (N x M) = W^T (N x K)
//   . x^T (K x M) on mma.sync m16n8k16 with f32 accumulators: the
//   weight's N fills the m16 side and x's M the n8 side, so a decode
//   step's M = 8 is one n8 tile and a chunk of M <= 128 is up to 16,
//   ragged M masked.  A CTA of 4 warps owns 64 output columns (16 per
//   warp) and up to 64 rows of x (8 n8 tiles; 128 rows in one CTA
//   measured slower, at 255 registers).  Row grp of a warp's m16 tile is
//   output column 2 grp and row grp + 8 column 2 grp + 1, so one 16-bit
//   shared load brings a thread both of its columns' bytes of one
//   (packed) weight row, and its two outputs of a row of x are
//   neighbours (one bf16x2 store).  A thread's A-register pair is
//   k = 2r, 2r + 1 of one column:
//     int4: one packed byte, turned into the bf16 integers -8..7 (exact)
//       by OR-ing the nibbles into the mantissa of 128.0 and subtracting
//       136;
//     int8: two bytes N apart (rows k and k + 1 of q (K, N)), paired by
//       __byte_perm and converted exactly through f32 (the byte OR-ed
//       into the mantissa of 2^23; -128..127 needs 8 significant bits, so
//       bf16 holds it), since the 128.0 trick holds only 7 bits.
//   A stage's A fragments are built before its mma chain, and B comes
//   from x by ldmatrix.  Products of integers and bf16 x are exact in
//   f32, so only the f32 summation order differs from the plain version.
//   int4 sums each scale group in its own f32 fragment and adds it to the
//   output fragment times s[g, n]; int8 applies its per-column scale once,
//   after the sum over K, as the reference does.  Weight rows, x and
//   (int4) the stage's scale rows are copied with 16-byte cp.async into
//   a ring of 4 K stages of 64 in shared memory (int8: 4 KB of weights a
//   stage, twice int4's); every weight byte is read once.  Split-K fills
//   the card: the wrapper's quant_splits(M, K, N) cuts the K stages into
//   up to 8 slices, launched as one thread-block cluster per output tile
//   (at decode 5 to 40 tiles become 40 to 200 CTAs on the main path's
//   shapes).  Each slice keeps its f32 partial tile in its own shared
//   memory, and after a cluster barrier the slices sum the tile's
//   partials in slice order through distributed shared memory, each a
//   share of the tile (int8 then scales): no workspace, no atomics, no
//   second launch.  The split depends on M, K and N alone and the sum's
//   order is fixed, so the result does not depend on timing.
//   Bound at the main path's shapes: bytes (int8 reads 2 bytes of weight
//   per 2 * M flops), and in practice the latency of one K slice's loads
//   plus the cluster barrier; the split and the ring keep every slice's
//   weight loads in flight at once.
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
// mma body (int8 and int4, bf16)
// ---------------------------------------------------------------------------
namespace mma {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kTileN = 16 * kWarps;   // output columns per CTA
constexpr int kTileK = 64;            // K per stage
constexpr int kWRow = kTileN + 16;    // bytes per weight row in smem
constexpr int kXRow = kTileK + 8;     // bf16 per row of x in smem
constexpr int kSteps = kTileK / 16;   // k16 steps per stage
constexpr int kStages = 4;            // K stages in flight
constexpr int kMaxSplits = 8;         // slices of K: a portable cluster

// One stage of the shared ring: weight rows (int8: 64 rows of 64 bytes;
// int4: 32 packed rows), rows of x, and for int4 the scale row of the
// group each k16 step lies in (int8's scale is applied after the sum).
template <int MT, bool kInt4>
struct Stage {
  static constexpr int kWRows = kInt4 ? kTileK / 2 : kTileK;
  uint8_t w[kWRows][kWRow];
  __nv_bfloat16 x[8 * MT][kXRow];
  float s[kInt4 ? kSteps : 1][kTileN];
};

// int4: the bf16 pair (low nibble - 8, high nibble - 8) of one packed
// byte: 0x4300 | v is the bf16 of 128 + v, and 128 + v - 136 is exact.
__device__ __forceinline__ uint32_t nibbles(uint32_t b) {
  const uint32_t v = (b & 0xFu) | ((b & 0xF0u) << 12) | 0x43004300u;
  const __nv_bfloat162 r =
      __hsub2(*reinterpret_cast<const __nv_bfloat162*>(&v),
              __floats2bfloat162_rn(136.f, 136.f));
  return rt::bf162_bits(r);
}

// int8: the bf16 pair of the two signed bytes in bits 0-15 of v.  Each
// byte, offset to u = b + 128 by flipping its sign bit, is OR-ed into
// the mantissa of the f32 2^23 (giving 2^23 + u, exact), and 2^23 + 128
// is subtracted: b exactly, in f32.  -128..127 needs at most 8
// significant bits, so the pair rounds to bf16 exactly.
__device__ __forceinline__ uint32_t bytes2(uint32_t v) {
  const uint32_t u = v ^ 0x8080u;
  const float lo = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7540)) -
                   8388736.f;
  const float hi = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7541)) -
                   8388736.f;
  return rt::bf162_bits(__floats2bfloat162_rn(lo, hi));
}

// The 16-bit word at p: the weight bytes of columns 2 grp, 2 grp + 1.
__device__ __forceinline__ uint32_t lds16(const uint8_t* p) {
  return *reinterpret_cast<const uint16_t*>(p);
}

// d[mt] += a * x^T over the n8 tiles of x rows, at k16 step kk of a stage.
template <int MT>
__device__ __forceinline__ void mma_x(float (&d)[MT][4],
                                      const uint32_t (&a)[4],
                                      const __nv_bfloat16 (*xs)[kXRow],
                                      int kk, int lane) {
  if constexpr (MT == 1) {
    const __nv_bfloat16* xr = &xs[lane >> 2][kk * 16 + 2 * (lane & 3)];
    rt::mma_bf16(d[0], a, *reinterpret_cast<const uint32_t*>(xr),
                 *reinterpret_cast<const uint32_t*>(xr + 8));
  } else {
#pragma unroll
    for (int mt = 0; mt < MT; mt += 2) {
      // B fragments of n8 tiles mt and mt + 1 in one ldmatrix
      uint32_t b[4];
      rt::ldmatrix_x4(b, &xs[mt * 8 + (lane & 7) + ((lane >> 4) << 3)]
                            [kk * 16 + ((lane >> 3) & 1) * 8]);
      rt::mma_bf16(d[mt], a, b[0], b[1]);
      rt::mma_bf16(d[mt + 1], a, b[2], b[3]);
    }
  }
}

template <int MT, bool kInt4>   // n8 tiles of x rows per CTA
__global__ void __launch_bounds__(kThreads)
mma_kernel(const __nv_bfloat16* __restrict__ x, const uint8_t* __restrict__ q,
           const float* __restrict__ s, __nv_bfloat16* __restrict__ out,
           int M, int K, int N, int G, int per_split) {
  using StageT = Stage<MT, kInt4>;
  constexpr int kRowsM = 8 * MT;
  constexpr int kWRows = StageT::kWRows;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  StageT* ring = reinterpret_cast<StageT*>(smem_raw);
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

  auto load = [&](int st, StageT& dst) {
    const int k0 = st * kTileK;
    // weight rows of 64 bytes, 16-byte chunks (int8: 2 per thread), in a
    // loop of a known trip count (the strided form measured slower)
#pragma unroll
    for (int i = 0; i < kWRows * (kTileN / 16) / kThreads; ++i) {
      const int e = tid + i * kThreads;
      const int r = e >> 2;
      const int c = (e & 3) * 16;
      const int gr = (kInt4 ? k0 / 2 : k0) + r;
      const bool ok = (kInt4 ? 2 * gr : gr) < K && n0 + c < N;
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
    if constexpr (kInt4) {
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
    }
  };

  // acc: the output fragments; int4 sums each scale group in part first
  float acc[MT][4], part[MT][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[mt][e] = part[mt][e] = 0.f;
  const int nw = warp * 16;
  // Row grp of the warp's m16 tile is output column ca (within the
  // CTA's tile), row grp + 8 the next column, so one 16-bit shared load
  // brings both of a thread's weight bytes of a (packed) row.
  const int ca = nw + 2 * grp;
  // k16 steps left in the current scale group (int4)
  const int group_steps = kInt4 ? G / 16 : 0;
  int left = kInt4 ? group_steps - (st0 * kTileK % G) / 16 : 0;

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
    const StageT& cur = ring[(st - st0) % kStages];
    const int steps = min(kSteps, (kend - st * kTileK) / 16);
    // all of the stage's A fragments first, off the mma chain
    uint32_t a[kSteps][4];
#pragma unroll
    for (int kk = 0; kk < kSteps; ++kk) {
      if constexpr (kInt4) {
        // packed row 8 kk + tig holds k = 16 kk + 2 tig, + 1; four rows
        // on, k + 8, + 9
        const uint8_t* wr = &cur.w[kk * 8 + tig][ca];
        const uint32_t lo = lds16(wr);
        const uint32_t hi = lds16(wr + 4 * kWRow);
        a[kk][0] = nibbles(lo & 0xFFu);
        a[kk][1] = nibbles(lo >> 8);
        a[kk][2] = nibbles(hi & 0xFFu);
        a[kk][3] = nibbles(hi >> 8);
      } else {
        // rows k = 16 kk + 2 tig, + 1, + 8, + 9: each register pairs the
        // bytes of one column from two rows
        const uint8_t* wr = &cur.w[kk * 16 + 2 * tig][ca];
        const uint32_t p01 = __byte_perm(lds16(wr), lds16(wr + kWRow), 0x5140);
        const uint32_t p89 =
            __byte_perm(lds16(wr + 8 * kWRow), lds16(wr + 9 * kWRow), 0x5140);
        a[kk][0] = bytes2(p01 & 0xFFFFu);
        a[kk][1] = bytes2(p01 >> 16);
        a[kk][2] = bytes2(p89 & 0xFFFFu);
        a[kk][3] = bytes2(p89 >> 16);
      }
    }
#pragma unroll
    for (int kk = 0; kk < kSteps; ++kk) {
      if (kk < steps) {
        if constexpr (kInt4) {
          mma_x<MT>(part, a[kk], cur.x, kk, lane);
          // the group ends here (or the slice does): fold it in, scaled
          if (--left == 0 || st * kTileK + 16 * (kk + 1) == kend) {
            left = group_steps;
            const float2 sc =
                *reinterpret_cast<const float2*>(&cur.s[kk][ca]);
#pragma unroll
            for (int mt = 0; mt < MT; ++mt) {
              acc[mt][0] = fmaf(sc.x, part[mt][0], acc[mt][0]);
              acc[mt][1] = fmaf(sc.x, part[mt][1], acc[mt][1]);
              acc[mt][2] = fmaf(sc.y, part[mt][2], acc[mt][2]);
              acc[mt][3] = fmaf(sc.y, part[mt][3], acc[mt][3]);
#pragma unroll
              for (int e = 0; e < 4; ++e) part[mt][e] = 0.f;
            }
          }
        } else {
          mma_x<MT>(acc, a[kk], cur.x, kk, lane);
        }
      }
    }
  }

  // Fragment element e of n8 tile mt: row m0 + 8 mt + 2 tig + (e & 1) of
  // x, output column n0 + ca + (e >> 1), so elements e and e + 2 are the
  // two neighbouring columns of one row.
  const int nc = n0 + ca;
  if (splits == 1) {
    float s0 = 1.f, s1 = 1.f;     // int8: the scale, after the sum
    if constexpr (!kInt4) {
      if (nc < N) {
        s0 = s[nc];
        s1 = s[nc + 1];
      }
    }
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = m0 + mt * 8 + 2 * tig + h;
        if (m < M && nc < N)
          *reinterpret_cast<__nv_bfloat162*>(out + static_cast<size_t>(m) * N +
                                             nc) =
              __floats2bfloat162_rn(acc[mt][h] * s0, acc[mt][h + 2] * s1);
      }
    return;
  }
  // Split K: the slices of a tile are one cluster.  Each writes its f32
  // partial tile into its own shared memory (the ring is free now), and
  // after a cluster barrier every slice sums a share of the tile's float4
  // granules over all slices' partials, read through distributed shared
  // memory in slice order (int8 then scales the sum).  The second
  // barrier keeps each partial alive until all its readers are done.
  constexpr int kPRow = kTileN + 4;    // partial row, in floats
  constexpr int kQuads = kTileN / 4;   // float4 granules per row
  rt::cp_async_wait<0>();
  __syncthreads();
  float* partial = reinterpret_cast<float*>(smem_raw);
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      *reinterpret_cast<float2*>(partial + (mt * 8 + 2 * tig + h) * kPRow +
                                 ca) = make_float2(acc[mt][h], acc[mt][h + 2]);
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
      if constexpr (!kInt4) {
        v.x *= s[n];
        v.y *= s[n + 1];
        v.z *= s[n + 2];
        v.w *= s[n + 3];
      }
      uint2 pair;
      pair.x = rt::bf162_bits(__floats2bfloat162_rn(v.x, v.y));
      pair.y = rt::bf162_bits(__floats2bfloat162_rn(v.z, v.w));
      *reinterpret_cast<uint2*>(out + static_cast<size_t>(m) * N + n) = pair;
    }
  }
  cluster.sync();
}

template <int MT, bool kInt4>
cudaError_t launch(const void* x, const void* q, const void* s, void* out,
                   int M, int K, int N, int G, int splits,
                   cudaStream_t stream) {
  const int stages = (K + kTileK - 1) / kTileK;
  const int per_split = (stages + splits - 1) / splits;
  const size_t bytes = kStages * sizeof(Stage<MT, kInt4>);
  cudaError_t err = rt::allow_smem(mma_kernel<MT, kInt4>, bytes);
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
  err = cudaLaunchKernelEx(&cfg, mma_kernel<MT, kInt4>,
                           static_cast<const __nv_bfloat16*>(x),
                           static_cast<const uint8_t*>(q),
                           static_cast<const float*>(s),
                           static_cast<__nv_bfloat16*>(out), M, K, N, G,
                           per_split);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <bool kInt4>
cudaError_t dispatch(const void* x, const void* q, const void* s, void* out,
                     int M, int K, int N, int G, int splits,
                     cudaStream_t st) {
  if (M <= 8) return launch<1, kInt4>(x, q, s, out, M, K, N, G, splits, st);
  if (M <= 16) return launch<2, kInt4>(x, q, s, out, M, K, N, G, splits, st);
  if (M <= 32) return launch<4, kInt4>(x, q, s, out, M, K, N, G, splits, st);
  return launch<8, kInt4>(x, q, s, out, M, K, N, G, splits, st);
}

// The checks both formats' mma entry shares: bf16, K of whole k16 steps,
// N on the tiles, 16-byte aligned x and q, and a split of whole stages
// within one portable cluster.
bool takes(const void* x, const void* q, int M, int K, int N, int dtype,
           int splits) {
  const int stages = (K + kTileK - 1) / kTileK;
  const bool aligned = ((reinterpret_cast<uintptr_t>(x) |
                         reinterpret_cast<uintptr_t>(q)) & 15u) == 0;
  return dtype == 1 && K > 0 && K % 16 == 0 && N % 16 == 0 && aligned &&
         splits >= 1 && splits <= stages && splits <= kMaxSplits &&
         (M + 7) / 8 <= 65535;
}

}  // namespace mma

}  // namespace

// The wgmma body (quant_wgmma.cu).
int quant_wgmma_launch(const void* x, const void* q, const void* s,
                       void* out, int M, int K, int N, int G, bool int4,
                       int splits, cudaStream_t stream);

// body: kBodyCudaCore, kBodyMma or kBodyWgmma; splits (1 to 8) is read by
// the mma and wgmma bodies only, each its own rule's; group is unused
// (int8 scales are per column).
extern "C" int rt_quant_matmul_int8(const void* x, const void* q,
                                    const void* s, void* out, int M, int K,
                                    int N, int group, int dtype, int body,
                                    int splits, void* stream) {
  (void)group;
  if (body == rt::kBodyCudaCore)
    return dispatch<false>(x, q, s, out, M, K, N, 0, dtype, stream);
  if (body == rt::kBodyWgmma) {
    if (M <= 0 || N <= 0) return 0;
    if (dtype != 1) return static_cast<int>(cudaErrorInvalidValue);
    return quant_wgmma_launch(x, q, s, out, M, K, N, 0, false, splits,
                              static_cast<cudaStream_t>(stream));
  }
  if (body != rt::kBodyMma) return static_cast<int>(cudaErrorInvalidValue);
  if (M <= 0 || N <= 0) return 0;
  if (!mma::takes(x, q, M, K, N, dtype, splits))
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(mma::dispatch<false>(
      x, q, s, out, M, K, N, 0, splits, static_cast<cudaStream_t>(stream)));
}

// body and splits as for int8.
extern "C" int rt_quant_matmul_int4(const void* x, const void* q,
                                    const void* s, void* out, int M, int K,
                                    int N, int group, int dtype, int body,
                                    int splits, void* stream) {
  if (body == rt::kBodyCudaCore)
    return dispatch<true>(x, q, s, out, M, K, N, group, dtype, stream);
  if (body == rt::kBodyWgmma) {
    if (M <= 0 || N <= 0) return 0;
    if (dtype != 1) return static_cast<int>(cudaErrorInvalidValue);
    return quant_wgmma_launch(x, q, s, out, M, K, N, group, true, splits,
                              static_cast<cudaStream_t>(stream));
  }
  if (body != rt::kBodyMma) return static_cast<int>(cudaErrorInvalidValue);
  if (M <= 0 || N <= 0) return 0;
  if (group <= 0 || group % 16 != 0 || K % group != 0 ||
      !mma::takes(x, q, M, K, N, dtype, splits))
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(mma::dispatch<true>(
      x, q, s, out, M, K, N, group, splits,
      static_cast<cudaStream_t>(stream)));
}
