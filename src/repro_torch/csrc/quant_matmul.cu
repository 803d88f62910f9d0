// Weight-only int8 / int4 dequantize-matmul: out (M, N) = x (M, K) @
// dequant(q, s), accumulated in f32, written in x's dtype.
//
// Replaces the TPU kernel
// src/repro/kernels/quant_matmul.py::quant_matmul_pallas (bodies
// _qmm_int8_kernel and _qmm_int4_kernel), i.e. the reference model's
// qdot on a packed weight (src/repro/models/quantize.py::_qdot_int8 and
// _qdot_int4) at the seven projection sites of every layer.
//
//   int8: q (K, N) int8, s (1, N) f32;  out = (x @ q) * s, the scale
//         applied once after the sum over K.
//   int4: q (K/2, N) uint8, packed row r holding k = 2r in the low nibble
//         and k = 2r + 1 in the high one, both biased by +8; s (K/G, N)
//         f32;  out = x @ ((nibble - 8) * s[k / G]), the scale inside the
//         sum as the reference's dequantize-then-dot has it.
//
// Grid (ceil(N / 128), ceil(M / 8)): a block owns 8 rows of x and 128
// output columns, 4 consecutive columns per lane, so one 32-bit load
// brings a lane its 4 weight bytes of one (packed) row and a warp reads
// 128 contiguous bytes.  The 8 warps split each K stage of 128 between
// them (16 k, or 8 packed rows, each), with that stage of x staged in
// shared memory as f32; each warp's weight loads for a stage are issued
// before the stage's barrier so they overlap the x staging.  At the end
// the 8 per-warp partial sums of every output are added in warp order in
// shared memory, so the result does not depend on timing.  Edges of M, N
// and K are masked, with no padding copies; vector loads are used only
// when N is a multiple of 4 (N = 320, 960, 2560 on the main path; the
// packed int4 rows are N bytes wide too).
//
// Bound on the H100: bytes at decode (M = 8: each weight byte is used 8
// times, 16 flops per int8 byte against ~295 for the bf16 tensor cores to
// become the limit), and still bytes at M = 128 against the bf16 peak.
// This first version does its FMAs on the f32 CUDA cores and launches
// few blocks for narrow N at decode (3 for N = 320); splitting K across
// blocks and moving the product onto the tensor cores are the changes
// that would approach the bound.
#include <cstdint>

#include "common.cuh"

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

}  // namespace

extern "C" int rt_quant_matmul_int8(const void* x, const void* q,
                                    const void* s, void* out, int M, int K,
                                    int N, int group, int dtype,
                                    void* stream) {
  (void)group;
  return dispatch<false>(x, q, s, out, M, K, N, 0, dtype, stream);
}

extern "C" int rt_quant_matmul_int4(const void* x, const void* q,
                                    const void* s, void* out, int M, int K,
                                    int N, int group, int dtype,
                                    void* stream) {
  return dispatch<true>(x, q, s, out, M, K, N, group, dtype, stream);
}
