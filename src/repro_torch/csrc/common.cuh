// Shared helpers of the port's Hopper kernels: element conversion to
// and from f32, warp reductions, and the dtype codes of the C interface
// (0 = float32, 1 = bfloat16; kernels/_build.py::DTYPE_CODES) and its
// body codes.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace rt {

constexpr float kNegInf = -1e30f;   // the reference's NEG_INF mask value

// Body codes of the entry points of kernels with two bodies
// (kernels/_build.py::BODY_CODES).
constexpr int kBodyCudaCore = 0;     // f32 on the CUDA cores
constexpr int kBodyMma = 1;          // bf16 on the tensor cores
constexpr int kBodyStateLanes = 2;   // the scan, d_state across lanes
constexpr int kBodyAddNorm = 3;      // rmsnorm fused with the residual add
constexpr int kBodyNorm = 4;         // rmsnorm, the row in registers
constexpr int kBodyWgmma = 5;        // bf16, warp-specialised wgmma and TMA

template <typename T>
__device__ __forceinline__ float to_f32(T v);

template <>
__device__ __forceinline__ float to_f32<float>(float v) { return v; }

template <>
__device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f32(float v);

template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }

template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Load n contiguous elements of T from global memory into f32 shared
// memory, cooperatively across the block.  16-byte vector loads when the
// source is 16-byte aligned and n is a multiple of the vector width.
template <typename T>
__device__ __forceinline__ void load_row_f32(float* dst, const T* src, int n) {
  constexpr int kVec = 16 / sizeof(T);
  const bool vec = (n % kVec == 0) &&
                   ((reinterpret_cast<size_t>(src) & 15) == 0);
  if (vec) {
    const int nv = n / kVec;
    for (int i = threadIdx.x; i < nv; i += blockDim.x) {
      const uint4 raw = reinterpret_cast<const uint4*>(src)[i];
      const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
      for (int j = 0; j < kVec; ++j) dst[i * kVec + j] = to_f32<T>(e[j]);
    }
  } else {
    for (int i = threadIdx.x; i < n; i += blockDim.x) dst[i] = to_f32<T>(src[i]);
  }
}

// Load a tile of `tk` logical KV slots [k0, k0 + tk) of one KV head from
// paged pools laid out (NB, bs, KV, hd) into f32 shared memory: K rows
// padded to hd + 1 (the score loop reads one column across many rows),
// V rows dense.  Logical slot s lives at physical block table[s / bs],
// offset s % bs.  Slots past `klast` are never read; their tile rows are
// zero-filled (the caller masks them).
template <typename T>
__device__ __forceinline__ void load_kv_tile(float* ks, float* vs,
                                             const T* __restrict__ kp,
                                             const T* __restrict__ vp,
                                             const int* __restrict__ table,
                                             int k0, int tk, int klast, int bs,
                                             int kv, int kvh, int hd) {
  constexpr int kVec = 16 / sizeof(T);
  const bool vec = (hd % kVec == 0) &&
                   (((reinterpret_cast<size_t>(kp) |
                      reinterpret_cast<size_t>(vp)) & 15) == 0);
  const int cpr = vec ? hd / kVec : hd;   // loads per row
  const int width = vec ? kVec : 1;
  for (int e = threadIdx.x; e < tk * cpr; e += blockDim.x) {
    const int ki = e / cpr;
    const int c = (e - ki * cpr) * width;
    float* kd = ks + ki * (hd + 1) + c;
    float* vd = vs + ki * hd + c;
    const int s = k0 + ki;
    if (s > klast) {
      for (int j = 0; j < width; ++j) { kd[j] = 0.f; vd[j] = 0.f; }
      continue;
    }
    const int blk = s / bs;
    const size_t base =
        ((static_cast<size_t>(table[blk]) * bs + (s - blk * bs)) * kv + kvh) * hd + c;
    if (vec) {
      const uint4 kr = *reinterpret_cast<const uint4*>(kp + base);
      const uint4 vr = *reinterpret_cast<const uint4*>(vp + base);
      const T* ke = reinterpret_cast<const T*>(&kr);
      const T* ve = reinterpret_cast<const T*>(&vr);
#pragma unroll
      for (int j = 0; j < kVec; ++j) {
        kd[j] = to_f32<T>(ke[j]);
        vd[j] = to_f32<T>(ve[j]);
      }
    } else {
      kd[0] = to_f32<T>(kp[base]);
      vd[0] = to_f32<T>(vp[base]);
    }
  }
}

// Raise a kernel's dynamic shared-memory cap when a launch needs more
// than the default 48 KB (Hopper allows up to 227 KB per block).
template <typename K>
inline cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

}  // namespace rt
