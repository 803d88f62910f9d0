// RMSNorm over the last dimension: out = x * rsqrt(mean(x^2) + eps) * scale,
// reduction in f32, output in x's type.
//
// Replaces the TPU kernel src/repro/kernels/rmsnorm.py::rmsnorm_pallas
// (body _rmsnorm_kernel), i.e. the jnp layers.rmsnorm the reference model
// runs (src/repro/models/layers.py::rmsnorm): two per layer plus the final
// norm.
//
// Bound on the H100: bytes.  A row of d elements is read twice (the second
// read hits L1) and written once, with a handful of flops per element; at
// the main path's shapes (8 decode rows or 128 prefill rows of 960) the
// whole call moves 15 KB to 490 KB, so it is latency bound long before it
// is bandwidth bound.  The design keeps that latency short: one block per
// row, sized to the row so each thread issues one or two 16-byte loads,
// a warp-shuffle reduction in f32 and a single shared-memory step across
// warps.  Fusing it into the neighbouring matmul epilogues is later work.
#include "common.cuh"

namespace {

template <typename T>
__global__ void rmsnorm_kernel(const T* __restrict__ x,
                               const T* __restrict__ scale,
                               T* __restrict__ out, int d, float eps) {
  constexpr int kVec = 16 / sizeof(T);
  const T* xr = x + static_cast<size_t>(blockIdx.x) * d;
  T* orow = out + static_cast<size_t>(blockIdx.x) * d;
  const bool vec = (d % kVec == 0) &&
                   (((reinterpret_cast<size_t>(xr) |
                      reinterpret_cast<size_t>(orow) |
                      reinterpret_cast<size_t>(scale)) & 15) == 0);

  float ss = 0.f;
  if (vec) {
    for (int i = threadIdx.x; i < d / kVec; i += blockDim.x) {
      const uint4 raw = reinterpret_cast<const uint4*>(xr)[i];
      const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
      for (int j = 0; j < kVec; ++j) {
        const float v = rt::to_f32<T>(e[j]);
        ss += v * v;
      }
    }
  } else {
    for (int i = threadIdx.x; i < d; i += blockDim.x) {
      const float v = rt::to_f32<T>(xr[i]);
      ss += v * v;
    }
  }

  __shared__ float red[32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = (blockDim.x + 31) >> 5;
  ss = rt::warp_sum(ss);
  if (lane == 0) red[warp] = ss;
  __syncthreads();
  if (warp == 0) {
    float v = lane < nwarps ? red[lane] : 0.f;
    v = rt::warp_sum(v);
    if (lane == 0) red[0] = v;
  }
  __syncthreads();
  const float inv = rsqrtf(red[0] / static_cast<float>(d) + eps);

  if (vec) {
    for (int i = threadIdx.x; i < d / kVec; i += blockDim.x) {
      const uint4 raw = reinterpret_cast<const uint4*>(xr)[i];
      const uint4 sraw = reinterpret_cast<const uint4*>(scale)[i];
      const T* e = reinterpret_cast<const T*>(&raw);
      const T* s = reinterpret_cast<const T*>(&sraw);
      uint4 res;
      T* r = reinterpret_cast<T*>(&res);
#pragma unroll
      for (int j = 0; j < kVec; ++j) {
        r[j] = rt::from_f32<T>(rt::to_f32<T>(e[j]) * inv * rt::to_f32<T>(s[j]));
      }
      reinterpret_cast<uint4*>(orow)[i] = res;
    }
  } else {
    for (int i = threadIdx.x; i < d; i += blockDim.x) {
      orow[i] = rt::from_f32<T>(rt::to_f32<T>(xr[i]) * inv *
                                rt::to_f32<T>(scale[i]));
    }
  }
}

template <typename T>
cudaError_t launch(const void* x, const void* scale, void* out, int rows,
                   int d, float eps, cudaStream_t stream) {
  constexpr int kVec = 16 / sizeof(T);
  int threads = ((d + kVec - 1) / kVec + 31) / 32 * 32;
  threads = threads < 32 ? 32 : (threads > 1024 ? 1024 : threads);
  rmsnorm_kernel<T><<<rows, threads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(scale),
      static_cast<T*>(out), d, eps);
  return cudaGetLastError();
}

}  // namespace

extern "C" int rt_rmsnorm(const void* x, const void* scale, void* out,
                          int rows, int d, float eps, int dtype,
                          void* stream) {
  if (rows <= 0 || d <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return static_cast<int>(launch<float>(x, scale, out, rows, d, eps, s));
  if (dtype == 1) return static_cast<int>(launch<__nv_bfloat16>(x, scale, out, rows, d, eps, s));
  return static_cast<int>(cudaErrorInvalidValue);
}
