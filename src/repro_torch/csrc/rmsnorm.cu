// RMSNorm over the last dimension, optionally fused with the residual add
// before it:
//   r   = x + delta                      (rounded once to x's type)
//   out = r * rsqrt(mean(r^2) + eps) * scale
// reduction in f32, outputs in x's type.  Without delta, r = x and only
// out is written: exactly the TPU kernel's function.
//
// Replaces the TPU kernel src/repro/kernels/rmsnorm.py::rmsnorm_pallas
// (body _rmsnorm_kernel), i.e. the jnp layers.rmsnorm the reference model
// runs (src/repro/models/layers.py::rmsnorm): two per attn layer with an
// MLP, one per Mamba1 layer, plus the final norm.  Every norm but the
// first of a stack follows a residual add (x + attention, x + MLP, x +
// Mamba1 output), which the model hands to this kernel as delta, so the
// add costs no launch of its own.
//
// Bound on the H100: bytes.  At the main path's shapes (8 decode rows or
// 128 prefill rows of 960 or 4096) one call moves 30 KB to 4.2 MB, so
// it is latency bound long before it is bandwidth bound, and the launch
// itself (about 0.0008 ms of device time for an empty kernel) is most
// of its cost.  Three bodies (kernels/rmsnorm.py: add_rmsnorm launches
// add_norm, rmsnorm launches norm):
//
// * add_norm / norm (every launch the model makes).  A row is spread
//   over the lanes of up to 8 warps of one block, one 16-byte access of
//   each tensor a lane where the row allows (960 bf16 values: 4 warps;
//   4096: 8 warps and two accesses a lane), more accesses a lane for a
//   wider row (kernels/rmsnorm.py::norm_lanes).  Each lane issues every
//   load of its share of x, delta and scale before it reduces, so their
//   latencies overlap, and keeps r in registers until the scale pass:
//   the row is read from memory once and written once, with one
//   shared-memory exchange and one barrier.  A row that fits one warp
//   (at most 32 accesses) reduces with shuffles alone, without a
//   barrier, several rows a block when there are rows enough to give
//   every SM a block.  Holding a wide row in one warp's registers (16
//   accesses a lane at 4096 bf16 values) took twice the time of 8 warps
//   (tools/torch_norm_sweep.py).  Rows that are not 16-byte aligned (or
//   whose width is not a whole number of vectors) take the same body
//   with one element per access.
// * cuda_core (the previous body, kept to be timed against them).  One
//   block per row sized so each thread holds one or two vectors, two
//   barriers, and a second read of the row after the reduction.
#include "common.cuh"

namespace {

// ---------------------------------------------------------------------------
// cuda_core: the previous body
// ---------------------------------------------------------------------------
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

// ---------------------------------------------------------------------------
// add_norm / norm: the row in registers
// ---------------------------------------------------------------------------
constexpr int kMaxWarps = 8;      // warps a block (kernels/rmsnorm.py)

// One access: 16 bytes (kPack elements) on the vector path, one element
// on the unaligned one.
template <typename T, int kPack>
struct Access { using type = uint4; };
template <typename T>
struct Access<T, 1> { using type = T; };

// Rows of d elements, `lanes` = 32 * warps_per_row threads a row, rows
// per block = blockDim.x / lanes; lane l of a row takes accesses l,
// l + lanes, ... (V of them at most), so a warp's loads are contiguous.
template <typename T, int kPack, int V, bool kDelta>
__global__ void __launch_bounds__(kMaxWarps * 32)
add_norm_kernel(const T* __restrict__ x, const T* __restrict__ delta,
                const T* __restrict__ scale, T* __restrict__ r_out,
                T* __restrict__ out, int rows, int d, float eps,
                int warps_per_row) {
  using A = typename Access<T, kPack>::type;
  const int lanes = 32 * warps_per_row;
  const int sub = threadIdx.x / lanes;
  const int li = threadIdx.x - sub * lanes;
  const int row = blockIdx.x * (blockDim.x / lanes) + sub;
  // a row's threads are whole warps, and a block with a row past the end
  // holds one-warp rows only, so no barrier below is skipped by a thread
  // that returns here
  if (row >= rows) return;
  const int na = d / kPack;
  const size_t base = static_cast<size_t>(row) * d;
  const A* xa = reinterpret_cast<const A*>(x + base);
  const A* da = reinterpret_cast<const A*>(delta + (kDelta ? base : 0));
  const A* sa = reinterpret_cast<const A*>(scale);

  A rv[V], sv[V];
  A dv[kDelta ? V : 1];
  // every load first: x, delta and scale are in flight together
#pragma unroll
  for (int i = 0; i < V; ++i) {
    const int a = li + i * lanes;
    if (a < na) {
      rv[i] = xa[a];
      if constexpr (kDelta) dv[i] = da[a];
      sv[i] = sa[a];
    }
  }
  // each access's squares summed on their own, so a lane's sums do not
  // wait on one another, then the accesses' sums in order
  float part[V];
#pragma unroll
  for (int i = 0; i < V; ++i) {
    part[i] = 0.f;
    if (li + i * lanes < na) {
      T* re = reinterpret_cast<T*>(&rv[i]);
#pragma unroll
      for (int j = 0; j < kPack; ++j) {
        if constexpr (kDelta) {
          const T* de = reinterpret_cast<const T*>(&dv[i]);
          // torch's x + delta: the sum in f32, rounded once to T
          re[j] = rt::from_f32<T>(rt::to_f32<T>(re[j]) + rt::to_f32<T>(de[j]));
        }
        const float v = rt::to_f32<T>(re[j]);
        part[i] += v * v;
      }
    }
  }
  float ss = 0.f;
#pragma unroll
  for (int i = 0; i < V; ++i) ss += part[i];
  ss = rt::warp_sum(ss);
  if (warps_per_row > 1) {
    // one block is one row here: each warp's sum to shared memory, then
    // every thread adds them in warp order (the same bits in every lane)
    __shared__ float red[kMaxWarps];
    if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = ss;
    __syncthreads();
    ss = 0.f;
    for (int w = 0; w < warps_per_row; ++w) ss += red[w];
  }
  const float inv = rsqrtf(ss / static_cast<float>(d) + eps);

  A* ra = reinterpret_cast<A*>(r_out + (kDelta ? base : 0));
  A* oa = reinterpret_cast<A*>(out + base);
#pragma unroll
  for (int i = 0; i < V; ++i) {
    const int a = li + i * lanes;
    if (a < na) {
      const T* re = reinterpret_cast<const T*>(&rv[i]);
      const T* se = reinterpret_cast<const T*>(&sv[i]);
      A o;
      T* oe = reinterpret_cast<T*>(&o);
#pragma unroll
      for (int j = 0; j < kPack; ++j) {
        oe[j] = rt::from_f32<T>(rt::to_f32<T>(re[j]) * inv *
                                rt::to_f32<T>(se[j]));
      }
      if constexpr (kDelta) ra[a] = rv[i];
      oa[a] = o;
    }
  }
}

template <typename T, int kPack, int V, bool kDelta>
cudaError_t launch_add_norm(const void* x, const void* delta,
                            const void* scale, void* r_out, void* out,
                            int rows, int d, float eps, int warps_per_row,
                            int rows_per_block, cudaStream_t stream) {
  const int blocks = (rows + rows_per_block - 1) / rows_per_block;
  add_norm_kernel<T, kPack, V, kDelta>
      <<<blocks, 32 * warps_per_row * rows_per_block, 0, stream>>>(
          static_cast<const T*>(x), static_cast<const T*>(delta),
          static_cast<const T*>(scale), static_cast<T*>(r_out),
          static_cast<T*>(out), rows, d, eps, warps_per_row);
  return cudaGetLastError();
}

template <typename T, bool kDelta>
cudaError_t dispatch_add_norm(const void* x, const void* delta,
                              const void* scale, void* r_out, void* out,
                              int rows, int d, float eps, int vec,
                              int lanes, int rows_per_block, int vecs,
                              cudaStream_t s) {
  constexpr int kVec = 16 / sizeof(T);
  const int warps = lanes / 32;
  const bool pow2 = warps > 0 && (warps & (warps - 1)) == 0;
  if (lanes % 32 != 0 || !pow2 || rows_per_block < 1 ||
      warps * rows_per_block > kMaxWarps ||
      (warps > 1 && rows_per_block != 1))
    return cudaErrorInvalidConfiguration;
  if (vec) {
    const size_t ptrs = reinterpret_cast<size_t>(x) |
                        reinterpret_cast<size_t>(scale) |
                        reinterpret_cast<size_t>(out) |
                        (kDelta ? reinterpret_cast<size_t>(delta) |
                                      reinterpret_cast<size_t>(r_out)
                                : 0);
    if (d % kVec != 0 || (ptrs & 15) != 0) return cudaErrorMisalignedAddress;
  }
  const int na = vec ? d / kVec : d;
  if (na > lanes * vecs) return cudaErrorInvalidValue;
#define RT_NORM_CASE(V)                                                        \
  if (vecs == V)                                                               \
    return vec ? launch_add_norm<T, kVec, V, kDelta>(                          \
                     x, delta, scale, r_out, out, rows, d, eps, warps,         \
                     rows_per_block, s)                                        \
               : launch_add_norm<T, 1, V, kDelta>(                             \
                     x, delta, scale, r_out, out, rows, d, eps, warps,         \
                     rows_per_block, s);
  RT_NORM_CASE(1) RT_NORM_CASE(2) RT_NORM_CASE(4) RT_NORM_CASE(8)
  RT_NORM_CASE(16)
#undef RT_NORM_CASE
  return cudaErrorInvalidValue;
}

template <typename T>
cudaError_t dispatch(const void* x, const void* delta, const void* scale,
                     void* r_out, void* out, int rows, int d, float eps,
                     int body, int vec, int lanes, int rows_per_block,
                     int vecs, cudaStream_t s) {
  if (body == rt::kBodyCudaCore) {
    if (delta != nullptr) return cudaErrorInvalidValue;
    return launch<T>(x, scale, out, rows, d, eps, s);
  }
  if (body == rt::kBodyAddNorm) {
    if (delta == nullptr || r_out == nullptr) return cudaErrorInvalidValue;
    return dispatch_add_norm<T, true>(x, delta, scale, r_out, out, rows, d,
                                      eps, vec, lanes, rows_per_block, vecs,
                                      s);
  }
  if (body == rt::kBodyNorm) {
    if (delta != nullptr) return cudaErrorInvalidValue;
    return dispatch_add_norm<T, false>(x, nullptr, scale, nullptr, out, rows,
                                       d, eps, vec, lanes, rows_per_block,
                                       vecs, s);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" int rt_rmsnorm(const void* x, const void* delta, const void* scale,
                          void* r_out, void* out, int rows, int d, float eps,
                          int dtype, int body, int vec, int lanes,
                          int rows_per_block, int vecs, void* stream) {
  if (rows <= 0 || d <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return static_cast<int>(dispatch<float>(x, delta, scale, r_out, out, rows,
                                            d, eps, body, vec, lanes,
                                            rows_per_block, vecs, s));
  if (dtype == 1)
    return static_cast<int>(dispatch<__nv_bfloat16>(
        x, delta, scale, r_out, out, rows, d, eps, body, vec, lanes,
        rows_per_block, vecs, s));
  return static_cast<int>(cudaErrorInvalidValue);
}
