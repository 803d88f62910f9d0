// Dense flash-decode: one query token per row against that row's
// contiguous KV cache, grouped-query attention, mask kpos <= pos (and
// kpos < S), running softmax in f32.
//
// Replaces the TPU kernel
// src/repro/kernels/decode_attention.py::decode_attention_pallas (body
// _decode_kernel), i.e. the scores / softmax / value sum of the reference
// model's dense decode path
// (src/repro/models/attention.py::decode_self_attention), which it
// computes after the caller's in-place write of the new token's K/V.
//
// Layout: the model's own dense cache layout (B, S, KV, hd) of one layer
// (models/kvcache.py::cache_struct), read in place; the TPU kernel's
// (B, KV, S, D) layout is never built.
//
// Both bodies are the paged kernel's (decode_attention.cuh), named by the
// same rule (decode_body) and, for the mma body, split by the same rule
// (decode_splits over the row capacity S): the row's cache is one block of
// S slots whose table holds the row's index, so the dense and paged
// kernels sum the same slots in the same order and give the same bits.
// Rows whose budget ran out decode token 0 at a frozen pos and are
// computed like any other row.
//
// Bound on the H100: bytes, as for the paged kernel (4 flops per K/V
// element and query head against 2 or 4 bytes per element); in practice
// latency and SM fill, which the mma body's split across a cluster
// addresses (paged_decode_attention.cu).
#include "decode_attention.cuh"

namespace {

template <typename T>
__global__ void __launch_bounds__(rt::kDecodeThreads)
dense_decode_kernel(const T* __restrict__ q, const T* __restrict__ kc,
                    const T* __restrict__ vc, const int* __restrict__ pos,
                    T* __restrict__ out, int H, int KV, int hd, int S,
                    float scale) {
  const int b = blockIdx.x;
  const int kvh = blockIdx.y;
  const int G = H / KV;
  extern __shared__ float smem[];
  __shared__ int table[1];          // row b's cache is block b of S slots
  if (threadIdx.x == 0) table[0] = b;
  const int p = pos[b];
  const int klast = p < S - 1 ? p : S - 1;
  const size_t qoff = (static_cast<size_t>(b) * H + kvh * G) * hd;
  // decode_row's first __syncthreads publishes table[0]
  rt::decode_row<T>(q + qoff, kc, vc, table, klast, S, KV, kvh, hd, G, scale,
                    out + qoff, smem);
}

template <typename T>
cudaError_t launch(const void* q, const void* kc, const void* vc,
                   const void* pos, void* out, int B, int H, int KV, int hd,
                   int S, float scale, cudaStream_t stream) {
  const size_t bytes = rt::decode_smem_floats(H / KV, hd) * sizeof(float);
  cudaError_t err = rt::allow_smem(dense_decode_kernel<T>, bytes);
  if (err != cudaSuccess) return err;
  dense_decode_kernel<T><<<dim3(B, KV), rt::kDecodeThreads, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(kc),
      static_cast<const T*>(vc), static_cast<const int*>(pos),
      static_cast<T*>(out), H, KV, hd, S, scale);
  return cudaGetLastError();
}

template <int HD>
__global__ void __launch_bounds__(rt::kSplitThreads)
dense_split_kernel(const __nv_bfloat16* __restrict__ q,
                   const __nv_bfloat16* __restrict__ kc,
                   const __nv_bfloat16* __restrict__ vc,
                   const int* __restrict__ pos,
                   __nv_bfloat16* __restrict__ out, int H, int KV, int S,
                   float scale_log2) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ int table[1];          // row b's cache is block b of S slots
  const int b = blockIdx.x;
  const int kvh = blockIdx.y;
  const int G = H / KV;
  if (threadIdx.x == 0) table[0] = b;
  __syncthreads();
  const int klast = min(pos[b], S - 1);
  const size_t qoff = (static_cast<size_t>(b) * H + kvh * G) * HD;
  rt::decode_split<HD>(q + qoff, kc, vc, table, klast, S, KV, kvh, G,
                       scale_log2, out + qoff, smem_raw);
}

template <int HD>
cudaError_t split_at(const void* q, const void* kc, const void* vc,
                     const void* pos, void* out, int B, int H, int KV, int S,
                     float scale, int splits, cudaStream_t s) {
  return rt::launch_split(
      dense_split_kernel<HD>, B, KV, splits, rt::split_smem_bytes(HD, H / KV),
      s, static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(kc),
      static_cast<const __nv_bfloat16*>(vc), static_cast<const int*>(pos),
      static_cast<__nv_bfloat16*>(out), H, KV, S, scale * rt::kLog2e);
}

// The instantiation for head dim hd, one of HD, HD - 16, ..., 16 (the
// entry point takes 256, the wide layout, to split_at<256> itself).
template <int HD>
cudaError_t launch_split(int hd, const void* q, const void* kc,
                         const void* vc, const void* pos, void* out, int B,
                         int H, int KV, int S, float scale, int splits,
                         cudaStream_t s) {
  if (hd == HD)
    return split_at<HD>(q, kc, vc, pos, out, B, H, KV, S, scale, splits, s);
  if constexpr (HD > 16)
    return launch_split<HD - 16>(hd, q, kc, vc, pos, out, B, H, KV, S, scale,
                                 splits, s);
  return cudaErrorInvalidValue;
}

}  // namespace

// body and splits as for rt_paged_decode_attention.
extern "C" int rt_dense_decode_attention(const void* q, const void* k_cache,
                                         const void* v_cache, const void* pos,
                                         void* out, int B, int H, int KV,
                                         int hd, int S, float scale, int dtype,
                                         int body, int splits, void* stream) {
  if (B <= 0) return 0;
  if (KV <= 0 || H % KV != 0 || S <= 0 || hd <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (body == rt::kBodyMma) {
    if (!rt::split_takes(dtype, hd, H / KV, splits, q, k_cache, v_cache, out))
      return static_cast<int>(cudaErrorInvalidValue);
    return static_cast<int>(
        hd == 256 ? split_at<256>(q, k_cache, v_cache, pos, out, B, H, KV, S,
                                  scale, splits, s)
                  : launch_split<128>(hd, q, k_cache, v_cache, pos, out, B, H,
                                      KV, S, scale, splits, s));
  }
  if (body != rt::kBodyCudaCore)
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0)
    return static_cast<int>(launch<float>(q, k_cache, v_cache, pos, out, B, H,
                                          KV, hd, S, scale, s));
  if (dtype == 1)
    return static_cast<int>(launch<__nv_bfloat16>(q, k_cache, v_cache, pos,
                                                  out, B, H, KV, hd, S, scale,
                                                  s));
  return static_cast<int>(cudaErrorInvalidValue);
}
