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
// The partials form (rt_dense_decode_attention_partial) runs the same
// bodies over one rank's slice of a sequence-sharded cache: slot j of the
// slice is logical slot s_start + j, valid for s_start + j <= pos, so a
// row's last slot is pos - s_start, cut on the device (below 0: an empty
// slice; past S - 1: the whole slice).  In place of the output each body
// writes its f32 softmax partials (acc, m, l; decode_attention.cuh), which
// serving/decode.py combines across the ranks.  Replaces the reference's
// _local_flash_decode (src/repro/serving/decode.py:26), whose on-device
// body is this TPU kernel.
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
                    float scale, int s_start, rt::Partials part) {
  const int b = blockIdx.x;
  const int kvh = blockIdx.y;
  const int G = H / KV;
  extern __shared__ float smem[];
  __shared__ int table[1];          // row b's cache is block b of S slots
  if (threadIdx.x == 0) table[0] = b;
  const int p = pos[b] - s_start;
  const int klast = p < S - 1 ? p : S - 1;
  const size_t qoff = (static_cast<size_t>(b) * H + kvh * G) * hd;
  const size_t hoff = static_cast<size_t>(b) * H + kvh * G;
  if (part.acc != nullptr) {
    part.acc += qoff;
    part.m += hoff;
    part.l += hoff;
  }
  // decode_row's first __syncthreads publishes table[0]
  rt::decode_row<T>(q + qoff, kc, vc, table, klast, S, KV, kvh, hd, G, scale,
                    out + qoff, smem, part);
}

template <typename T>
cudaError_t launch(const void* q, const void* kc, const void* vc,
                   const void* pos, void* out, int B, int H, int KV, int hd,
                   int S, float scale, int s_start, rt::Partials part,
                   cudaStream_t stream) {
  const size_t bytes = rt::decode_smem_floats(H / KV, hd) * sizeof(float);
  cudaError_t err = rt::allow_smem(dense_decode_kernel<T>, bytes);
  if (err != cudaSuccess) return err;
  dense_decode_kernel<T><<<dim3(B, KV), rt::kDecodeThreads, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(kc),
      static_cast<const T*>(vc), static_cast<const int*>(pos),
      static_cast<T*>(out), H, KV, hd, S, scale, s_start, part);
  return cudaGetLastError();
}

template <int HD>
__global__ void __launch_bounds__(rt::kSplitThreads)
dense_split_kernel(const __nv_bfloat16* __restrict__ q,
                   const __nv_bfloat16* __restrict__ kc,
                   const __nv_bfloat16* __restrict__ vc,
                   const int* __restrict__ pos,
                   __nv_bfloat16* __restrict__ out, int H, int KV, int S,
                   float scale_log2, int s_start, rt::Partials part) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ int table[1];          // row b's cache is block b of S slots
  const int b = blockIdx.x;
  const int kvh = blockIdx.y;
  const int G = H / KV;
  if (threadIdx.x == 0) table[0] = b;
  __syncthreads();
  const int klast = min(pos[b] - s_start, S - 1);
  const size_t qoff = (static_cast<size_t>(b) * H + kvh * G) * HD;
  const size_t hoff = static_cast<size_t>(b) * H + kvh * G;
  if (part.acc != nullptr) {
    part.acc += qoff;
    part.m += hoff;
    part.l += hoff;
  }
  rt::decode_split<HD>(q + qoff, kc, vc, table, klast, S, KV, kvh, G,
                       scale_log2, out + qoff, smem_raw, part);
}

template <int HD>
cudaError_t split_at(const void* q, const void* kc, const void* vc,
                     const void* pos, void* out, int B, int H, int KV, int S,
                     float scale, int s_start, rt::Partials part, int splits,
                     cudaStream_t s) {
  return rt::launch_split(
      dense_split_kernel<HD>, B, KV, splits, rt::split_smem_bytes(HD, H / KV),
      s, static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(kc),
      static_cast<const __nv_bfloat16*>(vc), static_cast<const int*>(pos),
      static_cast<__nv_bfloat16*>(out), H, KV, S, scale * rt::kLog2e,
      s_start, part);
}

// The instantiation for head dim hd, one of HD, HD - 16, ..., 16 (the
// entry point takes 256, the wide layout, to split_at<256> itself).
template <int HD>
cudaError_t launch_split(int hd, const void* q, const void* kc,
                         const void* vc, const void* pos, void* out, int B,
                         int H, int KV, int S, float scale, int s_start,
                         rt::Partials part, int splits, cudaStream_t s) {
  if (hd == HD)
    return split_at<HD>(q, kc, vc, pos, out, B, H, KV, S, scale, s_start,
                        part, splits, s);
  if constexpr (HD > 16)
    return launch_split<HD - 16>(hd, q, kc, vc, pos, out, B, H, KV, S, scale,
                                 s_start, part, splits, s);
  return cudaErrorInvalidValue;
}

// Both entry points: out (the output) or part (the partials form), never
// both; `aligned` is the pointer the mma body's alignment check reads.
int dispatch(const void* q, const void* k_cache, const void* v_cache,
             const void* pos, void* out, const void* aligned, int B, int H,
             int KV, int hd, int S, float scale, int s_start,
             rt::Partials part, int dtype, int body, int splits,
             void* stream) {
  if (B <= 0) return 0;
  if (KV <= 0 || H % KV != 0 || S <= 0 || hd <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (body == rt::kBodyMma) {
    if (!rt::split_takes(dtype, hd, H / KV, splits, q, k_cache, v_cache,
                         aligned))
      return static_cast<int>(cudaErrorInvalidValue);
    return static_cast<int>(
        hd == 256 ? split_at<256>(q, k_cache, v_cache, pos, out, B, H, KV, S,
                                  scale, s_start, part, splits, s)
                  : launch_split<128>(hd, q, k_cache, v_cache, pos, out, B, H,
                                      KV, S, scale, s_start, part, splits, s));
  }
  if (body != rt::kBodyCudaCore)
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0)
    return static_cast<int>(launch<float>(q, k_cache, v_cache, pos, out, B, H,
                                          KV, hd, S, scale, s_start, part, s));
  if (dtype == 1)
    return static_cast<int>(launch<__nv_bfloat16>(q, k_cache, v_cache, pos,
                                                  out, B, H, KV, hd, S, scale,
                                                  s_start, part, s));
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// body and splits as for rt_paged_decode_attention.
extern "C" int rt_dense_decode_attention(const void* q, const void* k_cache,
                                         const void* v_cache, const void* pos,
                                         void* out, int B, int H, int KV,
                                         int hd, int S, float scale, int dtype,
                                         int body, int splits, void* stream) {
  return dispatch(q, k_cache, v_cache, pos, out, out, B, H, KV, hd, S, scale,
                  0, rt::Partials{}, dtype, body, splits, stream);
}

// The partials form over one rank's slice (B, S, KV, hd) of the cache,
// whose slot 0 is logical slot s_start: acc (B, H, hd), m and l (B, H),
// all float32.  body and splits as for rt_dense_decode_attention.
extern "C" int rt_dense_decode_attention_partial(
    const void* q, const void* k_cache, const void* v_cache, const void* pos,
    void* acc, void* m, void* l, int B, int H, int KV, int hd, int S,
    int s_start, float scale, int dtype, int body, int splits, void* stream) {
  if (acc == nullptr || m == nullptr || l == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  rt::Partials part;
  part.acc = static_cast<float*>(acc);
  part.m = static_cast<float*>(m);
  part.l = static_cast<float*>(l);
  return dispatch(q, k_cache, v_cache, pos, nullptr, acc, B, H, KV, hd, S,
                  scale, s_start, part, dtype, body, splits, stream);
}
