// Paged flash-decode: one query token per row against a paged KV pool,
// grouped-query attention, mask kpos <= pos, running softmax in f32.
//
// Replaces the TPU kernel
// src/repro/kernels/decode_attention.py::paged_decode_attention_pallas
// (body _paged_decode_kernel), i.e. the scores / softmax / value sum of
// the reference model's paged decode path
// (src/repro/models/attention.py::paged_decode_self_attention), which it
// computes after the caller's in-place write of the new token's K/V.
//
// Layout: the model's own pool layout (NB, bs, KV, hd) of one layer, read
// in place through the row's block table; the TPU kernel's (KV, NB, bs, D)
// layout is never built.  Each (row, KV head) computes every query head
// of its group (G = H / KV heads), so each K/V element read serves G
// queries, over the row's logical slots [0, min(pos, nb * bs - 1)],
// looking each slot's physical block up in the table itself; slots past
// pos are neither read nor scored.  Rows the scheduler has masked run at
// a frozen pos against an all-zero table (the scratch block 0), which
// this kernel reads like any other block and never indexes past nb.
//
// Bound on the H100: bytes.  Each row reads (pos + 1) * KV * hd K/V
// elements twice over (K and V) and does 4 flops per element and query
// head, G = 3 at smollm-360m, far below the ~295 flops per byte where the
// tensor cores would become the limit; in practice latency and SM fill.
//
// Two bodies (decode_attention.cuh, shared with the dense decode kernel),
// named by the wrapper's decode_body rule:
// * mma (bf16): decode_split.  Each (row, KV head) is a thread-block
//   cluster of `splits` CTAs (decode_splits: 7 at the main path's B 8,
//   KV 5, 280 CTAs) that cut the slot range between them by logical slot,
//   read pos on the device, run both products on the tensor cores and
//   merge their partials through distributed shared memory.
// * cuda_core (float32, and bf16 off the mma tiles): decode_row, grid
//   (B, KV), one block walking the row's slots in tiles of 64 on the f32
//   CUDA cores.
#include "decode_attention.cuh"

namespace {

template <typename T>
__global__ void __launch_bounds__(rt::kDecodeThreads)
paged_decode_kernel(const T* __restrict__ q, const T* __restrict__ kp,
                    const T* __restrict__ vp, const int* __restrict__ tables,
                    const int* __restrict__ pos, T* __restrict__ out, int H,
                    int KV, int hd, int bs, int nb, float scale) {
  const int b = blockIdx.x;
  const int kvh = blockIdx.y;
  const int G = H / KV;
  extern __shared__ float smem[];
  const int p = pos[b];
  const int max_len = nb * bs;
  const int klast = p < max_len - 1 ? p : max_len - 1;
  const size_t qoff = (static_cast<size_t>(b) * H + kvh * G) * hd;
  rt::decode_row<T>(q + qoff, kp, vp, tables + static_cast<size_t>(b) * nb,
                    klast, bs, KV, kvh, hd, G, scale, out + qoff, smem);
}

template <typename T>
cudaError_t launch(const void* q, const void* kp, const void* vp,
                   const void* tables, const void* pos, void* out, int B,
                   int H, int KV, int hd, int bs, int nb, float scale,
                   cudaStream_t stream) {
  const size_t bytes = rt::decode_smem_floats(H / KV, hd) * sizeof(float);
  cudaError_t err = rt::allow_smem(paged_decode_kernel<T>, bytes);
  if (err != cudaSuccess) return err;
  paged_decode_kernel<T><<<dim3(B, KV), rt::kDecodeThreads, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(kp),
      static_cast<const T*>(vp), static_cast<const int*>(tables),
      static_cast<const int*>(pos), static_cast<T*>(out), H, KV, hd, bs, nb,
      scale);
  return cudaGetLastError();
}

template <int HD>
__global__ void __launch_bounds__(rt::kSplitThreads)
paged_split_kernel(const __nv_bfloat16* __restrict__ q,
                   const __nv_bfloat16* __restrict__ kp,
                   const __nv_bfloat16* __restrict__ vp,
                   const int* __restrict__ tables, const int* __restrict__ pos,
                   __nv_bfloat16* __restrict__ out, int H, int KV, int bs,
                   int nb, float scale_log2) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int b = blockIdx.x;
  const int kvh = blockIdx.y;
  const int G = H / KV;
  const int klast = min(pos[b], nb * bs - 1);
  const size_t qoff = (static_cast<size_t>(b) * H + kvh * G) * HD;
  rt::decode_split<HD>(q + qoff, kp, vp, tables + static_cast<size_t>(b) * nb,
                       klast, bs, KV, kvh, G, scale_log2, out + qoff,
                       smem_raw);
}

template <int HD>
cudaError_t split_at(const void* q, const void* kp, const void* vp,
                     const void* tables, const void* pos, void* out, int B,
                     int H, int KV, int bs, int nb, float scale, int splits,
                     cudaStream_t s) {
  return rt::launch_split(
      paged_split_kernel<HD>, B, KV, splits, rt::split_smem_bytes(HD, H / KV),
      s, static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(kp),
      static_cast<const __nv_bfloat16*>(vp), static_cast<const int*>(tables),
      static_cast<const int*>(pos), static_cast<__nv_bfloat16*>(out), H, KV,
      bs, nb, scale * rt::kLog2e);
}

// The instantiation for head dim hd, one of HD, HD - 16, ..., 16 (the
// entry point takes 256, the wide layout, to split_at<256> itself).
template <int HD>
cudaError_t launch_split(int hd, const void* q, const void* kp,
                         const void* vp, const void* tables, const void* pos,
                         void* out, int B, int H, int KV, int bs, int nb,
                         float scale, int splits, cudaStream_t s) {
  if (hd == HD)
    return split_at<HD>(q, kp, vp, tables, pos, out, B, H, KV, bs, nb, scale,
                        splits, s);
  if constexpr (HD > 16)
    return launch_split<HD - 16>(hd, q, kp, vp, tables, pos, out, B, H, KV,
                                 bs, nb, scale, splits, s);
  return cudaErrorInvalidValue;
}

}  // namespace

// body: kBodyCudaCore or kBodyMma; splits (1 to 8) is read by the mma
// body only.
extern "C" int rt_paged_decode_attention(const void* q, const void* k_pool,
                                         const void* v_pool,
                                         const void* tables, const void* pos,
                                         void* out, int B, int H, int KV,
                                         int hd, int bs, int nb, float scale,
                                         int dtype, int body, int splits,
                                         void* stream) {
  if (B <= 0) return 0;
  if (KV <= 0 || H % KV != 0 || nb <= 0 || bs <= 0 || hd <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (body == rt::kBodyMma) {
    if (!rt::split_takes(dtype, hd, H / KV, splits, q, k_pool, v_pool, out))
      return static_cast<int>(cudaErrorInvalidValue);
    return static_cast<int>(
        hd == 256 ? split_at<256>(q, k_pool, v_pool, tables, pos, out, B, H,
                                  KV, bs, nb, scale, splits, s)
                  : launch_split<128>(hd, q, k_pool, v_pool, tables, pos, out,
                                      B, H, KV, bs, nb, scale, splits, s));
  }
  if (body != rt::kBodyCudaCore)
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0)
    return static_cast<int>(launch<float>(q, k_pool, v_pool, tables, pos, out, B,
                                          H, KV, hd, bs, nb, scale, s));
  if (dtype == 1)
    return static_cast<int>(launch<__nv_bfloat16>(q, k_pool, v_pool, tables, pos,
                                                  out, B, H, KV, hd, bs, nb,
                                                  scale, s));
  return static_cast<int>(cudaErrorInvalidValue);
}
