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
// layout is never built.
//
// Grid (B, KV): a block owns every query head of one KV head of one row
// (G = H / KV heads), so each K/V element it reads serves G queries.  It
// walks its row's logical slots [0, min(pos, nb * bs - 1)] in tiles of
// 64 slots (decode_attention.cuh, shared with the dense decode kernel),
// looking each slot's physical block up in the table itself;
// slots past pos are neither read nor scored.  Rows the scheduler has
// masked run at a frozen pos against an all-zero table (the scratch
// block 0), which this kernel reads like any other block and never
// indexes past nb.
//
// Bound on the H100: bytes.  Each row reads (pos + 1) * KV * hd K/V
// elements twice over (K and V) and does 4 flops per element and query
// head, G = 3 at smollm-360m, far below the ~295 flops per byte where the
// tensor cores would become the limit.  This first version keeps the
// reads coalesced (16-byte loads along hd) and the arithmetic on the f32
// CUDA cores; with B * KV = 40 blocks at the main path's shapes it fills
// only a third of the 132 SMs, which splitting the slot range across
// blocks (split-K flash decoding) would fix in a later change.
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

}  // namespace

extern "C" int rt_paged_decode_attention(const void* q, const void* k_pool,
                                         const void* v_pool,
                                         const void* tables, const void* pos,
                                         void* out, int B, int H, int KV,
                                         int hd, int bs, int nb, float scale,
                                         int dtype, void* stream) {
  if (B <= 0) return 0;
  if (KV <= 0 || H % KV != 0 || nb <= 0 || bs <= 0 || hd <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return static_cast<int>(launch<float>(q, k_pool, v_pool, tables, pos, out, B,
                                          H, KV, hd, bs, nb, scale, s));
  if (dtype == 1)
    return static_cast<int>(launch<__nv_bfloat16>(q, k_pool, v_pool, tables, pos,
                                                  out, B, H, KV, hd, bs, nb,
                                                  scale, s));
  return static_cast<int>(cudaErrorInvalidValue);
}
