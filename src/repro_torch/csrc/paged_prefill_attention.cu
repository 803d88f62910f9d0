// Paged causal flash attention for chunked prefill: C query tokens of one
// request at positions pos .. pos + C - 1 attend causally to the logical
// slots [0, pos + C) of a paged KV pool, through the request's block
// table, with an online softmax in f32.
//
// Replaces the TPU kernel
// src/repro/kernels/flash_attention.py::flash_attention_pallas (body
// _flash_kernel) in the form the reference model's prefill runs it: the
// linear branch of src/repro/models/attention.py::paged_chunk_self_attention,
// computed after the caller's in-place write of the chunk's K/V.  Called
// with pos = 0 and an identity table it computes what
// flash_attention_pallas(causal=True, window=0) computes for contiguous
// K/V.  The sliding window is not on this path.
//
// Grid (ceil(C / kTileQ), H): a block owns kTileQ queries of one head and
// walks key tiles of kTileK logical slots, looking each slot's physical
// block up in the table itself.  Key tiles past the query tile's last
// position are skipped, so causal prefill reads about half the slots a
// full square would.
//
// Bound on the H100: operations once the prefix is long (4 * H * hd flops
// per query-key pair against 2 * KV * hd elements per key), bytes for
// short prefixes.  This first version runs the products on the f32 CUDA
// cores out of shared memory; moving them onto the tensor cores (mma /
// wgmma on bf16 tiles) is the change that would approach the bound.
#include "common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kTileQ = 32;   // queries per block
constexpr int kTileK = 32;   // logical KV slots per key tile (one per lane)

template <typename T>
__global__ void __launch_bounds__(kThreads)
paged_prefill_kernel(const T* __restrict__ q, const T* __restrict__ kp,
                     const T* __restrict__ vp, const int* __restrict__ table,
                     T* __restrict__ out, int C, int H, int KV, int hd, int bs,
                     int nb, int pos, float scale) {
  const int q0 = blockIdx.x * kTileQ;
  const int h = blockIdx.y;
  const int kvh = h / (H / KV);
  const int nq = C - q0 < kTileQ ? C - q0 : kTileQ;
  extern __shared__ float smem[];
  float* qs = smem;                          // kTileQ * hd
  float* ks = qs + kTileQ * hd;              // kTileK * (hd + 1)
  float* vs = ks + kTileK * (hd + 1);        // kTileK * hd
  float* sc = vs + kTileK * hd;              // kTileQ * kTileK
  float* acc = sc + kTileQ * kTileK;         // kTileQ * hd
  float* m = acc + kTileQ * hd;              // kTileQ
  float* l = m + kTileQ;                     // kTileQ
  float* alpha = l + kTileQ;                 // kTileQ

  for (int e = threadIdx.x; e < kTileQ * hd; e += blockDim.x) {
    const int qi = e / hd;
    const int d = e - qi * hd;
    qs[e] = qi < nq
        ? rt::to_f32<T>(q[(static_cast<size_t>(q0 + qi) * H + h) * hd + d])
        : 0.f;
    acc[e] = 0.f;
  }
  for (int qi = threadIdx.x; qi < kTileQ; qi += blockDim.x) {
    m[qi] = rt::kNegInf;
    l[qi] = 0.f;
  }
  __syncthreads();

  const int max_len = nb * bs;
  const int last_q = pos + q0 + nq - 1;            // tile's last position
  const int klast = last_q < max_len - 1 ? last_q : max_len - 1;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;

  for (int k0 = 0; k0 <= klast; k0 += kTileK) {
    rt::load_kv_tile<T>(ks, vs, kp, vp, table, k0, kTileK, klast, bs, KV, kvh, hd);
    __syncthreads();

    for (int e = threadIdx.x; e < kTileQ * kTileK; e += blockDim.x) {
      const int qi = e / kTileK;
      const int ki = e - qi * kTileK;
      const int kpos = k0 + ki;
      float s = rt::kNegInf;
      if (qi < nq && kpos <= pos + q0 + qi && kpos <= klast) {
        const float* qr = qs + qi * hd;
        const float* kr = ks + ki * (hd + 1);
        float dot = 0.f;
        for (int d = 0; d < hd; ++d) dot += qr[d] * kr[d];
        s = dot * scale;
      }
      sc[e] = s;
    }
    __syncthreads();

    for (int qi = warp; qi < kTileQ; qi += nwarps) {
      const float v = sc[qi * kTileK + lane];
      const float m_new = fmaxf(m[qi], rt::warp_max(v));
      const float pv = expf(v - m_new);
      sc[qi * kTileK + lane] = pv;
      const float sum = rt::warp_sum(pv);
      if (lane == 0) {
        const float a = expf(m[qi] - m_new);
        alpha[qi] = a;
        l[qi] = a * l[qi] + sum;
        m[qi] = m_new;
      }
    }
    __syncthreads();

    for (int e = threadIdx.x; e < kTileQ * hd; e += blockDim.x) {
      const int qi = e / hd;
      const int d = e - qi * hd;
      const float* pr = sc + qi * kTileK;
      float a = acc[e] * alpha[qi];
#pragma unroll 8
      for (int ki = 0; ki < kTileK; ++ki) a += pr[ki] * vs[ki * hd + d];
      acc[e] = a;
    }
    __syncthreads();
  }

  for (int e = threadIdx.x; e < nq * hd; e += blockDim.x) {
    const int qi = e / hd;
    const int d = e - qi * hd;
    out[(static_cast<size_t>(q0 + qi) * H + h) * hd + d] =
        rt::from_f32<T>(acc[e] / fmaxf(l[qi], 1e-30f));
  }
}

template <typename T>
cudaError_t launch(const void* q, const void* kp, const void* vp,
                   const void* table, void* out, int C, int H, int KV, int hd,
                   int bs, int nb, int pos, float scale, cudaStream_t stream) {
  const size_t floats = static_cast<size_t>(kTileQ) * hd * 2 +
                        static_cast<size_t>(kTileK) * (hd + 1) +
                        static_cast<size_t>(kTileK) * hd +
                        static_cast<size_t>(kTileQ) * kTileK + 3 * kTileQ;
  const size_t bytes = floats * sizeof(float);
  cudaError_t err = rt::allow_smem(paged_prefill_kernel<T>, bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((C + kTileQ - 1) / kTileQ, H);
  paged_prefill_kernel<T><<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(kp),
      static_cast<const T*>(vp), static_cast<const int*>(table),
      static_cast<T*>(out), C, H, KV, hd, bs, nb, pos, scale);
  return cudaGetLastError();
}

}  // namespace

extern "C" int rt_paged_prefill_attention(const void* q, const void* k_pool,
                                          const void* v_pool,
                                          const void* table, void* out, int C,
                                          int H, int KV, int hd, int bs,
                                          int nb, int pos, float scale,
                                          int dtype, void* stream) {
  if (C <= 0) return 0;
  if (KV <= 0 || H % KV != 0 || nb <= 0 || bs <= 0 || hd <= 0 || pos < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return static_cast<int>(launch<float>(q, k_pool, v_pool, table, out, C, H,
                                          KV, hd, bs, nb, pos, scale, s));
  if (dtype == 1)
    return static_cast<int>(launch<__nv_bfloat16>(q, k_pool, v_pool, table, out,
                                                  C, H, KV, hd, bs, nb, pos,
                                                  scale, s));
  return static_cast<int>(cudaErrorInvalidValue);
}
