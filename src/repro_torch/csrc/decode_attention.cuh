// The flash-decode body shared by the paged and the dense decode kernels:
// one block computes every query head of one KV head of one row, walking
// the row's logical slots [0, klast] in tiles of kDecodeTile with a
// running softmax (m, l, acc) in f32.  Slot s is read through the row's
// block table (physical block table[s / bs], offset s % bs), so a dense
// cache row is the case of one block of bs = S slots whose table holds
// the row's own index.  Both kernels therefore sum the same slots in the
// same order, and the card's dense and paged streams agree bit for bit.
#pragma once

#include "common.cuh"

namespace rt {

constexpr int kDecodeThreads = 128;
constexpr int kDecodeTile = 64;   // logical KV slots per tile

// Floats of dynamic shared memory decode_row needs for G query heads.
inline size_t decode_smem_floats(int G, int hd) {
  return static_cast<size_t>(G) * hd * 2 +
         static_cast<size_t>(kDecodeTile) * (hd + 1) +
         static_cast<size_t>(kDecodeTile) * hd +
         static_cast<size_t>(G) * kDecodeTile + 3 * G;
}

// q: the G * hd query values of this (row, KV head); out likewise.
// kp / vp: pools laid out (NB, bs, KV, hd); table: the row's block table.
template <typename T>
__device__ __forceinline__ void decode_row(const T* __restrict__ q,
                                           const T* __restrict__ kp,
                                           const T* __restrict__ vp,
                                           const int* __restrict__ table,
                                           int klast, int bs, int KV, int kvh,
                                           int hd, int G, float scale,
                                           T* __restrict__ out, float* smem) {
  float* qs = smem;                            // G * hd
  float* ks = qs + G * hd;                     // kDecodeTile * (hd + 1)
  float* vs = ks + kDecodeTile * (hd + 1);     // kDecodeTile * hd
  float* sc = vs + kDecodeTile * hd;           // G * kDecodeTile
  float* acc = sc + G * kDecodeTile;           // G * hd
  float* m = acc + G * hd;                     // G
  float* l = m + G;                            // G
  float* alpha = l + G;                        // G

  load_row_f32<T>(qs, q, G * hd);
  for (int e = threadIdx.x; e < G * hd; e += blockDim.x) acc[e] = 0.f;
  for (int g = threadIdx.x; g < G; g += blockDim.x) {
    m[g] = kNegInf;
    l[g] = 0.f;
  }
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  for (int k0 = 0; k0 <= klast; k0 += kDecodeTile) {
    load_kv_tile<T>(ks, vs, kp, vp, table, k0, kDecodeTile, klast, bs, KV,
                    kvh, hd);
    __syncthreads();

    for (int e = threadIdx.x; e < G * kDecodeTile; e += blockDim.x) {
      const int g = e / kDecodeTile;
      const int ki = e - g * kDecodeTile;
      float s = kNegInf;
      if (k0 + ki <= klast) {
        const float* qr = qs + g * hd;
        const float* kr = ks + ki * (hd + 1);
        float dot = 0.f;
        for (int d = 0; d < hd; ++d) dot += qr[d] * kr[d];
        s = dot * scale;
      }
      sc[e] = s;
    }
    __syncthreads();

    for (int g = warp; g < G; g += nwarps) {
      float* row = sc + g * kDecodeTile;
      float mx = kNegInf;
      for (int i = lane; i < kDecodeTile; i += 32) mx = fmaxf(mx, row[i]);
      mx = warp_max(mx);
      const float m_new = fmaxf(m[g], mx);
      float sum = 0.f;
      for (int i = lane; i < kDecodeTile; i += 32) {
        const float pv = expf(row[i] - m_new);
        row[i] = pv;
        sum += pv;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float a = expf(m[g] - m_new);
        alpha[g] = a;
        l[g] = a * l[g] + sum;
        m[g] = m_new;
      }
    }
    __syncthreads();

    for (int e = threadIdx.x; e < G * hd; e += blockDim.x) {
      const int g = e / hd;
      const int d = e - g * hd;
      const float* pr = sc + g * kDecodeTile;
      float a = acc[e] * alpha[g];
      for (int i = 0; i < kDecodeTile; ++i) a += pr[i] * vs[i * hd + d];
      acc[e] = a;
    }
    __syncthreads();
  }

  for (int e = threadIdx.x; e < G * hd; e += blockDim.x) {
    const int g = e / hd;
    out[e] = from_f32<T>(acc[e] / fmaxf(l[g], 1e-30f));
  }
}

}  // namespace rt
