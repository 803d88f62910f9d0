// The flash-decode bodies shared by the paged and the dense decode
// kernels.  Slot s of a row is read through the row's block table
// (physical block table[s / bs], offset s % bs), so a dense cache row is
// the case of one block of bs = S slots whose table holds the row's own
// index; both kernels therefore sum the same slots in the same order, and
// the card's dense and paged streams agree bit for bit.  Each kernel's
// wrapper names a body by one rule (kernels/decode_attention.py::
// decode_body), and its entry point refuses a body the shape cannot take.
//
// * decode_row, the cuda_core body (float32 at every shape, bf16 off the
//   mma tiles): one block of 128 threads computes every query head of
//   one KV head of one row, walking the row's logical slots [0, klast] in
//   tiles of kDecodeTile with a running softmax (m, l, acc) in f32 on the
//   CUDA cores.  float32 stays here because the card's float32 streams
//   must equal the CPU's, and tensor cores would round f32 inputs.
// * decode_split, the mma body (bf16, 16-byte aligned tensors, and hd %
//   16 == 0 up to 128 with G <= 16, or hd 256 with G <= 8): below.
//
// Either body writes, in place of the normalised output, the f32 softmax
// partials of its slots when handed a Partials (the dense kernel's
// partials form, the on-device body of the seq-parallel flash-decode,
// serving/decode.py): acc (G * hd, unnormalised), m and l (G), m in the
// natural units of the scores s * scale.  A row with no valid slot
// writes acc = 0, l = 0 and m = kNegInf exactly, as the reference's
// masked max gives (src/repro/serving/decode.py::_local_flash_decode).
#pragma once

#include <cooperative_groups.h>

#include "common.cuh"
#include "mma.cuh"

namespace rt {

constexpr int kDecodeThreads = 128;
constexpr int kDecodeTile = 64;   // logical KV slots per tile

// Where a body writes its softmax partials instead of its output: acc at
// the output's offset, m and l at the (row, head) offset.  A null acc
// means the body writes the normalised output.
struct Partials {
  float* acc = nullptr;
  float* m = nullptr;
  float* l = nullptr;
};

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
                                           T* __restrict__ out, float* smem,
                                           Partials part = {}) {
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

  if (part.acc != nullptr) {
    for (int e = threadIdx.x; e < G * hd; e += blockDim.x) part.acc[e] = acc[e];
    for (int g = threadIdx.x; g < G; g += blockDim.x) {
      part.m[g] = m[g];
      part.l[g] = l[g];
    }
    return;
  }
  for (int e = threadIdx.x; e < G * hd; e += blockDim.x) {
    const int g = e / hd;
    out[e] = from_f32<T>(acc[e] / fmaxf(l[g], 1e-30f));
  }
}


// ---------------------------------------------------------------------------
// decode_split: the split-slot flash-decode body (bf16)
// ---------------------------------------------------------------------------
// Replaces the TPU kernels' bodies _paged_decode_kernel
// (src/repro/kernels/decode_attention.py:117) and _decode_kernel (:36).
//
// Bound on the H100: bytes.  A decode step reads each live slot's K and V
// rows once (2 * hd * 2 bytes per slot and KV head) for 4 * G * hd flops,
// far below the ~295 flops per byte where the tensor cores would become
// the limit.  At the main path's shape (B 8, KV 5, a few hundred live
// slots a row) that is 2 to 4 MB, about 1 us at 3.35 TB/s, so the time
// goes to latency: one block per (row, KV head) is 40 blocks on 132 SMs,
// each walking up to 616 slots alone, one synchronous tile after another.
//
// What the design does about it:
// * Split the slot range across a cluster.  Each (row, KV head) is a
//   thread-block cluster of `splits` CTAs (<= 8, portable), named by the
//   wrapper's decode_splits(B, KV, nb * bs, hd) so the card holds about
//   two CTAs per SM (40 pairs -> 7 x 40 = 280 CTAs; at hd 256, one CTA
//   an SM, the most whose clusters all fit at once).  Each CTA reads pos on
//   the device and takes a share of the row's logical slots [0, klast]
//   cut at 16-slot chunks: chunks [r * per, (r + 1) * per) of
//   ceil((klast + 1) / 16), per = ceil(chunks / splits).  Launch
//   parameters depend on shapes alone (the host never reads pos, so a
//   macro-step can run ahead of it and be captured in a graph).  CTAs
//   whose share lies past klast compute nothing and join the merge with
//   (m = -inf, l = 0).
// * Overlap loads with compute.  A ring of 3 stages of 64 slots (K and V
//   rows of the share, 16-byte cp.async through the block table into
//   padded tiles, zero-filled past the share) keeps two steps in flight
//   while one computes; at the main path's shapes a CTA's whole share is
//   in flight at once.
// * The products on the tensor cores.  Each of the 4 warps takes one
//   16-slot chunk of a step: S = Q K^T on mma.sync m16n8k16 with the G
//   query heads on the m16 side (zero-padded; the rows are free, the
//   tensor cores idle otherwise) and 16 slots as two n8 tiles, Q held in
//   registers for the whole share and K by ldmatrix; the online softmax
//   runs on the accumulator fragments in f32 (log2 domain, exp2f); O +=
//   P V with P as the A operand in three bf16 parts, hi + mid + lo,
//   against V by ldmatrix.trans into f32 accumulators.  Products of bf16
//   values are exact in f32 and the three parts carry P to f32's own
//   precision, so the arithmetic is f32 throughout, as in the cuda_core
//   body; only the summation order differs.
// * Merge in a fixed order.  Each warp's (m, l, O) goes to shared memory
//   and the CTA merges its 4 warps in warp order; after a cluster
//   barrier every CTA merges a share of the G * hd outputs over all the
//   cluster's partials in split order, read through distributed shared
//   memory, divides by l and rounds once to bf16; a second barrier keeps
//   each partial alive until its readers are done.  No workspace, no
//   atomics, no second launch.
// Every cut is by logical slot, never by block, and the merge order is
// fixed, so the bits depend neither on bs, nor on the table, nor on
// timing.
//
// At hd 256 (gemma3-12b: G = 2, rows of up to 2,176 slots, 2 x 8 KV
// heads x 512 B a slot) heads on the m16 side would cost each warp 128
// f32 registers of O and 64 of Q, with 14 of the 16 rows zero.  The wide
// layout puts a warp's 16 slots on m16 and up to 8 heads on n8 instead:
// S^T = K Q^T (K by ldmatrix as the A operand, Q^T held as B fragments,
// 32 registers) and O^T += V^T P^T (V^T by ldmatrix.trans as A; P^T's
// accumulator halves moved into the B layout by movmatrix.trans, in the
// same three bf16 parts), so O is HD / 16 = 16 m-tiles of 16 dims x 8
// heads, 64 registers a thread, and each k16 step of either product is
// one mma where the narrow layout takes two.  A head's max and sum run
// over the 8 lanes of its column.  The ring stays 3 stages of 64 slots,
// 3 x 2 x 64 x 264 x 2 = 202,752 B: one CTA an SM, with two steps (128
// KB) in flight on each SM, past what the SM's share of the card's
// bandwidth needs to be covered; the split and the merges are the
// narrow layout's, so paged = dense and the bits' independence of bs
// hold unchanged.
constexpr int kSplitWarps = 4;
constexpr int kSplitThreads = 32 * kSplitWarps;
constexpr int kSplitChunk = 16;                          // slots a warp takes
constexpr int kSplitSpan = kSplitChunk * kSplitWarps;    // slots per step
constexpr int kSplitStages = 3;
constexpr int kMaxDecodeSplits = 8;                      // portable cluster
constexpr int kMaxSplitHeads = 16;                       // G on the m16 side
constexpr int kMaxSplitHeadsWide = 8;                    // G on the n8 side
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// Dynamic shared memory of decode_split: the K/V ring, reused after the
// walk for the warps' and the CTA's partials.
inline size_t split_smem_bytes(int hd, int G) {
  const size_t ring = static_cast<size_t>(kSplitStages) * 2 * kSplitSpan *
                      (hd + 8) * sizeof(__nv_bfloat16);
  const size_t parts = static_cast<size_t>(kSplitWarps + 1) * G * (hd + 2) *
                       sizeof(float);
  return ring > parts ? ring : parts;
}

// q: the G * HD query values of this (row, KV head); out likewise.
// kp / vp: pools laid out (NB, bs, KV, HD); table: the row's block table.
// Launched as clusters of gridDim.z CTAs, this CTA being split blockIdx.z.
// HD <= 128: heads on the m16 side (G <= 16).  HD 256 (wide): slots on
// the m16 side and heads on n8 (G <= 8), S^T = K Q^T and O^T = V^T P^T,
// so a warp keeps HD / 16 output fragments instead of HD / 8.
template <int HD>
__device__ __forceinline__ void decode_split(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ kp,
    const __nv_bfloat16* __restrict__ vp, const int* __restrict__ table,
    int klast, int bs, int KV, int kvh, int G, float scale_log2,
    __nv_bfloat16* __restrict__ out, unsigned char* smem_raw,
    Partials part = {}) {
  constexpr bool kWide = HD > 128;   // slots on m16, heads on n8
  constexpr int kStride = HD + 8;    // smem row, in bf16
  constexpr int kRowChunks = HD / 8; // 16-byte chunks per slot row
  constexpr int kKSteps = HD / 16;   // k16 steps of Q K^T
  constexpr int kPRow = HD + 2;      // partial row: O, then m and l
  __nv_bfloat16* ks = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* vs = ks + kSplitStages * kSplitSpan * kStride;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int grp = lane >> 2;
  const int tig = lane & 3;
  const int split = blockIdx.z;
  const int splits = gridDim.z;

  // this CTA's share: 16-slot chunks [c0, c1) of the row's [0, klast]
  const int nch = klast >= 0 ? klast / kSplitChunk + 1 : 0;
  const int per = (nch + splits - 1) / splits;
  const int c0 = split * per;
  const int c1 = min(c0 + per, nch);
  const int nsteps =
      c1 > c0 ? (c1 - c0 + kSplitWarps - 1) / kSplitWarps : 0;
  const int slast = min(klast, c1 * kSplitChunk - 1);

  // step it: slots [s0, s0 + kSplitSpan) into ring buffer buf, zero past
  // the share
  auto load = [&](int it, int buf) {
    const int s0 = (c0 + it * kSplitWarps) * kSplitChunk;
    __nv_bfloat16* kd = ks + buf * kSplitSpan * kStride;
    __nv_bfloat16* vd = vs + buf * kSplitSpan * kStride;
    for (int e = tid; e < kSplitSpan * kRowChunks; e += kSplitThreads) {
      const int ki = e / kRowChunks;
      const int c = e - ki * kRowChunks;
      const int s = s0 + ki;
      size_t off = 0;
      int n = 0;
      if (s <= slast) {
        const int blk = s / bs;
        off = ((static_cast<size_t>(table[blk]) * bs + (s - blk * bs)) * KV +
               kvh) * HD + c * 8;
        n = 16;
      }
      cp_async16(kd + ki * kStride + c * 8, kp + off, n);
      cp_async16(vd + ki * kStride + c * 8, vp + off, n);
    }
  };
#pragma unroll
  for (int i = 0; i < kSplitStages - 1; ++i) {
    if (i < nsteps) load(i, i);
    cp_async_commit();
  }

  // Q in registers, zero past G.  Not wide: the A operand, row grp head
  // grp, row grp + 8 head grp + 8.  Wide: the B operand (Q^T), column
  // grp head grp.
  uint32_t qf[kKSteps][kWide ? 2 : 4];
#pragma unroll
  for (int kk = 0; kk < kKSteps; ++kk)
#pragma unroll
    for (int r = 0; r < (kWide ? 2 : 4); ++r) {
      const int g = kWide ? grp : grp + 8 * (r & 1);
      const int d = kWide ? kk * 16 + 2 * tig + 8 * r
                          : kk * 16 + 2 * tig + 8 * (r >> 1);
      qf[kk][r] = g < G ? *reinterpret_cast<const uint32_t*>(q + g * HD + d)
                        : 0u;
    }

  // Not wide: o[HD / 8] n-tiles of (heads grp, grp + 8) x 8 dims; m_a / l_a
  // are head grp's, m_b / l_b head grp + 8's.  Wide: o[HD / 16] m-tiles of
  // 16 dims x (heads 2 tig, 2 tig + 1); m_a / l_a are head 2 tig's, m_b /
  // l_b head 2 tig + 1's.
  constexpr int kOTiles = kWide ? HD / 16 : HD / 8;
  float o[kOTiles][4];
#pragma unroll
  for (int d = 0; d < kOTiles; ++d)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[d][e] = 0.f;
  float m_a = kNegInf, m_b = kNegInf, l_a = 0.f, l_b = 0.f;

  for (int it = 0; it < nsteps; ++it) {
    cp_async_wait<kSplitStages - 2>();
    __syncthreads();     // step it landed; step it - 1's buffer is free
    const int nxt = it + kSplitStages - 1;
    if (nxt < nsteps) load(nxt, nxt % kSplitStages);
    cp_async_commit();
    const int chunk = c0 + it * kSplitWarps + warp;
    if (chunk >= c1) continue;
    const int k0 = chunk * kSplitChunk;
    const int buf = it % kSplitStages;
    const __nv_bfloat16* kt = ks + (buf * kSplitSpan + warp * kSplitChunk) *
                                       kStride;
    const __nv_bfloat16* vt = vs + (buf * kSplitSpan + warp * kSplitChunk) *
                                       kStride;
    if constexpr (kWide) {
      // S^T = K Q^T: 16 slots x 8 heads; this lane holds slots k0 + grp
      // (st[0], st[1]) and k0 + grp + 8 (st[2], st[3]) of heads 2 tig,
      // 2 tig + 1
      float st[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int kk = 0; kk < kKSteps; ++kk) {
        uint32_t a[4];
        ldmatrix_x4(a, kt + (lane & 15) * kStride + kk * 16 + (lane >> 4) * 8);
        mma_bf16(st, a, qf[kk][0], qf[kk][1]);
      }
      // into the log2 domain, slots past klast masked; each head's max
      // and sum run over the 8 lanes of its column (lane bits 2-4)
      const bool va = k0 + grp <= klast;
      const bool vb = k0 + grp + 8 <= klast;
      const float s0 = va ? st[0] * scale_log2 : kNegInf;
      const float s1 = va ? st[1] * scale_log2 : kNegInf;
      const float s2 = vb ? st[2] * scale_log2 : kNegInf;
      const float s3 = vb ? st[3] * scale_log2 : kNegInf;
      float mx_a = fmaxf(s0, s2), mx_b = fmaxf(s1, s3);
#pragma unroll
      for (int o2 = 4; o2 < 32; o2 <<= 1) {
        mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, o2));
        mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, o2));
      }
      const float mn_a = fmaxf(m_a, mx_a);
      const float mn_b = fmaxf(m_b, mx_b);
      const float al_a = exp2f(m_a - mn_a);
      const float al_b = exp2f(m_b - mn_b);
      m_a = mn_a;
      m_b = mn_b;
      const float p0 = exp2f(s0 - mn_a), p1 = exp2f(s1 - mn_b);
      const float p2 = exp2f(s2 - mn_a), p3 = exp2f(s3 - mn_b);
      float sum_a = p0 + p2, sum_b = p1 + p3;
#pragma unroll
      for (int o2 = 4; o2 < 32; o2 <<= 1) {
        sum_a += __shfl_xor_sync(0xffffffffu, sum_a, o2);
        sum_b += __shfl_xor_sync(0xffffffffu, sum_b, o2);
      }
      l_a = l_a * al_a + sum_a;
      l_b = l_b * al_b + sum_b;
#pragma unroll
      for (int d = 0; d < kOTiles; ++d) {
        o[d][0] *= al_a;
        o[d][1] *= al_b;
        o[d][2] *= al_a;
        o[d][3] *= al_b;
      }
      // O^T += V^T P^T: P^T (16 slots x 8 heads) as the B operand in
      // three bf16 parts, each 8-slot half transposed from the
      // accumulator layout by movmatrix; V^T by ldmatrix.trans
      uint32_t pb[3][2];
      {
        uint32_t h0, m0, l0, h1, m1, l1;
        split3_bf16(p0, p1, h0, m0, l0);     // slot grp
        split3_bf16(p2, p3, h1, m1, l1);     // slot grp + 8
        pb[0][0] = movmatrix_trans(h0);
        pb[1][0] = movmatrix_trans(m0);
        pb[2][0] = movmatrix_trans(l0);
        pb[0][1] = movmatrix_trans(h1);
        pb[1][1] = movmatrix_trans(m1);
        pb[2][1] = movmatrix_trans(l1);
      }
#pragma unroll
      for (int d = 0; d < kOTiles; ++d) {
        uint32_t a[4];
        ldmatrix_x4_trans(a, vt + ((lane & 7) + ((lane >> 4) << 3)) * kStride +
                                 d * 16 + ((lane >> 3) & 1) * 8);
#pragma unroll
        for (int part = 0; part < 3; ++part)
          mma_bf16(o[d], a, pb[part][0], pb[part][1]);
      }
    } else {
      // S = Q K^T: heads x 16 slots, as two n8 tiles
      float sc[2][4];
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) sc[j][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < kKSteps; ++kk) {
        uint32_t b[4];
        ldmatrix_x4(b, kt + ((lane & 7) + ((lane >> 4) << 3)) * kStride +
                           kk * 16 + ((lane >> 3) & 1) * 8);
        mma_bf16(sc[0], qf[kk], b[0], b[1]);
        mma_bf16(sc[1], qf[kk], b[2], b[3]);
      }
      // into the log2 domain, slots past klast masked
      float mx_a = kNegInf, mx_b = kNegInf;
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = k0 + 8 * j + 2 * tig + (e & 1);
          const float v = key <= klast ? sc[j][e] * scale_log2 : kNegInf;
          sc[j][e] = v;
          if (e < 2) mx_a = fmaxf(mx_a, v); else mx_b = fmaxf(mx_b, v);
        }
#pragma unroll
      for (int o2 = 1; o2 < 4; o2 <<= 1) {
        mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, o2));
        mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, o2));
      }
      const float mn_a = fmaxf(m_a, mx_a);
      const float mn_b = fmaxf(m_b, mx_b);
      const float al_a = exp2f(m_a - mn_a);
      const float al_b = exp2f(m_b - mn_b);
      m_a = mn_a;
      m_b = mn_b;
      float sum_a = 0.f, sum_b = 0.f;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        sc[j][0] = exp2f(sc[j][0] - mn_a);
        sc[j][1] = exp2f(sc[j][1] - mn_a);
        sc[j][2] = exp2f(sc[j][2] - mn_b);
        sc[j][3] = exp2f(sc[j][3] - mn_b);
        sum_a += sc[j][0] + sc[j][1];
        sum_b += sc[j][2] + sc[j][3];
      }
#pragma unroll
      for (int o2 = 1; o2 < 4; o2 <<= 1) {
        sum_a += __shfl_xor_sync(0xffffffffu, sum_a, o2);
        sum_b += __shfl_xor_sync(0xffffffffu, sum_b, o2);
      }
      l_a = l_a * al_a + sum_a;
      l_b = l_b * al_b + sum_b;
#pragma unroll
      for (int d = 0; d < kOTiles; ++d) {
        o[d][0] *= al_a;
        o[d][1] *= al_a;
        o[d][2] *= al_b;
        o[d][3] *= al_b;
      }
      // O += P V, P (heads x 16 slots) as three bf16 parts
      uint32_t p[3][4];
      split3_bf16(sc[0][0], sc[0][1], p[0][0], p[1][0], p[2][0]);
      split3_bf16(sc[0][2], sc[0][3], p[0][1], p[1][1], p[2][1]);
      split3_bf16(sc[1][0], sc[1][1], p[0][2], p[1][2], p[2][2]);
      split3_bf16(sc[1][2], sc[1][3], p[0][3], p[1][3], p[2][3]);
#pragma unroll
      for (int d2 = 0; d2 < HD / 16; ++d2) {
        uint32_t b[4];
        ldmatrix_x4_trans(b, vt + ((lane & 7) + ((lane >> 3) & 1) * 8) *
                                      kStride +
                                  d2 * 16 + (lane >> 4) * 8);
#pragma unroll
        for (int part = 0; part < 3; ++part) {
          mma_bf16(o[2 * d2], p[part], b[0], b[1]);
          mma_bf16(o[2 * d2 + 1], p[part], b[2], b[3]);
        }
      }
    }
  }

  // Each warp's (O, m, l) rows of the G heads into shared memory (the
  // ring is free now); a warp that took no chunk has m = -inf, l = 0,
  // O = 0.
  cp_async_wait<0>();
  __syncthreads();
  float* wpart = reinterpret_cast<float*>(smem_raw);   // [warp][G][kPRow]
  float* cpart = wpart + kSplitWarps * G * kPRow;       // [G][kPRow]
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int g = kWide ? 2 * tig + half : grp + 8 * half;
    if (g >= G) continue;
    float* row = wpart + (warp * G + g) * kPRow;
    if constexpr (kWide) {
#pragma unroll
      for (int d = 0; d < kOTiles; ++d) {
        row[16 * d + grp] = o[d][half];
        row[16 * d + grp + 8] = o[d][2 + half];
      }
    } else {
#pragma unroll
      for (int d = 0; d < kOTiles; ++d)
        *reinterpret_cast<float2*>(row + 8 * d + 2 * tig) =
            make_float2(o[d][2 * half], o[d][2 * half + 1]);
    }
    if ((kWide ? grp : tig) == 0) {
      row[HD] = half ? m_b : m_a;
      row[HD + 1] = half ? l_b : l_a;
    }
  }
  __syncthreads();
  // the CTA's partial: its warps merged in warp order
  for (int e = tid; e < G * HD; e += kSplitThreads) {
    const int g = e / HD;
    const int d = e - g * HD;
    float mx = kNegInf;
#pragma unroll
    for (int w = 0; w < kSplitWarps; ++w)
      mx = fmaxf(mx, wpart[(w * G + g) * kPRow + HD]);
    float l = 0.f, acc = 0.f;
#pragma unroll
    for (int w = 0; w < kSplitWarps; ++w) {
      const float* row = wpart + (w * G + g) * kPRow;
      const float a = exp2f(row[HD] - mx);
      l += row[HD + 1] * a;
      acc += row[d] * a;
    }
    cpart[g * kPRow + d] = acc;
    if (d == 0) {
      cpart[g * kPRow + HD] = mx;
      cpart[g * kPRow + HD + 1] = l;
    }
  }
  // the cluster's partials merged in split order, each CTA a share of
  // the outputs, read through distributed shared memory
  cooperative_groups::cluster_group cluster =
      cooperative_groups::this_cluster();
  cluster.sync();
  for (int e = split * kSplitThreads + tid; e < G * HD;
       e += splits * kSplitThreads) {
    const int g = e / HD;
    const int d = e - g * HD;
    float pm[kMaxDecodeSplits], pl[kMaxDecodeSplits], po[kMaxDecodeSplits];
#pragma unroll
    for (int sp = 0; sp < kMaxDecodeSplits; ++sp)
      if (sp < splits) {
        const float* row = cluster.map_shared_rank(cpart, sp) + g * kPRow;
        pm[sp] = row[HD];
        pl[sp] = row[HD + 1];
        po[sp] = row[d];
      }
    float mx = kNegInf;
#pragma unroll
    for (int sp = 0; sp < kMaxDecodeSplits; ++sp)
      if (sp < splits) mx = fmaxf(mx, pm[sp]);
    float l = 0.f, acc = 0.f;
#pragma unroll
    for (int sp = 0; sp < kMaxDecodeSplits; ++sp)
      if (sp < splits) {
        const float a = exp2f(pm[sp] - mx);
        l += pl[sp] * a;
        acc += po[sp] * a;
      }
    if (part.acc != nullptr) {
      // m from the log2 domain back to the scores' units; an empty row
      // keeps the mask value itself
      part.acc[e] = acc;
      if (d == 0) {
        part.m[g] = mx == kNegInf ? kNegInf : mx * kLn2;
        part.l[g] = l;
      }
    } else {
      out[e] = __float2bfloat16(acc / fmaxf(l, 1e-30f));
    }
  }
  cluster.sync();
}

// Launch a decode_split kernel: grid (B, KV, splits), one cluster of
// `splits` CTAs per (row, KV head).
template <typename Kernel, typename... Args>
inline cudaError_t launch_split(Kernel kernel, int B, int KV, int splits,
                                size_t bytes, cudaStream_t stream,
                                Args... args) {
  cudaError_t err = allow_smem(kernel, bytes);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(B, KV, splits);
  cfg.blockDim = dim3(kSplitThreads);
  cfg.dynamicSmemBytes = bytes;
  cfg.stream = stream;
  cudaLaunchAttribute cluster;
  cluster.id = cudaLaunchAttributeClusterDimension;
  cluster.val.clusterDim.x = 1;
  cluster.val.clusterDim.y = 1;
  cluster.val.clusterDim.z = splits;
  cfg.attrs = &cluster;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// Whether decode_split takes a launch: bf16, 16-byte aligned tensors,
// 1 to 8 splits, and either a head dim of whole k16 steps up to 128 with
// at most 16 query heads per KV head, or head dim 256 (the wide layout)
// with at most 8.
inline bool split_takes(int dtype, int hd, int G, int splits,
                        const void* q, const void* kp, const void* vp,
                        const void* out) {
  const bool aligned = ((reinterpret_cast<uintptr_t>(q) |
                         reinterpret_cast<uintptr_t>(kp) |
                         reinterpret_cast<uintptr_t>(vp) |
                         reinterpret_cast<uintptr_t>(out)) & 15u) == 0;
  const bool tiles = (hd % 16 == 0 && hd >= 16 && hd <= 128 &&
                      G <= kMaxSplitHeads) ||
                     (hd == 256 && G <= kMaxSplitHeadsWide);
  return dtype == 1 && tiles && aligned && splits >= 1 &&
         splits <= kMaxDecodeSplits;
}

}  // namespace rt
