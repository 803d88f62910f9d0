// The f32 CUDA-core body of the flash-attention kernel, as the window
// form (ring_chunk_attention.cu, ring_chunk_kernel) and the contiguous
// form (flash_attention.cu, flash_core_kernel) run it, cut into the parts
// that do not depend on where a tile's keys come from or which keys a row
// may see.  float32 stays on the CUDA cores so that the card's float32
// numbers equal the CPU's: TF32 tensor cores would round the inputs.
//
// * A CTA owns one KV head and kRows = 16 rows, a row being a (query,
//   head-in-group) pair of that KV head's G query heads, so each K/V tile
//   is read once for all G heads.  Its 8 warps are 4 row warps of 4 rows
//   times 2 key groups: the CTA's key tiles (32 keys each, one a lane)
//   alternate between the groups, each group loading its own tiles
//   behind its own named barrier (group_sync), so one group's loads
//   overlap the other's arithmetic.
// * load_rows: a tile converted to f32 in shared memory (K rows padded by
//   4 floats, so the lanes' 16-byte reads of 32 different keys at one
//   offset fall in distinct banks), each thread issuing kBatch 16-byte
//   loads a tensor before it stores any.
// * attend: one tile.  A lane computes its key's 4 scores from 16-byte
//   reads (the warp's 4 query rows are broadcast), the warp's 4 softmax
//   rows run across the lanes with butterfly reductions (m, l in
//   registers), and P goes through a warp-private shared tile into P V,
//   where each lane owns 4 rows times up to two 4-wide column groups of
//   the output in registers.  The mask is the caller's.
// * merge_key_groups: key group 1 hands its (m, l, O) to group 0, which
//   merges the two in a fixed order; store_row divides by l and rounds
//   once.
#pragma once

#include "common.cuh"

namespace core {

constexpr int kRowWarps = 4;                   // warps along the rows
constexpr int kKeyGroups = 2;                  // warp groups along the keys
constexpr int kGroupThreads = 32 * kRowWarps;
constexpr int kThreads = kGroupThreads * kKeyGroups;
constexpr int kRowsPerWarp = 4;
constexpr int kRows = kRowWarps * kRowsPerWarp;   // rows per CTA
constexpr int kTileK = 32;                     // keys per tile, one a lane
constexpr int kMaxGroups = 2;                  // 4-wide column groups a lane
constexpr int kMaxHd = 4 * 32 * kMaxGroups;    // 256
constexpr int kBatch = 8;                      // 16-byte loads in flight
constexpr int kXch = kRowsPerWarp * (2 + 4 * kMaxGroups);  // floats a lane

// Dynamic shared memory of a CTA at head dim hd: Q, group 0's K / V
// tiles, then group 1's and the warps' P tiles, which group 1's exchange
// of (m, l, O) reuses at the end.
inline size_t smem_bytes(int hd) {
  const int hd4 = (hd + 3) & ~3;
  const size_t tiles = static_cast<size_t>(kTileK) * (2 * hd4 + 4);
  const size_t ps = static_cast<size_t>(kThreads / 32) * kTileK * kRowsPerWarp;
  const size_t xch = static_cast<size_t>(kGroupThreads) * kXch;
  const size_t floats = static_cast<size_t>(kRows) * (hd4 + 4) + tiles +
                        (tiles + ps > xch ? tiles + ps : xch);
  return floats * sizeof(float);
}

// This thread's place in the CTA and its views of shared memory.
struct Cta {
  int hd4, kstride, ngroups;
  int lane, kgroup, gtid, warp;   // warp: its 4 rows within the key group
  float* qs;                      // kRows * kstride
  float* ks;                      // this group's K tile, kTileK * kstride
  float* vs;                      // and V tile, kTileK * hd4
  float* pw;                      // this warp's P, [key][row]
};

__device__ __forceinline__ Cta cta(float* smem, int hd) {
  Cta c;
  c.hd4 = (hd + 3) & ~3;
  c.kstride = c.hd4 + 4;
  c.ngroups = c.hd4 / 4;
  c.lane = threadIdx.x & 31;
  c.kgroup = threadIdx.x / kGroupThreads;
  c.gtid = threadIdx.x - c.kgroup * kGroupThreads;
  c.warp = c.gtid >> 5;
  c.qs = smem;
  c.ks = c.qs + kRows * c.kstride + c.kgroup * kTileK * (c.kstride + c.hd4);
  c.vs = c.ks + kTileK * c.kstride;
  c.pw = c.qs + kRows * c.kstride + kKeyGroups * kTileK * (c.kstride + c.hd4) +
         (threadIdx.x >> 5) * kTileK * kRowsPerWarp;
  return c;
}

// The key group's own named barrier (1 + group; __syncthreads is 0).
__device__ __forceinline__ void group_sync(const Cta& c) {
  asm volatile("bar.sync %0, %1;" ::"r"(1 + c.kgroup), "r"(kGroupThreads)
               : "memory");
}

// Rows [0, n) of NP tiles of ROWS rows (K and V: the same rows of two
// tensors) into f32 shared memory, tile p at dst[p] with stride[p]
// floats a row (columns [hd, hd4) zero); rows past n are zero.  Row r of
// tile p starts at base[p] + off(r).  With `vec` (hd a whole number of
// 16-byte chunks, the bases 16-byte aligned) each thread issues NP *
// kBatch 16-byte loads before it converts and stores any, so a tile's
// loads are in flight together instead of one latency after another;
// otherwise element by element.
template <int ROWS, int NP, typename T, typename Off>
__device__ __forceinline__ void load_rows(float* const (&dst)[NP],
                                          const int (&stride)[NP],
                                          const T* const (&base)[NP], int n,
                                          int hd, int hd4, bool vec, int tid,
                                          int nthreads, Off off) {
  if (vec) {
    constexpr int kVec = 16 / sizeof(T);
    const int cpr = hd / kVec;             // 16-byte chunks a row
    const int total = ROWS * cpr;
    for (int b0 = tid; b0 < total; b0 += kBatch * nthreads) {
      uint4 raw[NP][kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int e = b0 + u * nthreads;
        const int r = e / cpr;
        const bool live = e < total && r < n;
        const size_t o = live ? off(r) + (e - r * cpr) * kVec : 0;
#pragma unroll
        for (int p = 0; p < NP; ++p)
          raw[p][u] = live ? *reinterpret_cast<const uint4*>(base[p] + o)
                           : make_uint4(0u, 0u, 0u, 0u);
      }
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int e = b0 + u * nthreads;
        if (e < total) {
          const int r = e / cpr;
          const int c = (e - r * cpr) * kVec;
#pragma unroll
          for (int p = 0; p < NP; ++p) {
            const T* v = reinterpret_cast<const T*>(&raw[p][u]);
            float* d = dst[p] + r * stride[p] + c;
#pragma unroll
            for (int j = 0; j < kVec; ++j) d[j] = rt::to_f32<T>(v[j]);
          }
        }
      }
    }
    return;
  }
  for (int e = tid; e < ROWS * hd4; e += nthreads) {
    const int r = e / hd4;
    const int d = e - r * hd4;
#pragma unroll
    for (int p = 0; p < NP; ++p) {
      float v = 0.f;
      if (r < n && d < hd) v = rt::to_f32<T>(base[p][off(r) + d]);
      dst[p][r * stride[p] + d] = v;
    }
  }
}

// The CTA's Q rows [0, n) (zero past them and in the padding); row r
// starts at q + off(r).
template <typename T, typename Off>
__device__ __forceinline__ void load_q(const Cta& c, const T* q, int n,
                                       int hd, bool vec, Off off) {
  float* const dst[1] = {c.qs};
  const int stride[1] = {c.kstride};
  const T* const base[1] = {q};
  load_rows<kRows, 1>(dst, stride, base, n, hd, c.hd4, vec, threadIdx.x,
                      kThreads, off);
}

// The group's K and V tile: keys [0, n) of it, key r of K at k + off(r)
// and of V at v + off(r).
template <typename T, typename Off>
__device__ __forceinline__ void load_kv(const Cta& c, const T* k, const T* v,
                                        int n, int hd, bool vec, Off off) {
  float* const dst[2] = {c.ks, c.vs};
  const int stride[2] = {c.kstride, c.hd4};
  const T* const base[2] = {k, v};
  load_rows<kTileK, 2>(dst, stride, base, n, hd, c.hd4, vec, c.gtid,
                       kGroupThreads, off);
}

// The online-softmax state of a warp's 4 rows, in this lane's share.
struct Rows {
  float m[kRowsPerWarp], l[kRowsPerWarp];
  float acc[kRowsPerWarp][kMaxGroups][4];
};

__device__ __forceinline__ void init_rows(Rows& st) {
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    st.m[i] = rt::kNegInf;
    st.l[i] = 0.f;
#pragma unroll
    for (int g = 0; g < kMaxGroups; ++g)
#pragma unroll
      for (int c = 0; c < 4; ++c) st.acc[i][g][c] = 0.f;
  }
}

// One tile of the group's loaded K / V against the warp's 4 rows: this
// lane's key's scores, masked where ok(i) is false (row i against this
// lane's key), the online softmax across the lanes, then O += P V.
template <typename Ok>
__device__ __forceinline__ void attend(Rows& st, const Cta& c, float scale,
                                       Ok ok) {
  const int lane = c.lane;
  float s[kRowsPerWarp];
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) s[i] = 0.f;
  const float4* kr = reinterpret_cast<const float4*>(c.ks + lane * c.kstride);
  const float* qw = c.qs + c.warp * kRowsPerWarp * c.kstride;
  for (int d = 0; d < c.ngroups; ++d) {
    const float4 kv4 = kr[d];
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) {
      const float4 qv = reinterpret_cast<const float4*>(qw + i * c.kstride)[d];
      s[i] += qv.x * kv4.x;
      s[i] += qv.y * kv4.y;
      s[i] += qv.z * kv4.z;
      s[i] += qv.w * kv4.w;
    }
  }
  // mask, online softmax across the lanes, P into the warp's tile
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    const float v = ok(i) ? s[i] * scale : rt::kNegInf;
    const float m_new = fmaxf(st.m[i], rt::warp_max(v));
    const float p = expf(v - m_new);
    const float a = expf(st.m[i] - m_new);
    st.l[i] = a * st.l[i] + rt::warp_sum(p);
    st.m[i] = m_new;
    c.pw[lane * kRowsPerWarp + i] = p;
#pragma unroll
    for (int g = 0; g < kMaxGroups; ++g)
#pragma unroll
      for (int e = 0; e < 4; ++e) st.acc[i][g][e] *= a;
  }
  __syncwarp();

  // O += P V: this lane's column groups lane, lane + 32
#pragma unroll 4
  for (int k = 0; k < kTileK; ++k) {
    const float4 p4 = reinterpret_cast<const float4*>(c.pw)[k];
    const float pk[kRowsPerWarp] = {p4.x, p4.y, p4.z, p4.w};
#pragma unroll
    for (int g = 0; g < kMaxGroups; ++g) {
      const int col = lane + 32 * g;
      if (col < c.ngroups) {
        const float4 v4 = reinterpret_cast<const float4*>(c.vs + k * c.hd4)[col];
#pragma unroll
        for (int i = 0; i < kRowsPerWarp; ++i) {
          st.acc[i][g][0] += pk[i] * v4.x;
          st.acc[i][g][1] += pk[i] * v4.y;
          st.acc[i][g][2] += pk[i] * v4.z;
          st.acc[i][g][3] += pk[i] * v4.w;
        }
      }
    }
  }
  __syncwarp();
}

// Key group 1 hands its (m, l, O) to group 0 through its own K tile and
// the P tiles; group 0 merges the two in a fixed order.  A group that saw
// no valid key of a row holds m = kNegInf there (and finite sums of
// masked keys), and its share is scaled by exp(kNegInf - m) = 0: every
// live row sees a key.  Returns whether this thread holds merged rows
// (key group 0); group 1 is done.
__device__ __forceinline__ bool merge_key_groups(Rows& st, const Cta& c) {
  float* xch = c.qs + kRows * c.kstride + kTileK * (c.kstride + c.hd4) +
               (c.warp * 32 + c.lane) * kXch;
  __syncthreads();
  if (c.kgroup == 1) {
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) {
      xch[i] = st.m[i];
      xch[kRowsPerWarp + i] = st.l[i];
#pragma unroll
      for (int g = 0; g < kMaxGroups; ++g)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          xch[2 * kRowsPerWarp + (i * kMaxGroups + g) * 4 + e] =
              st.acc[i][g][e];
    }
  }
  __syncthreads();
  if (c.kgroup == 1) return false;
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    const float m1 = xch[i];
    const float mn = fmaxf(st.m[i], m1);
    const float a0 = expf(st.m[i] - mn);
    const float a1 = expf(m1 - mn);
    st.m[i] = mn;
    st.l[i] = st.l[i] * a0 + xch[kRowsPerWarp + i] * a1;
#pragma unroll
    for (int g = 0; g < kMaxGroups; ++g)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        st.acc[i][g][e] = st.acc[i][g][e] * a0 +
            xch[2 * kRowsPerWarp + (i * kMaxGroups + g) * 4 + e] * a1;
  }
  return true;
}

// Row i's output into dst (hd elements): divided by l (clamped at 1e-30)
// in f32, rounded once.  Returns the clamped l.
template <typename T>
__device__ __forceinline__ float store_row(const Rows& st, const Cta& c,
                                           int i, T* dst, int hd) {
  const float li = fmaxf(st.l[i], 1e-30f);
#pragma unroll
  for (int g = 0; g < kMaxGroups; ++g) {
    const int col = c.lane + 32 * g;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int d = 4 * col + e;
      if (col < c.ngroups && d < hd)
        dst[d] = rt::from_f32<T>(st.acc[i][g][e] / li);
    }
  }
  return li;
}

}  // namespace core
