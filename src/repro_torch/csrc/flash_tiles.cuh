// The tensor-core tiles of the flash-attention kernel's bf16 bodies, as
// the window form (ring_chunk_attention.cu, ring_mma_kernel) runs them:
// a copy of the paged-chunk form's mma body (paged_prefill_attention.cu,
// mma::prefill_kernel), cut into the parts that do not depend on where
// a step's keys come from or which keys a row may see.  The prefill
// keeps its own copy: compiled through these functions, in each of four
// arrangements of the same code, its body took 142 registers instead of
// 141 at hd 64 and spilled more at hd 16, 48 or 80 (nvcc 12.8, -Xptxas
// -v), so sharing would cost it what its tuning bought.
//
// * A CTA owns one KV head and kRows = 64 rows, a row being a (query,
//   head-in-group) pair of that KV head's G query heads, so each K/V tile
//   is read once for all G heads.  Its 8 warps are 4 row warps of 16 rows
//   (one m16 fragment each) times 2 key groups: a step brings kSpan
//   logical keys, key group g takes the kTileK at offset g * kTileK.
// * attend: one key group's tile.  S = Q K^T on mma.sync m16n8k16 with
//   f32 accumulators (products of bf16 are exact); the online softmax
//   keeps (m, l) per row in registers across an mma quad, in the log2
//   domain with exp2f; the mask (the caller's) only where the caller
//   says the tile needs it.  P is split into P_hi = bf16(P) and P_lo =
//   bf16(P - P_hi), and both go through the PV mma against the same
//   bf16 V into the f32 accumulators: P keeps about 16 bits, so the
//   output stays within one final bf16 rounding of the f32 plain version
//   (rounding P once to bf16 would add about 2^-9 of sum |P V|, past the
//   gate for small outputs).
// * merge_key_groups: key group 1 hands its (m, l, O) to group 0, which
//   merges the two in a fixed order.
// * finish: up to hd 128 group 0 divides by l and stores its rows; at
//   hd 256 (Tiles<256>, the wide tiles) a row tile's steps are split
//   across a thread-block cluster of `splits` CTAs, and after a cluster
//   barrier each CTA merges a share of the tile's 64 x 256 outputs over
//   the cluster's partials in split order, read through distributed
//   shared memory, divides by l and rounds once.
//
// The wide tiles answer three limits the narrow ones hit at hd 256:
// shared memory (Q and a double-buffered step of 2 x 32 keys: 64 x 264 x
// 2 + 2 x 2 x 64 x 264 x 2 = 168,960 B, one CTA an SM), registers (a
// warp's 16 x 256 f32 accumulator is 128 registers a thread, so Q is
// read from shared memory by ldmatrix at each k16 step instead of held
// as 64 more) and fill (too few row tiles for 132 SMs, hence the split).
#pragma once

#include <cooperative_groups.h>

#include "common.cuh"
#include "mma.cuh"

namespace flash {

constexpr int kRowWarps = 4;         // warps along the rows
constexpr int kKeyGroups = 2;        // warp groups along the keys
constexpr int kThreads = 32 * kRowWarps * kKeyGroups;
constexpr int kRows = 16 * kRowWarps;   // (query, head-in-group) rows per CTA
constexpr int kMaxSplits = 8;        // CTAs a key range splits across (wide)
constexpr float kLog2e = 1.4426950408889634f;

// The tiles of head dim HD.  Up to 128: key tiles of 64 slots a key
// group, Q held in registers, one CTA per row tile.  At 256 (wide): key
// tiles of 32 slots, Q read from shared memory at each k16 step, and
// each row tile's key range split across a cluster of CTAs.
template <int HD>
struct Tiles {
  static constexpr bool kWide = HD > 128;
  static constexpr int kTileK = kWide ? 32 : 64;   // slots a key group takes
  static constexpr int kSpan = kTileK * kKeyGroups;  // slots per CTA step
  static constexpr int kStride = HD + 8;    // smem row, in bf16
  static constexpr int kChunks = HD / 8;    // 16-byte chunks per row
  static constexpr int kKSteps = HD / 16;   // k16 steps of Q K^T
  static constexpr int kQFrags = kWide ? 1 : kKSteps;   // Q in registers
};

template <int HD>
constexpr size_t smem_bytes() {      // Q, then K and V, double-buffered
  return static_cast<size_t>(kRows + 4 * Tiles<HD>::kSpan) * (HD + 8) *
         sizeof(__nv_bfloat16);
}
static_assert(smem_bytes<256>() == 168960, "wide tiles: 165 KB a CTA");

// A lane's share of its warp's 16 rows: rows grp and grp + 8 (a and b),
// their output columns (8 d + 2 tig, + 1), running max and sum.
template <int HD>
struct Rows {
  float o[HD / 8][4];
  float m_a, m_b, l_a, l_b;
};

template <int HD>
__device__ __forceinline__ void init_rows(Rows<HD>& st) {
#pragma unroll
  for (int d = 0; d < HD / 8; ++d)
#pragma unroll
    for (int e = 0; e < 4; ++e) st.o[d][e] = 0.f;
  st.m_a = rt::kNegInf;
  st.m_b = rt::kNegInf;
  st.l_a = 0.f;
  st.l_b = 0.f;
}

// The CTA's Q rows r0 .. r0 + kRows - 1 of q (C, H, HD) into qs with
// 16-byte cp.async (zero past the last row); the caller commits.
template <int HD>
__device__ __forceinline__ void load_q(__nv_bfloat16* qs,
                                       const __nv_bfloat16* q, int r0,
                                       int rows, int G, int H, int kvh,
                                       int tid) {
  using T = Tiles<HD>;
  for (int e = tid; e < kRows * T::kChunks; e += kThreads) {
    const int r = e / T::kChunks;
    const int c = e - r * T::kChunks;
    const int rho = r0 + r;
    const __nv_bfloat16* src = q;
    int n = 0;
    if (rho < rows) {
      src = q + (static_cast<size_t>(rho / G) * H + kvh * G + rho % G) * HD +
            c * 8;
      n = 16;
    }
    rt::cp_async16(qs + r * T::kStride + c * 8, src, n);
  }
}

// The narrow tiles hold the warp's Q fragments in registers, loaded once
// after Q has landed; the wide ones read them at each k16 step.
template <int HD>
__device__ __forceinline__ void load_q_frags(
    uint32_t (&qf)[Tiles<HD>::kQFrags][4], const __nv_bfloat16* qs, int warp,
    int lane) {
  using T = Tiles<HD>;
  if constexpr (!T::kWide) {
#pragma unroll
    for (int kk = 0; kk < T::kKSteps; ++kk)
      rt::ldmatrix_x4(qf[kk], qs + (warp * 16 + (lane & 15)) * T::kStride +
                                  kk * 16 + (lane >> 4) * 8);
  }
}

// One key group's tile of kTileK keys, k0 the logical index of its first
// (kt, vt: its K and V rows in shared memory): S = Q K^T, scaled into the
// log2 domain; where `masked`, a key for which mask(key, half) holds is
// dropped for the lane's row a (half 0) or b (half 1); then the online
// softmax and O += P V with P = P_hi + P_lo.
template <int HD, typename Mask>
__device__ __forceinline__ void attend(
    Rows<HD>& st, const uint32_t (&qf)[Tiles<HD>::kQFrags][4],
    const __nv_bfloat16* qs, const __nv_bfloat16* kt,
    const __nv_bfloat16* vt, int k0, int warp, int lane, float scale_log2,
    bool masked, Mask mask) {
  using T = Tiles<HD>;
  constexpr int kTileK = T::kTileK;
  constexpr int kStride = T::kStride;
  const int tig = lane & 3;
  // S = Q K^T: kTileK / 8 n-tiles of 8 keys
  float sc[kTileK / 8][4];
#pragma unroll
  for (int j = 0; j < kTileK / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) sc[j][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < T::kKSteps; ++kk) {
    uint32_t a[4];
    if constexpr (T::kWide) {
      rt::ldmatrix_x4(a, qs + (warp * 16 + (lane & 15)) * kStride + kk * 16 +
                             (lane >> 4) * 8);
    } else {
#pragma unroll
      for (int r = 0; r < 4; ++r) a[r] = qf[kk][r];
    }
#pragma unroll
    for (int j2 = 0; j2 < kTileK / 16; ++j2) {
      uint32_t b[4];
      rt::ldmatrix_x4(b, kt + (j2 * 16 + (lane & 7) + ((lane >> 4) << 3)) *
                                  kStride +
                              kk * 16 + ((lane >> 3) & 1) * 8);
      rt::mma_bf16(sc[2 * j2], a, b[0], b[1]);
      rt::mma_bf16(sc[2 * j2 + 1], a, b[2], b[3]);
    }
  }
  // scale into the log2 domain; mask where the caller says the tile needs it
  float mx_a = rt::kNegInf, mx_b = rt::kNegInf;
#pragma unroll
  for (int j = 0; j < kTileK / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int key = k0 + 8 * j + 2 * tig + (e & 1);
      float v = sc[j][e] * scale_log2;
      if (masked && mask(key, e >= 2)) v = rt::kNegInf;
      sc[j][e] = v;
      if (e < 2) mx_a = fmaxf(mx_a, v); else mx_b = fmaxf(mx_b, v);
    }
#pragma unroll
  for (int o2 = 1; o2 < 4; o2 <<= 1) {
    mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, o2));
    mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, o2));
  }
  const float mn_a = fmaxf(st.m_a, mx_a);
  const float mn_b = fmaxf(st.m_b, mx_b);
  const float al_a = exp2f(st.m_a - mn_a);
  const float al_b = exp2f(st.m_b - mn_b);
  st.m_a = mn_a;
  st.m_b = mn_b;
  float sum_a = 0.f, sum_b = 0.f;
#pragma unroll
  for (int j = 0; j < kTileK / 8; ++j) {
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
  st.l_a = st.l_a * al_a + sum_a;
  st.l_b = st.l_b * al_b + sum_b;
#pragma unroll
  for (int d = 0; d < HD / 8; ++d) {
    st.o[d][0] *= al_a;
    st.o[d][1] *= al_a;
    st.o[d][2] *= al_b;
    st.o[d][3] *= al_b;
  }
  // O += P V with P = P_hi + P_lo, 16 keys per step
#pragma unroll
  for (int s2 = 0; s2 < kTileK / 16; ++s2) {
    uint32_t ph[4], pl[4];
    rt::split_bf16(sc[2 * s2][0], sc[2 * s2][1], ph[0], pl[0]);
    rt::split_bf16(sc[2 * s2][2], sc[2 * s2][3], ph[1], pl[1]);
    rt::split_bf16(sc[2 * s2 + 1][0], sc[2 * s2 + 1][1], ph[2], pl[2]);
    rt::split_bf16(sc[2 * s2 + 1][2], sc[2 * s2 + 1][3], ph[3], pl[3]);
#pragma unroll
    for (int d2 = 0; d2 < HD / 16; ++d2) {
      uint32_t b[4];
      rt::ldmatrix_x4_trans(
          b, vt + (s2 * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * kStride +
                 d2 * 16 + (lane >> 4) * 8);
      rt::mma_bf16(st.o[2 * d2], ph, b[0], b[1]);
      rt::mma_bf16(st.o[2 * d2], pl, b[0], b[1]);
      rt::mma_bf16(st.o[2 * d2 + 1], ph, b[2], b[3]);
      rt::mma_bf16(st.o[2 * d2 + 1], pl, b[2], b[3]);
    }
  }
}

// Key group 1 hands its (m, l, o) to group 0 through shared memory (the
// K buffers at ks are free once every copy has landed), which merges the
// two in a fixed order.  A row group 1 never reached has m = kNegInf,
// l = 0, o = 0.
template <int HD>
__device__ __forceinline__ void merge_key_groups(Rows<HD>& st,
                                                 __nv_bfloat16* ks,
                                                 int kgroup, int warp,
                                                 int lane) {
  using T = Tiles<HD>;
  constexpr int kXch = HD / 2 + 4;    // floats per thread
  static_assert(kRowWarps * 32 * kXch * sizeof(float) <=
                    2 * T::kSpan * T::kStride * sizeof(__nv_bfloat16),
                "the exchange fits the K buffers");
  rt::cp_async_wait<0>();
  __syncthreads();
  float* xch = reinterpret_cast<float*>(ks) + (warp * 32 + lane) * kXch;
  if (kgroup == 1) {
#pragma unroll
    for (int d = 0; d < HD / 8; ++d)
#pragma unroll
      for (int e = 0; e < 4; ++e) xch[4 * d + e] = st.o[d][e];
    xch[HD / 2] = st.m_a;
    xch[HD / 2 + 1] = st.m_b;
    xch[HD / 2 + 2] = st.l_a;
    xch[HD / 2 + 3] = st.l_b;
  }
  __syncthreads();
  if (kgroup == 0) {
    const float m1a = xch[HD / 2], m1b = xch[HD / 2 + 1];
    const float mn_a = fmaxf(st.m_a, m1a), mn_b = fmaxf(st.m_b, m1b);
    const float a0 = exp2f(st.m_a - mn_a), a1 = exp2f(m1a - mn_a);
    const float b0 = exp2f(st.m_b - mn_b), b1 = exp2f(m1b - mn_b);
    st.m_a = mn_a;
    st.m_b = mn_b;
    st.l_a = st.l_a * a0 + xch[HD / 2 + 2] * a1;
    st.l_b = st.l_b * b0 + xch[HD / 2 + 3] * b1;
#pragma unroll
    for (int d = 0; d < HD / 8; ++d) {
      st.o[d][0] = st.o[d][0] * a0 + xch[4 * d] * a1;
      st.o[d][1] = st.o[d][1] * a0 + xch[4 * d + 1] * a1;
      st.o[d][2] = st.o[d][2] * b0 + xch[4 * d + 2] * b1;
      st.o[d][3] = st.o[d][3] * b0 + xch[4 * d + 3] * b1;
    }
  }
}

// The CTA's rows into out (C, H, HD), rows r0 .. rlast of its KV head
// kvh, after merge_key_groups.  Narrow: group 0 divides by l in f32,
// rounds once and stores pairs.  Wide: the CTA's partial rows (O, then m
// and l) go to the V buffers at vs; after a cluster barrier every CTA
// merges a share of the tile's rows x HD outputs over the cluster's
// partials in split order, read through distributed shared memory,
// divides by l and rounds once; a second barrier keeps each partial
// alive until its readers are done.
template <int HD>
__device__ __forceinline__ void finish(Rows<HD>& st, __nv_bfloat16* vs,
                                       __nv_bfloat16* out, int r0, int rlast,
                                       bool live, int G, int H, int kvh,
                                       int kgroup, int warp, int lane,
                                       int split, int splits) {
  const int grp = lane >> 2;
  const int tig = lane & 3;
  if constexpr (!Tiles<HD>::kWide) {
    if (kgroup == 1) return;
    const int ra = r0 + warp * 16 + grp;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int rho = ra + 8 * half;
      if (!live || rho > rlast) continue;
      const float l = fmaxf(half ? st.l_b : st.l_a, 1e-30f);
      __nv_bfloat16* dst =
          out + (static_cast<size_t>(rho / G) * H + kvh * G + rho % G) * HD +
          2 * tig;
#pragma unroll
      for (int d = 0; d < HD / 8; ++d)
        *reinterpret_cast<__nv_bfloat162*>(dst + 8 * d) =
            __floats2bfloat162_rn(st.o[d][2 * half] / l,
                                  st.o[d][2 * half + 1] / l);
    }
  } else {
    using T = Tiles<HD>;
    constexpr int kPRow = HD + 2;
    static_assert(kRows * kPRow * sizeof(float) <=
                      2 * T::kSpan * T::kStride * sizeof(__nv_bfloat16),
                  "the partial fits the V buffers");
    const int tid = threadIdx.x;
    float* cpart = reinterpret_cast<float*>(vs);
    if (kgroup == 0) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        float* row = cpart + (warp * 16 + grp + 8 * half) * kPRow;
#pragma unroll
        for (int d = 0; d < HD / 8; ++d)
          *reinterpret_cast<float2*>(row + 8 * d + 2 * tig) =
              make_float2(st.o[d][2 * half], st.o[d][2 * half + 1]);
        if (tig == 0) {
          row[HD] = half ? st.m_b : st.m_a;
          row[HD + 1] = half ? st.l_b : st.l_a;
        }
      }
    }
    cooperative_groups::cluster_group cluster =
        cooperative_groups::this_cluster();
    cluster.sync();
    for (int e = split * kThreads + tid; e < kRows * HD;
         e += splits * kThreads) {
      const int r = e / HD;
      const int d = e - r * HD;
      const int rho = r0 + r;
      if (rho > rlast) break;       // e only grows
      float pm[kMaxSplits], pl[kMaxSplits], po[kMaxSplits];
#pragma unroll
      for (int sp = 0; sp < kMaxSplits; ++sp)
        if (sp < splits) {
          const float* row = cluster.map_shared_rank(cpart, sp) + r * kPRow;
          pm[sp] = row[HD];
          pl[sp] = row[HD + 1];
          po[sp] = row[d];
        }
      float mx = rt::kNegInf;
#pragma unroll
      for (int sp = 0; sp < kMaxSplits; ++sp)
        if (sp < splits) mx = fmaxf(mx, pm[sp]);
      float l = 0.f, acc = 0.f;
#pragma unroll
      for (int sp = 0; sp < kMaxSplits; ++sp)
        if (sp < splits) {
          const float a = exp2f(pm[sp] - mx);
          l += pl[sp] * a;
          acc += po[sp] * a;
        }
      out[(static_cast<size_t>(rho / G) * H + kvh * G + rho % G) * HD + d] =
          __float2bfloat16(acc / fmaxf(l, 1e-30f));
    }
    cluster.sync();
  }
}

// Launch kernel on grid (tiles * splits, KV, B) of kThreads with
// smem_bytes<HD>(), the splits of a row tile as one cluster along x at
// the wide tiles.
template <int HD, typename Kernel, typename... Args>
cudaError_t launch(Kernel kernel, int tiles, int splits, int KV, int B,
                   cudaStream_t stream, Args... args) {
  const size_t bytes = smem_bytes<HD>();
  cudaError_t err = rt::allow_smem(kernel, bytes);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(tiles * splits, KV, B);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = bytes;
  cfg.stream = stream;
  cudaLaunchAttribute cluster;
  if (Tiles<HD>::kWide) {           // the splits of a row tile: one cluster
    cluster.id = cudaLaunchAttributeClusterDimension;
    cluster.val.clusterDim.x = splits;
    cluster.val.clusterDim.y = 1;
    cluster.val.clusterDim.z = 1;
    cfg.attrs = &cluster;
    cfg.numAttrs = 1;
  }
  err = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace flash
