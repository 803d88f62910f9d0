// Sliding-window chunk attention over a ring buffer: C query tokens of one
// request, at positions pos .. pos + C - 1, attend to the w keys of the
// request's old ring plus the chunk's own C keys, with the causal and the
// window mask, and an online softmax in f32.
//
// Keys are numbered as the reference concatenates them, [old ring ; chunk]:
// * key j < w is ring slot j, read in place from paged pools laid out
//   (NB, bs, KV, hd) through the ring's block table (block table[j / bs],
//   offset j % bs).  It holds the latest position p < pos with p % w == j,
//   p_old = pos - w + ((j - pos) mod w);
// * key w + i is chunk key i, at position pos + i, read from the chunk's
//   contiguous (C, KV, hd) K and V.
// Query qi (position pos + qi) sees a key at position kpos iff
// kpos >= 0, kpos <= pos + qi and kpos > pos + qi - w.  For a ring key,
// with o = (j - pos) mod w, that is o > qi and p_old >= 0; p_old >= 0
// holds for every slot once pos >= w, and for slots j < pos before, so a
// CTA reads ring slots [0, min(pos, w)) only.  For a chunk key it is
// qi - w < i <= qi.  The caller writes the chunk's keys into the ring
// after this kernel has read it: an in-chunk write would clobber old slots
// that earlier queries of the chunk still see.
//
// Replaces the TPU kernel flash_attention_pallas
// (src/repro/kernels/flash_attention.py:72, body _flash_kernel) in its
// window > 0 form, which masks keys with kpos > qpos - window
// (flash_attention.py:51-52), as the reference model runs it for
// sliding-window layers: the swa branch of
// src/repro/models/attention.py::paged_chunk_self_attention (a paged
// ring) and of chunk_self_attention (a dense ring row, which the wrapper
// passes as one block of W slots with table [0]).
//
// Bound on the H100: operations at gemma3-12b's chunks (C = 128 queries of
// 16 heads of 256 against up to 1024 + 128 keys: 4 * hd flops per
// (query head, key) pair over 2 * 8 * 256 bytes per key, some 64 flops a
// byte), bytes at short prefixes.  This body runs on the CUDA cores in f32
// for f32 and bf16 alike (a tensor-core body at hd 256 is later work).
//
// One body, cuda_core.  A CTA owns one KV head and 16 rows, a row being a
// (query, head-in-group) pair of that KV head's G query heads, so each
// K/V tile is read once for all G heads.  Its 8 warps are 4 row warps of
// 4 rows times 2 key groups: the CTA's key tiles (32 keys each, one a
// lane; ring tiles from slot 0, then chunk tiles from key w) alternate
// between the groups, each group loading its own tiles behind its own
// named barrier, so one group's loads overlap the other's arithmetic, and
// at the end group 1 hands its (m, l, O) to group 0, which merges them
// in a fixed order.  A tile is converted to f32 in shared memory (K rows
// padded by 4 floats, so the lanes' 16-byte reads of 32 different keys at
// one offset fall in distinct banks), each thread issuing 8 16-byte loads
// before it stores any.  A lane computes its key's 4 scores from 16-byte
// reads (the warp's 4 query rows are broadcast), the warp's 4 softmax
// rows run across the lanes with butterfly reductions (m, l in
// registers), and P goes through a warp-private shared tile into P V,
// where each lane owns 4 rows times up to two 4-wide column groups of the
// output in registers.  Tiles are cut by logical key index, never by
// block, so the output bits do not depend on bs or on the table: a dense
// one-block ring gives the bits of a paged one.
#include "common.cuh"

namespace {

constexpr int kRowWarps = 4;                   // warps along the rows
constexpr int kKeyGroups = 2;                  // warp groups along the keys
constexpr int kGroupThreads = 32 * kRowWarps;
constexpr int kThreads = kGroupThreads * kKeyGroups;
constexpr int kRowsPerWarp = 4;
constexpr int kRows = kRowWarps * kRowsPerWarp;   // rows per CTA
constexpr int kTileK = 32;                     // keys per tile, one a lane
constexpr int kMaxGroups = 2;                  // 4-wide column groups a lane
constexpr int kMaxHd = 4 * 32 * kMaxGroups;    // 256

// Load rows [0, n) of NP tiles of ROWS rows (K and V: the same rows of
// two tensors) into f32 shared memory, tile p at dst[p] with stride[p]
// floats a row (columns [hd, hd4) zero); rows past n are zero.  Row r of
// tile p starts at base[p] + off(r).  With `vec` (hd a whole number of
// 16-byte chunks, the bases 16-byte aligned) each thread issues NP *
// kBatch 16-byte loads before it converts and stores any, so a tile's
// loads are in flight together instead of one latency after another;
// otherwise element by element.
constexpr int kBatch = 8;

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

template <typename T>
__global__ void __launch_bounds__(kThreads)
ring_chunk_kernel(const T* __restrict__ q, const T* __restrict__ kp,
                  const T* __restrict__ vp, const int* __restrict__ table,
                  const T* __restrict__ kn, const T* __restrict__ vn,
                  T* __restrict__ out, int C, int H, int KV, int hd, int bs,
                  int pos, int w, float scale) {
  const int G = H / KV;
  const int kvh = blockIdx.y;
  const int r0 = blockIdx.x * kRows;
  const int rows = C * G;
  const int hd4 = (hd + 3) & ~3;
  const int kstride = hd4 + 4;
  const int lane = threadIdx.x & 31;
  const int kgroup = threadIdx.x / kGroupThreads;   // this warp's key group
  const int gtid = threadIdx.x - kgroup * kGroupThreads;
  const int warp = gtid >> 5;                       // and its 4 rows
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;                                 // kRows * kstride
  // this group's K tile (kTileK * kstride) and V tile (kTileK * hd4)
  float* ks = qs + kRows * kstride + kgroup * kTileK * (kstride + hd4);
  float* vs = ks + kTileK * kstride;
  // this warp's P, [key][row]
  float* pw = qs + kRows * kstride + kKeyGroups * kTileK * (kstride + hd4) +
              (threadIdx.x >> 5) * kTileK * kRowsPerWarp;

  // 16-byte loads where every row starts on a 16-byte boundary
  const bool vec =
      hd % (16 / static_cast<int>(sizeof(T))) == 0 &&
      ((reinterpret_cast<size_t>(q) | reinterpret_cast<size_t>(kp) |
        reinterpret_cast<size_t>(vp) | reinterpret_cast<size_t>(kn) |
        reinterpret_cast<size_t>(vn)) & 15u) == 0;

  // Q rows of this CTA (zero past the last row and in the padding)
  {
    float* const dst[1] = {qs};
    const int stride[1] = {kstride};
    const T* const base[1] = {q};
    load_rows<kRows, 1>(dst, stride, base, rows - r0, hd, hd4, vec,
                        threadIdx.x, kThreads, [&](int r) {
      const int rho = r0 + r;
      return (static_cast<size_t>(rho / G) * H + kvh * G + rho % G) * hd;
    });
  }
  __syncthreads();

  // this warp's rows and their queries; a row past the last is inert
  int qi[kRowsPerWarp];
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    const int rho = r0 + warp * kRowsPerWarp + i;
    qi[i] = rho < rows ? rho / G : -1;
  }
  const int q_last = (min(r0 + kRows, rows) - 1) / G;   // CTA's last query
  const int n_old = pos < w ? pos : w;                  // ring slots read
  const int pos_mod = pos % w;
  const int ngroups = hd4 / 4;

  float m[kRowsPerWarp], l[kRowsPerWarp];
  float acc[kRowsPerWarp][kMaxGroups][4];
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    m[i] = rt::kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int g = 0; g < kMaxGroups; ++g)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[i][g][c] = 0.f;
  }

  // Ring tiles [0, n_old), then chunk tiles [0, q_last]; key group g
  // takes tiles g, g + 2, ...  Each group syncs on its own named barrier
  // (1 + g; __syncthreads is barrier 0).
  const int n_ring_tiles = (n_old + kTileK - 1) / kTileK;
  const int n_tiles = n_ring_tiles + (q_last + kTileK) / kTileK;
  auto group_sync = [&]() {
    asm volatile("bar.sync %0, %1;" ::"r"(1 + kgroup), "r"(kGroupThreads)
                 : "memory");
  };
  for (int t = kgroup; t < n_tiles; t += kKeyGroups) {
    const bool ring = t < n_ring_tiles;
    const int k0 = (ring ? t : t - n_ring_tiles) * kTileK;
    group_sync();   // the group's previous K / V tile is no longer read
    float* const dst[2] = {ks, vs};
    const int stride[2] = {kstride, hd4};
    if (ring) {
      const T* const base[2] = {kp, vp};
      load_rows<kTileK, 2>(dst, stride, base, min(kTileK, n_old - k0), hd,
                           hd4, vec, gtid, kGroupThreads, [&](int r) {
        const int j = k0 + r;
        const int blk = j / bs;
        return ((static_cast<size_t>(table[blk]) * bs + (j - blk * bs)) * KV +
                kvh) * hd;
      });
    } else {
      const T* const base[2] = {kn, vn};
      load_rows<kTileK, 2>(dst, stride, base, min(kTileK, q_last + 1 - k0),
                           hd, hd4, vec, gtid, kGroupThreads, [&](int r) {
        return (static_cast<size_t>(k0 + r) * KV + kvh) * hd;
      });
    }
    group_sync();

    // scores of this lane's key against the warp's 4 rows
    const int key = k0 + lane;
    float s[kRowsPerWarp];
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) s[i] = 0.f;
    const float4* kr = reinterpret_cast<const float4*>(ks + lane * kstride);
    const float* qw = qs + warp * kRowsPerWarp * kstride;
    for (int d = 0; d < ngroups; ++d) {
      const float4 kv4 = kr[d];
#pragma unroll
      for (int i = 0; i < kRowsPerWarp; ++i) {
        const float4 qv =
            reinterpret_cast<const float4*>(qw + i * kstride)[d];
        s[i] += qv.x * kv4.x;
        s[i] += qv.y * kv4.y;
        s[i] += qv.z * kv4.z;
        s[i] += qv.w * kv4.w;
      }
    }
    // mask, online softmax across the lanes, P into the warp's tile
    const int o = ring ? (key - pos_mod + w) % w : 0;
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) {
      bool ok;
      if (ring)
        ok = key < n_old && o > qi[i];
      else
        ok = key <= qi[i] && key > qi[i] - w;
      const float v = ok ? s[i] * scale : rt::kNegInf;
      const float m_new = fmaxf(m[i], rt::warp_max(v));
      const float p = expf(v - m_new);
      const float a = expf(m[i] - m_new);
      l[i] = a * l[i] + rt::warp_sum(p);
      m[i] = m_new;
      pw[lane * kRowsPerWarp + i] = p;
#pragma unroll
      for (int g = 0; g < kMaxGroups; ++g)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[i][g][c] *= a;
    }
    __syncwarp();

    // O += P V: this lane's column groups lane, lane + 32
#pragma unroll 4
    for (int k = 0; k < kTileK; ++k) {
      const float4 p4 = reinterpret_cast<const float4*>(pw)[k];
      const float pk[kRowsPerWarp] = {p4.x, p4.y, p4.z, p4.w};
#pragma unroll
      for (int g = 0; g < kMaxGroups; ++g) {
        const int col = lane + 32 * g;
        if (col < ngroups) {
          const float4 v4 = reinterpret_cast<const float4*>(vs + k * hd4)[col];
#pragma unroll
          for (int i = 0; i < kRowsPerWarp; ++i) {
            acc[i][g][0] += pk[i] * v4.x;
            acc[i][g][1] += pk[i] * v4.y;
            acc[i][g][2] += pk[i] * v4.z;
            acc[i][g][3] += pk[i] * v4.w;
          }
        }
      }
    }
    __syncwarp();
  }

  // Key group 1 hands its (m, l, O) to group 0 through its own K tile,
  // which group 0 never reads; group 0 merges the two in a fixed order.
  // A group that saw no valid key of a row holds m = kNegInf there (and
  // finite sums of masked keys), and its share is scaled by
  // exp(kNegInf - m) = 0: every row sees its own chunk key.
  constexpr int kXch = kRowsPerWarp * (2 + 4 * kMaxGroups);  // floats a lane
  float* xch = qs + kRows * kstride + kTileK * (kstride + hd4) +
               (warp * 32 + lane) * kXch;
  __syncthreads();
  if (kgroup == 1) {
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) {
      xch[i] = m[i];
      xch[kRowsPerWarp + i] = l[i];
#pragma unroll
      for (int g = 0; g < kMaxGroups; ++g)
#pragma unroll
        for (int c = 0; c < 4; ++c)
          xch[2 * kRowsPerWarp + (i * kMaxGroups + g) * 4 + c] = acc[i][g][c];
    }
  }
  __syncthreads();
  if (kgroup == 1) return;
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    const float m1 = xch[i];
    const float mn = fmaxf(m[i], m1);
    const float a0 = expf(m[i] - mn);
    const float a1 = expf(m1 - mn);
    l[i] = l[i] * a0 + xch[kRowsPerWarp + i] * a1;
#pragma unroll
    for (int g = 0; g < kMaxGroups; ++g)
#pragma unroll
      for (int c = 0; c < 4; ++c)
        acc[i][g][c] = acc[i][g][c] * a0 +
            xch[2 * kRowsPerWarp + (i * kMaxGroups + g) * 4 + c] * a1;
  }

  // divide by l in f32, round once
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    if (qi[i] < 0) continue;
    const int rho = r0 + warp * kRowsPerWarp + i;
    T* dst = out + (static_cast<size_t>(qi[i]) * H + kvh * G + rho % G) * hd;
    const float li = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int g = 0; g < kMaxGroups; ++g) {
      const int col = lane + 32 * g;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int d = 4 * col + c;
        if (col < ngroups && d < hd)
          dst[d] = rt::from_f32<T>(acc[i][g][c] / li);
      }
    }
  }
}

template <typename T>
cudaError_t launch(const void* q, const void* kp, const void* vp,
                   const void* table, const void* kn, const void* vn,
                   void* out, int C, int H, int KV, int hd, int bs, int pos,
                   int w, float scale, cudaStream_t stream) {
  const int hd4 = (hd + 3) & ~3;
  // Q, group 0's K / V tiles, then group 1's and the warps' P tiles,
  // which group 1's exchange of (m, l, O) reuses at the end
  const size_t tiles = static_cast<size_t>(kTileK) * (2 * hd4 + 4);
  const size_t ps = static_cast<size_t>(kThreads / 32) * kTileK * kRowsPerWarp;
  const size_t xch = static_cast<size_t>(kGroupThreads) * kRowsPerWarp *
                     (2 + 4 * kMaxGroups);
  const size_t floats = static_cast<size_t>(kRows) * (hd4 + 4) + tiles +
                        (tiles + ps > xch ? tiles + ps : xch);
  const size_t bytes = floats * sizeof(float);
  cudaError_t err = rt::allow_smem(ring_chunk_kernel<T>, bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((C * (H / KV) + kRows - 1) / kRows, KV);
  ring_chunk_kernel<T><<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(kp),
      static_cast<const T*>(vp), static_cast<const int*>(table),
      static_cast<const T*>(kn), static_cast<const T*>(vn),
      static_cast<T*>(out), C, H, KV, hd, bs, pos, w, scale);
  return cudaGetLastError();
}

}  // namespace

// q (C, H, hd); pools (NB, bs, KV, hd); table (nb,) int32 covering ring
// slots [0, w); k_new / v_new (C, KV, hd); out like q.  pos >= 0 is the
// position of the chunk's first query, w the ring size.
extern "C" int rt_ring_chunk_attention(const void* q, const void* k_pool,
                                       const void* v_pool, const void* table,
                                       const void* k_new, const void* v_new,
                                       void* out, int C, int H, int KV,
                                       int hd, int bs, int nb, int pos, int w,
                                       float scale, int dtype, int body,
                                       void* stream) {
  if (C <= 0) return static_cast<int>(cudaSuccess);
  if (KV <= 0 || H % KV != 0 || bs <= 0 || hd <= 0 || hd > kMaxHd ||
      pos < 0 || w <= 0 || nb * bs < w || body != rt::kBodyCudaCore)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return static_cast<int>(launch<float>(q, k_pool, v_pool, table, k_new,
                                          v_new, out, C, H, KV, hd, bs, pos,
                                          w, scale, s));
  if (dtype == 1)
    return static_cast<int>(launch<__nv_bfloat16>(
        q, k_pool, v_pool, table, k_new, v_new, out, C, H, KV, hd, bs, pos, w,
        scale, s));
  return static_cast<int>(cudaErrorInvalidValue);
}
