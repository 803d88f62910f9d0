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
// The position pos is a host int, or an int32 on the device that the
// CTAs read themselves: the grid and the cluster depend on C, H, KV, hd
// and w only, so the host never reads pos (a CUDA graph can capture the
// launch), and a device-pos launch runs the instructions, and gives the
// bits, of a host-int launch at the same pos.
//
// Bound on the H100: bytes at gemma3-12b's chunks (C = 128 queries of 16
// heads of 256 against up to 1024 + 128 keys of 8 KV heads: 4 * hd flops
// per (query head, key) pair over 2 * 8 * 256 bytes per key, some 64
// flops a byte, below the bf16 tensor cores' 295), in practice latency
// and SM fill: a chunk is 4 row tiles of 64 x 8 KV heads, 32 units of
// work for 132 SMs.
//
// Two bodies; the wrapper names one by its rule
// (kernels/flash_attention.py::ring_body) and this entry point launches
// it, refusing a body the shape cannot take:
//
// * mma (bf16, hd % 16 == 0 up to 128 or hd 256, 16-byte aligned q /
//   pools / chunk K/V / out): a copy of the paged prefill's tensor-core
//   tiles (flash_tiles.cuh) over the ring's key numbering.  A CTA owns one KV
//   head and 64 (query, head-in-group) rows, 4 row warps of one m16
//   fragment times 2 key groups; gemma3's chunk is 4 row tiles x 8 KV
//   heads.  A step is kSpan logical keys of one source, never both: the
//   ring's steps cover [0, n_old), n_old = min(pos, w), the chunk's
//   [0, q_last] (the tile's last query); ring slot j is read in place
//   through table[j / bs], chunk key i from the contiguous K/V, each key
//   row copied with 16-byte cp.async into a padded shared tile (stride
//   hd + 8), the next step loading while this one computes.  A key group
//   skips a tile no row of its warp may see (chunk keys past the warp's
//   last query or at or below its first query - w; ring slots all with
//   o <= its first query) and masks, in the log2 domain, only the tiles
//   that need it.  At hd 256 (wide tiles: 32-slot key tiles, Q from
//   shared memory, 168,960 B) each row tile's steps are split across a
//   cluster of `splits` CTAs (the wrapper's ring_splits, shape only: 3
//   at gemma3's chunk, 96 CTAs, since the card holds 39 clusters of 3 at
//   one CTA an SM but 30 of 4); CTA r takes steps [r * per, (r + 1) *
//   per) of the n_old / kSpan (rounded up) + q_last / kSpan + 1 it
//   derives from pos, and the partials merge in split order through
//   distributed shared memory.  Below hd 256 the split is 1, as the
//   prefill's is (a split there spilled registers).
// * cuda_core (float32 at every shape, bf16 at the others, hd <= 256):
//   the f32 CUDA-core body of the first port (core_tiles.cuh, which the
//   contiguous form shares): 16 rows a CTA, 4 row warps of 4 rows times
//   2 key groups taking alternate tiles of 32 keys, ring tiles from slot
//   0, then chunk tiles from key w.  float32 stays here because the
//   card's float32 streams must equal the CPU's.
//
// Both bodies cut their tiles by logical key index, never by block, so
// the output bits do not depend on bs or on the table: a dense one-block
// ring gives the bits of a paged one.
#include "common.cuh"
#include "core_tiles.cuh"
#include "flash_tiles.cuh"

namespace {

template <typename T>
__global__ void __launch_bounds__(core::kThreads)
ring_chunk_kernel(const T* __restrict__ q, const T* __restrict__ kp,
                  const T* __restrict__ vp, const int* __restrict__ table,
                  const T* __restrict__ kn, const T* __restrict__ vn,
                  const int* __restrict__ pos_dev, T* __restrict__ out,
                  int C, int H, int KV, int hd, int bs, int pos_host, int w,
                  float scale) {
  using core::kRows;
  using core::kRowsPerWarp;
  using core::kTileK;
  const int pos = pos_dev != nullptr ? *pos_dev : pos_host;
  const int G = H / KV;
  const int kvh = blockIdx.y;
  const int r0 = blockIdx.x * kRows;
  const int rows = C * G;
  extern __shared__ __align__(16) float smem[];
  const core::Cta c = core::cta(smem, hd);

  // 16-byte loads where every row starts on a 16-byte boundary
  const bool vec =
      hd % (16 / static_cast<int>(sizeof(T))) == 0 &&
      ((reinterpret_cast<size_t>(q) | reinterpret_cast<size_t>(kp) |
        reinterpret_cast<size_t>(vp) | reinterpret_cast<size_t>(kn) |
        reinterpret_cast<size_t>(vn)) & 15u) == 0;

  // Q rows of this CTA (zero past the last row and in the padding)
  core::load_q(c, q, rows - r0, hd, vec, [&](int r) {
    const int rho = r0 + r;
    return (static_cast<size_t>(rho / G) * H + kvh * G + rho % G) * hd;
  });
  __syncthreads();

  // this warp's rows and their queries; a row past the last is inert
  int qi[kRowsPerWarp];
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    const int rho = r0 + c.warp * kRowsPerWarp + i;
    qi[i] = rho < rows ? rho / G : -1;
  }
  const int q_last = (min(r0 + kRows, rows) - 1) / G;   // CTA's last query
  const int n_old = pos < w ? pos : w;                  // ring slots read
  const int pos_mod = pos % w;

  core::Rows st;
  core::init_rows(st);

  // Ring tiles [0, n_old), then chunk tiles [0, q_last]; key group g
  // takes tiles g, g + 2, ...
  const int n_ring_tiles = (n_old + kTileK - 1) / kTileK;
  const int n_tiles = n_ring_tiles + (q_last + kTileK) / kTileK;
  for (int t = c.kgroup; t < n_tiles; t += core::kKeyGroups) {
    const bool ring = t < n_ring_tiles;
    const int k0 = (ring ? t : t - n_ring_tiles) * kTileK;
    core::group_sync(c);   // the group's previous K / V tile is no longer read
    if (ring) {
      core::load_kv(c, kp, vp, min(kTileK, n_old - k0), hd, vec, [&](int r) {
        const int j = k0 + r;
        const int blk = j / bs;
        return ((static_cast<size_t>(table[blk]) * bs + (j - blk * bs)) * KV +
                kvh) * hd;
      });
    } else {
      core::load_kv(c, kn, vn, min(kTileK, q_last + 1 - k0), hd, vec,
                    [&](int r) {
        return (static_cast<size_t>(k0 + r) * KV + kvh) * hd;
      });
    }
    core::group_sync(c);

    core::attend(st, c, scale, [&](int i) {
      const int key = k0 + c.lane;
      return ring ? key < n_old && (key - pos_mod + w) % w > qi[i]
                  : key <= qi[i] && key > qi[i] - w;
    });
  }

  // every row sees its own chunk key
  if (!core::merge_key_groups(st, c)) return;

  // divide by l in f32, round once
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    if (qi[i] < 0) continue;
    const int rho = r0 + c.warp * kRowsPerWarp + i;
    core::store_row(
        st, c, i,
        out + (static_cast<size_t>(qi[i]) * H + kvh * G + rho % G) * hd, hd);
  }
}

template <typename T>
cudaError_t launch(const void* q, const void* kp, const void* vp,
                   const void* table, const void* kn, const void* vn,
                   const void* pos_dev, void* out, int C, int H, int KV,
                   int hd, int bs, int pos, int w, float scale,
                   cudaStream_t stream) {
  const size_t bytes = core::smem_bytes(hd);
  cudaError_t err = rt::allow_smem(ring_chunk_kernel<T>, bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((C * (H / KV) + core::kRows - 1) / core::kRows, KV);
  ring_chunk_kernel<T><<<grid, core::kThreads, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(kp),
      static_cast<const T*>(vp), static_cast<const int*>(table),
      static_cast<const T*>(kn), static_cast<const T*>(vn),
      static_cast<const int*>(pos_dev), static_cast<T*>(out), C, H, KV, hd,
      bs, pos, w, scale);
  return cudaGetLastError();
}


// ---------------------------------------------------------------------------
// mma body (bf16): flash_tiles.cuh's tiles over [old ring ; chunk]
// ---------------------------------------------------------------------------
namespace mma {

using flash::kRows;
using flash::kThreads;

template <int HD>
__global__ void __launch_bounds__(kThreads)
ring_mma_kernel(const __nv_bfloat16* __restrict__ q,
                const __nv_bfloat16* __restrict__ kp,
                const __nv_bfloat16* __restrict__ vp,
                const int* __restrict__ table,
                const __nv_bfloat16* __restrict__ kn,
                const __nv_bfloat16* __restrict__ vn,
                const int* __restrict__ pos_dev,
                __nv_bfloat16* __restrict__ out, int C, int H, int KV,
                int bs, int pos_host, int w, float scale_log2, int splits) {
  using T = flash::Tiles<HD>;
  constexpr int kTileK = T::kTileK;
  constexpr int kSpan = T::kSpan;
  constexpr int kStride = T::kStride;
  constexpr int kChunks = T::kChunks;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* ks = qs + kRows * kStride;        // [2][kSpan][kStride]
  __nv_bfloat16* vs = ks + 2 * kSpan * kStride;    // [2][kSpan][kStride]

  const int pos = pos_dev != nullptr ? *pos_dev : pos_host;
  const int G = H / KV;
  const int kvh = blockIdx.y;
  const int rows = C * G;
  // grid x: row tiles, each split across `splits` CTAs (a cluster); 1
  // below the wide tiles, fixed here so those bodies compile as unsplit
  if constexpr (!T::kWide) splits = 1;
  const int split = blockIdx.x % splits;
  const int r0 = blockIdx.x / splits * kRows;
  const int rlast = min(r0 + kRows, rows) - 1;
  const int q_last = rlast / G;                    // the tile's last query
  const int n_old = min(pos, w);                   // ring slots read
  const int pos_mod = pos % w;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  // this warp's 16 rows, and its half of each step
  const int warp = (tid >> 5) % flash::kRowWarps;
  const int kgroup = (tid >> 5) / flash::kRowWarps;

  // the tile's steps of kSpan logical keys: n_rs over the ring's
  // [0, n_old), then q_last / kSpan + 1 over the chunk's [0, q_last];
  // this CTA's share [st0, st1) (empty past the last)
  const int n_rs = (n_old + kSpan - 1) / kSpan;
  const int nst = n_rs + q_last / kSpan + 1;
  const int per = (nst + splits - 1) / splits;
  const int st0 = split * per;
  const int st1 = min(st0 + per, nst);

  flash::load_q<HD>(qs, q, r0, rows, G, H, kvh, tid);
  // step it's keys into buffer buf: ring slots through the table, zero
  // past n_old; chunk keys from k_new / v_new, zero past q_last
  auto load_tile = [&](int it, int buf) {
    __nv_bfloat16* kd = ks + buf * kSpan * kStride;
    __nv_bfloat16* vd = vs + buf * kSpan * kStride;
    const bool ring = it < n_rs;
    const int k0 = (ring ? it : it - n_rs) * kSpan;
    const int kend = ring ? n_old : q_last + 1;
    const __nv_bfloat16* kb = ring ? kp : kn;
    const __nv_bfloat16* vb = ring ? vp : vn;
    for (int e = tid; e < kSpan * kChunks; e += kThreads) {
      const int ki = e / kChunks;
      const int c = e - ki * kChunks;
      const int s = k0 + ki;
      size_t off = 0;
      int n = 0;
      if (s < kend) {
        size_t row = s;
        if (ring) {
          const int blk = s / bs;
          row = static_cast<size_t>(table[blk]) * bs + (s - blk * bs);
        }
        off = (row * KV + kvh) * HD + c * 8;
        n = 16;
      }
      rt::cp_async16(kd + ki * kStride + c * 8, kb + off, n);
      rt::cp_async16(vd + ki * kStride + c * 8, vb + off, n);
    }
  };
  if (st0 < st1) load_tile(st0, 0);
  rt::cp_async_commit();

  // this warp's rows: wr0 .. wr0 + 15, their queries wq_first ..
  // wq_last; this lane's two rows' queries qa and qb
  const int grp = lane >> 2;
  const int wr0 = r0 + warp * 16;
  const bool live = wr0 <= rlast;
  const int wq_first = wr0 / G;
  const int wq_last = min(wr0 + 15, rlast) / G;
  const int qa = (wr0 + grp) / G;
  const int qb = (wr0 + grp + 8) / G;

  uint32_t qf[T::kQFrags][4];   // Q in registers (not wide)
  flash::Rows<HD> st;
  flash::init_rows(st);

  for (int it = st0; it < st1; ++it) {
    const int buf = (it - st0) & 1;
    if (it + 1 < st1) load_tile(it + 1, buf ^ 1);
    rt::cp_async_commit();
    rt::cp_async_wait<1>();
    __syncthreads();
    if (it == st0) flash::load_q_frags<HD>(qf, qs, warp, lane);
    // this key group's tile: k0 its first logical key.  A ring slot j
    // (j < n_old) is seen by query qi iff o = (j - pos) mod w > qi; the
    // tile's o run from d0 up, through w - 1 to 0 where it `wraps`.  A
    // chunk key i is seen iff qi - w < i <= qi.
    const bool ring = it < n_rs;
    const int k0 = (ring ? it : it - n_rs) * kSpan + kgroup * kTileK;
    bool seen, masked;
    if (ring) {
      const int n = min(kTileK, n_old - k0);   // its slots below n_old
      int d0 = k0 - pos_mod;
      if (d0 < 0) d0 += w;
      const bool wraps = d0 + n - 1 >= w;
      seen = n > 0 && (wraps || d0 + n - 1 > wq_first);
      masked = n < kTileK || wraps || d0 <= wq_last;
    } else {
      seen = k0 <= wq_last && k0 + kTileK - 1 > wq_first - w;
      masked = k0 + kTileK - 1 > wq_first || k0 <= wq_last - w;
    }
    if (live && seen) {
      flash::attend<HD>(
          st, qf, qs, ks + (buf * kSpan + kgroup * kTileK) * kStride,
          vs + (buf * kSpan + kgroup * kTileK) * kStride, k0, warp, lane,
          scale_log2, masked, [&](int key, bool half) {
            const int qi = half ? qb : qa;
            if (!ring) return key > qi || key <= qi - w;
            int o = key - pos_mod;
            if (o < 0) o += w;
            return key >= n_old || o <= qi;
          });
    }
    __syncthreads();
  }

  flash::merge_key_groups<HD>(st, ks, kgroup, warp, lane);
  flash::finish<HD>(st, vs, out, r0, rlast, live, G, H, kvh, kgroup, warp,
                    lane, split, splits);
}

template <int HD>
cudaError_t launch(const void* q, const void* kp, const void* vp,
                   const void* table, const void* kn, const void* vn,
                   const void* pos_dev, void* out, int C, int H, int KV,
                   int bs, int pos, int w, float scale, int splits,
                   cudaStream_t stream) {
  const int tiles = (C * (H / KV) + kRows - 1) / kRows;
  return flash::launch<HD>(
      ring_mma_kernel<HD>, tiles, splits, KV, 1, stream,
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(kp),
      static_cast<const __nv_bfloat16*>(vp), static_cast<const int*>(table),
      static_cast<const __nv_bfloat16*>(kn),
      static_cast<const __nv_bfloat16*>(vn), static_cast<const int*>(pos_dev),
      static_cast<__nv_bfloat16*>(out), C, H, KV, bs, pos, w,
      scale * flash::kLog2e, splits);
}

// The instantiation for head dim hd, one of HD, HD - 16, ..., 16.
template <int HD>
cudaError_t dispatch(int hd, const void* q, const void* kp, const void* vp,
                     const void* table, const void* kn, const void* vn,
                     const void* pos_dev, void* out, int C, int H, int KV,
                     int bs, int pos, int w, float scale, cudaStream_t s) {
  if (hd == HD)
    return launch<HD>(q, kp, vp, table, kn, vn, pos_dev, out, C, H, KV, bs,
                      pos, w, scale, 1, s);
  if constexpr (HD > 16)
    return dispatch<HD - 16>(hd, q, kp, vp, table, kn, vn, pos_dev, out, C,
                             H, KV, bs, pos, w, scale, s);
  return cudaErrorInvalidValue;
}

}  // namespace mma
}  // namespace

// q (C, H, hd); pools (NB, bs, KV, hd); table (nb,) int32 covering ring
// slots [0, w); k_new / v_new (C, KV, hd); out like q.  The position of
// the chunk's first query is *pos_dev, an int32 on the device, where
// pos_dev is not null, else pos (>= 0); w is the ring size.  splits (1
// to 8) is read by the wide mma body only; the others take 1.
extern "C" int rt_ring_chunk_attention(const void* q, const void* k_pool,
                                       const void* v_pool, const void* table,
                                       const void* k_new, const void* v_new,
                                       const void* pos_dev, void* out, int C,
                                       int H, int KV, int hd, int bs, int nb,
                                       int pos, int w, float scale, int dtype,
                                       int body, int splits, void* stream) {
  if (C <= 0) return static_cast<int>(cudaSuccess);
  if (KV <= 0 || H % KV != 0 || bs <= 0 || hd <= 0 ||
      (pos_dev == nullptr && pos < 0) || w <= 0 || nb * bs < w)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (body == rt::kBodyMma) {
    const bool aligned = ((reinterpret_cast<uintptr_t>(q) |
                           reinterpret_cast<uintptr_t>(k_pool) |
                           reinterpret_cast<uintptr_t>(v_pool) |
                           reinterpret_cast<uintptr_t>(k_new) |
                           reinterpret_cast<uintptr_t>(v_new) |
                           reinterpret_cast<uintptr_t>(out)) & 15u) == 0;
    if (dtype != 1 || !aligned)
      return static_cast<int>(cudaErrorInvalidValue);
    if (hd == 256) {
      if (splits < 1 || splits > flash::kMaxSplits)
        return static_cast<int>(cudaErrorInvalidValue);
      return static_cast<int>(mma::launch<256>(
          q, k_pool, v_pool, table, k_new, v_new, pos_dev, out, C, H, KV, bs,
          pos, w, scale, splits, s));
    }
    if (hd % 16 != 0 || hd > 128 || splits != 1)
      return static_cast<int>(cudaErrorInvalidValue);
    return static_cast<int>(mma::dispatch<128>(
        hd, q, k_pool, v_pool, table, k_new, v_new, pos_dev, out, C, H, KV,
        bs, pos, w, scale, s));
  }
  if (body != rt::kBodyCudaCore || hd > core::kMaxHd || splits != 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0)
    return static_cast<int>(launch<float>(q, k_pool, v_pool, table, k_new,
                                          v_new, pos_dev, out, C, H, KV, hd,
                                          bs, pos, w, scale, s));
  if (dtype == 1)
    return static_cast<int>(launch<__nv_bfloat16>(
        q, k_pool, v_pool, table, k_new, v_new, pos_dev, out, C, H, KV, hd,
        bs, pos, w, scale, s));
  return static_cast<int>(cudaErrorInvalidValue);
}
