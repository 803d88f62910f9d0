// The wgmma body of serving's two chunk-attention forms (bf16, hd 64, 112
// and 128): the paged chunk (rt_paged_prefill_attention,
// rt_paged_chunk_attention: C queries of each of B rows, row b's at
// positions pos[b] .. pos[b] + C - 1, attend causally to the logical
// slots [0, pos[b] + C) of a paged pool through the row's block table,
// keys clamped at nb * bs - 1) and the window form (rt_ring_chunk_attention:
// C queries of one request attend to its sliding-window ring plus the
// chunk's own keys, the keys numbered [old ring ; chunk] as
// ring_chunk_attention.cu sets out).  The entry points launch it where
// the wrappers' rules (kernels/flash_attention.py::chunk_body,
// ring_body) name "wgmma".  Both replace flash_attention_pallas
// (src/repro/kernels/flash_attention.py:72) in the forms the reference
// model's chunked prefill runs it.
//
// Bound on the H100: operations at the served chunks that walk long
// prefixes (mixtral-8x7b's window form: 32 / 8 heads of 128 over up to
// 4096 + 128 keys; zamba2-7b's hd-112 chunk over 2176 slots: 4 hd flops a
// (query head, key) pair), bytes at short ones; before this body both ran
// the mma body of 64-row tiles, one CTA per (row tile, KV head), which
// left half of the SMs idle at those shapes and fed each warp's mma.sync
// from cp.async copies of 16 bytes a row.
//
// The design: the cross form's body (paged_cross_attention.cu) with a
// causal or window mask.  Two consumer warpgroups of 64 (query,
// head-in-group) rows run S = Q K^T and O += (P_hi + P_lo) V on wgmma
// (wg_attention.cuh); one producer warp issues every copy by TMA.
// * Q: one 5-D map (hd, head-in-group, query, KV head, row) over q
//   (B, C, H, hd), boxes of 64 columns of nq = 128 / G whole queries' G
//   rows (rows past C read zeros).
// * Pool tiles: 64 logical slots, cut by logical slot and brought as
//   segments of `seg` slots, one TMA box a (block, tile) segment a half,
//   through a 4-D map (hd, KV head, slot in block, block) over the pool:
//   seg = 64 where no tile straddles a block (bs a multiple of 64, or one
//   block a row: the dense caches and the dense ring), else the largest
//   power of two dividing bs and 64, at least 8 (one swizzle atom; the
//   wrappers send other block sizes to mma).  The producer's first warp
//   finds a tile's segments in the table a lane each, a tile ahead of the
//   copies.  A segment past the slots the CTA reads is never looked up:
//   its box names a block past the pool's, which TMA fills with zeros.
//   The segment that holds the CTA's last key may bring finite pool
//   values past it (the reference's pools are zero-initialised and only
//   ever hold K/V); their P is exactly 0, so no bit of the output depends
//   on them, and so none on bs or the table: a dense one-block cache
//   gives a paged one's bits.  The maps do not depend on pos (no tail
//   map), so a graph can capture the batched launch.
// * The window form's chunk tiles: 64 of the chunk's contiguous
//   (C, KV, hd) keys through a 3-D map whose extent C zero-fills past the
//   chunk.  A tile never mixes the ring and the chunk.
// * hd 112 (zamba2-7b) runs the hd-128 body: every map stops at column
//   112, so TMA fills columns 112-127 of the second half with zeros; S
//   sums the same products, P V's last 16 columns are zeros and the store
//   stops at 14 steps of 8.
// * Key range: each CTA reads its row's pos (a host int, or the device
//   value of the batched form and of a device-pos window launch) and
//   derives its tiles: the paged chunk's [0, klast], klast = min(pos +
//   its last query, nb * bs - 1); the window form's ring tiles over slots
//   [0, n_old), n_old = min(pos, w) (none when the CTA's first query
//   sees no ring slot, at C > w), then chunk tiles from the first its
//   queries may see (first query - w + 1) to its last query.  Each
//   consumer warpgroup computes the run of tiles from the first a row of
//   it may see to the last (the window form's hull of the ring: the slots
//   no row sees are a cyclic range of at most C, masked), masks only the
//   tiles that straddle an edge (the diagonal, the clamp, n_old, the
//   ring's cyclic edge, the window), and skips the others, copies
//   included in the producer's count.
// * Split: each (row tile, KV head, row)'s tiles are split across a
//   cluster of `splits` CTAs (kernels/flash_attention.py::chunk_splits,
//   ring_splits: shape only), CTA r taking tiles [r nt / splits, (r + 1)
//   nt / splits) of the nt it derives from pos; the partials merge in
//   split order through distributed shared memory
//   (wg_attention.cuh::store_rows).  Equal shapes take equal splits and
//   run the same instructions, so a row of a batched launch gives a
//   one-row call's bits, and a device pos a host pos's.
#include <cooperative_groups.h>

#include "common.cuh"
#include "hopper.cuh"
#include "wg_attention.cuh"

namespace {

using wgt::kMaxSplits;
using wgt::kRows;
using wgt::kThreads;

// 64-key tiles in a ring of 4 at both head dims, as the cross form's
template <int HD>
using ChunkCfg = wgt::Cfg<HD, 64, 4>;
// The cross form's register split: the producer warp finds segments a
// lane each besides issuing (32), the consumers 232.
constexpr int kConsumerRegs = 232;
constexpr int kProducerRegs = 32;
static_assert(wgt::kC * 128 * kConsumerRegs + 128 * kProducerRegs < 65536,
              "the warpgroups' registers fit the SM");

struct Params {
  const int* tables;            // (B, nb): each row's blocks (the ring's)
  const int* pos_dev;           // (B,) on the device, or null: pos_host
  __nv_bfloat16* out;           // (B, C, H, hd)
  int pos_host;
  int C, H, KV, G, hd;          // hd: HD, or 112 on the hd-128 body
  int nb, bs, nbp;              // a row's blocks, slots a block, the pool's
  int nq;                       // whole queries of a CTA's rows: kRows / G
  int seg;                      // slots a TMA box
  int splits;                   // CTAs a cluster
  int w;                        // the window form's ring slots
  float scale_log2;
};

template <int HD, bool kRing>
__global__ void __launch_bounds__(kThreads, 1)
chunk_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                   const __grid_constant__ CUtensorMap tk,
                   const __grid_constant__ CUtensorMap tv,
                   const __grid_constant__ CUtensorMap tkn,
                   const __grid_constant__ CUtensorMap tvn,
                   const Params p) {
  using K = ChunkCfg<HD>;
  constexpr int kTK = K::kTK;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const wgt::Ring<K> ring(smem_raw);
  ring.init();

  const int split = blockIdx.x % p.splits;
  const int q0 = blockIdx.x / p.splits * p.nq;
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  const int pos = p.pos_dev != nullptr ? p.pos_dev[b] : p.pos_host;
  const int rows = min(p.nq, p.C - q0) * p.G;     // rows of real queries
  const int q_last = q0 + (rows - 1) / p.G;       // the CTA's last query
  // The CTA's key tiles: pool slots [0, slots) first (the paged chunk's
  // [0, klast], the window form's ring [0, n_old) in nrt tiles), then
  // the window form's chunk tiles, tile t >= nrt holding chunk keys from
  // t * kTK - koff
  int slots, nrt, koff = 0, nt;
  if constexpr (kRing) {
    slots = min(pos, p.w);
    nrt = q0 < p.w ? (slots + kTK - 1) / kTK : 0;
    const int c_lo = max(0, q0 - p.w + 1) / kTK;
    koff = (nrt - c_lo) * kTK;
    nt = nrt + q_last / kTK - c_lo + 1;
  } else {
    slots = min(pos + q_last, p.nb * p.bs - 1) + 1;
    nrt = (slots + kTK - 1) / kTK;
    nt = nrt;
  }
  const int t_lo = split * nt / p.splits;         // this CTA's share
  const int t_hi = (split + 1) * nt / p.splits - 1;
  const int wgi = threadIdx.x / 128;

  if (wgi == wgt::kC) {
    // producer: its first warp.  Lane i < nseg finds segment i of a pool
    // tile (its block through the table and its slot), a tile ahead of
    // the copies; lane 0 issues every copy: Q once (its halves), then the
    // key tiles.
    hop::reg_dealloc<kProducerRegs>();
    if (threadIdx.x < wgt::kC * 128 + 32) {
      const int lane = threadIdx.x & 31;
      const int nseg = kTK / p.seg;
      const int* table = p.tables + static_cast<size_t>(b) * p.nb;
      auto find = [&](int t, int& slot, int& blk) {
        const int s0 = t * kTK + lane * p.seg;
        slot = 0;
        blk = p.nbp;                   // past the pool's blocks: zeros
        if (lane < nseg && s0 < slots) {
          blk = table[s0 / p.bs];
          slot = s0 % p.bs;
        }
      };
      auto issue = [&](unsigned char* dst, const CUtensorMap* map,
                       uint64_t* bar, int slot, int blk) {
        for (int i = 0; i < nseg; ++i) {
          const int sl = __shfl_sync(0xffffffffu, slot, i);
          const int bk = __shfl_sync(0xffffffffu, blk, i);
          if (lane == 0)
            for (int h = 0; h < K::kHalves; ++h)
              hop::tma_load_4d(
                  dst + h * K::kTileHalf + i * p.seg * wgt::kAtomRow, map,
                  bar, 64 * h, kvh, sl, bk);
        }
      };
      if (lane == 0) {
        hop::mbar_expect_tx(ring.q_full,
                            p.nq * p.G * wgt::kAtomRow * K::kHalves);
        for (int h = 0; h < K::kHalves; ++h)
          hop::tma_load_5d(ring.qs + h * K::kQHalf, &tq, ring.q_full, 64 * h,
                           0, q0, kvh, b);
      }
      int slot = 0, blk = 0;
      if (t_lo <= t_hi && t_lo < nrt) find(t_lo, slot, blk);
      int n = 0;
      for (int t = t_lo; t <= t_hi; ++t, ++n) {
        int n_slot = 0, n_blk = 0;
        if (t < t_hi && t + 1 < nrt) find(t + 1, n_slot, n_blk);
        const int s = n % K::kStages;
        if (n >= K::kStages)
          hop::mbar_wait(&ring.kv_empty[s], (n / K::kStages - 1) & 1);
        unsigned char* kd = ring.ks + s * K::kTileBytes;
        unsigned char* vd = ring.vs + s * K::kTileBytes;
        if (lane == 0) {
          hop::mbar_expect_tx(&ring.k_full[s], K::kTileBytes);
          hop::mbar_expect_tx(&ring.v_full[s], K::kTileBytes);
        }
        if (t < nrt) {
          issue(kd, &tk, &ring.k_full[s], slot, blk);
          issue(vd, &tv, &ring.v_full[s], slot, blk);
        } else if (lane == 0) {       // the window form's chunk keys
          const int i0 = t * kTK - koff;
          for (int h = 0; h < K::kHalves; ++h) {
            hop::tma_load_3d(kd + h * K::kTileHalf, &tkn, &ring.k_full[s],
                             64 * h, kvh, i0);
            hop::tma_load_3d(vd + h * K::kTileHalf, &tvn, &ring.v_full[s],
                             64 * h, kvh, i0);
          }
        }
        slot = n_slot;
        blk = n_blk;
      }
    }
    if (p.splits > 1) {              // the consumers' two cluster barriers
      cooperative_groups::this_cluster().sync();
      cooperative_groups::this_cluster().sync();
    }
    return;
  }

  // consumers (each branch keeps its own registers: code after a join
  // of the two would be held to the producer's).  Warpgroup wgi's rows
  // 64 wgi .. 64 wgi + 63 hold queries wq_first .. wq_last; this
  // thread's rows ra and ra + 8 queries qa and qb.
  hop::reg_alloc<kConsumerRegs>();
  wgt::Consumer<K> c(ring, wgi);
  const int rlo = 64 * wgi;
  const bool live = rlo < rows;
  const int wq_first = q0 + rlo / p.G;
  const int wq_last = q0 + (min(rlo + 63, rows - 1)) / p.G;
  const int qa = q0 + c.ra / p.G;
  const int qb = q0 + (c.ra + 8) / p.G;
  c.start_item();
  hop::mbar_wait(ring.q_full, 0);
  if constexpr (kRing) {
    // ring slot j (j < n_old) is seen by query qi iff o = (j - pos) mod w
    // > qi; the slots of a tile from j0 have o from d0 up, through w - 1
    // to 0 where the tile `wraps`; chunk key i is seen iff qi - w < i <=
    // qi.  Ring tiles are one run (the hull) for a warpgroup whose first
    // query sees some ring slot, so its seen tiles are one run.
    const int w = p.w;
    const int n_old = slots;
    const int pos_mod = pos % w;
    const int ring_keys = nrt * kTK;
    c.run(
        t_lo, t_hi, p.scale_log2,
        [&](int t) {
          if (!live) return false;
          if (t < nrt) return wq_first < w;
          const int i0 = t * kTK - koff;
          return i0 <= wq_last && i0 + kTK - 1 > wq_first - w;
        },
        [&](int k0) {
          if (k0 < ring_keys) {
            const int n = min(kTK, n_old - k0);
            int d0 = k0 - pos_mod;
            if (d0 < 0) d0 += w;
            return n < kTK || d0 + n - 1 >= w || d0 <= wq_last;
          }
          const int i0 = k0 - koff;
          return i0 + kTK - 1 > wq_first || i0 <= wq_last - w;
        },
        [&](int key, bool second) {
          const int qi = second ? qb : qa;
          if (key < ring_keys) {
            int o = key - pos_mod;
            if (o < 0) o += w;
            return key >= n_old || o <= qi;
          }
          const int i = key - koff;
          return i > qi || i <= qi - w;
        });
  } else {
    // slot s is seen by query qi iff s <= min(pos + qi, nb * bs - 1)
    const int cap = p.nb * p.bs - 1;
    const int ka = min(pos + qa, cap);
    const int kb = min(pos + qb, cap);
    const int k_first = min(pos + wq_first, cap);
    const int k_last = min(pos + wq_last, cap);
    c.run(
        t_lo, t_hi, p.scale_log2,
        [&](int t) { return live && t * kTK <= k_last; },
        [&](int k0) { return k0 + kTK - 1 > k_first; },
        [&](int key, bool second) { return key > (second ? kb : ka); });
  }
  wgt::store_rows(c, ring, rows, p.hd, split, p.splits, [&](int r) {
    return p.out + ((static_cast<size_t>(b) * p.C + q0 + r / p.G) * p.H +
                    kvh * p.G + r % p.G) * p.hd;
  });
}

// The maps over the tensors' hd columns and the launch of a grid (row
// tiles x splits, KV heads, B) of clusters of `splits`; k_new / v_new the
// window form's chunk K/V (C, KV, hd), else null.  A CUDA error, or
// hop::kTensorMapError + the CUDA driver's CUresult.
template <int HD, bool kRing>
int launch(const void* q, const void* k_pool, const void* v_pool,
           const void* tables, const void* k_new, const void* v_new,
           const void* pos_dev, void* out, int B, int C, int H, int KV,
           int hd, int bs, int nb, int nbp, int pos, int w, float scale,
           int splits, cudaStream_t stream) {
  using K = ChunkCfg<HD>;
  Params p;
  p.G = H / KV;
  if (p.G > kRows || splits < 1 || splits > kMaxSplits || nbp <= 0 ||
      KV > 65535 || B > 65535 || (kRing && (w <= 0 || nb * bs < w)))
    return static_cast<int>(cudaErrorInvalidValue);
  p.seg = wgt::pool_segment(bs, nb, K::kTK);
  if (p.seg == 0) return static_cast<int>(cudaErrorInvalidValue);
  p.tables = static_cast<const int*>(tables);
  p.pos_dev = static_cast<const int*>(pos_dev);
  p.out = static_cast<__nv_bfloat16*>(out);
  p.pos_host = pos;
  p.C = C;
  p.H = H;
  p.KV = KV;
  p.hd = hd;
  p.nb = nb;
  p.bs = bs;
  p.nbp = nbp;
  p.nq = kRows / p.G;
  p.splits = splits;
  p.w = w;
  p.scale_log2 = scale * wgt::kLog2e;
  const int tiles = (C + p.nq - 1) / p.nq;
  // Q: (hd, head-in-group, query, KV head, row), boxes of 64 columns of
  // nq whole queries' G rows; the pools: (hd, KV head, slot, block),
  // boxes of 64 columns of seg slots of one KV head; the chunk's K/V:
  // (hd, KV head, key), boxes of 64 columns of 64 keys
  const cuuint64_t e = sizeof(__nv_bfloat16);
  const cuuint64_t d = static_cast<cuuint64_t>(hd);
  CUtensorMap tq, tk, tv, tkn, tvn;
  const cuuint64_t q_dims[5] = {d, static_cast<cuuint64_t>(p.G),
                                static_cast<cuuint64_t>(C),
                                static_cast<cuuint64_t>(KV),
                                static_cast<cuuint64_t>(B)};
  const cuuint64_t q_strides[4] = {d * e, H * d * e, p.G * d * e,
                                   static_cast<cuuint64_t>(C) * H * d * e};
  const cuuint32_t q_box[5] = {64, static_cast<cuuint32_t>(p.G),
                               static_cast<cuuint32_t>(p.nq), 1, 1};
  int rc = hop::encode_bf16(&tq, q, 5, q_dims, q_strides, q_box);
  const cuuint64_t kv_dims[4] = {d, static_cast<cuuint64_t>(KV),
                                 static_cast<cuuint64_t>(bs),
                                 static_cast<cuuint64_t>(nbp)};
  const cuuint64_t kv_strides[3] = {d * e, KV * d * e,
                                    static_cast<cuuint64_t>(bs) * KV * d * e};
  const cuuint32_t kv_box[4] = {64, 1, static_cast<cuuint32_t>(p.seg), 1};
  if (rc == 0)
    rc = hop::encode_bf16(&tk, k_pool, 4, kv_dims, kv_strides, kv_box);
  if (rc == 0)
    rc = hop::encode_bf16(&tv, v_pool, 4, kv_dims, kv_strides, kv_box);
  if (kRing) {
    const cuuint64_t c_dims[3] = {d, static_cast<cuuint64_t>(KV),
                                  static_cast<cuuint64_t>(C)};
    const cuuint64_t c_strides[2] = {d * e, KV * d * e};
    const cuuint32_t c_box[3] = {64, 1, static_cast<cuuint32_t>(K::kTK)};
    if (rc == 0) rc = hop::encode_bf16(&tkn, k_new, 3, c_dims, c_strides,
                                       c_box);
    if (rc == 0) rc = hop::encode_bf16(&tvn, v_new, 3, c_dims, c_strides,
                                       c_box);
  } else {
    tkn = tk;                          // not read
    tvn = tv;
  }
  if (rc != 0) return rc;
  cudaError_t err = rt::allow_smem(chunk_wgmma_kernel<HD, kRing>, K::kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(tiles * splits, KV, B);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = K::kSmem;
  cfg.stream = stream;
  cudaLaunchAttribute cluster;
  if (splits > 1) {                  // the splits of a row tile: one cluster
    cluster.id = cudaLaunchAttributeClusterDimension;
    cluster.val.clusterDim.x = splits;
    cluster.val.clusterDim.y = 1;
    cluster.val.clusterDim.z = 1;
    cfg.attrs = &cluster;
    cfg.numAttrs = 1;
  }
  err = cudaLaunchKernelEx(&cfg, chunk_wgmma_kernel<HD, kRing>, tq, tk, tv,
                           tkn, tvn, p);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// Clusters of `splits` CTAs of the body the card holds at once (the
// occupancy calculator on the kernel itself, at its shared memory).
template <int HD, bool kRing>
int clusters(int splits, int* out) {
  cudaError_t err =
      rt::allow_smem(chunk_wgmma_kernel<HD, kRing>, ChunkCfg<HD>::kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(splits);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = ChunkCfg<HD>::kSmem;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = splits;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  return static_cast<int>(cudaOccupancyMaxActiveClusters(
      out, chunk_wgmma_kernel<HD, kRing>, &cfg));
}

template <int HD, bool kRing>
int occupancy(int* ctas, int* smem, int* tile_keys) {
  using K = ChunkCfg<HD>;
  *smem = K::kSmem;
  *tile_keys = K::kTK;
  cudaError_t err = rt::allow_smem(chunk_wgmma_kernel<HD, kRing>, K::kSmem);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        ctas, chunk_wgmma_kernel<HD, kRing>, kThreads, K::kSmem);
  return static_cast<int>(err);
}

bool takes(int hd) { return hd == 64 || hd == 112 || hd == 128; }

}  // namespace

// The paged chunk's wgmma body (rt_paged_prefill_attention with pos_dev
// null and the host's pos, rt_paged_chunk_attention with each row's pos
// on the device): q (B, C, H, hd), pools (nbp, bs, KV, hd), tables (B,
// nb), out like q; hd 64, 112 or 128.
int chunk_wgmma_launch(const void* q, const void* k_pool, const void* v_pool,
                       const void* tables, const void* pos_dev, void* out,
                       int B, int C, int H, int KV, int hd, int bs, int nb,
                       int nbp, int pos, float scale, int splits,
                       cudaStream_t stream) {
  if (hd == 64)
    return launch<64, false>(q, k_pool, v_pool, tables, nullptr, nullptr,
                             pos_dev, out, B, C, H, KV, hd, bs, nb, nbp, pos,
                             0, scale, splits, stream);
  if (hd == 112 || hd == 128)
    return launch<128, false>(q, k_pool, v_pool, tables, nullptr, nullptr,
                              pos_dev, out, B, C, H, KV, hd, bs, nb, nbp, pos,
                              0, scale, splits, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The window form's wgmma body (rt_ring_chunk_attention): q (C, H, hd),
// pools (nbp, bs, KV, hd) read through table (nb,) over ring slots
// [0, w), k_new / v_new (C, KV, hd), out like q; pos from *pos_dev where
// it is not null, else the host's; hd 64, 112 or 128.
int ring_wgmma_launch(const void* q, const void* k_pool, const void* v_pool,
                      const void* table, const void* k_new,
                      const void* v_new, const void* pos_dev, void* out,
                      int C, int H, int KV, int hd, int bs, int nb, int nbp,
                      int pos, int w, float scale, int splits,
                      cudaStream_t stream) {
  if (hd == 64)
    return launch<64, true>(q, k_pool, v_pool, table, k_new, v_new, pos_dev,
                            out, 1, C, H, KV, hd, bs, nb, nbp, pos, w, scale,
                            splits, stream);
  if (hd == 112 || hd == 128)
    return launch<128, true>(q, k_pool, v_pool, table, k_new, v_new, pos_dev,
                             out, 1, C, H, KV, hd, bs, nb, nbp, pos, w, scale,
                             splits, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The CTAs of the paged chunk's (ring 0) or the window form's (ring 1)
// wgmma body at head dim hd (64, or 112 and 128, which share a body) an
// SM of this card holds, into *ctas, its dynamic shared memory, into
// *smem, and the keys a K/V tile holds, into *tile_keys (what
// kernels/flash_attention.py's wgmma_smem_bytes and wgmma_tile_keys
// mirror for the "chunk" form; chip_smoke.py holds them to these).
extern "C" int rt_chunk_wgmma_occupancy(int hd, int ring, int* ctas,
                                        int* smem, int* tile_keys) {
  if (!takes(hd)) return static_cast<int>(cudaErrorInvalidValue);
  if (hd == 64)
    return ring ? occupancy<64, true>(ctas, smem, tile_keys)
                : occupancy<64, false>(ctas, smem, tile_keys);
  return ring ? occupancy<128, true>(ctas, smem, tile_keys)
              : occupancy<128, false>(ctas, smem, tile_keys);
}

// Clusters of `splits` (1 to 8) CTAs of that body the card holds at once,
// into *out: the table chunk_splits and ring_splits read
// (kernels/decode_attention.py::WIDE_CLUSTERS).
extern "C" int rt_chunk_wgmma_clusters(int hd, int ring, int splits,
                                       int* out) {
  if (!takes(hd) || splits < 1 || splits > kMaxSplits)
    return static_cast<int>(cudaErrorInvalidValue);
  if (hd == 64)
    return ring ? clusters<64, true>(splits, out)
                : clusters<64, false>(splits, out);
  return ring ? clusters<128, true>(splits, out)
              : clusters<128, false>(splits, out);
}
