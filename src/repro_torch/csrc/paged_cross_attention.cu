// The cross form's wgmma body (bf16, hd 64 and 128): C queries of each
// of B rows attend to all n_keys slots [0, n_keys) of the row's blocks of
// a paged pool (NB, bs, KV, hd), unmasked; rt_paged_cross_attention
// (paged_prefill_attention.cu) launches it where the wrapper's rule
// (kernels/flash_attention.py::cross_body) names "wgmma".  The reference
// computes cross-attention in jnp (src/repro/models/attention.py::
// cross_attention); the port runs it as a form of the flash kernel that
// replaces flash_attention_pallas (src/repro/kernels/flash_attention.py:72).
//
// Bound on the H100: operations at llama-3.2-vision-90b's shapes (64 / 8
// heads of 128 over 1601 patches: 4 hd flops a (query head, key) pair,
// 0.054 ms of the tensor cores at B 8, C 128), bytes at
// seamless-m4t-medium's (16 / 16 heads of 64 over 1024 frames).
//
// The design: the contiguous form's warp-specialised body
// (wg_attention.cuh: two consumer warpgroups of 64 (query,
// head-in-group) rows on wgmma, one producer thread issuing TMA) over
// logical slots read in place through the row's block table.
// * Q: one 5-D map (hd, head-in-group, query, KV head, row) over q
//   (B, C, H, hd), boxes of 64 columns of nq = 128 / G whole queries'
//   G rows (16 at vision's G 8, 128 at seamless's G 1; rows past C read
//   zeros).
// * K and V: tiles of 64 logical slots at both head dims (CrossCfg: at
//   hd 64, 128-key tiles left the consumer's S and P registers to
//   spill), cut by logical slot, each brought as segments of `seg` slots, one
//   TMA box a (block, tile) segment a half, through a 4-D map (hd, KV
//   head, slot in block, block) over the pool: seg = kTK where no tile
//   straddles a block (bs a multiple of kTK, or one block a row: the
//   dense caches of Model.prefill through identity tables), else the
//   largest power of two dividing bs and kTK (16 in the paged engine's
//   pools), at least 8 (one swizzle atom; the wrapper's rule sends other
//   block sizes to mma).  Slots past n_keys - 1 are real pool memory
//   that TMA would copy (1601 = 100 x 16 + 1): the segment that holds
//   the last key, and every segment after it, go through a second map
//   whose slot extent is the last block's keys, (n_keys - 1) % bs + 1,
//   so those slots arrive as zeros and no stale value reaches P V; the
//   last tile alone masks its scores past n_keys - 1.  The smem tiles
//   hold the same values whatever bs and the table are, so the output
//   bits do not depend on them.
// * Fill: a plain grid (row tiles x splits, KV heads, B) of clusters
//   (non-causal items all weigh the same, so no persistent schedule; one
//   that walked a cluster over the rows of a batch was tried and was
//   slower, PERF.md §6): each (row tile, KV head, row)'s key tiles are
//   split across a cluster of `splits` CTAs
//   (kernels/flash_attention.py::cross_splits, a rule of (C, H, KV, hd,
//   n_keys) alone), CTA r taking tiles [r nt / splits, (r + 1) nt /
//   splits) of nt = ceil(n_keys / 64).  The producer's first warp finds
//   a tile's segments in the table a lane each, a tile ahead of the
//   copies.  The partials merge in split order through distributed shared
//   memory (wg_attention.cuh::store_rows, the epilogue the chunk forms of
//   chunk_wgmma.cu share).  Equal shapes take equal splits, so equal bits
//   (a batched row = a one-row call).
#include <cooperative_groups.h>

#include "common.cuh"
#include "hopper.cuh"
#include "wg_attention.cuh"

namespace {

using wgt::kMaxSplits;
using wgt::kRows;
using wgt::kThreads;

// The cross form's shape: 64-key tiles in a ring of 4 at both head dims
// (at hd 64, 128-key tiles left the consumer's S and P registers to
// spill).
template <int HD>
using CrossCfg = wgt::Cfg<HD, 64, 4>;
// The producer warp finds segments a lane each besides issuing: 32
// registers (at 24 it spilled), the consumers 232 (they need about 180),
// so each SM sub-partition's two consumer warps and one producer warp
// fit its 16,384 registers with room to spare (at 240 and 32 they fill
// it exactly, and setmaxnreg.inc never returned).
constexpr int kConsumerRegs = 232;
constexpr int kProducerRegs = 32;
static_assert(wgt::kC * 128 * kConsumerRegs + 128 * kProducerRegs < 65536,
              "the warpgroups' registers fit the SM");

struct Params {
  const int* tables;            // (B, nb)
  __nv_bfloat16* out;           // (B, C, H, hd)
  int C, H, KV, G;
  int nb, bs;
  int n_keys;
  int nq;                       // whole queries of a CTA's rows: kRows / G
  int seg;                      // slots a TMA box
  int tail;                     // keys in the last key's block
  int splits, nt;               // CTAs a cluster; key tiles of a row
  float scale_log2;
};

template <int HD>
__global__ void __launch_bounds__(kThreads, 1)
cross_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                   const __grid_constant__ CUtensorMap tk,
                   const __grid_constant__ CUtensorMap tv,
                   const __grid_constant__ CUtensorMap tk_tail,
                   const __grid_constant__ CUtensorMap tv_tail,
                   const Params p) {
  using K = CrossCfg<HD>;
  constexpr int kTK = K::kTK;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const wgt::Ring<K> ring(smem_raw);
  ring.init();

  const int split = blockIdx.x % p.splits;
  const int q0 = blockIdx.x / p.splits * p.nq;
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  const int klast = p.n_keys - 1;
  const int t_lo = split * p.nt / p.splits;       // this CTA's key tiles
  const int t_hi = (split + 1) * p.nt / p.splits - 1;
  const int rows = min(p.nq, p.C - q0) * p.G;     // rows of real queries
  const int wgi = threadIdx.x / 128;

  if (wgi == wgt::kC) {
    // producer: its first warp.  Lane i < nseg finds segment i of a tile
    // (its block through the table, its slot, its map), a tile ahead of
    // the copies, so the table's latency hides behind the ring; lane 0
    // issues every copy: Q once (its halves), then the key tiles.
    hop::reg_dealloc<kProducerRegs>();
    if (threadIdx.x < wgt::kC * 128 + 32) {
      const int lane = threadIdx.x & 31;
      const int nseg = kTK / p.seg;
      const int* table = p.tables + static_cast<size_t>(b) * p.nb;
      // segment `lane` of tile t: wholly before the last key through the
      // main map (tail 0); the one that holds it through the tail map
      // (its slots past the last key zero), and those after it wholly
      // out of the tail map's extent (zeros)
      auto find = [&](int t, int& slot, int& blk, int& tail) {
        const int s0 = t * kTK + lane * p.seg;
        slot = p.tail;
        blk = 0;
        tail = 1;
        if (lane < nseg && s0 <= klast) {
          blk = table[s0 / p.bs];
          slot = s0 % p.bs;
          tail = s0 + p.seg - 1 > klast;
        }
      };
      auto issue = [&](unsigned char* dst, const CUtensorMap* map,
                       const CUtensorMap* tail_map, uint64_t* bar, int slot,
                       int blk, int tail) {
        for (int i = 0; i < nseg; ++i) {
          const int sl = __shfl_sync(0xffffffffu, slot, i);
          const int bk = __shfl_sync(0xffffffffu, blk, i);
          const int tl = __shfl_sync(0xffffffffu, tail, i);
          if (lane == 0)
            for (int h = 0; h < K::kHalves; ++h)
              hop::tma_load_4d(
                  dst + h * K::kTileHalf + i * p.seg * wgt::kAtomRow,
                  tl ? tail_map : map, bar, 64 * h, kvh, sl, bk);
        }
      };
      if (lane == 0) {
        hop::mbar_expect_tx(ring.q_full,
                            p.nq * p.G * wgt::kAtomRow * K::kHalves);
        for (int h = 0; h < K::kHalves; ++h)
          hop::tma_load_5d(ring.qs + h * K::kQHalf, &tq, ring.q_full, 64 * h,
                           0, q0, kvh, b);
      }
      int slot, blk, tail;
      find(t_lo, slot, blk, tail);
      int n = 0;
      for (int t = t_lo; t <= t_hi; ++t, ++n) {
        int n_slot = 0, n_blk = 0, n_tail = 1;
        if (t < t_hi) find(t + 1, n_slot, n_blk, n_tail);
        const int s = n % K::kStages;
        if (n >= K::kStages)
          hop::mbar_wait(&ring.kv_empty[s], (n / K::kStages - 1) & 1);
        if (lane == 0) {
          hop::mbar_expect_tx(&ring.k_full[s], K::kTileBytes);
          hop::mbar_expect_tx(&ring.v_full[s], K::kTileBytes);
        }
        issue(ring.ks + s * K::kTileBytes, &tk, &tk_tail, &ring.k_full[s],
              slot, blk, tail);
        issue(ring.vs + s * K::kTileBytes, &tv, &tv_tail, &ring.v_full[s],
              slot, blk, tail);
        slot = n_slot;
        blk = n_blk;
        tail = n_tail;
      }
    }
    if (p.splits > 1) {              // the consumers' two cluster barriers
      cooperative_groups::this_cluster().sync();
      cooperative_groups::this_cluster().sync();
    }
    return;
  }

  // consumers (each branch keeps its own registers: code after a join
  // of the two would be held to the producer's)
  hop::reg_alloc<kConsumerRegs>();
  wgt::Consumer<K> c(ring, wgi);
  const bool live = 64 * wgi < rows;
  c.start_item();
  hop::mbar_wait(ring.q_full, 0);
  c.run(
      t_lo, t_hi, p.scale_log2, [&](int) { return live; },
      [&](int k0) { return k0 + kTK - 1 > klast; },
      [&](int key, bool) { return key > klast; });
  wgt::store_rows(c, ring, rows, HD, split, p.splits, [&](int r) {
    return p.out + ((static_cast<size_t>(b) * p.C + q0 + r / p.G) * p.H +
                    kvh * p.G + r % p.G) * HD;
  });
}

template <int HD>
int launch(const void* q, const void* k_pool, const void* v_pool,
           const void* tables, void* out, int B, int C, int H, int KV,
           int bs, int nb, int nbp, int n_keys, float scale, int splits,
           cudaStream_t stream) {
  using K = CrossCfg<HD>;
  Params p;
  p.G = H / KV;
  p.nt = (n_keys + K::kTK - 1) / K::kTK;
  if (p.G > kRows || splits < 1 || splits > kMaxSplits || splits > p.nt ||
      nbp <= 0 || KV > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  p.seg = wgt::pool_segment(bs, nb, K::kTK);
  if (p.seg == 0) return static_cast<int>(cudaErrorInvalidValue);
  p.tables = static_cast<const int*>(tables);
  p.out = static_cast<__nv_bfloat16*>(out);
  p.C = C;
  p.H = H;
  p.KV = KV;
  p.nb = nb;
  p.bs = bs;
  p.n_keys = n_keys;
  p.nq = kRows / p.G;
  p.tail = (n_keys - 1) % bs + 1;
  p.splits = splits;
  p.scale_log2 = scale * wgt::kLog2e;
  const int tiles = (C + p.nq - 1) / p.nq;
  // Q: (hd, head-in-group, query, KV head, row), boxes of 64 columns of
  // nq whole queries' G rows; the pools: (hd, KV head, slot, block),
  // boxes of 64 columns of seg slots of one KV head
  const cuuint64_t e = sizeof(__nv_bfloat16);
  CUtensorMap tq, tk, tv, tk_tail, tv_tail;
  const cuuint64_t q_dims[5] = {HD, static_cast<cuuint64_t>(p.G),
                                static_cast<cuuint64_t>(C),
                                static_cast<cuuint64_t>(KV),
                                static_cast<cuuint64_t>(B)};
  const cuuint64_t q_strides[4] = {HD * e, H * HD * e, p.G * HD * e,
                                   static_cast<cuuint64_t>(C) * H * HD * e};
  const cuuint32_t q_box[5] = {64, static_cast<cuuint32_t>(p.G),
                               static_cast<cuuint32_t>(p.nq), 1, 1};
  int rc = hop::encode_bf16(&tq, q, 5, q_dims, q_strides, q_box);
  cuuint64_t kv_dims[4] = {HD, static_cast<cuuint64_t>(KV),
                           static_cast<cuuint64_t>(bs),
                           static_cast<cuuint64_t>(nbp)};
  const cuuint64_t kv_strides[3] = {HD * e, KV * HD * e,
                                    static_cast<cuuint64_t>(bs) * KV * HD * e};
  const cuuint32_t kv_box[4] = {64, 1, static_cast<cuuint32_t>(p.seg), 1};
  if (rc == 0)
    rc = hop::encode_bf16(&tk, k_pool, 4, kv_dims, kv_strides, kv_box);
  if (rc == 0)
    rc = hop::encode_bf16(&tv, v_pool, 4, kv_dims, kv_strides, kv_box);
  kv_dims[2] = static_cast<cuuint64_t>(p.tail);
  if (rc == 0)
    rc = hop::encode_bf16(&tk_tail, k_pool, 4, kv_dims, kv_strides, kv_box);
  if (rc == 0)
    rc = hop::encode_bf16(&tv_tail, v_pool, 4, kv_dims, kv_strides, kv_box);
  if (rc != 0) return rc;
  cudaError_t err = rt::allow_smem(cross_wgmma_kernel<HD>, K::kSmem);
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
  err = cudaLaunchKernelEx(&cfg, cross_wgmma_kernel<HD>, tq, tk, tv, tk_tail,
                           tv_tail, p);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// Clusters of `splits` CTAs of the body the card holds at once (the
// occupancy calculator on the kernel itself, at its shared memory).
template <int HD>
int clusters(int splits, int* out) {
  cudaError_t err =
      rt::allow_smem(cross_wgmma_kernel<HD>, CrossCfg<HD>::kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(splits);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = CrossCfg<HD>::kSmem;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = splits;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  return static_cast<int>(
      cudaOccupancyMaxActiveClusters(out, cross_wgmma_kernel<HD>, &cfg));
}

template <int HD>
int occupancy(int* ctas, int* smem, int* tile_keys) {
  using K = CrossCfg<HD>;
  *smem = K::kSmem;
  *tile_keys = K::kTK;
  cudaError_t err = rt::allow_smem(cross_wgmma_kernel<HD>, K::kSmem);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        ctas, cross_wgmma_kernel<HD>, kThreads, K::kSmem);
  return static_cast<int>(err);
}

}  // namespace

// The wgmma body of rt_paged_cross_attention (bf16, hd 64 or 128, 16-byte
// aligned tensors): q (B, C, H, hd), pools (nbp, bs, KV, hd), tables (B,
// nb), out like q; a CUDA error, or hop::kTensorMapError + the CUDA
// driver's CUresult.
int cross_wgmma_launch(const void* q, const void* k_pool, const void* v_pool,
                       const void* tables, void* out, int B, int C, int H,
                       int KV, int hd, int bs, int nb, int nbp, int n_keys,
                       float scale, int splits, cudaStream_t stream) {
  if (hd == 64)
    return launch<64>(q, k_pool, v_pool, tables, out, B, C, H, KV, bs, nb,
                      nbp, n_keys, scale, splits, stream);
  if (hd == 128)
    return launch<128>(q, k_pool, v_pool, tables, out, B, C, H, KV, bs, nb,
                       nbp, n_keys, scale, splits, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The CTAs of the cross form's wgmma body at head dim hd (64 or 128) an
// SM of this card holds, into *ctas, its dynamic shared memory, into
// *smem, and the keys a K/V tile holds, into *tile_keys (the tiles
// cross_splits counts, through wgmma_tile_keys; chip_smoke.py holds the
// mirror to this).
extern "C" int rt_cross_wgmma_occupancy(int hd, int* ctas, int* smem,
                                        int* tile_keys) {
  if (hd == 64) return occupancy<64>(ctas, smem, tile_keys);
  if (hd == 128) return occupancy<128>(ctas, smem, tile_keys);
  return static_cast<int>(cudaErrorInvalidValue);
}

// Clusters of `splits` (1 to 8) CTAs of the cross form's wgmma body at
// head dim hd (64 or 128) the card holds at once, into *out: the table
// cross_splits reads (kernels/decode_attention.py::WIDE_CLUSTERS).
extern "C" int rt_cross_wgmma_clusters(int hd, int splits, int* out) {
  if (splits < 1 || splits > kMaxSplits)
    return static_cast<int>(cudaErrorInvalidValue);
  if (hd == 64) return clusters<64>(splits, out);
  if (hd == 128) return clusters<128>(splits, out);
  return static_cast<int>(cudaErrorInvalidValue);
}
