// Contiguous flash attention, the form the TPU kernel's own signature
// computes: Q (B, H, S, hd) attends to K / V (B, KV, S, hd) of the same
// S positions, causal or not, with an optional sliding window (causal
// only), GQA (q head h reads KV head h / G), no cache.  It writes O like
// Q and the f32 row log-sum-exp lse (B, H, S), which the gradient
// (kernels/flash_attention.py::flash_attention_backward, torch ops)
// recomputes P from.
//
// Replaces the TPU kernel flash_attention_pallas
// (src/repro/kernels/flash_attention.py:72, body _flash_kernel) as the
// reference model runs its jnp analogue in train mode
// (src/repro/models/attention.py::self_attention): keys masked with
// kpos < S; causal: kpos <= qpos, and with window > 0 also
// kpos > qpos - window (the window is ignored when not causal); masked
// scores at -1e30; the denominator clamped at 1e-30.
//
// Layout: every tensor is read and written in place through its strides
// (batch, head, position; the head dim contiguous), so the model's
// (B, S, H, hd) projections are read without a transposing copy; K and
// V share their strides.  lse is contiguous.
//
// Bound on the H100: operations at the train shape (smollm-360m, B 8,
// S 4096, 15 / 5 heads of 64, causal: 4 * hd flops per (query head, key)
// pair, some 258 GFLOP over 168 MB of Q, K, V and O), so the tensor
// cores' rate is the bound, and what matters is keeping them fed:
// skipping work no row needs, and reading each K/V tile once for the G
// heads of a group.
//
// Three bodies; the wrapper names one by its rule
// (kernels/flash_attention.py::flash_body) and this entry point launches
// it, refusing a body the shape cannot take:
//
// * wgmma (bf16, hd 64, 112 and 128, 16-byte aligned pointers and
//   strides: every launch of smollm-360m's and zamba2-7b's train steps and
//   of Model.prefill's self-attention), warp-specialised for Hopper, the
//   consumers shared
//   with the cross form (wg_attention.cuh).  One producer warp issues
//   every copy by TMA over the tensors' own strides (hopper.cuh): Q once
//   an item, through a 5-D map (hd, head-in-group, query, KV head,
//   batch) whose box is 64 columns of nq = 128 / G whole queries, so a
//   CTA's 128 rows keep the (query, head) packing and each K/V tile
//   serves all G heads; K and V as boxes of 4-D maps into a ring
//   (hd 64: 128-key tiles, 3 stages; hd 128: each row two 64-column
//   halves, 64-key tiles, 4 stages, 165,120 B; hd 112 runs the hd-128
//   body, its maps over the tensors' 112 columns, so the second half's
//   boxes read columns 64-111 and TMA fills 112-127 with zeros: S sums
//   the same products, P V's last 16 columns are zeros and never
//   stored), with full / empty
//   mbarriers, keys past S arriving as zeros, only the tiles some row of
//   the CTA may see.  Two consumer warpgroups (setmaxnreg 240; the
//   producer 24) of 64 rows each run S = Q K^T as wgmma from the
//   128-byte-swizzled tiles, the softmax in registers (the mask only on
//   tiles that straddle the diagonal, the window's edge or S; a tile
//   none of a warpgroup's rows may see is skipped), and
//   O += (P_hi + P_lo) V, P from registers, V read MN-major (at hd 128
//   one m64n128k16 over V's two halves a k16 step and P part).  Each
//   tile's S is issued beside the previous tile's PV, so its softmax
//   runs while the tensor cores finish that PV, and the two warpgroups
//   take turns issuing, so one's softmax runs beside the other's
//   products.  A persistent grid of one CTA an SM walks the items (row
//   tile, KV head, row b) at a stride of the grid, causal row tiles with
//   the most keys first; the same shapes give the same bits (no atomics;
//   a static schedule).  At the train shape it is 3.6x its operations
//   bound: neither pipe is full, and each warpgroup's S -> softmax -> PV
//   chain is exposed (PERF.md §6).
// * mma (bf16, hd % 16 == 0 up to 128 or hd 256, 16-byte aligned
//   pointers and strides): the tensor-core tiles of the paged prefill and
//   the window form (flash_tiles.cuh) over contiguous keys.  A CTA owns
//   one (row b, KV head) and 64 rows, a row being a (query,
//   head-in-group) pair of that KV head's G query heads, so each K/V tile
//   is read once for all G heads; smollm-360m's train shape is 192 row
//   tiles x 5 KV heads x 8 = 7,680 CTAs, so no split across a cluster is
//   needed (nor at hd 256: gemma3-12b's heads at S 4096 are 1,024).  Its
//   8 warps are 4 row warps of one m16 fragment times 2 key groups; each
//   step brings kSpan keys (128 up to hd 128, 64 at 256) with 16-byte
//   cp.async into padded shared tiles, the next step loading while this
//   one computes.  S = Q K^T and P V run on mma.sync m16n8k16 with f32
//   accumulators, P entering PV as bf16 P_hi + P_lo, so the output stays
//   within one final bf16 rounding of the f32 plain version.  Causal
//   tiles above the diagonal are skipped, not masked: a CTA's steps end
//   at its last query, and a key group skips a tile past its warp's last
//   query; with a window, so are tiles wholly at or before the warp's
//   first query - window (a CTA's steps start at its first query -
//   window + 1).  The mask is applied only on tiles that straddle the
//   diagonal, the window's edge or S.  The TPU kernel masks every tile.
// * cuda_core (float32 at every shape, bf16 at the others, hd <= 256):
//   f32 on the CUDA cores, so the card's float32 numbers equal the CPU's
//   (TF32 tensor cores would round the inputs): the window form's f32
//   body (core_tiles.cuh) over contiguous keys, 16 rows a CTA, 4 row
//   warps of 4 rows times 2 key groups taking alternate tiles of 32
//   keys; the same skip at tile granularity.
#include <climits>
#include <initializer_list>

#include "common.cuh"
#include "core_tiles.cuh"
#include "flash_tiles.cuh"
#include "hopper.cuh"
#include "wg_attention.cuh"

namespace {

constexpr float kLn2 = 0.6931471805599453f;

// Element strides of the (batch, head, position) dims; the head dim is
// contiguous.  K and V share theirs.
struct Layout {
  long long q[3];
  long long kv[3];
  long long o[3];
};

// The keys a CTA's queries q_first .. q_last may see: [k_lo, k_hi].
struct KeyRange {
  int lo, hi;
};

__device__ __forceinline__ KeyRange key_range(int q_first, int q_last, int S,
                                              bool causal, int window) {
  if (!causal) return {0, S - 1};
  return {window > 0 ? max(0, q_first - window + 1) : 0, q_last};
}

// ---------------------------------------------------------------------------
// cuda_core body (f32 arithmetic): core_tiles.cuh over contiguous keys
// ---------------------------------------------------------------------------
template <typename T>
__global__ void __launch_bounds__(core::kThreads)
flash_core_kernel(const T* __restrict__ q, const T* __restrict__ k,
                  const T* __restrict__ v, T* __restrict__ out,
                  float* __restrict__ lse, Layout lay, int S, int H, int KV,
                  int hd, int causal, int window, float scale, int vec) {
  using core::kRows;
  using core::kRowsPerWarp;
  using core::kTileK;
  const int G = H / KV;
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  const int r0 = blockIdx.x * kRows;
  const int rows = S * G;
  extern __shared__ __align__(16) float smem[];
  const core::Cta c = core::cta(smem, hd);
  const T* kb = k + b * lay.kv[0] + kvh * lay.kv[1];
  const T* vb = v + b * lay.kv[0] + kvh * lay.kv[1];

  core::load_q(c, q + b * lay.q[0], rows - r0, hd, vec != 0, [&](int r) {
    const int rho = r0 + r;
    return static_cast<size_t>((kvh * G + rho % G) * lay.q[1] +
                               (rho / G) * lay.q[2]);
  });
  __syncthreads();

  // this warp's rows and their queries; a row past the last is inert
  int qi[kRowsPerWarp];
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    const int rho = r0 + c.warp * kRowsPerWarp + i;
    qi[i] = rho < rows ? rho / G : -1;
  }
  const KeyRange kr = key_range(r0 / G, (min(r0 + kRows, rows) - 1) / G, S,
                                causal != 0, window);

  core::Rows st;
  core::init_rows(st);

  // tiles kr.lo / kTileK .. kr.hi / kTileK; key group g takes every
  // other one
  for (int t = kr.lo / kTileK + c.kgroup; t <= kr.hi / kTileK;
       t += core::kKeyGroups) {
    const int k0 = t * kTileK;
    core::group_sync(c);   // the group's previous K / V tile is no longer read
    core::load_kv(c, kb, vb, min(kTileK, kr.hi + 1 - k0), hd, vec != 0,
                  [&](int r) {
      return static_cast<size_t>((k0 + r) * lay.kv[2]);
    });
    core::group_sync(c);
    const int key = k0 + c.lane;
    core::attend(st, c, scale, [&](int i) {
      return key <= kr.hi &&
             (!causal ||
              (key <= qi[i] && (window <= 0 || key > qi[i] - window)));
    });
  }

  if (!core::merge_key_groups(st, c)) return;

  // divide by l in f32, round once; lane 0 writes the row's lse
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    if (qi[i] < 0) continue;
    const int h = kvh * G + (r0 + c.warp * kRowsPerWarp + i) % G;
    const float li = core::store_row(
        st, c, i, out + b * lay.o[0] + h * lay.o[1] + qi[i] * lay.o[2], hd);
    if (c.lane == 0)
      lse[(static_cast<size_t>(b) * H + h) * S + qi[i]] = st.m[i] + logf(li);
  }
}

template <typename T>
cudaError_t launch_core(const void* q, const void* k, const void* v,
                        void* out, float* lse, const Layout& lay, int B,
                        int S, int H, int KV, int hd, int causal, int window,
                        float scale, int vec, cudaStream_t stream) {
  const size_t bytes = core::smem_bytes(hd);
  cudaError_t err = rt::allow_smem(flash_core_kernel<T>, bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((S * (H / KV) + core::kRows - 1) / core::kRows, KV, B);
  flash_core_kernel<T><<<grid, core::kThreads, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), lse, lay, S, H, KV, hd,
      causal, window, scale, vec);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// mma body (bf16): flash_tiles.cuh's tiles over contiguous keys
// ---------------------------------------------------------------------------
namespace mma {

template <int HD>
__global__ void __launch_bounds__(flash::kThreads)
flash_mma_kernel(const __nv_bfloat16* __restrict__ q,
                 const __nv_bfloat16* __restrict__ k,
                 const __nv_bfloat16* __restrict__ v,
                 __nv_bfloat16* __restrict__ out, float* __restrict__ lse,
                 Layout lay, int S, int H, int KV, int causal, int window,
                 float scale_log2) {
  using T = flash::Tiles<HD>;
  constexpr int kRows = flash::kRows;
  constexpr int kThreads = flash::kThreads;
  constexpr int kTileK = T::kTileK;
  constexpr int kSpan = T::kSpan;
  constexpr int kStride = T::kStride;
  constexpr int kChunks = T::kChunks;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* ks = qs + kRows * kStride;        // [2][kSpan][kStride]
  __nv_bfloat16* vs = ks + 2 * kSpan * kStride;    // [2][kSpan][kStride]

  const int G = H / KV;
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  const int rows = S * G;
  const int r0 = blockIdx.x * kRows;
  const int rlast = min(r0 + kRows, rows) - 1;
  const bool win = causal && window > 0;
  const KeyRange kr = key_range(r0 / G, rlast / G, S, causal != 0, window);
  const int st0 = kr.lo / kSpan;                   // this CTA's steps
  const int st1 = kr.hi / kSpan + 1;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = (tid >> 5) % flash::kRowWarps;  // this warp's 16 rows
  const int kgroup = (tid >> 5) / flash::kRowWarps;   // its half a step
  const __nv_bfloat16* qb = q + b * lay.q[0];
  const __nv_bfloat16* kb = k + b * lay.kv[0] + kvh * lay.kv[1];
  const __nv_bfloat16* vb = v + b * lay.kv[0] + kvh * lay.kv[1];

  // the CTA's Q rows (zero past the last row)
  for (int e = tid; e < kRows * kChunks; e += kThreads) {
    const int r = e / kChunks;
    const int c = e - r * kChunks;
    const int rho = r0 + r;
    const __nv_bfloat16* src = q;
    int n = 0;
    if (rho < rows) {
      src = qb + (kvh * G + rho % G) * lay.q[1] + (rho / G) * lay.q[2] + c * 8;
      n = 16;
    }
    rt::cp_async16(qs + r * kStride + c * 8, src, n);
  }
  // step it's keys into buffer buf, zero past kr.hi
  auto load_tile = [&](int it, int buf) {
    __nv_bfloat16* kd = ks + buf * kSpan * kStride;
    __nv_bfloat16* vd = vs + buf * kSpan * kStride;
    const int k0 = it * kSpan;
    for (int e = tid; e < kSpan * kChunks; e += kThreads) {
      const int ki = e / kChunks;
      const int c = e - ki * kChunks;
      const int key = k0 + ki;
      const __nv_bfloat16* ksrc = k;
      const __nv_bfloat16* vsrc = v;
      int n = 0;
      if (key <= kr.hi) {
        ksrc = kb + key * lay.kv[2] + c * 8;
        vsrc = vb + key * lay.kv[2] + c * 8;
        n = 16;
      }
      rt::cp_async16(kd + ki * kStride + c * 8, ksrc, n);
      rt::cp_async16(vd + ki * kStride + c * 8, vsrc, n);
    }
  };
  load_tile(st0, 0);
  rt::cp_async_commit();

  // this warp's rows wr0 .. wr0 + 15, their queries wq_first .. wq_last;
  // this lane's two rows' queries qa and qb
  const int grp = lane >> 2;
  const int tig = lane & 3;
  const int wr0 = r0 + warp * 16;
  const bool live = wr0 <= rlast;
  const int wq_first = wr0 / G;
  const int wq_last = min(wr0 + 15, rlast) / G;
  const int qa = (wr0 + grp) / G;
  const int qb_ = (wr0 + grp + 8) / G;

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
    // this key group's tile of keys k0 .. k0 + kTileK - 1: skipped where
    // no row of the warp may see a key of it, masked where some row may
    // not see some key
    const int k0 = it * kSpan + kgroup * kTileK;
    bool seen, masked;
    if (causal) {
      seen = k0 <= wq_last && (!win || k0 + kTileK - 1 > wq_first - window);
      masked = k0 + kTileK - 1 > wq_first || (win && k0 <= wq_last - window);
    } else {
      seen = k0 < S;
      masked = k0 + kTileK > S;
    }
    if (live && seen) {
      flash::attend<HD>(
          st, qf, qs, ks + (buf * kSpan + kgroup * kTileK) * kStride,
          vs + (buf * kSpan + kgroup * kTileK) * kStride, k0, warp, lane,
          scale_log2, masked, [&](int key, bool half) {
            if (!causal) return key >= S;
            const int qi = half ? qb_ : qa;
            return key > qi || (win && key <= qi - window);
          });
    }
    __syncthreads();
  }

  flash::merge_key_groups<HD>(st, ks, kgroup, warp, lane);
  if (kgroup == 1 || !live) return;
  // divide by l in f32, round once; lse = (m + log2 l) ln 2 (m is in the
  // log2 domain)
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int rho = wr0 + grp + 8 * half;
    if (rho > rlast) continue;
    const int qi = rho / G;
    const int h = kvh * G + rho % G;
    const float l = fmaxf(half ? st.l_b : st.l_a, 1e-30f);
    __nv_bfloat16* dst = out + b * lay.o[0] + h * lay.o[1] + qi * lay.o[2] +
                         2 * tig;
#pragma unroll
    for (int d = 0; d < HD / 8; ++d)
      *reinterpret_cast<__nv_bfloat162*>(dst + 8 * d) =
          __floats2bfloat162_rn(st.o[d][2 * half] / l,
                                st.o[d][2 * half + 1] / l);
    if (tig == 0)
      lse[(static_cast<size_t>(b) * H + h) * S + qi] =
          ((half ? st.m_b : st.m_a) + log2f(l)) * kLn2;
  }
}

template <int HD>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   float* lse, const Layout& lay, int B, int S, int H, int KV,
                   int causal, int window, float scale, cudaStream_t stream) {
  const int tiles = (S * (H / KV) + flash::kRows - 1) / flash::kRows;
  return flash::launch<HD>(
      flash_mma_kernel<HD>, tiles, 1, KV, B, stream,
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(out),
      lse, lay, S, H, KV, causal, window, scale * flash::kLog2e);
}

// The instantiation for head dim hd, one of HD, HD - 16, ..., 16.
template <int HD>
cudaError_t dispatch(int hd, const void* q, const void* k, const void* v,
                     void* out, float* lse, const Layout& lay, int B, int S,
                     int H, int KV, int causal, int window, float scale,
                     cudaStream_t s) {
  if (hd == HD)
    return launch<HD>(q, k, v, out, lse, lay, B, S, H, KV, causal, window,
                      scale, s);
  if constexpr (HD > 16)
    return dispatch<HD - 16>(hd, q, k, v, out, lse, lay, B, S, H, KV, causal,
                             window, scale, s);
  return cudaErrorInvalidValue;
}

}  // namespace mma

// ---------------------------------------------------------------------------
// wgmma body (bf16, hd 64, 112 and 128): warp-specialised, Q / K / V by
// TMA, the consumers of wg_attention.cuh; hd 112 on the hd-128 body
// ---------------------------------------------------------------------------
namespace wg {

using wgt::kRows;
using wgt::kThreads;

struct Params {
  __nv_bfloat16* out;
  float* lse;
  long long o[3];   // out's element strides (batch, head, position)
  int hd;           // the tensors' head dim: HD, or 112 on the hd-128 body
  int S, H, KV, G;
  int nq;           // whole queries of a CTA's rows: kRows / G
  int tiles;        // row tiles, ceil(S / nq)
  int nbkv;         // B * KV
  int items;        // tiles * nbkv
  int causal, window;
  float scale_log2;
};

// Work item w: row tile rank w / nbkv (heaviest first: the last causal
// row tiles see the most keys), then (KV head, row b).
struct Item {
  int kvh, b, q0, t_lo, t_hi;   // first query; key tiles
};

template <int HD>
__device__ __forceinline__ Item item_of(const Params& p, int w) {
  constexpr int kTK = wgt::FlashCfg<HD>::kTK;
  const int rank = w / p.nbkv;
  const int r = w - rank * p.nbkv;
  Item it;
  it.kvh = r % p.KV;
  it.b = r / p.KV;
  it.q0 = (p.causal ? p.tiles - 1 - rank : rank) * p.nq;
  const KeyRange kr = key_range(it.q0, min(it.q0 + p.nq, p.S) - 1, p.S,
                                p.causal != 0, p.window);
  it.t_lo = kr.lo / kTK;
  it.t_hi = kr.hi / kTK;
  return it;
}

template <int HD>
__global__ void __launch_bounds__(kThreads, 1)
flash_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                   const __grid_constant__ CUtensorMap tk,
                   const __grid_constant__ CUtensorMap tv, const Params p) {
  using K = wgt::FlashCfg<HD>;
  constexpr int kTK = K::kTK;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const wgt::Ring<K> ring(smem_raw);
  ring.init();

  // a persistent grid: each CTA walks the items at a stride of the grid
  const int first = blockIdx.x;
  const int stride = gridDim.x;
  const int wgi = threadIdx.x / 128;

  if (wgi == wgt::kC) {
    // producer: one thread issues every copy, Q once an item (its halves
    // as boxes of 64 columns), then the item's key tiles into the ring as
    // the consumers release it
    hop::reg_dealloc<wgt::kProducerRegs>();
    if (threadIdx.x == wgt::kC * 128) {
      const uint32_t q_bytes = p.nq * p.G * wgt::kAtomRow * K::kHalves;
      int n = 0;                               // K / V tiles issued
      int j = 0;                               // items
      for (int w = first; w < p.items; w += stride, ++j) {
        const Item it = item_of<HD>(p, w);
        if (j > 0) hop::mbar_wait(ring.q_empty, (j - 1) & 1);
        hop::mbar_expect_tx(ring.q_full, q_bytes);
        for (int h = 0; h < K::kHalves; ++h)
          hop::tma_load_5d(ring.qs + h * K::kQHalf, &tq, ring.q_full, 64 * h,
                           0, it.q0, it.kvh, it.b);
        for (int t = it.t_lo; t <= it.t_hi; ++t, ++n) {
          const int s = n % K::kStages;
          if (n >= K::kStages)
            hop::mbar_wait(&ring.kv_empty[s], (n / K::kStages - 1) & 1);
          unsigned char* kd = ring.ks + s * K::kTileBytes;
          unsigned char* vd = ring.vs + s * K::kTileBytes;
          hop::mbar_expect_tx(&ring.k_full[s], K::kTileBytes);
          for (int h = 0; h < K::kHalves; ++h)
            hop::tma_load_4d(kd + h * K::kTileHalf, &tk, &ring.k_full[s],
                             64 * h, t * kTK, it.kvh, it.b);
          hop::mbar_expect_tx(&ring.v_full[s], K::kTileBytes);
          for (int h = 0; h < K::kHalves; ++h)
            hop::tma_load_4d(vd + h * K::kTileHalf, &tv, &ring.v_full[s],
                             64 * h, t * kTK, it.kvh, it.b);
        }
      }
    }
  } else {
    // consumer warpgroup wgi: rows 64 wgi .. 64 wgi + 63 of the CTA's
    // nq * G, this thread's ra and ra + 8
    hop::reg_alloc<wgt::kConsumerRegs>();
    wgt::Consumer<K> c(ring, wgi);
    const int rows = p.nq * p.G;
    const int rlo = 64 * wgi;
    const int rhi = min(rlo + 63, rows - 1);
    const bool win = p.causal && p.window > 0;
    int j = 0;
    for (int w = first; w < p.items; w += stride, ++j) {
      const Item it = item_of<HD>(p, w);
      const int wq_first = it.q0 + rlo / p.G;
      const int wq_last = min(it.q0 + rhi / p.G, p.S - 1);
      const bool live = rlo <= rhi && wq_first < p.S;
      const int qa = it.q0 + c.ra / p.G;
      const int qb = it.q0 + (c.ra + 8) / p.G;
      c.start_item();
      hop::mbar_wait(ring.q_full, j & 1);
      // the key tiles some row of the warpgroup may see: one run of tiles;
      // masked where some row may not see some key of the tile
      c.run(
          it.t_lo, it.t_hi, p.scale_log2,
          [&](int t) {
            const int k0 = t * kTK;
            if (!p.causal) return live;
            return live && k0 <= wq_last &&
                   (!win || k0 + kTK - 1 > wq_first - p.window);
          },
          [&](int k0) {
            return p.causal ? k0 + kTK - 1 > wq_first ||
                                  (win && k0 <= wq_last - p.window)
                            : k0 + kTK > p.S;
          },
          [&](int key, bool second) {
            const int qi = second ? qb : qa;
            return p.causal ? key > qi || (win && key <= qi - p.window)
                            : key >= p.S;
          });
      if (c.lane == 0) hop::mbar_arrive(ring.q_empty);   // Q is read no more

      // divide by l in f32, round once, store through out's strides
      // (the launch's hd columns: the zero-filled ones are not stored);
      // lse = (m + log2 l) ln 2
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int rho = c.ra + 8 * half;
        const int qi = half ? qb : qa;
        if (!live || rho >= rows || qi >= p.S) continue;
        const int h = it.kvh * p.G + rho % p.G;
        const float l = fmaxf(half ? c.l_b : c.l_a, 1e-30f);
        __nv_bfloat16* dst = p.out + it.b * p.o[0] + h * p.o[1] +
                             qi * p.o[2] + 2 * c.tig;
#pragma unroll
        for (int d = 0; d < HD / 8; ++d)
          if (8 * d < p.hd)
            *reinterpret_cast<__nv_bfloat162*>(dst + 8 * d) =
                __floats2bfloat162_rn(c.o[4 * d + 2 * half] / l,
                                      c.o[4 * d + 2 * half + 1] / l);
        if (c.tig == 0)
          p.lse[(static_cast<size_t>(it.b) * p.H + h) * p.S + qi] =
              ((half ? c.m_b : c.m_a) + log2f(l)) * kLn2;
      }
    }
  }
}

// Encode the three tensor maps over the tensors' own strides and head
// dim hd (HD, or 112 on the hd-128 body: columns past hd arrive as
// zeros) and launch a persistent grid of one CTA an SM; a CUDA error, or
// hop::kTensorMapError + the CUDA driver's CUresult.
template <int HD>
int launch(const void* q, const void* k, const void* v, void* out,
           float* lse, const Layout& lay, int B, int S, int H, int KV,
           int hd, int causal, int window, float scale,
           cudaStream_t stream) {
  using K = wgt::FlashCfg<HD>;
  Params p;
  p.hd = hd;
  p.G = H / KV;
  if (p.G > kRows) return static_cast<int>(cudaErrorInvalidValue);
  p.out = static_cast<__nv_bfloat16*>(out);
  p.lse = lse;
  for (int i = 0; i < 3; ++i) p.o[i] = lay.o[i];
  p.S = S;
  p.H = H;
  p.KV = KV;
  p.nq = kRows / p.G;
  p.tiles = (S + p.nq - 1) / p.nq;
  p.nbkv = B * KV;
  p.causal = causal;
  p.window = window;
  p.scale_log2 = scale * flash::kLog2e;
  if (static_cast<long long>(p.tiles) * p.nbkv > INT_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  p.items = p.tiles * p.nbkv;
  // Q: (hd, head-in-group, query, KV head, batch), boxes of 64 columns
  // of nq whole queries' G rows; K and V: (hd, position, KV head, batch),
  // boxes of 64 columns of kTK keys (past S and past hd: zeros; the
  // barriers count whole boxes)
  const cuuint64_t e = sizeof(__nv_bfloat16);
  CUtensorMap tq, tk, tv;
  const cuuint64_t q_dims[5] = {static_cast<cuuint64_t>(hd),
                                static_cast<cuuint64_t>(p.G),
                                static_cast<cuuint64_t>(S),
                                static_cast<cuuint64_t>(KV),
                                static_cast<cuuint64_t>(B)};
  const cuuint64_t q_strides[4] = {
      lay.q[1] * e, lay.q[2] * e, p.G * lay.q[1] * e, lay.q[0] * e};
  const cuuint32_t q_box[5] = {64, static_cast<cuuint32_t>(p.G),
                               static_cast<cuuint32_t>(p.nq), 1, 1};
  int rc = hop::encode_bf16(&tq, q, 5, q_dims, q_strides, q_box);
  const cuuint64_t kv_dims[4] = {static_cast<cuuint64_t>(hd),
                                 static_cast<cuuint64_t>(S),
                                 static_cast<cuuint64_t>(KV),
                                 static_cast<cuuint64_t>(B)};
  const cuuint64_t kv_strides[3] = {lay.kv[2] * e, lay.kv[1] * e,
                                    lay.kv[0] * e};
  const cuuint32_t kv_box[4] = {64, K::kTK, 1, 1};
  if (rc == 0) rc = hop::encode_bf16(&tk, k, 4, kv_dims, kv_strides, kv_box);
  if (rc == 0) rc = hop::encode_bf16(&tv, v, 4, kv_dims, kv_strides, kv_box);
  if (rc != 0) return rc;
  cudaError_t err = rt::allow_smem(flash_wgmma_kernel<HD>, K::kSmem);
  int dev = 0, sms = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_wgmma_kernel<HD><<<min(p.items, sms), kThreads, K::kSmem, stream>>>(
      tq, tk, tv, p);
  return static_cast<int>(cudaGetLastError());
}

// The CTAs of the body at head dim HD an SM of this card holds
// (registers and shared memory), its dynamic shared memory, and the keys
// a K/V tile holds.
template <int HD>
int occupancy(int* ctas, int* smem, int* tile_keys) {
  using K = wgt::FlashCfg<HD>;
  *smem = K::kSmem;
  *tile_keys = K::kTK;
  cudaError_t err = rt::allow_smem(flash_wgmma_kernel<HD>, K::kSmem);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        ctas, flash_wgmma_kernel<HD>, kThreads, K::kSmem);
  return static_cast<int>(err);
}

}  // namespace wg
}  // namespace

// q (B, H, S, hd), k / v (B, KV, S, hd) and out (like q) at the element
// strides q_s*, kv_s* and o_s* of their batch, head and position dims
// (the head dim contiguous); lse (B, H, S) f32, contiguous.  causal 0 or
// 1; window > 0 limits a causal query's lookback and is ignored when not
// causal.
extern "C" int rt_flash_attention(
    const void* q, const void* k, const void* v, void* out, void* lse, int B,
    int H, int KV, int S, int hd, long long q_sb, long long q_sh,
    long long q_ss, long long kv_sb, long long kv_sh, long long kv_ss,
    long long o_sb, long long o_sh, long long o_ss, int causal, int window,
    float scale, int dtype, int body, void* stream) {
  if (S <= 0 || B <= 0) return static_cast<int>(cudaSuccess);
  if (KV <= 0 || H % KV != 0 || hd <= 0 || B > 65535 || KV > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const Layout lay = {{q_sb, q_sh, q_ss}, {kv_sb, kv_sh, kv_ss},
                      {o_sb, o_sh, o_ss}};
  if (!causal) window = 0;
  float* l = static_cast<float*>(lse);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  // 16-byte rows: pointers 16-byte aligned, strides whole 16-byte chunks
  const int vec_elems = dtype == 1 ? 8 : 4;
  long long strides = 0;
  for (const long long sd : {q_sb, q_sh, q_ss, kv_sb, kv_sh, kv_ss, o_sb, o_sh,
                             o_ss})
    strides |= sd % vec_elems;
  const bool aligned = strides == 0 && hd % vec_elems == 0 &&
                       ((reinterpret_cast<uintptr_t>(q) |
                         reinterpret_cast<uintptr_t>(k) |
                         reinterpret_cast<uintptr_t>(v) |
                         reinterpret_cast<uintptr_t>(out)) & 15u) == 0;
  if (body == rt::kBodyWgmma) {
    if (dtype != 1 || !aligned || (hd != 64 && hd != 112 && hd != 128))
      return static_cast<int>(cudaErrorInvalidValue);
    return hd == 64 ? wg::launch<64>(q, k, v, out, l, lay, B, S, H, KV, hd,
                                     causal, window, scale, s)
                    : wg::launch<128>(q, k, v, out, l, lay, B, S, H, KV, hd,
                                      causal, window, scale, s);
  }
  if (body == rt::kBodyMma) {
    if (dtype != 1 || !aligned)
      return static_cast<int>(cudaErrorInvalidValue);
    if (hd == 256)
      return static_cast<int>(mma::launch<256>(q, k, v, out, l, lay, B, S, H,
                                               KV, causal, window, scale, s));
    if (hd % 16 != 0 || hd > 128)
      return static_cast<int>(cudaErrorInvalidValue);
    return static_cast<int>(mma::dispatch<128>(hd, q, k, v, out, l, lay, B, S,
                                               H, KV, causal, window, scale,
                                               s));
  }
  if (body != rt::kBodyCudaCore || hd > core::kMaxHd)
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0)
    return static_cast<int>(launch_core<float>(q, k, v, out, l, lay, B, S, H,
                                               KV, hd, causal, window, scale,
                                               aligned, s));
  if (dtype == 1)
    return static_cast<int>(launch_core<__nv_bfloat16>(
        q, k, v, out, l, lay, B, S, H, KV, hd, causal, window, scale, aligned,
        s));
  return static_cast<int>(cudaErrorInvalidValue);
}

// The CTAs of the wgmma body at head dim hd (64, or 112 and 128, which
// share a body) an SM of this card holds (registers and shared memory),
// into *ctas, its dynamic shared memory, into *smem, and the keys a K/V
// tile holds, into *tile_keys (what kernels/flash_attention.py's
// wgmma_smem_bytes and wgmma_tile_keys mirror; chip_smoke.py holds them
// to these).
extern "C" int rt_flash_wgmma_occupancy(int hd, int* ctas, int* smem,
                                        int* tile_keys) {
  if (hd == 64) return wg::occupancy<64>(ctas, smem, tile_keys);
  if (hd == 112 || hd == 128)
    return wg::occupancy<128>(ctas, smem, tile_keys);
  return static_cast<int>(cudaErrorInvalidValue);
}
