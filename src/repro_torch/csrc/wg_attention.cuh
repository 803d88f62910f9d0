// The consumer side of the port's warp-specialised attention bodies on
// Hopper (wgmma, fed by TMA), shared by the contiguous flash form
// (flash_attention.cu, flash_wgmma_kernel), the cross form
// (paged_cross_attention.cu, cross_wgmma_kernel) and the paged chunk's and
// the window form's body (chunk_wgmma.cu, chunk_wgmma_kernel): the
// shared-memory ring, its barriers, and a consumer warpgroup's walk over
// an item's key tiles (S = Q K^T, the online softmax, O += (P_hi + P_lo)
// V).  Each kernel brings its own producer (which tiles, through which
// tensor maps); the three forms whose key tiles split across a cluster
// share their epilogue (store_rows).
//
// A CTA holds kRows = 128 (query, head-in-group) rows: kC = 2 consumer
// warpgroups of 64 rows (setmaxnreg 240), then one producer warpgroup
// (setmaxnreg 24) one thread of which issues every copy.  Shared tiles
// are bf16 rows of 128 bytes written by TMA with the 128-byte swizzle
// (hopper.cuh); a row of HD values is HD / 64 such halves, each half of
// a tile its own array of 1024-byte atoms:
//
//   form        HD   halves  keys a tile  stages  Q       ring    smem
//   contiguous  64   1       128          3       16 KB   96 KB   115,968
//   contiguous  128  2       64           4       32 KB   128 KB  165,120
//   (contiguous 112 runs the hd-128 body: its tensor maps stop at column
//   112 and TMA fills 112-127 with zeros; flash_attention.cu)
//   cross       64   1       64           4       16 KB   64 KB   83,200
//   cross       128  2       64           4       32 KB   128 KB  165,120
//   chunk       64   1       64           4       16 KB   64 KB   83,200
//   chunk       128  2       64           4       32 KB   128 KB  165,120
//   (chunk: the paged chunk's and the window form's body; hd 112 on the
//   hd-128 body, as the contiguous form's)
//
// hd 64 is the contiguous body as first built, unchanged; hd 128 halves
// the key tile so that a consumer thread holds S (32 f32), P_hi and P_lo
// (32 registers) and O (64 f32) under setmaxnreg 240, and runs four
// stages in the shared memory a block may take (two of 128 keys would
// fit too, at twice the S and P registers).  S at hd 128 steps its eight k16 steps through
// Q's and K's first half, then their second; P V issues one m64n128k16 a
// k16 step (and P part) over V's two halves, the descriptor's LBO the
// bytes from one half to the next (one m64n64k16 a half measured the
// same, PERF.md).
//
// The walk over an item's tiles (Consumer::run): the tiles some row of
// the warpgroup may see are one run; the first's S alone, then each
// tile's S goes out beside the previous tile's PV and the tile's softmax
// runs while the tensor cores finish that PV; then the last PV.  A tile
// no row may see is only waited for and released, before the run and
// after it.  The two warpgroups take turns issuing (turn[wgi], one
// arrival a warp of the one before), a turn for every key tile and one
// for an item's last PV, skipped tiles included, so both count the same
// turns.  The mask is applied only on tiles the caller says are masked;
// masked scores are -1e30 (the reference's NEG_INF).
#pragma once

#include <cooperative_groups.h>

#include <cstdint>

#include "common.cuh"
#include "hopper.cuh"

namespace wgt {

constexpr int kC = 2;                      // consumer warpgroups
constexpr int kRows = 64 * kC;             // (query, head-in-group) rows
constexpr int kThreads = 128 * (kC + 1);
constexpr int kConsumerRegs = 240;
constexpr int kProducerRegs = 24;
constexpr int kAtomRow = 128;              // a swizzled row: 64 bf16
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kMaxSplits = 8;              // a portable cluster
static_assert(kC * 128 * kConsumerRegs + 128 * kProducerRegs <= 65536,
              "the warpgroups' registers fit the SM");

// Slots a TMA box of a paged body's key tile holds (the cross form's and
// the chunk forms'): the whole tile of tk slots where no tile straddles a
// block (bs a multiple of tk, or one block a row), else the largest power
// of two dividing bs and tk; 0 below 8 slots (one swizzle atom), which
// the bodies refuse (kernels/flash_attention.py's rules send such pools
// to mma).  tk is a power of two.
inline int pool_segment(int bs, int nb, int tk) {
  if (bs % tk == 0 || nb == 1) return tk;
  int seg = tk;
  while (bs % seg != 0) seg /= 2;
  return seg >= 8 ? seg : 0;
}

// A body's shape: head dim HD, key tiles of TK keys in a ring of STAGES.
template <int HD, int TK, int STAGES>
struct Cfg {
  static_assert(HD == 64 || HD == 128, "the wgmma bodies take hd 64, 128");
  static_assert(TK == 64 || TK == 128, "key tiles of 64 or 128 keys");
  static constexpr int kHd = HD;
  static constexpr int kHalves = HD / 64;
  static constexpr int kTK = TK;                        // keys a tile
  static constexpr int kStages = STAGES;
  static constexpr int kQHalf = kRows * kAtomRow;
  static constexpr int kQBytes = kHalves * kQHalf;
  static constexpr int kTileHalf = kTK * kAtomRow;
  static constexpr int kTileBytes = kHalves * kTileHalf;   // a K or V tile
  // Q, then the stages' K and V tiles (1024-byte aligned), then the
  // barriers; 1024 bytes of slack align the dynamic base
  static constexpr int kBarOffset = kQBytes + 2 * kStages * kTileBytes;
  static constexpr int kSmem = 1024 + kBarOffset + 256;
  static_assert((2 + 3 * kStages + kC) * 8 <= 256, "the barriers fit");
  static_assert(kSmem <= 232448, "a block's shared memory");
};

// The contiguous form's shape (at hd 64 the body as first built).
template <int HD>
using FlashCfg = Cfg<HD, HD == 64 ? 128 : 64, HD == 64 ? 3 : 4>;

// The ring in shared memory: Q's halves, the stages' K and V tiles, and
// the barriers (Q full / empty; K full, V full and K/V empty a stage;
// the consumers' turns).
template <class K>
struct Ring {
  unsigned char* qs;
  unsigned char* ks;      // [kStages][kTileBytes]
  unsigned char* vs;      // [kStages][kTileBytes]
  uint64_t* q_full;
  uint64_t* q_empty;
  uint64_t* k_full;
  uint64_t* v_full;
  uint64_t* kv_empty;
  uint64_t* turn;         // [kC]

  __device__ __forceinline__ explicit Ring(unsigned char* raw) {
    qs = raw + ((1024 - (rt::smem_addr(raw) & 1023)) & 1023);
    ks = qs + K::kQBytes;
    vs = ks + K::kStages * K::kTileBytes;
    q_full = reinterpret_cast<uint64_t*>(qs + K::kBarOffset);
    q_empty = q_full + 1;
    k_full = q_full + 2;
    v_full = k_full + K::kStages;
    kv_empty = v_full + K::kStages;
    turn = kv_empty + K::kStages;
  }

  // thread 0 initialises the barriers; the block then synchronises
  __device__ __forceinline__ void init() const {
    if (threadIdx.x == 0) {
      hop::mbar_init(q_full, 1);
      hop::mbar_init(q_empty, 4 * kC);      // lane 0 of each consumer warp
      for (int s = 0; s < K::kStages; ++s) {
        hop::mbar_init(&k_full[s], 1);
        hop::mbar_init(&v_full[s], 1);
        hop::mbar_init(&kv_empty[s], 4 * kC);
      }
      for (int c = 0; c < kC; ++c) hop::mbar_init(&turn[c], 4);
      hop::fence_barrier_init();
    }
    __syncthreads();
  }
};

// A consumer thread of warpgroup wgi: its share of the item's 64 rows
// (ra = 16 warp + grp and ra + 8 of the warpgroup's, accumulator layout
// of hopper.cuh), the score and P registers, and its place in the ring.
template <class K>
struct Consumer {
  static constexpr int HD = K::kHd;
  static constexpr int kTK = K::kTK;
  static constexpr int kN = kTK / 8;        // n8 column tiles of S
  static constexpr int kK16 = kTK / 16;     // k16 steps of P V

  const Ring<K>& r;
  int wgi, lane, tig;
  int ra;                        // this thread's first row of the CTA's
  uint32_t q_addr, k_addr, v_addr;
  uint32_t takes = 0;            // turns taken
  int n = 0;                     // K / V tiles consumed: the ring's place
  float sc[4 * kN];              // S, then P in f32, of the newest tile
  uint32_t ph[kK16][4], pl[kK16][4];   // P_hi, P_lo of the tile PV runs on
  // the item's rows: O (columns 8 d + 2 tig + e % 2 at 4 d + e), and the
  // running max (log2 domain) and this thread's columns' share of l
  float o[HD / 2];
  float m_a, m_b, l_a, l_b;

  __device__ __forceinline__ Consumer(const Ring<K>& ring, int wg)
      : r(ring), wgi(wg) {
    const int tid = threadIdx.x & 127;
    lane = tid & 31;
    tig = lane & 3;
    ra = 64 * wgi + 16 * (tid >> 5) + (lane >> 2);
    q_addr = rt::smem_addr(r.qs) + 64 * wgi * kAtomRow;
    k_addr = rt::smem_addr(r.ks);
    v_addr = rt::smem_addr(r.vs);
#pragma unroll
    for (int i = 0; i < 4 * kN; ++i) sc[i] = 0.f;
#pragma unroll
    for (int s2 = 0; s2 < kK16; ++s2)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        ph[s2][e] = 0u;
        pl[s2][e] = 0u;
      }
    if (wgi == kC - 1) pass();               // warpgroup 0 goes first
  }

  __device__ __forceinline__ void take() {
    hop::mbar_wait(&r.turn[wgi], takes & 1);
    ++takes;
  }
  __device__ __forceinline__ void pass() const {
    if (lane == 0) hop::mbar_arrive(&r.turn[(wgi + 1) % kC]);
  }

  __device__ __forceinline__ void start_item() {
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) o[i] = 0.f;
    m_a = m_b = rt::kNegInf;
    l_a = l_b = 0.f;
  }

  // a tile the warpgroup skips: its turn, then wait for its copies (so
  // no arrival runs a round ahead) and release it
  __device__ __forceinline__ void skip() {
    take();
    pass();
    const int s = n % K::kStages;
    hop::mbar_wait(&r.k_full[s], (n / K::kStages) & 1);
    hop::mbar_wait(&r.v_full[s], (n / K::kStages) & 1);
    if (lane == 0) hop::mbar_arrive(&r.kv_empty[s]);
  }

  // S = Q K^T of stage s: HD / 16 k16 steps, through the halves in turn
  __device__ __forceinline__ void issue_s(int s) {
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      const int h = kk / 4;
      const uint64_t dq =
          hop::desc_sw128(q_addr + h * K::kQHalf + 32 * (kk % 4));
      const uint64_t dk = hop::desc_sw128(
          k_addr + s * K::kTileBytes + h * K::kTileHalf + 32 * (kk % 4));
      if constexpr (kTK == 128)
        hop::wgmma_m64n128k16_ss(sc, dq, dk, kk);
      else
        hop::wgmma_m64n64k16_ss(sc, dq, dk, kk);
    }
    hop::wgmma_commit();
  }

  // O += (P_hi + P_lo) V of stage s: V the MN-major B operand, 16 keys
  // (2048 bytes of each half) a k16 step
  __device__ __forceinline__ void issue_pv(int s) {
#pragma unroll
    for (int s2 = 0; s2 < kK16; ++s2) {
      const uint32_t a = v_addr + s * K::kTileBytes + s2 * 16 * kAtomRow;
      if constexpr (HD == 64) {
        const uint64_t dv = hop::desc_sw128(a);
        hop::wgmma_m64n64k16_rs_tb(o, ph[s2], dv);
        hop::wgmma_m64n64k16_rs_tb(o, pl[s2], dv);
      } else {
        const uint64_t dv = hop::desc_sw128(a, K::kTileHalf);
        hop::wgmma_m64n128k16_rs_tb(o, ph[s2], dv);
        hop::wgmma_m64n128k16_rs_tb(o, pl[s2], dv);
      }
    }
    hop::wgmma_commit();
  }

  __device__ __forceinline__ void pin_s() {
#pragma unroll
    for (int i = 0; i < 4 * kN; ++i) hop::pin(sc[i]);
  }
  __device__ __forceinline__ void pin_pv() {
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) hop::pin(o[i]);
#pragma unroll
    for (int s2 = 0; s2 < kK16; ++s2)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        hop::pin(ph[s2][e]);
        hop::pin(pl[s2][e]);
      }
  }

  // The tile at key k0: S in the log2 domain, the mask where `masked`
  // (hidden(key, second) names the keys row ra, or ra + 8 when second,
  // may not see; else the scale folded into exp2's FMA), the online
  // softmax; sc becomes P, and O's rows owe al_a / al_b.
  template <class Hidden>
  __device__ __forceinline__ void softmax(int k0, bool masked, float sl,
                                          Hidden hidden, float& al_a,
                                          float& al_b) {
    float mx_a = rt::kNegInf, mx_b = rt::kNegInf;
    if (masked) {
#pragma unroll
      for (int jn = 0; jn < kN; ++jn)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = k0 + 8 * jn + 2 * tig + (e & 1);
          float x = sc[4 * jn + e] * sl;
          if (hidden(key, e >= 2)) x = rt::kNegInf;
          sc[4 * jn + e] = x;
          if (e < 2) mx_a = fmaxf(mx_a, x); else mx_b = fmaxf(mx_b, x);
        }
    } else {
#pragma unroll
      for (int jn = 0; jn < kN; ++jn) {
        mx_a = fmaxf(mx_a, fmaxf(sc[4 * jn], sc[4 * jn + 1]));
        mx_b = fmaxf(mx_b, fmaxf(sc[4 * jn + 2], sc[4 * jn + 3]));
      }
      mx_a *= sl;   // sl > 0: the max of the scaled scores
      mx_b *= sl;
    }
#pragma unroll
    for (int o2 = 1; o2 < 4; o2 <<= 1) {
      mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, o2));
      mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, o2));
    }
    const float mn_a = fmaxf(m_a, mx_a);
    const float mn_b = fmaxf(m_b, mx_b);
    al_a = hop::exp2_ftz(m_a - mn_a);
    al_b = hop::exp2_ftz(m_b - mn_b);
    m_a = mn_a;
    m_b = mn_b;
    const float f = masked ? 1.f : sl;
    float sum_a = 0.f, sum_b = 0.f;
#pragma unroll
    for (int jn = 0; jn < kN; ++jn) {
      sc[4 * jn] = hop::exp2_ftz(fmaf(sc[4 * jn], f, -mn_a));
      sc[4 * jn + 1] = hop::exp2_ftz(fmaf(sc[4 * jn + 1], f, -mn_a));
      sc[4 * jn + 2] = hop::exp2_ftz(fmaf(sc[4 * jn + 2], f, -mn_b));
      sc[4 * jn + 3] = hop::exp2_ftz(fmaf(sc[4 * jn + 3], f, -mn_b));
      sum_a += sc[4 * jn] + sc[4 * jn + 1];
      sum_b += sc[4 * jn + 2] + sc[4 * jn + 3];
    }
    l_a = l_a * al_a + sum_a;
    l_b = l_b * al_b + sum_b;
  }

  // P = P_hi + P_lo as the A fragments of the k16 steps of keys
  __device__ __forceinline__ void split() {
#pragma unroll
    for (int s2 = 0; s2 < kK16; ++s2) {
      rt::split_bf16(sc[8 * s2], sc[8 * s2 + 1], ph[s2][0], pl[s2][0]);
      rt::split_bf16(sc[8 * s2 + 2], sc[8 * s2 + 3], ph[s2][1], pl[s2][1]);
      rt::split_bf16(sc[8 * s2 + 4], sc[8 * s2 + 5], ph[s2][2], pl[s2][2]);
      rt::split_bf16(sc[8 * s2 + 6], sc[8 * s2 + 7], ph[s2][3], pl[s2][3]);
    }
  }

  __device__ __forceinline__ void rescale(float al_a, float al_b) {
#pragma unroll
    for (int d = 0; d < HD / 8; ++d) {
      o[4 * d] *= al_a;
      o[4 * d + 1] *= al_a;
      o[4 * d + 2] *= al_b;
      o[4 * d + 3] *= al_b;
    }
  }

  // The item's key tiles t_lo .. t_hi (the ring's next ones): seen(t)
  // says some row of the warpgroup may see a key of tile t (the seen
  // tiles are one run), masked(k0) that some row may not see some key of
  // the tile at k0, hidden(key, second) which.  Leaves O, m and l of the
  // rows (l summed across the quad).
  template <class Seen, class Masked, class Hidden>
  __device__ __forceinline__ void run(int t_lo, int t_hi, float sl,
                                      Seen seen, Masked masked,
                                      Hidden hidden) {
    int t = t_lo;
    for (; t <= t_hi && !seen(t); ++t, ++n) skip();
    if (t <= t_hi) {
      int s = n % K::kStages;
      hop::mbar_wait(&r.k_full[s], (n / K::kStages) & 1);
      take();
      hop::wgmma_fence();
      issue_s(s);
      pass();
      hop::wgmma_wait<0>();
      pin_s();
      float al_a, al_b;
      softmax(t * kTK, masked(t * kTK), sl, hidden, al_a, al_b);  // O is 0
      split();
      int prev = s, prev_n = n;
      for (++t, ++n; t <= t_hi && seen(t); ++t, ++n) {
        s = n % K::kStages;
        hop::mbar_wait(&r.k_full[s], (n / K::kStages) & 1);
        hop::mbar_wait(&r.v_full[prev], (prev_n / K::kStages) & 1);
        take();
        hop::wgmma_fence();
        issue_s(s);
        issue_pv(prev);
        pass();
        hop::wgmma_wait<1>();                // S is in, PV may run on
        pin_s();
        softmax(t * kTK, masked(t * kTK), sl, hidden, al_a, al_b);
        hop::wgmma_wait<0>();
        pin_pv();
        if (lane == 0) hop::mbar_arrive(&r.kv_empty[prev]);
        rescale(al_a, al_b);
        split();
        prev = s;
        prev_n = n;
      }
      hop::mbar_wait(&r.v_full[prev], (prev_n / K::kStages) & 1);
      take();
      hop::wgmma_fence();
      issue_pv(prev);
      pass();
      hop::wgmma_wait<0>();
      pin_pv();
      if (lane == 0) hop::mbar_arrive(&r.kv_empty[prev]);
    } else {
      take();                                // the last PV's turn
      pass();
    }
    for (; t <= t_hi; ++t, ++n) skip();
#pragma unroll
    for (int o2 = 1; o2 < 4; o2 <<= 1) {
      l_a += __shfl_xor_sync(0xffffffffu, l_a, o2);
      l_b += __shfl_xor_sync(0xffffffffu, l_b, o2);
    }
  }
};

// The epilogue of a body whose item's key tiles may be split across a
// cluster of `splits` CTAs (this CTA its `split`-th; 1: no cluster):
// rows [0, rows) of the consumers' O, m and l into the output, row_out(r)
// the first of row r's `cols` columns (cols <= HD: columns the maps
// zero-filled past it are not stored).  Unsplit, each thread divides its
// own rows by l in f32, rounds once and stores pairs.  Split, both
// consumer warpgroups first finish with the ring (a named barrier of
// their 256 threads; every copy has landed, since each waited for every
// tile), and the CTA's partial rows (O, then m and l) go into its K/V
// ring; after a cluster barrier every CTA merges a share of the tile's
// rows x cols outputs, four columns at a time, over the cluster's
// partials in split order, read through distributed shared memory (each
// unit's reads of every split go out together, so a unit waits for
// distributed shared memory once), divides by l and rounds once; a
// second barrier keeps each partial alive until its readers are done.
// The producer warpgroup meets the two cluster barriers itself.
template <class K, class RowOut>
__device__ __forceinline__ void store_rows(const Consumer<K>& c,
                                           const Ring<K>& ring, int rows,
                                           int cols, int split, int splits,
                                           RowOut row_out) {
  constexpr int HD = K::kHd;
  constexpr int kPRow = HD + 4;   // a partial row: O, m, l (16-byte rows)
  static_assert(kRows * kPRow * 4 <= 2 * K::kStages * K::kTileBytes,
                "the partial fits the K/V ring");
  if (splits == 1) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int rho = c.ra + 8 * half;
      if (rho >= rows) continue;
      const float l = fmaxf(half ? c.l_b : c.l_a, 1e-30f);
      __nv_bfloat16* dst = row_out(rho) + 2 * c.tig;
#pragma unroll
      for (int d = 0; d < HD / 8; ++d)
        if (8 * d < cols)
          *reinterpret_cast<__nv_bfloat162*>(dst + 8 * d) =
              __floats2bfloat162_rn(c.o[4 * d + 2 * half] / l,
                                    c.o[4 * d + 2 * half + 1] / l);
    }
    return;
  }
  asm volatile("bar.sync 1, %0;\n" :: "n"(128 * kC) : "memory");
  float* cpart = reinterpret_cast<float*>(ring.ks);
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    float* row = cpart + (c.ra + 8 * half) * kPRow;
#pragma unroll
    for (int d = 0; d < HD / 8; ++d)
      *reinterpret_cast<float2*>(row + 8 * d + 2 * c.tig) =
          make_float2(c.o[4 * d + 2 * half], c.o[4 * d + 2 * half + 1]);
    if (c.tig == 0) {
      row[HD] = half ? c.m_b : c.m_a;
      row[HD + 1] = half ? c.l_b : c.l_a;
    }
  }
  cooperative_groups::cluster_group cluster =
      cooperative_groups::this_cluster();
  cluster.sync();
  constexpr int kUnits = HD / 4;           // float4 units a row
#pragma unroll 2
  for (int u = split * 128 * kC + threadIdx.x; u < rows * kUnits;
       u += splits * 128 * kC) {
    const int r = u / kUnits;
    const int d = (u - r * kUnits) * 4;
    if (d >= cols) continue;
    float2 ml[kMaxSplits];
    float4 po[kMaxSplits];
#pragma unroll
    for (int sp = 0; sp < kMaxSplits; ++sp)
      if (sp < splits) {
        const float* row = cluster.map_shared_rank(cpart, sp) + r * kPRow;
        ml[sp] = *reinterpret_cast<const float2*>(row + HD);
        po[sp] = *reinterpret_cast<const float4*>(row + d);
      }
    float mx = rt::kNegInf;
#pragma unroll
    for (int sp = 0; sp < kMaxSplits; ++sp)
      if (sp < splits) mx = fmaxf(mx, ml[sp].x);
    float l = 0.f;
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int sp = 0; sp < kMaxSplits; ++sp)
      if (sp < splits) {
        const float a = exp2f(ml[sp].x - mx);
        l += ml[sp].y * a;
        acc.x += po[sp].x * a;
        acc.y += po[sp].y * a;
        acc.z += po[sp].z * a;
        acc.w += po[sp].w * a;
      }
    l = fmaxf(l, 1e-30f);
    __nv_bfloat162* dst = reinterpret_cast<__nv_bfloat162*>(row_out(r) + d);
    dst[0] = __floats2bfloat162_rn(acc.x / l, acc.y / l);
    dst[1] = __floats2bfloat162_rn(acc.z / l, acc.w / l);
  }
  cluster.sync();               // each partial lives until its readers end
}

}  // namespace wgt
