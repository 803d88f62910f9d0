// The wgmma body of the weight-only int8 / int4 dequantize-matmul (bf16):
// out (M, N) = x (M, K) @ dequant(q, s), entered from
// rt_quant_matmul_int8 / rt_quant_matmul_int4 (quant_matmul.cu) where the
// wrappers' rules (kernels/quant_matmul.py::int8_body, int4_body) name
// "wgmma".  Replaces quant_matmul_pallas
// (src/repro/kernels/quant_matmul.py:54, bodies _qmm_int8_kernel and
// _qmm_int4_kernel) as the mma body does, with the same arithmetic: the
// weights as exact bf16 integers, products exact in f32, int8's scale
// once after the sum over K, int4's scale groups summed apart in f32 and
// added times s[g, n] (never (nibble - 8) * s rounded to bf16); only the
// order of the f32 sums differs from the plain version.
//
// Bound on the H100: bytes at decode (M = 8: qwen2-72b's MLP moves 121 MB
// of int4 or 242 MB of int8 weights for 2 * 8 flops a weight), operations
// at qwen2-72b's int4 prefill chunk (M = 128: 62.0 GFLOP take 0.0627 ms
// at 989 TFLOP/s, the 145.9 MB 0.0436 ms at 3.35 TB/s).  The mma body
// (quant_matmul.cu) reached neither: its warps both issue the 16-byte
// cp.async copies and compute, each stage of 2 KB (int4) or 4 KB (int8)
// pays address arithmetic, a whole-CTA barrier and one 16-bit shared load
// a packed row, few bytes are in flight an SM, and mma.sync is Ampere's.
//
// The design (one producer warp, two consumer warpgroups; kThreads 288):
// * The product is out^T = W^T x^T: a CTA owns kTileN = 128 output
//   columns, 64 a consumer warpgroup (wgmma's M side), and 8 MT rows of x
//   (wgmma's N side: n8 at decode, n128 at a chunk), ragged M zero-filled
//   by TMA and masked at the store, more rows tiled on the grid.
// * The producer's lane 0 issues every copy by TMA into a ring of
//   kStages stages of 64 k, each with a full / empty mbarrier pair: the
//   weight tile (int8 64 rows of q (K, N), int4 32 packed rows, 128 bytes
//   of columns, 128-byte swizzle), x's tile (rows x 64 k, bf16, 128-byte
//   swizzle: the K-major B layout of hopper.cuh) and int4's scale rows (a
//   stage's one row at G 64, else the row of each k16 step).  The
//   descriptors are prefetched at the start.
//   The stages come from a shared-memory budget (Cfg): at decode a CTA
//   holds 11 to 15 stages and keeps 48 to 88 KB of weight in flight,
//   where the mma body kept 6 KB (int4) or 12 KB (int8); two CTAs an SM
//   at n8 and n16, one above.
// * Consumers read a warp's 16 columns of a stage's weight rows with
//   ldmatrix.trans on the bytes as b16: int8 two x4 loads, int4 one x4
//   whose row addresses interleave packed rows t and t + 4, so that each
//   32-bit word holds the bytes of the thread's two columns at the k
//   pairs its m16n8k16 A fragment takes (the warp's rows grp and grp + 8
//   are output columns 2 grp and 2 grp + 1 of its 16).  The words become
//   the exact bf16 integers in registers: int8 by masking each byte's low
//   seven bits into the mantissa of 128 and subtracting 128 or 256 by its
//   sign bit; int4 by pairing each byte's nibbles in the mantissa of 128
//   and subtracting 136.  That register A fragment, four k16 steps a
//   stage, feeds wgmma.mma_async m64nNk16 with B (x) from shared memory;
//   the fragments are double-buffered, so a stage's products run while
//   the next stage is dequantised, and a stage is released (its empty
//   barrier) once its products are done.
// * No branch touches a wgmma or its registers: one would make ptxas
//   serialise every wgmma (its C7520 warning), which doubles qwen2-72b's
//   int4 decode against the TMA stream alone (PERF.md).  The warpgroup
//   index is
//   made warp-uniform by a shuffle, every stage issues its four k16 steps
//   (TMA zero-fills rows past K), and the loop takes stages in pairs with
//   the A buffer fixed at compile time, a slice of odd length ending on a
//   pad stage that loads nothing: zero A fragments (selected) against
//   the x tile its slot last held, or zeros written at the start where
//   the slot was never loaded.
// * int4 at G 64 (every served site: a stage is a group): up to n64 each
//   stage sums into the stage accumulator of its parity (its first step
//   overwrites), so the two take turns, and once a stage's products are
//   done, beside the next stage's wgmma, it is added to the output times
//   s[g, n]; at n128 two accumulators and two A buffers do not fit
//   beside the output's registers, so one stage accumulator is scaled in
//   after its products are done, the next stage's weight words already
//   read, before that stage is dequantised and issued (while the other
//   warpgroup's products run).  Other groups (G 16 .. 48, 128, ...) sum into one
//   accumulator folded as each group ends, its wgmmas serialised (no
//   served site takes that path).
// * Filling the card: where output tiles are fewer than the card holds,
//   K is split across a thread-block cluster of `splits` CTAs
//   (kernels/quant_matmul.py::wgmma_splits, from M, K and N alone), each
//   a run of whole stages; the slices' f32 partial tiles are summed in
//   split order through distributed shared memory (int8 then scales), as
//   the mma body does, so the result does not depend on timing.
//
// Conditions (the rule mirrors them; the entry refuses the rest): bf16;
// K % 16 == 0 and N % 16 == 0 (16-byte tensor-map strides, whole k16
// steps); x, q and (int4) s 16-byte aligned; int4 G % 16 == 0 and
// K % G == 0;
// N / 128 tiles within a grid dimension; a split of whole stages within
// one portable cluster.
#include <cooperative_groups.h>

#include <cstdint>
#include <type_traits>

#include "common.cuh"
#include "hopper.cuh"

namespace {

constexpr int kC = 2;                     // consumer warpgroups
constexpr int kThreads = 128 * kC + 32;   // and one producer warp
constexpr int kTileN = 64 * kC;           // output columns a CTA
constexpr int kTileK = 64;                // K a stage
constexpr int kSteps = kTileK / 16;       // k16 steps a stage
constexpr int kMaxSplits = 8;             // a portable cluster
constexpr int kMaxStages = 16;
// CTAs an SM at wgmma N 8 and 16 (tools/torch_split_sweep.py --quant
// builds the body with another count to time it against this one)
#ifndef RT_QW_SMALL_CTAS
#define RT_QW_SMALL_CTAS 2
#endif

// A body's shape: MT n8 tiles of x rows (wgmma N = 8 MT), the format.
template <int MT, bool kInt4>
struct Cfg {
  static_assert(MT == 1 || MT == 2 || MT == 4 || MT == 8 || MT == 16,
                "wgmma N of 8, 16, 32, 64 or 128");
  static constexpr int kRowsM = 8 * MT;
  static constexpr int kAcc = 4 * MT;                 // f32 a thread
  static constexpr int kCtasPerSm = MT <= 2 ? RT_QW_SMALL_CTAS : 1;
  static constexpr int kWRows = kInt4 ? kTileK / 2 : kTileK;
  static constexpr int kWBytes = kWRows * kTileN;     // 128-byte rows
  static constexpr int kXBytes = kRowsM * 128;        // 64 bf16 a row
  static constexpr int kSBytes = kInt4 ? kSteps * kTileN * 4 : 0;
  static constexpr int kStageBytes = kWBytes + kXBytes + kSBytes;
  static constexpr int kBudget = kCtasPerSm == 2 ? 110 * 1024 : 220 * 1024;
  static constexpr int kStages = kBudget / kStageBytes < kMaxStages
                                     ? kBudget / kStageBytes : kMaxStages;
  static constexpr int kBarOffset = kStages * kStageBytes;
  // 1024 bytes of slack align the dynamic base; then the ring, then the
  // full and empty barriers
  static constexpr int kSmem = 1024 + kBarOffset + 2 * kMaxStages * 8;
  static constexpr int kPRow = kTileN + 4;            // a partial row, f32
  static_assert(kStageBytes % 1024 == 0, "1024-byte aligned tiles");
  static_assert(kRowsM * kPRow * 4 <= kBarOffset, "the partial fits");
  static_assert(kCtasPerSm * (kSmem + 1024) <= 233472, "the SM's memory");
};

struct Params {
  const float* s;               // int8 (1, N): the scale after the sum
  __nv_bfloat16* out;           // (M, N)
  int M, K, N, G;               // G: int4's group (0 for int8)
  int stages;                   // K stages of the whole product
  int per_split;                // stages a split (the last may take fewer)
};

// int8: the bf16 pair of the signed bytes 0 and 2 of v (exact): the low
// seven bits in the mantissa of 128 (bf16 128 + v), less 128, or 256
// where the sign bit is set (its bit lands on the exponent's lowest).
__device__ __forceinline__ uint32_t i8pair(uint32_t v) {
  const uint32_t lo = (v & 0x007F007Fu) | 0x43004300u;
  const uint32_t sg = (v & 0x00800080u) | 0x43004300u;
  const __nv_bfloat162 r =
      __hsub2(*reinterpret_cast<const __nv_bfloat162*>(&lo),
              *reinterpret_cast<const __nv_bfloat162*>(&sg));
  return rt::bf162_bits(r);
}

// int4: the bf16 pair (low nibble - 8, high nibble - 8) of byte i of v
// (hi4 = v >> 4): both nibbles in the mantissa of 128, less 136 (exact).
template <int I>
__device__ __forceinline__ uint32_t i4pair(uint32_t v, uint32_t hi4) {
  const uint32_t p = __byte_perm(v, hi4, I | ((4 + I) << 8));
  const uint32_t b = (p & 0x000F000Fu) | 0x43004300u;
  const __nv_bfloat162 r =
      __hsub2(*reinterpret_cast<const __nv_bfloat162*>(&b),
              __floats2bfloat162_rn(136.f, 136.f));
  return rt::bf162_bits(r);
}

// The formats' code paths: int8; int4 at groups of 64 (a stage a group;
// every served site), both pipelined with no branch around a wgmma;
// int4 at other groups, folded as each group ends (its wgmmas serialised).
constexpr int kInt8 = 0;
constexpr int kInt4G64 = 1;
constexpr int kInt4Any = 2;

template <int MT, bool kInt4>
struct Consumer {
  using C = Cfg<MT, kInt4>;
  static constexpr int kAcc = C::kAcc;
  float acc[kAcc];
  float part[kInt4 ? 2 : 1][kAcc];   // int4: a stage's sums, by parity
  uint32_t a[2][kSteps][4];          // the A fragments, double-buffered
  uint32_t w_off[2];                 // this lane's ldmatrix rows
  int col;                           // this thread's first column, of 128
  int lane;

  __device__ __forceinline__ void init(int wgi) {
    const int tid = threadIdx.x & 127;
    const int warp = tid >> 5;
    lane = tid & 31;
    const int chunk = 4 * wgi + warp;   // the warp's 16 columns
    col = 16 * chunk + 2 * (lane >> 2);
    if constexpr (kInt4) {
      // matrix i = k16 step i; its row j is packed row 8 i + j / 2 + 4 (j
      // & 1), so a thread's word holds packed rows tig and tig + 4
      const int j = lane & 7;
      const int r = 8 * (lane >> 3) + (j >> 1) + 4 * (j & 1);
      w_off[0] = w_off[1] = r * 128 + ((chunk ^ (r & 7)) << 4);
    } else {
      // x4 h covers k16 steps 2 h and 2 h + 1: lane l gives row 32 h + l
#pragma unroll
      for (int h = 0; h < 2; ++h)
        w_off[h] = (32 * h + lane) * 128 + ((chunk ^ (lane & 7)) << 4);
    }
#pragma unroll
    for (int i = 0; i < kAcc; ++i) {
      acc[i] = 0.f;
      part[0][i] = 0.f;
      if constexpr (kInt4) part[1][i] = 0.f;
    }
  }

  // A stage's weight words: int4 one ldmatrix x4 (word kk: k16 step kk),
  // int8 two (v[h][2 j]: rows k, k + 1 of step 2 h + j, k = 16 (2 h + j)
  // + 2 tig; v[h][2 j + 1]: rows k + 8, k + 9).
  static constexpr int kLdsm = kInt4 ? 1 : 2;
  __device__ __forceinline__ void ldsm(uint32_t (&v)[kLdsm][4],
                                       const unsigned char* w) const {
#pragma unroll
    for (int h = 0; h < kLdsm; ++h) rt::ldmatrix_x4_trans(v[h], w + w_off[h]);
  }

  // The words into the exact bf16 A fragments a[P].
  template <int P>
  __device__ __forceinline__ void convert(const uint32_t (&v)[kLdsm][4]) {
#pragma unroll
    for (int kk = 0; kk < kSteps; ++kk) {
      if constexpr (kInt4) {
        const uint32_t w = v[0][kk];
        const uint32_t hi4 = w >> 4;
        a[P][kk][0] = i4pair<0>(w, hi4);
        a[P][kk][1] = i4pair<1>(w, hi4);
        a[P][kk][2] = i4pair<2>(w, hi4);
        a[P][kk][3] = i4pair<3>(w, hi4);
      } else {
        const uint32_t lo = v[kk / 2][2 * (kk % 2)];
        const uint32_t hi = v[kk / 2][2 * (kk % 2) + 1];
        a[P][kk][0] = i8pair(lo);
        a[P][kk][1] = i8pair(lo >> 8);
        a[P][kk][2] = i8pair(hi);
        a[P][kk][3] = i8pair(hi >> 8);
      }
    }
  }

  template <int P>
  __device__ __forceinline__ void dequant(const unsigned char* w) {
    uint32_t v[kLdsm][4];
    ldsm(v, w);
    convert<P>(v);
  }

  template <int P>
  __device__ __forceinline__ void pin_a() {
#pragma unroll
    for (int kk = 0; kk < kSteps; ++kk)
#pragma unroll
      for (int e = 0; e < 4; ++e) hop::pin(a[P][kk][e]);
  }

  template <class D>
  __device__ __forceinline__ void pin_d(D& d) {
#pragma unroll
    for (int i = 0; i < kAcc; ++i) hop::pin(d[i]);
  }

  // A fragments of zeros where `zero` (the pad stage), by selects: a
  // branch would serialise the wgmmas.
  template <int P>
  __device__ __forceinline__ void zero_a(bool zero) {
#pragma unroll
    for (int kk = 0; kk < kSteps; ++kk)
#pragma unroll
      for (int e = 0; e < 4; ++e) a[P][kk][e] = zero ? 0u : a[P][kk][e];
  }

  // int4: acc += s[column] * d over the thread's two columns (sc: the
  // group's scale row), or nothing where `skip` (the pad stage, whose
  // scale row was never loaded), by a select
  __device__ __forceinline__ void fold(const float (&d)[kAcc],
                                      const float* sc, bool skip = false) {
    const float2 s2 = *reinterpret_cast<const float2*>(sc + col);
    const float sx = skip ? 0.f : s2.x;
    const float sy = skip ? 0.f : s2.y;
#pragma unroll
    for (int i = 0; i < kAcc; ++i)
      acc[i] = fmaf((i & 2) ? sy : sx, d[i], acc[i]);
  }
};

template <int MT, int kFmt>
__global__ void __launch_bounds__(kThreads, Cfg<MT, kFmt != kInt8>::kCtasPerSm)
quant_wgmma_kernel(const __grid_constant__ CUtensorMap tw,
                   const __grid_constant__ CUtensorMap tx,
                   const __grid_constant__ CUtensorMap ts, const Params p) {
  constexpr bool kInt4 = kFmt != kInt8;
  using C = Cfg<MT, kInt4>;
  constexpr int kStages = C::kStages;
  constexpr int kN = C::kRowsM;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* ring =
      smem_raw + ((1024 - (rt::smem_addr(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + C::kBarOffset);
  uint64_t* empty = full + kStages;
  const int m0 = blockIdx.x * kN;
  const int n0 = blockIdx.y * kTileN;
  const int split = blockIdx.z;
  const int splits = gridDim.z;
  const int st0 = split * p.per_split;
  const int nst = min(st0 + p.per_split, p.stages) - st0;
  // The pipelined paths take stages in pairs, so that the A buffer of
  // each is fixed at compile time; an odd slice ends with a pad stage
  // that loads nothing: its A fragments are zeros (selected), and its B
  // the x tile its slot last held, or zeros where the slot was never
  // loaded (written here), so its products are exactly 0.
  const int nst_pad = nst + (nst & 1);
  const int kend = min((st0 + nst) * kTileK, p.K);
  if (threadIdx.x == 128 * kC) {
    hop::prefetch_tensormap(&tw);
    hop::prefetch_tensormap(&tx);
    if constexpr (kFmt != kInt8) hop::prefetch_tensormap(&ts);
  }
  constexpr bool kPaired = kFmt == kInt8 || (kFmt == kInt4G64 && MT < 16);
  if (kPaired && nst < nst_pad && nst < kStages) {
    uint4* xz = reinterpret_cast<uint4*>(ring + nst * C::kStageBytes +
                                         C::kWBytes);
    for (int e = threadIdx.x; e < C::kXBytes / 16; e += kThreads)
      xz[e] = make_uint4(0u, 0u, 0u, 0u);
    hop::fence_proxy_async();        // wgmma reads it through the async proxy
  }
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      hop::mbar_init(&full[s], 1);
      hop::mbar_init(&empty[s], 4 * kC);   // lane 0 of each consumer warp
    }
    hop::fence_barrier_init();
  }
  __syncthreads();
  // warp-uniform, as the compiler sees it (a lane's own index is not)
  const int wgi = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);

  if (wgi == kC) {
    // the producer: lane 0 issues every copy, a stage at a time
    if (threadIdx.x == 128 * kC) {
      const int s_bytes =
          kFmt == kInt4G64 ? kTileN * 4 : kFmt == kInt4Any ? C::kSBytes : 0;
      for (int i = 0; i < nst; ++i) {
        const int s = i % kStages;
        if (i >= kStages) hop::mbar_wait(&empty[s], (i / kStages - 1) & 1);
        unsigned char* st = ring + s * C::kStageBytes;
        const int k0 = (st0 + i) * kTileK;
        hop::mbar_expect_tx(&full[s], C::kWBytes + C::kXBytes + s_bytes);
        hop::tma_load_2d(st, &tw, &full[s], n0, kInt4 ? k0 / 2 : k0);
        hop::tma_load_2d(st + C::kWBytes, &tx, &full[s], k0, m0);
        unsigned char* sd = st + C::kWBytes + C::kXBytes;
        if constexpr (kFmt == kInt4G64) {
          hop::tma_load_2d(sd, &ts, &full[s], n0, k0 / 64);
        } else if constexpr (kFmt == kInt4Any) {
          for (int j = 0; j < kSteps; ++j)
            hop::tma_load_2d(sd + j * kTileN * 4, &ts, &full[s], n0,
                             (k0 + 16 * j) / p.G);
        }
      }
    }
    if (splits > 1) {              // the consumers' two cluster barriers
      cooperative_groups::this_cluster().sync();
      cooperative_groups::this_cluster().sync();
    }
    return;
  }

  Consumer<MT, kInt4> c;
  c.init(wgi);
  auto slot = [&](int i) { return ring + (i % kStages) * C::kStageBytes; };
  auto scales = [&](int i) {
    return reinterpret_cast<const float*>(slot(i) + C::kWBytes + C::kXBytes);
  };
  auto x_desc = [&](int i, int kk) {
    return hop::desc_sw128(rt::smem_addr(slot(i)) + C::kWBytes + 32 * kk);
  };
  auto release = [&](int i) {
    if (c.lane == 0 && i < nst) hop::mbar_arrive(&empty[i % kStages]);
  };
  using B0 = std::integral_constant<int, 0>;
  using B1 = std::integral_constant<int, 1>;
  using Mid = std::false_type;       // a stage of the loop: never the pad
  using Last = std::true_type;       // the slice's last: the pad if odd
  // Wait for stage i's copies and dequantise it into A buffer P (zeros
  // for the pad).
  auto load = [&](auto buf, auto last, int i) {
    constexpr int P = decltype(buf)::value;
    const bool pad = decltype(last)::value && i >= nst;
    if (!pad) hop::mbar_wait(&full[i % kStages], (i / kStages) & 1);
    c.template dequant<P>(slot(i));
    if constexpr (decltype(last)::value) c.template zero_a<P>(pad);
  };

  if constexpr (kFmt == kInt4Any) {
    // groups that end inside a stage: each group sums into part[0] and is
    // folded as it ends, after its products are done
    const int group_steps = p.G / 16;
    int left = group_steps - (st0 * kTileK % p.G) / 16;
    int fresh = 1;
    for (int i = 0; i < nst; ++i) {
      load(B0(), Mid(), i);
      const int k0 = (st0 + i) * kTileK;
      const int steps = min(kSteps, (kend - k0) / 16);
      hop::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kSteps; ++kk) {
        if (kk < steps) {
          hop::wgmma_rs<kN>(c.part[0], c.a[0][kk], x_desc(i, kk),
                            1 - fresh);
          fresh = 0;
          if (--left == 0 || k0 + 16 * (kk + 1) == kend) {
            left = group_steps;
            hop::wgmma_commit();
            hop::wgmma_wait<0>();
            c.pin_d(c.part[0]);
            c.fold(c.part[0], scales(i) + kk * kTileN);
            fresh = 1;
            hop::wgmma_fence();
          }
        }
      }
      hop::wgmma_commit();
      hop::wgmma_wait<0>();
      c.template pin_a<0>();
      release(i);
    }
  } else if constexpr (kFmt == kInt4G64 && MT == 16) {
    // int4 at n128: one stage accumulator and one A buffer (two of either
    // do not fit the registers beside the output's).  Stage i's words are
    // read while stage i - 1's products run; then, those done, stage i -
    // 1 is scaled into the output and released, and stage i is
    // dequantised and its products issued (the other warpgroup's run
    // meanwhile).
    auto issue = [&](int i) {
      hop::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kSteps; ++kk)
        hop::wgmma_rs<kN>(c.part[0], c.a[0][kk], x_desc(i, kk),
                          kk == 0 ? 0 : 1);
      hop::wgmma_commit();
    };
    uint32_t v[Consumer<MT, kInt4>::kLdsm][4];
    hop::mbar_wait(&full[0], 0);
    c.template dequant<0>(slot(0));
    issue(0);
    for (int i = 1; i < nst; ++i) {
      hop::mbar_wait(&full[i % kStages], (i / kStages) & 1);
      c.ldsm(v, slot(i));
      hop::wgmma_wait<0>();
      c.template pin_a<0>();
      c.pin_d(c.part[0]);
      c.fold(c.part[0], scales(i - 1));
      release(i - 1);
      c.template convert<0>(v);
      issue(i);
    }
    hop::wgmma_wait<0>();
    c.template pin_a<0>();
    c.pin_d(c.part[0]);
    c.fold(c.part[0], scales(nst - 1));
    release(nst - 1);
  } else {
    // int8, and int4 at groups of 64 (a stage a group) up to n64: stage
    // i's products run while stage i + 1 is dequantised into the other A
    // buffer (int4: summed into the other stage accumulator); stage i is
    // retired (int4: scaled into the output) once the wgmmas of stage
    // i + 1 are issued and its own are done
    auto issue = [&](auto buf, auto last, int i) {
      constexpr int P = decltype(buf)::value;
      load(buf, last, i);
      hop::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kSteps; ++kk) {
        if constexpr (kInt4)
          hop::wgmma_rs<kN>(c.part[P], c.a[P][kk], x_desc(i, kk),
                            kk == 0 ? 0 : 1);
        else
          hop::wgmma_rs<kN>(c.acc, c.a[P][kk], x_desc(i, kk), 1);
      }
      hop::wgmma_commit();
    };
    auto retire = [&](auto buf, int i) {
      constexpr int P = decltype(buf)::value;
      c.template pin_a<P>();
      if constexpr (kInt4) {
        c.pin_d(c.part[P]);
        c.fold(c.part[P], scales(i), i >= nst);
      }
      release(i);
    };
    issue(B0(), Mid(), 0);
    int i = 1;
    for (; i + 1 < nst_pad; i += 2) {
      issue(B1(), Mid(), i);
      hop::wgmma_wait<1>();
      retire(B0(), i - 1);
      issue(B0(), Mid(), i + 1);
      hop::wgmma_wait<1>();
      retire(B1(), i);
    }
    issue(B1(), Last(), i);          // nst_pad is even: i = nst_pad - 1
    hop::wgmma_wait<1>();
    retire(B0(), i - 1);
    hop::wgmma_wait<0>();
    retire(B1(), i);
  }
  c.pin_d(c.acc);

  // Accumulator element 4 j + e: x row m0 + 8 j + 2 tig + (e & 1), output
  // column n0 + col + (e >> 1), so elements e and e + 2 are one row's
  // neighbouring columns.
  const int tig = c.lane & 3;
  const int nc = n0 + c.col;
  if (splits == 1) {
    float s0 = 1.f, s1 = 1.f;       // int8: the scale, after the sum
    if constexpr (!kInt4) {
      if (nc < p.N) {
        s0 = p.s[nc];
        s1 = p.s[nc + 1];
      }
    }
#pragma unroll
    for (int j = 0; j < MT; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = m0 + 8 * j + 2 * tig + h;
        if (m < p.M && nc < p.N)
          *reinterpret_cast<__nv_bfloat162*>(
              p.out + static_cast<size_t>(m) * p.N + nc) =
              __floats2bfloat162_rn(c.acc[4 * j + h] * s0,
                                    c.acc[4 * j + h + 2] * s1);
      }
    return;
  }
  // Split K: the consumers first finish with the ring (a named barrier of
  // their 256 threads: every copy has landed, each waited for every
  // stage), then write the f32 partial tile into it; after a cluster
  // barrier every CTA sums a share of the tile's float4 granules over the
  // cluster's partials in split order, read through distributed shared
  // memory (int8 then scales); the second barrier keeps each partial
  // alive until its readers are done.
  constexpr int kPRow = C::kPRow;
  constexpr int kQuads = kTileN / 4;
  asm volatile("bar.sync 1, %0;\n" :: "n"(128 * kC) : "memory");
  float* partial = reinterpret_cast<float*>(ring);
#pragma unroll
  for (int j = 0; j < MT; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      *reinterpret_cast<float2*>(partial + (8 * j + 2 * tig + h) * kPRow +
                                 c.col) =
          make_float2(c.acc[4 * j + h], c.acc[4 * j + h + 2]);
  cooperative_groups::cluster_group cluster =
      cooperative_groups::this_cluster();
  cluster.sync();
  for (int gi = split * 128 * kC + static_cast<int>(threadIdx.x);
       gi < kN * kQuads; gi += splits * 128 * kC) {
    const int r = gi / kQuads;
    const int cq = (gi - r * kQuads) * 4;
    const int m = m0 + r;
    const int n = n0 + cq;
    if (m >= p.M || n >= p.N) continue;
    float4 q4[kMaxSplits];   // all slices' loads in flight, then the sum
#pragma unroll
    for (int sp = 0; sp < kMaxSplits; ++sp)
      if (sp < splits)
        q4[sp] = *reinterpret_cast<const float4*>(
            cluster.map_shared_rank(partial, sp) + r * kPRow + cq);
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int sp = 0; sp < kMaxSplits; ++sp)
      if (sp < splits) {
        v.x += q4[sp].x;
        v.y += q4[sp].y;
        v.z += q4[sp].z;
        v.w += q4[sp].w;
      }
    if constexpr (!kInt4) {
      v.x *= p.s[n];
      v.y *= p.s[n + 1];
      v.z *= p.s[n + 2];
      v.w *= p.s[n + 3];
    }
    uint2 pair;
    pair.x = rt::bf162_bits(__floats2bfloat162_rn(v.x, v.y));
    pair.y = rt::bf162_bits(__floats2bfloat162_rn(v.z, v.w));
    *reinterpret_cast<uint2*>(p.out + static_cast<size_t>(m) * p.N + n) =
        pair;
  }
  cluster.sync();
}

// n8 tiles of x rows a CTA for M rows (mirrored by
// kernels/quant_matmul.py::wgmma_rows).
int tiles_m(int M) {
  if (M <= 8) return 1;
  if (M <= 16) return 2;
  if (M <= 32) return 4;
  if (M <= 64) return 8;
  return 16;
}

// The conditions of the file's header; splits of whole stages.
bool takes(const void* x, const void* q, const void* s, int M, int K, int N,
           int G, bool int4, int splits) {
  const int stages = (K + kTileK - 1) / kTileK;
  // int4's scales come by TMA too; int8's are read after the sum
  const bool aligned = ((reinterpret_cast<uintptr_t>(x) |
                         reinterpret_cast<uintptr_t>(q) |
                         (int4 ? reinterpret_cast<uintptr_t>(s) : 0u)) &
                        15u) == 0;
  if (M <= 0 || K <= 0 || K % 16 != 0 || N <= 0 || N % 16 != 0 || !aligned)
    return false;
  if (int4 && (G <= 0 || G % 16 != 0 || K % G != 0)) return false;
  if ((N + kTileN - 1) / kTileN > 65535) return false;
  if (splits < 1 || splits > kMaxSplits || splits > stages) return false;
  const int per = (stages + splits - 1) / splits;
  return (splits - 1) * per < stages;
}

template <int MT, int kFmt>
int launch(const void* x, const void* q, const void* s, void* out, int M,
           int K, int N, int G, int splits, cudaStream_t stream) {
  constexpr bool kInt4 = kFmt != kInt8;
  using C = Cfg<MT, kInt4>;
  Params p;
  p.s = static_cast<const float*>(s);
  p.out = static_cast<__nv_bfloat16*>(out);
  p.M = M;
  p.K = K;
  p.N = N;
  p.G = kInt4 ? G : 0;
  p.stages = (K + kTileK - 1) / kTileK;
  p.per_split = (p.stages + splits - 1) / splits;
  // the weight: (N, K rows) bytes, boxes of 128 columns of a stage's
  // rows; x: (K, M) bf16, boxes of 64 k of the CTA's rows; int4's scales:
  // (N, K / G) f32, boxes of one row of 128 columns
  const cuuint64_t kr = static_cast<cuuint64_t>(kInt4 ? K / 2 : K);
  CUtensorMap tw, tx, ts;
  const cuuint64_t w_dims[2] = {static_cast<cuuint64_t>(N), kr};
  const cuuint64_t w_strides[1] = {static_cast<cuuint64_t>(N)};
  const cuuint32_t w_box[2] = {kTileN, C::kWRows};
  int rc = hop::encode(&tw, CU_TENSOR_MAP_DATA_TYPE_UINT8, q, 2, w_dims,
                       w_strides, w_box, CU_TENSOR_MAP_SWIZZLE_128B);
  const cuuint64_t x_dims[2] = {static_cast<cuuint64_t>(K),
                                static_cast<cuuint64_t>(M)};
  const cuuint64_t x_strides[1] = {static_cast<cuuint64_t>(K) * 2};
  const cuuint32_t x_box[2] = {kTileK, C::kRowsM};
  if (rc == 0)
    rc = hop::encode(&tx, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, x, 2, x_dims,
                     x_strides, x_box, CU_TENSOR_MAP_SWIZZLE_128B);
  if (kInt4) {
    const cuuint64_t s_dims[2] = {static_cast<cuuint64_t>(N),
                                  static_cast<cuuint64_t>(K / G)};
    const cuuint64_t s_strides[1] = {static_cast<cuuint64_t>(N) * 4};
    const cuuint32_t s_box[2] = {kTileN, 1};
    if (rc == 0)
      rc = hop::encode(&ts, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, s, 2, s_dims,
                       s_strides, s_box, CU_TENSOR_MAP_SWIZZLE_NONE);
  } else {
    ts = tw;                           // not read
  }
  if (rc != 0) return rc;
  cudaError_t err = rt::allow_smem(quant_wgmma_kernel<MT, kFmt>, C::kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((M + C::kRowsM - 1) / C::kRowsM,
                     (N + kTileN - 1) / kTileN, splits);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = C::kSmem;
  cfg.stream = stream;
  cudaLaunchAttribute cluster;
  if (splits > 1) {                  // the slices of one tile: a cluster
    cluster.id = cudaLaunchAttributeClusterDimension;
    cluster.val.clusterDim.x = 1;
    cluster.val.clusterDim.y = 1;
    cluster.val.clusterDim.z = splits;
    cfg.attrs = &cluster;
    cfg.numAttrs = 1;
  }
  err = cudaLaunchKernelEx(&cfg, quant_wgmma_kernel<MT, kFmt>, tw, tx, ts,
                           p);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

template <int kFmt>
int dispatch(const void* x, const void* q, const void* s, void* out, int M,
             int K, int N, int G, int splits, cudaStream_t st) {
  switch (tiles_m(M)) {
    case 1: return launch<1, kFmt>(x, q, s, out, M, K, N, G, splits, st);
    case 2: return launch<2, kFmt>(x, q, s, out, M, K, N, G, splits, st);
    case 4: return launch<4, kFmt>(x, q, s, out, M, K, N, G, splits, st);
    case 8: return launch<8, kFmt>(x, q, s, out, M, K, N, G, splits, st);
    default: return launch<16, kFmt>(x, q, s, out, M, K, N, G, splits, st);
  }
}

// f(kernel, its shared memory, its stages) on the body of format int4 at
// n8 tiles MT (int4: the group-64 path's kernel; the other groups' path
// has the same shared memory and stages).
template <class F>
int with_kernel(bool int4, int mt, F f) {
  if (int4) {
    switch (mt) {
      case 1: return f(quant_wgmma_kernel<1, kInt4G64>, Cfg<1, true>::kSmem,
                       Cfg<1, true>::kStages);
      case 2: return f(quant_wgmma_kernel<2, kInt4G64>, Cfg<2, true>::kSmem,
                       Cfg<2, true>::kStages);
      case 4: return f(quant_wgmma_kernel<4, kInt4G64>, Cfg<4, true>::kSmem,
                       Cfg<4, true>::kStages);
      case 8: return f(quant_wgmma_kernel<8, kInt4G64>, Cfg<8, true>::kSmem,
                       Cfg<8, true>::kStages);
      case 16: return f(quant_wgmma_kernel<16, kInt4G64>,
                        Cfg<16, true>::kSmem, Cfg<16, true>::kStages);
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  switch (mt) {
    case 1: return f(quant_wgmma_kernel<1, kInt8>, Cfg<1, false>::kSmem,
                     Cfg<1, false>::kStages);
    case 2: return f(quant_wgmma_kernel<2, kInt8>, Cfg<2, false>::kSmem,
                     Cfg<2, false>::kStages);
    case 4: return f(quant_wgmma_kernel<4, kInt8>, Cfg<4, false>::kSmem,
                     Cfg<4, false>::kStages);
    case 8: return f(quant_wgmma_kernel<8, kInt8>, Cfg<8, false>::kSmem,
                     Cfg<8, false>::kStages);
    case 16: return f(quant_wgmma_kernel<16, kInt8>, Cfg<16, false>::kSmem,
                      Cfg<16, false>::kStages);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// The wgmma body (quant_matmul.cu's entries call it for body "wgmma"):
// x (M, K) bf16, q int8 (K, N) or uint8 (K / 2, N), s (1, N) or (K / G,
// N) f32, out (M, N) bf16; a CUDA error, cudaErrorInvalidValue where the
// body does not take the shape, or hop::kTensorMapError + the CUDA
// driver's CUresult.
int quant_wgmma_launch(const void* x, const void* q, const void* s,
                       void* out, int M, int K, int N, int G, bool int4,
                       int splits, cudaStream_t stream) {
  if (!takes(x, q, s, M, K, N, G, int4, splits))
    return static_cast<int>(cudaErrorInvalidValue);
  if (!int4) return dispatch<kInt8>(x, q, s, out, M, K, N, G, splits, stream);
  if (G == 64)
    return dispatch<kInt4G64>(x, q, s, out, M, K, N, G, splits, stream);
  return dispatch<kInt4Any>(x, q, s, out, M, K, N, G, splits, stream);
}

// The body at `rows` rows of x a CTA (8, 16, 32, 64, or 128 for int8)
// for format int4 (0 / 1): the CTAs an SM of this card holds, into
// *ctas (the occupancy calculator on the kernel at its shared memory),
// its dynamic shared memory, into *smem, and its stages, into *stages
// (what kernels/quant_matmul.py's WGMMA_CTAS_PER_SM, wgmma_smem_bytes
// and wgmma_stages mirror; chip_smoke.py holds them to these).
extern "C" int rt_quant_wgmma_occupancy(int int4, int rows, int* ctas,
                                        int* smem, int* stages) {
  if (rows % 8 != 0) return static_cast<int>(cudaErrorInvalidValue);
  return with_kernel(int4 != 0, rows / 8, [&](auto kernel, int bytes,
                                              int n) {
    *smem = bytes;
    *stages = n;
    cudaError_t err = rt::allow_smem(kernel, bytes);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(ctas, kernel,
                                                          kThreads, bytes);
    return static_cast<int>(err);
  });
}

// Clusters of `splits` (1 to 8) CTAs of that body the card holds at once,
// into *out: the table wgmma_splits reads (kernels/quant_matmul.py::
// WGMMA_CLUSTERS).
extern "C" int rt_quant_wgmma_clusters(int int4, int rows, int splits,
                                       int* out) {
  if (rows % 8 != 0 || splits < 1 || splits > kMaxSplits)
    return static_cast<int>(cudaErrorInvalidValue);
  return with_kernel(int4 != 0, rows / 8, [&](auto kernel, int bytes, int) {
    cudaError_t err = rt::allow_smem(kernel, bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(1, 1, splits);
    cfg.blockDim = dim3(kThreads);
    cfg.dynamicSmemBytes = bytes;
    cudaLaunchAttribute attr;
    attr.id = cudaLaunchAttributeClusterDimension;
    attr.val.clusterDim.x = 1;
    attr.val.clusterDim.y = 1;
    attr.val.clusterDim.z = splits;
    cfg.attrs = &attr;
    cfg.numAttrs = 1;
    return static_cast<int>(
        cudaOccupancyMaxActiveClusters(out, kernel, &cfg));
  });
}
