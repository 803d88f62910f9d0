// Paged causal flash attention over chunks: C query tokens of each of B
// rows, row b's at positions pos[b] .. pos[b] + C - 1, attend causally to
// the logical slots [0, pos[b] + C) of a paged KV pool, through the row's
// block table, with an online softmax in f32.  Keys are clamped at
// max_len - 1 = nb * bs - 1.
//
// Three entry points share the bodies below:
// * rt_paged_prefill_attention: one request's prefill chunk (B = 1), its
//   pos a host int;
// * rt_paged_chunk_attention: the batched form the draft-verify round
//   runs (B rows of C = K + 1 tokens, Model.verify_steps), each row's pos
//   read from a (B,) int32 device array by the CTAs themselves.  The grid
//   is (tiles of one row, heads or KV heads, B): sized from B, C, H and
//   KV only, so the host never reads pos and a verify round launches
//   the same grid whatever the rows' positions (a CUDA graph can
//   capture it).  Each CTA derives its key range and early exits from
//   its row's pos, as the one-row launch does from the host's.  Row b of
//   a batched launch runs exactly the instructions a one-row launch at
//   pos[b] runs, so its output is bit-equal to that launch's.
// * rt_paged_cross_attention: the cross form.  C queries of each of B
//   rows attend to all n_keys slots [0, n_keys) of the row's blocks, with
//   no causal mask: cross-attention over a source (image patches, the
//   encoder's output) whose K/V sit in the row's cross blocks (the paged
//   engine's cross pools through cross_tables, or a dense cache as B
//   blocks of src slots).  Its bf16 body at hd 64 and 128 is wgmma
//   (paged_cross_attention.cu: the contiguous form's warp-specialised
//   body over the pools by TMA, split across a cluster); the bodies
//   below run it elsewhere (mma, cuda_core) with every CTA's key range
//   [0, n_keys), the only mask the tail of the last tile past n_keys - 1
//   (1601 = 100 x 16 + 1 slots at llama-3.2-vision's image).  pos plays
//   no part.  The reference computes this in jnp
//   (src/repro/models/attention.py::cross_attention), outside any Pallas
//   kernel; the causal forms cannot give it, since any pos that made key
//   n_keys - 1 visible to a chunk's first query would let its later
//   queries read past n_keys.
//
// Replaces the TPU kernel flash_attention_pallas
// (src/repro/kernels/flash_attention.py:72, body _flash_kernel) in the
// form the reference model's prefill runs it: the linear branch of
// src/repro/models/attention.py::paged_chunk_self_attention, computed
// after the caller's in-place write of the chunk's K/V.  Called with
// pos = 0 and an identity table it computes what
// flash_attention_pallas(causal=True, window=0) computes for contiguous
// K/V.  The sliding window is not on this path.  The slot engine runs it
// too, on a dense cache row seen as one block of S slots.
//
// Bound on the H100: bytes at the main path's chunks (C = 128 against a
// prefix of a few hundred keys: 4 * H * hd flops per query-key pair, far
// below the bf16 tensor cores' 295 flops per byte; at gemma3-12b's hd
// 256, C = 128 against 1,152-2,176 keys of 8 KV heads, 3.4-5.9 us of
// bytes); in practice latency and SM fill, since a chunk is a few tens
// of row tiles.
//
// Three bodies for the causal forms; the wrapper names one by its rule
// (kernels/flash_attention.py::chunk_body) and this entry point
// launches it, refusing a body the shape cannot take:
//
// * wgmma (bf16 at hd 64, 112 and 128, 16-byte aligned q / pools / out,
//   blocks of a multiple of 8 slots or one dense block): the
//   warp-specialised body of chunk_wgmma.cu, 128 (query, head-in-group)
//   rows a CTA on wgmma, the pools read by TMA through the table, each
//   (row tile, KV head, row)'s key tiles split across a cluster of
//   `splits` CTAs (the wrapper's chunk_splits, shape only).  The one-row
//   and the batched form share it, so a batched row keeps a one-row
//   call's bits.
// * mma (bf16, hd % 16 == 0 up to 128 or hd 256, 16-byte aligned q /
//   pools / out).  A CTA owns one KV head and 64 rows, a row being a (query,
//   head-in-group) pair of that KV head's G query heads, so each K/V tile
//   is read once for all G heads.  Its 8 warps are 4 row warps of 16 rows
//   (one m16 fragment each) times 2 key groups: each step brings 128
//   logical slots, key group g takes the 64 at offset 64 g, and at the
//   end group 1 hands its (m, l, O) to group 0, which merges them in a
//   fixed order; this halves the serial chain of key tiles a long prefix
//   puts on each warp.  C = 128, H = 15, KV = 5 gives 6 x 5 = 30 CTAs,
//   240 warps; a verify round's batched launch (B 8, C = K + 1 = 5) gives
//   1 x 5 x 8 = 40 CTAs whose 64-row tiles hold 15 live rows each (filling
//   them is later work).  Each slot row's physical block comes from the
//   table, and its hd * 2 bytes are copied with 16-byte cp.async into a padded
//   shared tile (row stride hd + 8, so ldmatrix has no bank conflicts),
//   the next step loading while the current one computes.  S = Q K^T
//   runs on mma.sync m16n8k16 with f32 accumulators (products of bf16
//   are exact); the online softmax keeps (m, l) per row in registers
//   across an mma quad, in the log2 domain with exp2f.  P is split into
//   P_hi = bf16(P) and P_lo = bf16(P - P_hi), and both go through the PV
//   mma against the same bf16 V into the f32 accumulators: P keeps about
//   16 bits, so the output stays within one final bf16 rounding of the
//   f32 plain version (rounding P once to bf16 would add about 2^-9 of
//   sum |P V|, past the gate for small outputs).  Tiles past a warp's
//   last query are skipped, and the causal mask is applied only on tiles
//   that reach past a warp's first query.  Tiles are cut by logical
//   slot, never by block, so the output bits do not depend on bs or on
//   the table.
//   At hd 256 (gemma3-12b's attn layers) the same body runs wide
//   (Tiles<256>), for three limits the narrow tiles hit there:
//   - shared memory: Q and a double-buffered 128-slot step would take
//     (64 + 512) x 264 x 2 = 304,128 B, past the 232,448 a block may use.
//     The wide body's key groups take 32 slots each, so a step is 64:
//     Q 64 x 264 x 2 + K and V 2 x 2 x 64 x 264 x 2 = 168,960 B, one CTA
//     an SM;
//   - registers: each warp's 16 x 256 f32 accumulator is 128 registers a
//     thread, so Q is not held as fragments (64 more) but read from
//     shared memory by ldmatrix at each k16 step; the score tile of 32
//     keys is 16 registers;
//   - fill: a chunk of C = 128 at G = 2 is 4 row tiles x 8 KV heads = 32
//     CTAs on 132 SMs, each walking 1,152-2,176 keys.  Each row tile's
//     steps of 64 logical slots are split across a thread-block cluster
//     of `splits` CTAs along grid x (the wrapper's prefill_splits, shape
//     only: 3 at gemma3's chunk, 96 CTAs; the card holds 39 clusters of
//     3 at one CTA an SM, but only 30 of 4, so 4 would take two waves
//     and measured 1.6x slower, tools/torch_split_sweep.py): CTA r of
//     the cluster takes
//     steps [r * per, (r + 1) * per) of klast / 64 + 1, per = ceil(steps
//     / splits), reading pos on the device as before.  Its key groups
//     merge as above; then each CTA's rows (O, m, l) go to its V
//     buffers, and after a cluster barrier each CTA merges a share of
//     the tile's 64 x 256 outputs over the cluster's partials in split
//     order, read through distributed shared memory, divides by l and
//     rounds once.  Cuts by logical slot and a split that depends on
//     (C, H, KV, hd, nb * bs) alone keep the bits independent of bs, of
//     the table and of the batch (a batched row = a one-row call).
// * cuda_core (float32 at every shape, bf16 at the others): the f32
//   CUDA-core body of the first port, grid (ceil(C / 32), H, B), products in
//   scalar loops out of shared memory.  float32 stays here because the
//   card's float32 streams must equal the CPU's: TF32 tensor cores would
//   round the inputs.
#include <cooperative_groups.h>

#include "common.cuh"
#include "mma.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kTileQ = 32;   // queries per block
constexpr int kTileK = 32;   // logical KV slots per key tile (one per lane)

template <typename T>
__global__ void __launch_bounds__(kThreads)
paged_prefill_kernel(const T* __restrict__ q, const T* __restrict__ kp,
                     const T* __restrict__ vp, const int* __restrict__ table,
                     const int* __restrict__ pos_dev, T* __restrict__ out,
                     int C, int H, int KV, int hd, int bs, int nb,
                     int pos_host, int n_keys, float scale) {
  // row b of the batch: its queries, outputs, table and position
  const int b = blockIdx.z;
  const int pos = pos_dev != nullptr ? pos_dev[b] : pos_host;
  q += static_cast<size_t>(b) * C * H * hd;
  out += static_cast<size_t>(b) * C * H * hd;
  table += static_cast<size_t>(b) * nb;
  const int q0 = blockIdx.x * kTileQ;
  const int h = blockIdx.y;
  const int kvh = h / (H / KV);
  const int nq = C - q0 < kTileQ ? C - q0 : kTileQ;
  extern __shared__ float smem[];
  float* qs = smem;                          // kTileQ * hd
  float* ks = qs + kTileQ * hd;              // kTileK * (hd + 1)
  float* vs = ks + kTileK * (hd + 1);        // kTileK * hd
  float* sc = vs + kTileK * hd;              // kTileQ * kTileK
  float* acc = sc + kTileQ * kTileK;         // kTileQ * hd
  float* m = acc + kTileQ * hd;              // kTileQ
  float* l = m + kTileQ;                     // kTileQ
  float* alpha = l + kTileQ;                 // kTileQ

  for (int e = threadIdx.x; e < kTileQ * hd; e += blockDim.x) {
    const int qi = e / hd;
    const int d = e - qi * hd;
    qs[e] = qi < nq
        ? rt::to_f32<T>(q[(static_cast<size_t>(q0 + qi) * H + h) * hd + d])
        : 0.f;
    acc[e] = 0.f;
  }
  for (int qi = threadIdx.x; qi < kTileQ; qi += blockDim.x) {
    m[qi] = rt::kNegInf;
    l[qi] = 0.f;
  }
  __syncthreads();

  const int max_len = nb * bs;
  // the cross form (n_keys > 0) reads [0, n_keys) for every query
  const bool cross = n_keys > 0;
  const int last_q = pos + q0 + nq - 1;            // tile's last position
  const int klast =
      cross ? n_keys - 1 : (last_q < max_len - 1 ? last_q : max_len - 1);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;

  for (int k0 = 0; k0 <= klast; k0 += kTileK) {
    rt::load_kv_tile<T>(ks, vs, kp, vp, table, k0, kTileK, klast, bs, KV, kvh, hd);
    __syncthreads();

    for (int e = threadIdx.x; e < kTileQ * kTileK; e += blockDim.x) {
      const int qi = e / kTileK;
      const int ki = e - qi * kTileK;
      const int kpos = k0 + ki;
      float s = rt::kNegInf;
      if (qi < nq && (cross || kpos <= pos + q0 + qi) && kpos <= klast) {
        const float* qr = qs + qi * hd;
        const float* kr = ks + ki * (hd + 1);
        float dot = 0.f;
        for (int d = 0; d < hd; ++d) dot += qr[d] * kr[d];
        s = dot * scale;
      }
      sc[e] = s;
    }
    __syncthreads();

    for (int qi = warp; qi < kTileQ; qi += nwarps) {
      const float v = sc[qi * kTileK + lane];
      const float m_new = fmaxf(m[qi], rt::warp_max(v));
      const float pv = expf(v - m_new);
      sc[qi * kTileK + lane] = pv;
      const float sum = rt::warp_sum(pv);
      if (lane == 0) {
        const float a = expf(m[qi] - m_new);
        alpha[qi] = a;
        l[qi] = a * l[qi] + sum;
        m[qi] = m_new;
      }
    }
    __syncthreads();

    for (int e = threadIdx.x; e < kTileQ * hd; e += blockDim.x) {
      const int qi = e / hd;
      const int d = e - qi * hd;
      const float* pr = sc + qi * kTileK;
      float a = acc[e] * alpha[qi];
#pragma unroll 8
      for (int ki = 0; ki < kTileK; ++ki) a += pr[ki] * vs[ki * hd + d];
      acc[e] = a;
    }
    __syncthreads();
  }

  for (int e = threadIdx.x; e < nq * hd; e += blockDim.x) {
    const int qi = e / hd;
    const int d = e - qi * hd;
    out[(static_cast<size_t>(q0 + qi) * H + h) * hd + d] =
        rt::from_f32<T>(acc[e] / fmaxf(l[qi], 1e-30f));
  }
}

template <typename T>
cudaError_t launch(const void* q, const void* kp, const void* vp,
                   const void* table, const void* pos_dev, void* out, int B,
                   int C, int H, int KV, int hd, int bs, int nb, int pos,
                   int n_keys, float scale, cudaStream_t stream) {
  const size_t floats = static_cast<size_t>(kTileQ) * hd * 2 +
                        static_cast<size_t>(kTileK) * (hd + 1) +
                        static_cast<size_t>(kTileK) * hd +
                        static_cast<size_t>(kTileQ) * kTileK + 3 * kTileQ;
  const size_t bytes = floats * sizeof(float);
  cudaError_t err = rt::allow_smem(paged_prefill_kernel<T>, bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((C + kTileQ - 1) / kTileQ, H, B);
  paged_prefill_kernel<T><<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(kp),
      static_cast<const T*>(vp), static_cast<const int*>(table),
      static_cast<const int*>(pos_dev), static_cast<T*>(out), C, H, KV, hd,
      bs, nb, pos, n_keys, scale);
  return cudaGetLastError();
}


// ---------------------------------------------------------------------------
// mma body (bf16)
// ---------------------------------------------------------------------------
namespace mma {

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
};

template <int HD>
constexpr size_t smem_bytes() {      // Q, then K and V, double-buffered
  return static_cast<size_t>(kRows + 4 * Tiles<HD>::kSpan) * (HD + 8) *
         sizeof(__nv_bfloat16);
}
static_assert(smem_bytes<256>() == 168960, "wide body: 165 KB a CTA");

template <int HD>
__global__ void __launch_bounds__(kThreads)
prefill_kernel(const __nv_bfloat16* __restrict__ q,
               const __nv_bfloat16* __restrict__ kp,
               const __nv_bfloat16* __restrict__ vp,
               const int* __restrict__ table,
               const int* __restrict__ pos_dev,
               __nv_bfloat16* __restrict__ out, int C, int H, int KV, int bs,
               int nb, int pos_host, int n_keys, float scale_log2,
               int splits) {
  using T = Tiles<HD>;
  constexpr int kTileK = T::kTileK;
  constexpr int kSpan = T::kSpan;
  constexpr int kStride = HD + 8;    // smem row, in bf16
  constexpr int kChunks = HD / 8;    // 16-byte chunks per row
  constexpr int kKSteps = HD / 16;   // k16 steps of Q K^T
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* ks = qs + kRows * kStride;        // [2][kSpan][kStride]
  __nv_bfloat16* vs = ks + 2 * kSpan * kStride;    // [2][kSpan][kStride]

  // row b of the batch: its queries, outputs, table and position
  const int b = blockIdx.z;
  const int pos = pos_dev != nullptr ? pos_dev[b] : pos_host;
  q += static_cast<size_t>(b) * C * H * HD;
  out += static_cast<size_t>(b) * C * H * HD;
  table += static_cast<size_t>(b) * nb;
  const int G = H / KV;
  const int kvh = blockIdx.y;
  const int rows = C * G;
  // grid x: row tiles, each split across `splits` CTAs (a cluster); 1
  // below the wide body, fixed here so those bodies compile as unsplit
  if constexpr (!T::kWide) splits = 1;
  const int split = blockIdx.x % splits;
  const int r0 = blockIdx.x / splits * kRows;
  const int rlast = min(r0 + kRows, rows) - 1;
  // the cross form (n_keys > 0): every row's last key is n_keys - 1
  const bool cross = n_keys > 0;
  const int klast = cross ? n_keys - 1 : min(pos + rlast / G, nb * bs - 1);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = (tid >> 5) % kRowWarps;   // this warp's 16 rows
  const int kgroup = (tid >> 5) / kRowWarps;  // and its half of each step

  // this CTA's share of the tile's steps of kSpan logical slots: steps
  // [st0, st1) of klast / kSpan + 1 (empty past klast)
  const int nst = klast / kSpan + 1;
  const int per = (nst + splits - 1) / splits;
  const int st0 = split * per;
  const int st1 = min(st0 + per, nst);

  // Q rows of this CTA (zero past the last row)
  for (int e = tid; e < kRows * kChunks; e += kThreads) {
    const int r = e / kChunks;
    const int c = e - r * kChunks;
    const int rho = r0 + r;
    const __nv_bfloat16* src = q;
    int n = 0;
    if (rho < rows) {
      src = q + (static_cast<size_t>(rho / G) * H + kvh * G + rho % G) * HD +
            c * 8;
      n = 16;
    }
    rt::cp_async16(qs + r * kStride + c * 8, src, n);
  }
  // slots [k0, k0 + kSpan) into buffer buf (zero past klast)
  auto load_tile = [&](int k0, int buf) {
    __nv_bfloat16* kd = ks + buf * kSpan * kStride;
    __nv_bfloat16* vd = vs + buf * kSpan * kStride;
    for (int e = tid; e < kSpan * kChunks; e += kThreads) {
      const int ki = e / kChunks;
      const int c = e - ki * kChunks;
      const int s = k0 + ki;
      size_t off = 0;
      int n = 0;
      if (s <= klast) {
        const int blk = s / bs;
        off = ((static_cast<size_t>(table[blk]) * bs + (s - blk * bs)) * KV +
               kvh) * HD + c * 8;
        n = 16;
      }
      rt::cp_async16(kd + ki * kStride + c * 8, kp + off, n);
      rt::cp_async16(vd + ki * kStride + c * 8, vp + off, n);
    }
  };
  if (st0 < st1) load_tile(st0 * kSpan, 0);
  rt::cp_async_commit();

  // this warp's rows: wr0 .. wr0 + 15; this lane's two, ra and ra + 8
  const int grp = lane >> 2;
  const int tig = lane & 3;
  const int wr0 = r0 + warp * 16;
  const bool live = wr0 <= rlast;
  const int wq_first = cross ? klast : pos + wr0 / G;
  const int wq_last = cross ? klast : pos + min(wr0 + 15, rlast) / G;
  const int ra = wr0 + grp;
  const int qpa = cross ? klast : min(pos + ra / G, klast);  // last key of ra
  const int qpb =
      cross ? klast : min(pos + (ra + 8) / G, klast);  // and of row ra + 8

  uint32_t qf[T::kWide ? 1 : kKSteps][4];   // Q in registers (not wide)
  float o[HD / 8][4];
#pragma unroll
  for (int d = 0; d < HD / 8; ++d)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[d][e] = 0.f;
  float m_a = rt::kNegInf, m_b = rt::kNegInf, l_a = 0.f, l_b = 0.f;

  // Step it holds slots [it * kSpan, (it + 1) * kSpan); key group g
  // takes the tile of kTileK slots at it * kSpan + g * kTileK.
  for (int it = st0; it < st1; ++it) {
    const int k0 = it * kSpan + kgroup * kTileK;
    const int buf = (it - st0) & 1;
    if (it + 1 < st1) load_tile((it + 1) * kSpan, buf ^ 1);
    rt::cp_async_commit();
    rt::cp_async_wait<1>();
    __syncthreads();
    if constexpr (!T::kWide) {
      if (it == st0) {
#pragma unroll
        for (int kk = 0; kk < kKSteps; ++kk)
          rt::ldmatrix_x4(qf[kk], qs + (warp * 16 + (lane & 15)) * kStride +
                                      kk * 16 + (lane >> 4) * 8);
      }
    }
    if (live && k0 <= wq_last) {
      const __nv_bfloat16* kt = ks + (buf * kSpan + kgroup * kTileK) * kStride;
      const __nv_bfloat16* vt = vs + (buf * kSpan + kgroup * kTileK) * kStride;
      // S = Q K^T: kTileK / 8 n-tiles of 8 keys
      float sc[kTileK / 8][4];
#pragma unroll
      for (int j = 0; j < kTileK / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) sc[j][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < kKSteps; ++kk) {
        uint32_t a[4];
        if constexpr (T::kWide) {
          rt::ldmatrix_x4(a, qs + (warp * 16 + (lane & 15)) * kStride +
                                 kk * 16 + (lane >> 4) * 8);
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
      // scale into the log2 domain; mask where the tile reaches past the
      // warp's first query or the clamp
      const bool masked = k0 + kTileK - 1 > min(wq_first, klast);
      float mx_a = rt::kNegInf, mx_b = rt::kNegInf;
#pragma unroll
      for (int j = 0; j < kTileK / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = k0 + 8 * j + 2 * tig + (e & 1);
          float v = sc[j][e] * scale_log2;
          if (masked && key > (e < 2 ? qpa : qpb)) v = rt::kNegInf;
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
      l_a = l_a * al_a + sum_a;
      l_b = l_b * al_b + sum_b;
#pragma unroll
      for (int d = 0; d < HD / 8; ++d) {
        o[d][0] *= al_a;
        o[d][1] *= al_a;
        o[d][2] *= al_b;
        o[d][3] *= al_b;
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
          rt::mma_bf16(o[2 * d2], ph, b[0], b[1]);
          rt::mma_bf16(o[2 * d2], pl, b[0], b[1]);
          rt::mma_bf16(o[2 * d2 + 1], ph, b[2], b[3]);
          rt::mma_bf16(o[2 * d2 + 1], pl, b[2], b[3]);
        }
      }
    }
    __syncthreads();
  }

  // Key group 1 hands its (m, l, o) to group 0 through shared memory
  // (the K/V buffers are free now), which merges the two in a fixed
  // order.  A row group 1 never reached has m = kNegInf, l = 0, o = 0.
  constexpr int kXch = HD / 2 + 4;    // floats per thread
  static_assert(kRowWarps * 32 * kXch * sizeof(float) <=
                    2 * kSpan * kStride * sizeof(__nv_bfloat16),
                "the exchange fits the K buffers");
  rt::cp_async_wait<0>();
  __syncthreads();
  float* xch = reinterpret_cast<float*>(ks) + (warp * 32 + lane) * kXch;
  if (kgroup == 1) {
#pragma unroll
    for (int d = 0; d < HD / 8; ++d)
#pragma unroll
      for (int e = 0; e < 4; ++e) xch[4 * d + e] = o[d][e];
    xch[HD / 2] = m_a;
    xch[HD / 2 + 1] = m_b;
    xch[HD / 2 + 2] = l_a;
    xch[HD / 2 + 3] = l_b;
  }
  __syncthreads();
  if (kgroup == 0) {
    const float m1a = xch[HD / 2], m1b = xch[HD / 2 + 1];
    const float mn_a = fmaxf(m_a, m1a), mn_b = fmaxf(m_b, m1b);
    const float a0 = exp2f(m_a - mn_a), a1 = exp2f(m1a - mn_a);
    const float b0 = exp2f(m_b - mn_b), b1 = exp2f(m1b - mn_b);
    m_a = mn_a;
    m_b = mn_b;
    l_a = l_a * a0 + xch[HD / 2 + 2] * a1;
    l_b = l_b * b0 + xch[HD / 2 + 3] * b1;
#pragma unroll
    for (int d = 0; d < HD / 8; ++d) {
      o[d][0] = o[d][0] * a0 + xch[4 * d] * a1;
      o[d][1] = o[d][1] * a0 + xch[4 * d + 1] * a1;
      o[d][2] = o[d][2] * b0 + xch[4 * d + 2] * b1;
      o[d][3] = o[d][3] * b0 + xch[4 * d + 3] * b1;
    }
  }

  if constexpr (!T::kWide) {
    if (kgroup == 1) return;
    // divide by l in f32, round once, store pairs
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int rho = ra + 8 * half;
      if (!live || rho > rlast) continue;
      const float l = fmaxf(half ? l_b : l_a, 1e-30f);
      __nv_bfloat16* dst =
          out + (static_cast<size_t>(rho / G) * H + kvh * G + rho % G) * HD +
          2 * tig;
#pragma unroll
      for (int d = 0; d < HD / 8; ++d)
        *reinterpret_cast<__nv_bfloat162*>(dst + 8 * d) =
            __floats2bfloat162_rn(o[d][2 * half] / l, o[d][2 * half + 1] / l);
    }
  } else {
    // The CTA's partial rows (O, then m and l) into the V buffers; after
    // a cluster barrier every CTA merges a share of the tile's rows x HD
    // outputs over the cluster's partials in split order, read through
    // distributed shared memory, divides by l and rounds once; a second
    // barrier keeps each partial alive until its readers are done.
    constexpr int kPRow = HD + 2;
    static_assert(kRows * kPRow * sizeof(float) <=
                      2 * kSpan * kStride * sizeof(__nv_bfloat16),
                  "the partial fits the V buffers");
    float* cpart = reinterpret_cast<float*>(vs);
    if (kgroup == 0) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        float* row = cpart + (warp * 16 + grp + 8 * half) * kPRow;
#pragma unroll
        for (int d = 0; d < HD / 8; ++d)
          *reinterpret_cast<float2*>(row + 8 * d + 2 * tig) =
              make_float2(o[d][2 * half], o[d][2 * half + 1]);
        if (tig == 0) {
          row[HD] = half ? m_b : m_a;
          row[HD + 1] = half ? l_b : l_a;
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

template <int HD>
cudaError_t launch(const void* q, const void* kp, const void* vp,
                   const void* table, const void* pos_dev, void* out, int B,
                   int C, int H, int KV, int bs, int nb, int pos, int n_keys,
                   float scale, int splits, cudaStream_t stream) {
  const size_t bytes = smem_bytes<HD>();
  cudaError_t err = rt::allow_smem(prefill_kernel<HD>, bytes);
  if (err != cudaSuccess) return err;
  const int tiles = (C * (H / KV) + kRows - 1) / kRows;
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
  err = cudaLaunchKernelEx(
      &cfg, prefill_kernel<HD>, static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(kp),
      static_cast<const __nv_bfloat16*>(vp), static_cast<const int*>(table),
      static_cast<const int*>(pos_dev), static_cast<__nv_bfloat16*>(out), C,
      H, KV, bs, nb, pos, n_keys, scale * kLog2e, splits);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// The instantiation for head dim hd, one of HD, HD - 16, ..., 16.
template <int HD>
cudaError_t dispatch(int hd, const void* q, const void* kp, const void* vp,
                     const void* table, const void* pos_dev, void* out, int B,
                     int C, int H, int KV, int bs, int nb, int pos, int n_keys,
                     float scale, cudaStream_t s) {
  if (hd == HD)
    return launch<HD>(q, kp, vp, table, pos_dev, out, B, C, H, KV, bs, nb,
                      pos, n_keys, scale, 1, s);
  if constexpr (HD > 16)
    return dispatch<HD - 16>(hd, q, kp, vp, table, pos_dev, out, B, C, H, KV,
                             bs, nb, pos, n_keys, scale, s);
  return cudaErrorInvalidValue;
}

}  // namespace mma

}  // namespace

// The paged chunk's wgmma body (chunk_wgmma.cu).
int chunk_wgmma_launch(const void* q, const void* k_pool, const void* v_pool,
                       const void* tables, const void* pos_dev, void* out,
                       int B, int C, int H, int KV, int hd, int bs, int nb,
                       int nbp, int pos, float scale, int splits,
                       cudaStream_t stream);

namespace {

// Every entry point: B rows, each row's pos from pos_dev when it is not
// null, else the host's pos; n_keys > 0 selects the cross form (keys
// [0, n_keys), no causal mask, pos unused), 0 the causal one.  splits (1
// to 8) is read by the causal form's wgmma body (chunk_wgmma.cu; hd 64,
// 112 and 128, nbp the pool's blocks, the extent of its maps) and the
// wide mma body; the others take 1.
cudaError_t run(const void* q, const void* k_pool, const void* v_pool,
                const void* tables, const void* pos_dev, void* out, int B,
                int C, int H, int KV, int hd, int bs, int nb, int nbp,
                int pos, int n_keys, float scale, int dtype, int body,
                int splits, cudaStream_t s) {
  if (B <= 0 || C <= 0) return cudaSuccess;
  if (KV <= 0 || H % KV != 0 || nb <= 0 || bs <= 0 || hd <= 0 || pos < 0 ||
      B > 65535 || n_keys < 0 || n_keys > nb * bs)
    return cudaErrorInvalidValue;
  if (body == rt::kBodyWgmma) {
    const bool aligned = ((reinterpret_cast<uintptr_t>(q) |
                           reinterpret_cast<uintptr_t>(k_pool) |
                           reinterpret_cast<uintptr_t>(v_pool) |
                           reinterpret_cast<uintptr_t>(out)) & 15u) == 0;
    if (dtype != 1 || !aligned || n_keys != 0 ||
        (hd != 64 && hd != 112 && hd != 128))
      return cudaErrorInvalidValue;
    const int rc = chunk_wgmma_launch(q, k_pool, v_pool, tables, pos_dev,
                                      out, B, C, H, KV, hd, bs, nb, nbp, pos,
                                      scale, splits, s);
    return static_cast<cudaError_t>(rc);
  }
  if (body == rt::kBodyMma) {
    const bool aligned = ((reinterpret_cast<uintptr_t>(q) |
                           reinterpret_cast<uintptr_t>(k_pool) |
                           reinterpret_cast<uintptr_t>(v_pool) |
                           reinterpret_cast<uintptr_t>(out)) & 15u) == 0;
    if (dtype != 1 || !aligned) return cudaErrorInvalidValue;
    if (hd == 256) {
      if (splits < 1 || splits > mma::kMaxSplits) return cudaErrorInvalidValue;
      return mma::launch<256>(q, k_pool, v_pool, tables, pos_dev, out, B, C,
                              H, KV, bs, nb, pos, n_keys, scale, splits, s);
    }
    if (hd % 16 != 0 || hd > 128 || splits != 1) return cudaErrorInvalidValue;
    return mma::dispatch<128>(hd, q, k_pool, v_pool, tables, pos_dev, out, B,
                              C, H, KV, bs, nb, pos, n_keys, scale, s);
  }
  if (body != rt::kBodyCudaCore) return cudaErrorInvalidValue;
  if (dtype == 0)
    return launch<float>(q, k_pool, v_pool, tables, pos_dev, out, B, C, H, KV,
                         hd, bs, nb, pos, n_keys, scale, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k_pool, v_pool, tables, pos_dev, out, B,
                                 C, H, KV, hd, bs, nb, pos, n_keys, scale, s);
  return cudaErrorInvalidValue;
}

}  // namespace

// q (C, H, hd), pools (nbp, bs, KV, hd), table (nb,), out like q.
extern "C" int rt_paged_prefill_attention(const void* q, const void* k_pool,
                                          const void* v_pool,
                                          const void* table, void* out, int C,
                                          int H, int KV, int hd, int bs,
                                          int nb, int nbp, int pos,
                                          float scale, int dtype, int body,
                                          int splits, void* stream) {
  return static_cast<int>(run(q, k_pool, v_pool, table, nullptr, out, 1, C, H,
                              KV, hd, bs, nb, nbp, pos, 0, scale, dtype, body,
                              splits, static_cast<cudaStream_t>(stream)));
}

// q (B, C, H, hd), pools (nbp, bs, KV, hd), tables (B, nb), pos (B,)
// int32 on the device, out like q.
extern "C" int rt_paged_chunk_attention(const void* q, const void* k_pool,
                                        const void* v_pool, const void* tables,
                                        const void* pos, void* out, int B,
                                        int C, int H, int KV, int hd, int bs,
                                        int nb, int nbp, float scale,
                                        int dtype, int body, int splits,
                                        void* stream) {
  if (pos == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(run(q, k_pool, v_pool, tables, pos, out, B, C, H,
                              KV, hd, bs, nb, nbp, 0, 0, scale, dtype, body,
                              splits, static_cast<cudaStream_t>(stream)));
}

// The cross form's wgmma body (paged_cross_attention.cu).
int cross_wgmma_launch(const void* q, const void* k_pool, const void* v_pool,
                       const void* tables, void* out, int B, int C, int H,
                       int KV, int hd, int bs, int nb, int nbp, int n_keys,
                       float scale, int splits, cudaStream_t stream);

// The cross form: q (B, C, H, hd), pools (nbp, bs, KV, hd), tables (B,
// nb), out like q; every query attends to slots [0, n_keys) of its row's
// blocks, 1 <= n_keys <= nb * bs.  body wgmma (bf16, hd 64 or 128,
// 16-byte aligned q / pools / out) launches paged_cross_attention.cu's
// body, splits the CTAs of its cluster; the others run's.
extern "C" int rt_paged_cross_attention(const void* q, const void* k_pool,
                                        const void* v_pool, const void* tables,
                                        void* out, int B, int C, int H, int KV,
                                        int hd, int bs, int nb, int nbp,
                                        int n_keys, float scale, int dtype,
                                        int body, int splits, void* stream) {
  if (n_keys <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (body != rt::kBodyWgmma)
    return static_cast<int>(run(q, k_pool, v_pool, tables, nullptr, out, B,
                                C, H, KV, hd, bs, nb, nbp, 0, n_keys, scale,
                                dtype, body, splits, s));
  if (B <= 0 || C <= 0) return static_cast<int>(cudaSuccess);
  const bool aligned = ((reinterpret_cast<uintptr_t>(q) |
                         reinterpret_cast<uintptr_t>(k_pool) |
                         reinterpret_cast<uintptr_t>(v_pool) |
                         reinterpret_cast<uintptr_t>(out)) & 15u) == 0;
  if (dtype != 1 || !aligned || KV <= 0 || H % KV != 0 || nb <= 0 ||
      bs <= 0 || B > 65535 || n_keys > nb * bs)
    return static_cast<int>(cudaErrorInvalidValue);
  return cross_wgmma_launch(q, k_pool, v_pool, tables, out, B, C, H, KV, hd,
                            bs, nb, nbp, n_keys, scale, splits, s);
}
