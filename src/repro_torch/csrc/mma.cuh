// Warp-level tensor-core helpers of the port's bf16 bodies (sm_90a):
// 16-byte cp.async copies into shared memory, ldmatrix fragment loads,
// movmatrix transposes of a fragment, mma.sync.aligned.m16n8k16 on bf16
// with f32 accumulators, and the splitting of f32 values into bf16 parts
// for an exact-enough operand.
//
// Fragment layout of m16n8k16 (lane = 4 * grp + tig):
//   A (16 x 16, row-major), 4 regs of two bf16: a0 (row grp, cols 2tig,
//     2tig+1), a1 (row grp+8, same cols), a2 (row grp, cols 2tig+8, +9),
//     a3 (row grp+8, cols 2tig+8, +9);
//   B (16 x 8), 2 regs: b0 (rows 2tig, 2tig+1 of column grp), b1 (rows
//     2tig+8, +9);
//   C/D (16 x 8, f32): c0, c1 (row grp, cols 2tig, 2tig+1), c2, c3 (row
//     grp+8, same cols).
// The lower 16 bits of a register hold the element of the lower index.
#pragma once

#include <cstdint>

#include <cuda_bf16.h>

namespace rt {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Copy 16 bytes from global to shared memory, asynchronously; with
// src_bytes = 0 nothing is read and the 16 bytes are zero-filled.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

// Four 8x8 b16 matrices; lanes 8i..8i+7 give the row addresses of
// matrix i, and register i receives matrix i's (row grp, cols 2tig, +1).
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// The same, each matrix transposed: register i receives matrix i's
// (rows 2tig, 2tig+1 of column grp).
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// One 8x8 b16 matrix in the C/D half layout (lane grp holds row grp,
// cols 2tig, 2tig+1), transposed in place across the warp: the lane
// then holds rows 2tig, 2tig+1 of column grp, the B layout of m16n8k16.
__device__ __forceinline__ uint32_t movmatrix_trans(uint32_t a) {
  uint32_t d;
  asm volatile("movmatrix.sync.aligned.m8n8.trans.b16 %0, %1;\n"
               : "=r"(d) : "r"(a));
  return d;
}

// d += a * b on one m16n8k16 tile.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t bf162_bits(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

// Two f32 values as a bf16 pair (x in the low half), rounded to nearest,
// and the pair of what that rounding left over, rounded again: hi + lo
// carries x and y to about 16 significant bits.
__device__ __forceinline__ void split_bf16(float x, float y, uint32_t& hi,
                                           uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  hi = bf162_bits(h);
  lo = bf162_bits(__floats2bfloat162_rn(x - __low2float(h),
                                        y - __high2float(h)));
}

// The same in three parts: hi + mid + lo carries x and y to within about
// 2^-24 of their size, which is f32's own precision.
__device__ __forceinline__ void split3_bf16(float x, float y, uint32_t& hi,
                                            uint32_t& mid, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  const float rx = x - __low2float(h);
  const float ry = y - __high2float(h);
  const __nv_bfloat162 m = __floats2bfloat162_rn(rx, ry);
  hi = bf162_bits(h);
  mid = bf162_bits(m);
  lo = bf162_bits(__floats2bfloat162_rn(rx - __low2float(m),
                                        ry - __high2float(m)));
}

}  // namespace rt
