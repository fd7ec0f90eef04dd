// Tensor-core and asynchronous-copy helpers for bf16 kernels (sm_80 and
// later; the port builds for sm_90a): cp.async copies into shared memory,
// ldmatrix fragment loads, the m16n8k16 bf16 mma with f32 accumulation,
// and the tile copies that the flash kernels (flash_fwd.cu, flash_bwd.cu)
// share: 128-thread blocks of 4 warps, bf16 tiles in shared memory with
// rows padded by 16 bytes.
//
// Fragment layouts of mma.m16n8k16 (lane = 4 * g + t, g = lane / 4,
// t = lane % 4):
//   A (16 x 16, 4 regs of 2 bf16): a0 = (row g, cols 2t, 2t+1),
//     a1 = (row g + 8, cols 2t..), a2 = (row g, cols 8 + 2t..),
//     a3 = (row g + 8, cols 8 + 2t..);
//   B (16 x 8, 2 regs): b0 = (rows 2t, 2t+1, col g), b1 = (rows 8 + 2t..);
//   C (16 x 8, 4 f32): c0, c1 = (row g, cols 2t, 2t+1), c2, c3 = (row
//     g + 8, cols 2t, 2t+1).
// So the C fragments of two neighbouring 8-column tiles, rounded to bf16
// and packed in pairs, are the A fragment of one 16-wide k step: a
// product's result feeds the next product from registers.
//
// The ldmatrix offsets below (in elements, for a row-major shared tile
// with `ld` elements per row) give, per lane, the row address of an
// ldmatrix.x4 that loads:
//   a_offset   — one A fragment, 16 rows x 16 columns;
//   b_offset   — B fragments of two 8-column tiles from a tile stored
//                with the product's n index on its rows (k contiguous);
//   (.trans at a_offset) — B fragments of two 8-column tiles from a tile
//                stored with the k index on its rows (n contiguous).

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace tc {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, bypassing L1. With `valid` false nothing is
// read and the 16 bytes are zero-filled.
__device__ __forceinline__ void cp_async_16(uint32_t dst, const void* src,
                                            bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

// 4 bytes global -> shared; zero-filled when `valid` is false.
__device__ __forceinline__ void cp_async_4(uint32_t dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// c += a * b on the tensor cores: 16 x 16 bf16 by 16 x 8 bf16 into 16 x 8
// f32.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two f32 values rounded to bf16 (nearest even), `lo` in the low half.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// The A fragment of k step `kk` from the C fragments of a row of 8-column
// tiles (tiles 2 kk and 2 kk + 1), rounded to bf16.
template <int N>
__device__ __forceinline__ void c_to_a(uint32_t (&a)[4], const float (&c)[N][4],
                                       int kk) {
  a[0] = pack_bf16(c[2 * kk][0], c[2 * kk][1]);
  a[1] = pack_bf16(c[2 * kk][2], c[2 * kk][3]);
  a[2] = pack_bf16(c[2 * kk + 1][0], c[2 * kk + 1][1]);
  a[3] = pack_bf16(c[2 * kk + 1][2], c[2 * kk + 1][3]);
}

__device__ __forceinline__ int a_offset(int lane, int ld) {
  return (lane % 16) * ld + (lane / 16) * 8;
}

__device__ __forceinline__ int b_offset(int lane, int ld) {
  return ((lane % 8) + (lane / 16) * 8) * ld + ((lane / 8) % 2) * 8;
}

// ---------------------------------------------------------------------------
// Tiles of the flash kernels
// ---------------------------------------------------------------------------

using bf16 = __nv_bfloat16;

constexpr int TC_THREADS = 128;  // 4 warps
constexpr int BLOCK_ROWS = 64;   // output rows of a block: q rows or keys
constexpr int PAD = 8;           // bf16 of padding per shared-memory row
constexpr float LOG2E = 1.4426950408889634f;

// Round an f32 value to bf16 and back.
__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

// Rows [r0, r0 + ROWS) of one head of a [.., S, heads, D] bf16 tensor into
// a [ROWS][D + PAD] shared tile: 16-byte cp.async copies, neighbouring
// threads on neighbouring 16 bytes of a row; rows at or past n are
// zero-filled.
template <int D, int ROWS>
__device__ __forceinline__ void load_rows_async(bf16* dst, const bf16* head,
                                                int64_t row_stride, int64_t r0,
                                                int64_t n) {
  constexpr int CPR = D / 8;  // 16-byte pieces per row
  static_assert(ROWS * CPR % TC_THREADS == 0, "whole pieces per thread");
  const uint32_t base = smem_addr(dst);
#pragma unroll
  for (int j = 0; j < ROWS * CPR / TC_THREADS; ++j) {
    const int i = threadIdx.x + j * TC_THREADS;
    const int r = i / CPR, c = i % CPR;
    const bool valid = r0 + r < n;
    const bf16* src = valid ? head + (r0 + r) * row_stride + c * 8 : head;
    cp_async_16(base + 2 * (r * (D + PAD) + c * 8), src, valid);
  }
}

// Multiply the pieces of a tile that this thread copied with
// load_rows_async by `scale` and round to bf16: the TPU kernels' q *
// sm_scale in q's dtype. The thread's copies must have landed.
template <int D, int ROWS>
__device__ __forceinline__ void scale_rows(bf16* tile, float scale) {
  constexpr int CPR = D / 8;
#pragma unroll
  for (int j = 0; j < ROWS * CPR / TC_THREADS; ++j) {
    const int i = threadIdx.x + j * TC_THREADS;
    uint4* piece =
        reinterpret_cast<uint4*>(tile + (i / CPR) * (D + PAD) + (i % CPR) * 8);
    uint4 v = *piece;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&v);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float2 f = __bfloat1622float2(h[e]);
      h[e] = __floats2bfloat162_rn(f.x * scale, f.y * scale);
    }
    *piece = v;
  }
}

}  // namespace tc
