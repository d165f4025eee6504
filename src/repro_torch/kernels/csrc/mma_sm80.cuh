// Warp-level tensor-core helpers shared by the kernels under csrc/:
// ldmatrix from shared memory and the bf16 m16n8k16 mma.sync with f32
// accumulate (Ampere's instructions, which Hopper runs as they are; wgmma is
// the later step).
//
// Fragment layouts (lane = threadIdx.x % 32, g = lane / 4, t = lane % 4):
//   A 16x16 (row):  a0 = (g, 2t..2t+1), a1 = (g+8, 2t..), a2 = (g, 8+2t..),
//                   a3 = (g+8, 8+2t..)
//   B 16x8  (col):  b0 = (k 2t..2t+1, n g), b1 = (k 8+2t.., n g)
//   C 16x8  (f32):  c0,c1 = (g, 2t..2t+1), c2,c3 = (g+8, 2t..2t+1)
// so the accumulator of S = Q K^T turns into the A operand of P V without
// moving between lanes.

#pragma once

#include <cuda_bf16.h>
#include <cstdint>

namespace mma_sm80 {

using bf16 = __nv_bfloat16;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Four 8x8 b16 matrices; lanes 8i..8i+7 give the row addresses of matrix i,
// and register i of every lane receives its part of matrix i.
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// The same, each matrix transposed on the way.
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// c += a * b for one 16x8x16 tile.
__device__ __forceinline__ void mma16816(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two floats as one bf16x2 register, x in the low half.
__device__ __forceinline__ uint32_t pack_bf16(float x, float y) {
  __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  return *reinterpret_cast<uint32_t*>(&h);
}

}  // namespace mma_sm80
