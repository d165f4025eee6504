// Warpgroup tensor-core helpers for Hopper (sm_90a), shared by the kernels
// under csrc/: shared-memory matrix descriptors for the 128-byte swizzle,
// the bf16 wgmma.mma_async m64n64k16 with f32 accumulate (A from shared
// memory or from registers) and its m64n32k16 / m64n96k16 / m64n128k16 /
// m64n192k16 / m64n256k16 forms (A from shared memory, K-major or
// MN-major), the fences and group waits around them, cp.async into the
// swizzled layout, the slab ring of the persistent
// wgmma kernels (slab_ring), an accumulator row's 16-byte bf16 pieces
// (row8_bf16) and the once-a-device shared-memory attribute (with_smem).
//
// Shared-memory layout (the one the descriptors below describe): a tile is
// cut into 64-column chunks of bf16 (128 bytes a row); a chunk of R rows
// holds row r at byte r*128, and its 16-byte piece j (columns 8j..8j+7) at
// piece position j ^ (r % 8).  Chunks start 1024-byte aligned.  Read with
// rows as M/N and columns as K this is the K-major operand; read with
// rows as K and columns as M/N it is the MN-major operand (transpose bit
// set), so a V tile stored row by row feeds O += P V unchanged, and so
// does a row-major (K, M) tile as A of A^T B (the MN-major A of the
// memcom_xattn backward's dK = dS^T Q).
//
// Accumulator fragment of m64nN (f32, thread t of the warpgroup, w = t/32,
// g = (t%32)/4, q = t%4): d[4n+0..1] = (row 16w+g, cols 8n+2q, 8n+2q+1),
// d[4n+2..3] = (row 16w+g+8, same cols).  The A fragment of the register
// form (bf16, m64k16) is a0 = (16w+g, 2q..2q+1), a1 = (16w+g+8, 2q..),
// a2 = (16w+g, 8+2q..), a3 = (16w+g+8, 8+2q..): the accumulator of a
// product turns into the A operand of the next without moving between
// threads (pack d[8k..8k+7] pairwise for k-step k).

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cstdint>

#include "mma_sm80.cuh"  // smem_addr, pack_bf16

namespace wgmma_sm90 {

using mma_sm80::pack_bf16;
using mma_sm80::smem_addr;

// Byte offset of 16-byte piece `piece` (0..7) of row `row` in a chunk.
__device__ __forceinline__ uint32_t sw128(int row, int piece) {
  return static_cast<uint32_t>(row * 128 + ((piece ^ (row & 7)) << 4));
}

// Descriptor of a 128B-swizzled operand at shared address `addr`:
// lbo / sbo in bytes (the stride between 64-column chunks along MN for an
// MN-major operand wider than 64; the stride between 8-row groups).
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo,
                                         uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4)
       | static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16
       | static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32
       | static_cast<uint64_t>(1) << 62;  // 128-byte swizzle
}

__device__ __forceinline__ void fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Generic-proxy writes to shared memory (st.shared, cp.async) made visible
// to wgmma's reads (the async proxy); call before the barrier.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
// Pins registers that an issued wgmma reads or writes: reads of an
// accumulator stay after the wait, and an A operand's registers are not
// reused before it.
__device__ __forceinline__ void reg_fence(float (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
__device__ __forceinline__ void reg_fence(uint32_t (&a)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) asm volatile("" : "+r"(a[i])::"memory");
}

#define WGMMA_D32                                                          \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "  \
  "%30, %31}"
#define WGMMA_OUT32(d)                                                     \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),  \
  "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),             \
  "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),         \
  "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),         \
  "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),         \
  "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),         \
  "+f"(d[31])

// d (+)= A B for a 64 x 64 x 16 tile, A and B in shared memory (A
// K-major, or MN-major with TA = 1; B K-major, or MN-major with TB = 1).
// accumulate = 0 ignores d.
template <int TB, int TA = 0>
__device__ __forceinline__ void mma_ss(float (&d)[32], uint64_t da,
                                       uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " WGMMA_D32
      ", %32, %33, p, 1, 1, %36, %35;\n}\n"
      : WGMMA_OUT32(d)
      : "l"(da), "l"(db), "r"(accumulate), "n"(TB), "n"(TA));
}

// The same with A (64 x 16 bf16) from registers, in the fragment above.
template <int TB>
__device__ __forceinline__ void mma_rs(float (&d)[32], const uint32_t (&a)[4],
                                       uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " WGMMA_D32
      ", {%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
      : WGMMA_OUT32(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(accumulate), "n"(TB));
}

#define WGMMA_D16                                                          \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}"
#define WGMMA_OUT16(d)                                                     \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),  \
  "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),             \
  "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])

// The narrow form of mma_ss: d (+)= A B for a 64 x 32 x 16 tile (d: 16
// floats a thread, the accumulator fragment above with n = 0..3).
template <int TB, int TA = 0>
__device__ __forceinline__ void mma_ss32(float (&d)[16], uint64_t da,
                                         uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 " WGMMA_D16
      ", %16, %17, p, 1, 1, %20, %19;\n}\n"
      : WGMMA_OUT16(d)
      : "l"(da), "l"(db), "r"(accumulate), "n"(TB), "n"(TA));
}

#define WGMMA_D48 \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, " \
  "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, " \
  "%44, %45, %46, %47}"
#define WGMMA_OUT48(d) \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), \
  "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), \
  "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), \
  "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), \
  "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), \
  "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), \
  "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), \
  "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), \
  "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), \
  "+f"(d[46]), "+f"(d[47])
#define WGMMA_D64 \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, " \
  "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, " \
  "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, " \
  "%58, %59, %60, %61, %62, %63}"
#define WGMMA_OUT64(d) \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), \
  "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), \
  "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), \
  "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), \
  "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), \
  "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), \
  "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), \
  "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), \
  "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), \
  "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), \
  "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), \
  "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), \
  "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
#define WGMMA_D128 \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, " \
  "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, " \
  "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, " \
  "%58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, " \
  "%72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, " \
  "%86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, %98, %99, " \
  "%100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, " \
  "%111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, " \
  "%122, %123, %124, %125, %126, %127}"
#define WGMMA_OUT128(d) \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), \
  "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), \
  "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), \
  "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), \
  "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), \
  "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), \
  "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), \
  "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), \
  "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), \
  "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), \
  "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), \
  "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), \
  "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), \
  "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), \
  "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), \
  "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]), \
  "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), \
  "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]), \
  "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), \
  "+f"(d[95]), "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), \
  "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), "+f"(d[104]), \
  "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), \
  "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), \
  "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]), \
  "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), \
  "+f"(d[125]), "+f"(d[126]), "+f"(d[127])

#define WGMMA_D96 \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, " \
  "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, " \
  "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, " \
  "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, " \
  "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, " \
  "%67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, " \
  "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, " \
  "%93, %94, %95}"
#define WGMMA_OUT96(d) \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), \
  "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), \
  "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), \
  "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), \
  "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), \
  "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), \
  "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), \
  "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), \
  "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), \
  "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), \
  "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), \
  "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), \
  "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]), \
  "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), \
  "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), \
  "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), \
  "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), \
  "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), \
  "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95])
// The wider forms of mma_ss: d (+)= A B for a 64 x 96 x 16 tile (d: 48
// floats a thread), a 64 x 128 x 16 tile (64 floats), a 64 x 192 x 16
// tile (96 floats) and a 64 x 256 x 16 tile (128 floats), in the
// accumulator fragment above with n = 0..11, 0..15, 0..23 or 0..31.  An
// MN-major B wider than 64 columns is a row of 64-column chunks, lbo bytes
// apart.
// An MN-major A (TA = 1: the 64 rows of M run along a chunk's columns, its
// rows are K) is one such chunk.
template <int TB, int TA = 0>
__device__ __forceinline__ void mma_ss96(float (&d)[48], uint64_t da,
                                         uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %50, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 " WGMMA_D48
      ", %48, %49, p, 1, 1, %52, %51;\n}\n"
      : WGMMA_OUT48(d)
      : "l"(da), "l"(db), "r"(accumulate), "n"(TB), "n"(TA));
}
template <int TB, int TA = 0>
__device__ __forceinline__ void mma_ss128(float (&d)[64], uint64_t da,
                                          uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " WGMMA_D64
      ", %64, %65, p, 1, 1, %68, %67;\n}\n"
      : WGMMA_OUT64(d)
      : "l"(da), "l"(db), "r"(accumulate), "n"(TB), "n"(TA));
}
template <int TB, int TA = 0>
__device__ __forceinline__ void mma_ss192(float (&d)[96], uint64_t da,
                                          uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %98, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 " WGMMA_D96
      ", %96, %97, p, 1, 1, %100, %99;\n}\n"
      : WGMMA_OUT96(d)
      : "l"(da), "l"(db), "r"(accumulate), "n"(TB), "n"(TA));
}
template <int TB, int TA = 0>
__device__ __forceinline__ void mma_ss256(float (&d)[128], uint64_t da,
                                          uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 " WGMMA_D128
      ", %128, %129, p, 1, 1, %132, %131;\n}\n"
      : WGMMA_OUT128(d)
      : "l"(da), "l"(db), "r"(accumulate), "n"(TB), "n"(TA));
}
// mma_ss at N = 96, 128, 192 or 256 columns.
template <int N, int TB, int TA = 0>
__device__ __forceinline__ void mma_ss_n(float (&d)[N / 2], uint64_t da,
                                         uint64_t db, int accumulate) {
  static_assert(N == 96 || N == 128 || N == 192 || N == 256,
                "wgmma N: 96, 128, 192 or 256");
  if constexpr (N == 96) mma_ss96<TB, TA>(d, da, db, accumulate);
  else if constexpr (N == 128) mma_ss128<TB, TA>(d, da, db, accumulate);
  else if constexpr (N == 192) mma_ss192<TB, TA>(d, da, db, accumulate);
  else mma_ss256<TB, TA>(d, da, db, accumulate);
}
template <int N>
__device__ __forceinline__ void reg_fence(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

#undef WGMMA_D16
#undef WGMMA_OUT16
#undef WGMMA_D32
#undef WGMMA_OUT32
#undef WGMMA_D48
#undef WGMMA_OUT48
#undef WGMMA_D64
#undef WGMMA_OUT64
#undef WGMMA_D96
#undef WGMMA_OUT96
#undef WGMMA_D128
#undef WGMMA_OUT128

// 16 bytes global -> shared, asynchronously; valid = false writes zeros
// (src is not read, but must be a mapped address).
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// The slab ring of the persistent wgmma kernels (moe_gmm.cu's gmm_wgmma
// and gmm_bwd_wgmma, memcom_xattn.cu's xattn_logits_wgmma and
// xattn_out_wgmma).  A block
// walks the 64-deep contraction slabs of its `tiles` output tiles, `nk`
// slabs a tile, as one stream through a ring of STAGES shared-memory
// stages filled by cp.async: STAGES - 2 slabs load beyond the current one,
// one barrier a slab, and one wgmma group stays in flight across the
// barrier, so the load of slab i + STAGES - 2 goes into the stage of slab
// i - 2, which every warpgroup has retired by then; the next tile's first
// slabs load while this tile's last ones multiply and it is stored.
// ring_prime issues the first STAGES - 2 slabs; ring_walk the rest.  The
// caller's functions:
//   issue(stage)    load the caller's cursor's slab into `stage`; the
//                   cursor moves on (it runs over all tiles * nk slabs);
//   land(stage, kt) this thread's copies of slab kt of the tile have
//                   landed; runs before the barrier that shows every
//                   thread's copies to the warpgroups' wgmma;
//   mma(stage, kt)  issue the slab's products on the accumulators (kt == 0
//                   starts a tile: its accumulators are zero, or its first
//                   k-step does not accumulate);
//   pin()           reg_fence on the accumulators;
//   finish(t)       tile t's products are complete: store it.
template <int STAGES, typename Issue>
__device__ __forceinline__ void ring_prime(int total, Issue&& issue) {
  static_assert(STAGES >= 3, "one wgmma group in flight needs 3 stages");
#pragma unroll
  for (int s = 0; s < STAGES - 2; ++s) {
    if (s < total) issue(s);
    cp_async_commit();
  }
}
template <int STAGES, typename Issue, typename Land, typename Mma,
          typename Pin, typename Finish>
__device__ __forceinline__ void ring_walk(int tiles, int nk, Issue&& issue,
                                          Land&& land, Mma&& mma, Pin&& pin,
                                          Finish&& finish) {
  constexpr int AHEAD = STAGES - 2;
  const int total = tiles * nk;
  for (int t = 0, q = 0; t < tiles; ++t) {
    for (int kt = 0; kt < nk; ++kt, ++q) {
      const int stage = q % STAGES;
      cp_async_wait<AHEAD - 1>();  // slab q has landed (this thread's part)
      land(stage, kt);
      fence_proxy_async();
      // ... and every thread's; every warpgroup has also retired slab
      // q - 2, whose stage the next load overwrites
      __syncthreads();
      if (q + AHEAD < total) issue((q + AHEAD) % STAGES);
      cp_async_commit();  // possibly empty: keeps the group count in step
      pin();
      fence();
      mma(stage, kt);
      commit();
      wait<1>();  // slab q - 1's products are done
      pin();
    }
    wait<0>();
    pin();
    finish(t);
  }
  cp_async_wait<0>();  // no copy outlives the block
}

// Row 16 warp + lane / 4 + 8h, columns 8 (4j + q) .. + 7 (q = lane % 4) of
// an accumulator fragment (N / 2 floats a thread, the layout above),
// rounded to bf16 as one 16-byte piece: the quad trades its pairs by
// shuffles (member q sends its pair for n = 4j + (q - r) and receives
// member (q + r)'s pair for n = 4j + q).  Every lane of the warp calls it,
// with j known at compile time.
template <int NF>
__device__ __forceinline__ uint4 row8_bf16(const float (&d)[NF], int h,
                                           int j, int lane) {
  const int q = lane % 4;
  uint32_t v[4], got[4] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int i = 0; i < 4; ++i)
    v[i] = pack_bf16(d[4 * (4 * j + i) + 2 * h], d[4 * (4 * j + i) + 2 * h + 1]);
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int to = (q - r) & 3, from = (q + r) & 3;
    const uint32_t send = to == 0 ? v[0] : to == 1 ? v[1]
                        : to == 2 ? v[2] : v[3];
    const uint32_t recv = __shfl_sync(0xffffffffu, send, (lane & ~3) | from);
#pragma unroll
    for (int k = 0; k < 4; ++k)
      if (k == from) got[k] = recv;
  }
  return make_uint4(got[0], got[1], got[2], got[3]);
}

// Lets `kernel` take `smem` bytes of dynamic shared memory on the current
// device (*dev), once a device and process: bit d of `ready` records
// device d (the attribute call per launch is host time).
template <typename Kernel>
cudaError_t with_smem(Kernel kernel, size_t smem, unsigned& ready, int* dev) {
  cudaError_t err = cudaGetDevice(dev);
  if (err != cudaSuccess) return err;
  const unsigned bit = *dev < 32 ? 1u << *dev : 0u;
  if (ready & bit) return cudaSuccess;
  err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err == cudaSuccess) ready |= bit;
  return err;
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}
__device__ __forceinline__ float tanh_approx(float x) {
  float y;
  asm("tanh.approx.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

}  // namespace wgmma_sm90
