// Grouped (per-expert) matmul for Hopper (sm_90a), CUDA C++.
//
// Replaces: src/repro/kernels/moe_gmm.py::gmm (the Pallas TPU kernel).
// Contract: src/repro/kernels/ref.py::gmm_ref —
//   out[e] = x[e] @ w[e],  x (E,C,D), w (E,D,F), out (E,C,F) in x's type,
//   summed in float32.  The capacity buffers of the sort-based MoE
//   (models/moe.py): every expert's problem has the same shape.
//
// What bounds it on an H100: at granite-moe-3b-a800m's shapes (E = 40,
// D = 1536 -> F = 512 and back) the weights are 62.9 MB per call.  At the
// 3072-token source prefill (C = 768) the call moves ~189 MB for 48 GFLOP:
// bytes and operations are within 15% of each other.  At the memory LLM
// (C = 128) and at decode (C = 8) it is bound by reading the weights.
//
// Design: the TPU kernel walks (E, C, F, D) in order, accumulating over D
// in a VMEM scratch tile.  Here every (F tile, C tile, expert) is its own
// thread block (grid (ceil(F/128), ceil(C/64), E)) that loops over D in
// 32-deep slabs and keeps the sum in registers:
//   * bfloat16: tensor cores (mma.sync m16n8k16, f32 accumulate), four
//     warps of 32 x 64 outputs, ldmatrix from padded shared tiles, two
//     shared-memory stages filled by cp.async so the next slab loads while
//     this one multiplies.  A slab's rows and columns past C, D or F are
//     zero-filled.  Operands are copied 8 elements (16 bytes) at a time
//     when the row length is a multiple of 8 and the base 16-byte aligned,
//     else element by element.
//   * float32: CUDA cores (64 x 64 x 16 block tiles, 4 x 4 outputs per
//     thread), so a float32 check on the card runs without TF32.
// At decode (C = 8) a 64-row tile computes 56 rows of zeros; the call is
// bound by the weights anyway.  A few-row variant is later work.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cstdint>

#include "mma_sm80.cuh"

namespace {

using bf16 = __nv_bfloat16;
using mma_sm80::ldsm_x4;
using mma_sm80::ldsm_x4_t;
using mma_sm80::mma16816;
using mma_sm80::smem_addr;

// ---- float32: CUDA cores ------------------------------------------------

constexpr int NT = 256;                  // threads of a float32 block
constexpr int TM = 64, TN = 64, TK = 16;  // float32 block tile

// out[e] = x[e] @ w[e] for e = blockIdx.z, float32 throughout.
__global__ void __launch_bounds__(NT)
gmm_f32(const float* __restrict__ x, const float* __restrict__ w,
        float* __restrict__ out, int C, int D, int F) {
  __shared__ __align__(16) float As[TK][TM + 4];
  __shared__ __align__(16) float Bs[TK][TN + 4];
  const size_t e = blockIdx.z;
  x += e * C * static_cast<size_t>(D);
  w += e * D * static_cast<size_t>(F);
  out += e * C * static_cast<size_t>(F);
  const int m0 = blockIdx.y * TM, n0 = blockIdx.x * TN;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  float acc[4][4] = {};

  for (int k0 = 0; k0 < D; k0 += TK) {
#pragma unroll 1
    for (int i = threadIdx.x; i < TM * TK; i += NT) {
      const int mm = i / TK, kk = i % TK;
      const int gm = m0 + mm, gk = k0 + kk;
      As[kk][mm] = (gm < C && gk < D) ? x[static_cast<size_t>(gm) * D + gk] : 0.f;
    }
#pragma unroll 1
    for (int i = threadIdx.x; i < TN * TK; i += NT) {
      const int nn = i % TN, kk = i / TN;
      const int gn = n0 + nn, gk = k0 + kk;
      Bs[kk][nn] = (gn < F && gk < D) ? w[static_cast<size_t>(gk) * F + gn] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < TK; ++kk) {
      const float4 a = *reinterpret_cast<const float4*>(&As[kk][ty * 4]);
      const float4 b = *reinterpret_cast<const float4*>(&Bs[kk][tx * 4]);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] += av[i] * bv[j];
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int gm = m0 + ty * 4 + i;
    if (gm >= C) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int gn = n0 + tx * 4 + j;
      if (gn < F) out[static_cast<size_t>(gm) * F + gn] = acc[i][j];
    }
  }
}

// ---- bfloat16: tensor cores ---------------------------------------------

constexpr int MB = 64, NB = 128, KB = 32, MNT = 128;  // block tile, threads
constexpr int SKP = KB + 8;  // padded row of the x tile (80 bytes)
constexpr int SNP = NB + 8;  // padded row of the w tile (272 bytes)

// 16 bytes global -> shared, asynchronously; src_bytes = 0 zero-fills.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
// Wait until at most one group of this thread's copies is in flight.
__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}

// Eight consecutive elements of a row of length `len` from `row` (elements
// [col, col + 8)), into shared memory at `dst`, zero past `len` or when the
// row itself is out of range.  `vec`: the row length is a multiple of 8 and
// the base is 16-byte aligned, so one asynchronous 16-byte copy serves.
__device__ __forceinline__ void load8(bf16* dst, const bf16* base,
                                      const bf16* row, bool row_ok, int col,
                                      int len, bool vec) {
  if (vec) {
    const bool ok = row_ok && col < len;
    cp_async16(dst, ok ? static_cast<const void*>(row + col)
                       : static_cast<const void*>(base), ok ? 16 : 0);
    return;
  }
#pragma unroll
  for (int i = 0; i < 8; ++i)
    dst[i] = (row_ok && col + i < len) ? row[col + i] : __float2bfloat16_rn(0.f);
}

// out[e] = x[e] @ w[e] for e = blockIdx.z: bf16 in, f32 accumulate, bf16
// out.  x[e] is C x D and w[e] D x F, both row-major.
__global__ void __launch_bounds__(MNT)
gmm_bf16(const bf16* __restrict__ x, const bf16* __restrict__ w,
         bf16* __restrict__ out, int C, int D, int F, bool vec_x, bool vec_w) {
  __shared__ __align__(16) bf16 As[2][MB * SKP];
  __shared__ __align__(16) bf16 Bs[2][KB * SNP];
  const size_t e = blockIdx.z;
  const bf16* xe = x + e * C * static_cast<size_t>(D);
  const bf16* we = w + e * D * static_cast<size_t>(F);
  out += e * C * static_cast<size_t>(F);
  const int m0 = blockIdx.y * MB, n0 = blockIdx.x * NB;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int wm = (warp / 2) * 32, wn = (warp % 2) * 64;  // warp's 32 x 64
  float acc[2][8][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[i][j][q] = 0.f;

  // stage s <- the D slab starting at k0: x rows m0.., w columns n0..
  auto load_slab = [&](int s, int k0) {
    for (int i = threadIdx.x; i < MB * KB / 8; i += MNT) {
      const int r = i / (KB / 8), c = (i % (KB / 8)) * 8;
      const int gm = m0 + r;
      load8(&As[s][r * SKP + c], xe, xe + static_cast<size_t>(gm) * D,
            gm < C, k0 + c, D, vec_x);
    }
    for (int i = threadIdx.x; i < KB * NB / 8; i += MNT) {
      const int r = i / (NB / 8), c = (i % (NB / 8)) * 8;
      const int gk = k0 + r;
      load8(&Bs[s][r * SNP + c], we, we + static_cast<size_t>(gk) * F,
            gk < D, n0 + c, F, vec_w);
    }
  };

  const int nk = (D + KB - 1) / KB;
  load_slab(0, 0);
  cp_async_commit();
  for (int kt = 0; kt < nk; ++kt) {
    const int s = kt & 1;
    if (kt + 1 < nk) load_slab(s ^ 1, (kt + 1) * KB);
    cp_async_commit();  // possibly empty: keeps the group count in step
    cp_async_wait_one();  // slab kt has landed
    __syncthreads();
    const bf16* as = As[s];
    const bf16* bs = Bs[s];
#pragma unroll
    for (int kk = 0; kk < KB; kk += 16) {
      uint32_t af[2][4];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
        ldsm_x4(af[mi], &as[(wm + mi * 16 + lane % 16) * SKP + kk + (lane / 16) * 8]);
#pragma unroll
      for (int nj = 0; nj < 4; ++nj) {
        uint32_t bfr[4];
        ldsm_x4_t(bfr, &bs[(kk + lane % 8 + ((lane / 8) % 2) * 8) * SNP
                           + wn + nj * 16 + (lane / 16) * 8]);
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) {
          mma16816(acc[mi][2 * nj], af[mi], bfr[0], bfr[1]);
          mma16816(acc[mi][2 * nj + 1], af[mi], bfr[2], bfr[3]);
        }
      }
    }
    __syncthreads();  // stage s is refilled in the next iteration
  }
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 8; ++ni)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int gm = m0 + wm + mi * 16 + lane / 4 + h * 8;
        const int gn = n0 + wn + ni * 8 + (lane % 4) * 2;
        if (gm >= C) continue;
        bf16* row = out + static_cast<size_t>(gm) * F;
        if (gn < F) row[gn] = __float2bfloat16_rn(acc[mi][ni][2 * h]);
        if (gn + 1 < F) row[gn + 1] = __float2bfloat16_rn(acc[mi][ni][2 * h + 1]);
      }
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

}  // namespace

// out = per-expert x @ w: x (E,C,D), w (E,D,F), out (E,C,F), contiguous.
// dtype: 0 = float32, 1 = bfloat16.  Returns a cudaError_t (0 = launched).
extern "C" int moe_gmm_fwd(const void* x, const void* w, void* out, int E,
                           int C, int D, int F, int dtype, void* stream) {
  if (E < 0 || C < 0 || D <= 0 || F < 0) return cudaErrorInvalidValue;
  if (E == 0 || C == 0 || F == 0) return cudaSuccess;
  if (E > 65535 || (C + TM - 1) / TM > 65535) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    const dim3 grid((F + TN - 1) / TN, (C + TM - 1) / TM, E);
    gmm_f32<<<grid, NT, 0, st>>>(static_cast<const float*>(x),
                                 static_cast<const float*>(w),
                                 static_cast<float*>(out), C, D, F);
    return cudaGetLastError();
  }
  if (dtype == 1) {
    const dim3 grid((F + NB - 1) / NB, (C + MB - 1) / MB, E);
    gmm_bf16<<<grid, MNT, 0, st>>>(
        static_cast<const bf16*>(x), static_cast<const bf16*>(w),
        static_cast<bf16*>(out), C, D, F, D % 8 == 0 && aligned16(x),
        F % 8 == 0 && aligned16(w));
    return cudaGetLastError();
  }
  return cudaErrorInvalidValue;
}
