// MemCom 1-head cross-attention for Hopper (sm_90a), CUDA C++.
//
// Replaces: src/repro/kernels/memcom_xattn.py::memcom_xattn (the Pallas TPU
// kernel).  Contract: src/repro/kernels/ref.py::memcom_xattn_ref —
//   O = softmax(scale * Q K^T) V,  Q (B,M,D), K = V shape (B,T,D), no mask,
//   one head of width D = d_model; out (B,M,D) in Q's type.
//
// What bounds it on an H100: at gemma2-2b's compress shape (M = 512,
// T = 3072, D = 2304) the two products are 2*2*M*T*D = 14.5 GFLOP against
// ~33 MB of bf16 operands, so it is bound by operations (the tensor cores).
//
// Design: the TPU kernel keeps a (bm, D) f32 accumulator and the Q tile
// resident across the T sweep.  At D = 2304 and bm = 64 that accumulator
// alone is 590 KB, far above the 227 KB of shared memory one H100 block may
// use, so D is tiled on both sides and the softmax is split out:
//   1. logits: S = scale * Q K^T, a tiled (M x T, contraction D) product
//      written to an f32 workspace (B,M,Tp), Tp = T rounded up to 8;
//   2. rows:   one block per row turns S into P = softmax(S);
//   3. output: O = P V, a tiled (M x D, contraction T) product.
// bfloat16 runs both products on the tensor cores (mma.sync m16n8k16, f32
// accumulate, ldmatrix from padded shared tiles; 64 x 128 x 32 block
// tiles, four warps of 32 x 64), with P stored in bf16 for the second
// product.  It takes D % 8 == 0.  Its workspace is 6*B*M*Tp bytes (9.4 MB
// at the shape above): S written once and read once, P written once and
// read once per 128-column tile of O.  float32 runs the same three passes
// on the CUDA cores (one 64x64x16 shared-memory tiled kernel, 4x4 outputs
// per thread) so that it matches the float32 reference to 1e-4; its
// workspace is 4*B*M*T bytes, P overwriting S.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cstdint>

#include "mma_sm80.cuh"

namespace {

using bf16 = __nv_bfloat16;
using mma_sm80::ldsm_x4;
using mma_sm80::ldsm_x4_t;
using mma_sm80::mma16816;
constexpr int NT = 256;  // threads of the softmax and float32 GEMM blocks
constexpr unsigned FULL = 0xffffffffu;

// ---- float32: CUDA-core products, softmax -------------------------------

constexpr int TM = 64, TN = 64, TK = 16;  // float32 GEMM block tile

// C[m][n] = alpha * sum_k A[m][k] * B(k, n), per batch (blockIdx.z), in
// float32 on the CUDA cores.  A is row-major M x K.  B(k, n) = Bm[n*K + k]
// when BT (B stored N x K), else Bm[k*N + n] (B stored K x N).  C is
// row-major M x N.
template <bool BT>
__global__ void __launch_bounds__(NT)
gemm_f32(const float* __restrict__ A, const float* __restrict__ Bm,
         float* __restrict__ C, int M, int N, int K, float alpha,
         long long sA, long long sB, long long sC) {
  __shared__ __align__(16) float As[TK][TM + 4];
  __shared__ __align__(16) float Bs[TK][TN + 4];
  A += blockIdx.z * sA;
  Bm += blockIdx.z * sB;
  C += blockIdx.z * sC;
  const int m0 = blockIdx.y * TM, n0 = blockIdx.x * TN;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  float acc[4][4] = {};

  for (int k0 = 0; k0 < K; k0 += TK) {
#pragma unroll 1  // staging loops stay rolled: unrolled, they spill
    for (int e = threadIdx.x; e < TM * TK; e += NT) {
      const int mm = e / TK, kk = e % TK;
      const int gm = m0 + mm, gk = k0 + kk;
      As[kk][mm] = (gm < M && gk < K) ? A[static_cast<size_t>(gm) * K + gk] : 0.f;
    }
#pragma unroll 1
    for (int e = threadIdx.x; e < TN * TK; e += NT) {
      const int nn = BT ? e / TK : e % TN, kk = BT ? e % TK : e / TN;
      const int gn = n0 + nn, gk = k0 + kk;
      const size_t at = BT ? static_cast<size_t>(gn) * K + gk
                           : static_cast<size_t>(gk) * N + gn;
      Bs[kk][nn] = (gn < N && gk < K) ? Bm[at] : 0.f;
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
    if (gm >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int gn = n0 + tx * 4 + j;
      if (gn < N) C[static_cast<size_t>(gm) * N + gn] = alpha * acc[i][j];
    }
  }
}

__device__ float block_reduce(float x, bool is_max) {
  __shared__ float part[NT / 32];
  for (int o = 16; o > 0; o >>= 1) {
    const float y = __shfl_xor_sync(FULL, x, o);
    x = is_max ? fmaxf(x, y) : x + y;
  }
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  __syncthreads();  // `part` may still be read from the previous reduction
  if (lane == 0) part[warp] = x;
  __syncthreads();
  x = part[0];
  for (int w = 1; w < NT / 32; ++w) x = is_max ? fmaxf(x, part[w]) : x + part[w];
  return x;
}

// One block per row of S (B*M rows of length T): S <- softmax(S) in place.
__global__ void __launch_bounds__(NT) softmax_rows(float* __restrict__ S, int T) {
  float* row = S + static_cast<size_t>(blockIdx.x) * T;
  float mx = -1e30f;
  for (int t = threadIdx.x; t < T; t += NT) mx = fmaxf(mx, row[t]);
  mx = block_reduce(mx, true);
  float sum = 0.f;
  for (int t = threadIdx.x; t < T; t += NT) sum += expf(row[t] - mx);
  sum = block_reduce(sum, false);
  for (int t = threadIdx.x; t < T; t += NT) row[t] = expf(row[t] - mx) / sum;
}


// ---- bfloat16: tensor-core products -------------------------------------

constexpr int MB = 64, NB = 128, KB = 32, MNT = 128;  // block tile, threads
constexpr int SKP = KB + 8;   // padded row of a k-contiguous tile (80 bytes)
constexpr int SNP = NB + 8;   // padded row of an n-contiguous tile (272 bytes)

__device__ __forceinline__ void put(float* p, float x) { *p = x; }
__device__ __forceinline__ void put(bf16* p, float x) { *p = __float2bfloat16_rn(x); }

// C[m][n] = alpha * sum_k A[m][k] * B(k, n), per batch (blockIdx.z), bf16
// in, f32 accumulate.  A is M x K row-major with row stride lda.  B(k, n)
// = Bm[n*ldb + k] when BT (stored N x K), else Bm[k*ldb + n] (K x N).  C is
// M x N with row stride ldc.  Operands are read 8 elements at a time along
// their contiguous axis: every stride is a multiple of 8, K is one too when
// BT (else A's rows run on into zero padding up to lda) and N when not BT;
// tiles past M, N or K are zero-filled.
template <bool BT, typename TC>
__global__ void __launch_bounds__(MNT)
gemm_tc(const bf16* __restrict__ A, const bf16* __restrict__ Bm,
        TC* __restrict__ C, int M, int N, int K, float alpha, int lda,
        int ldb, int ldc, long long sA, long long sB, long long sC) {
  __shared__ __align__(16) bf16 As[MB * SKP];
  __shared__ __align__(16) bf16 Bs[BT ? NB * SKP : KB * SNP];
  A += blockIdx.z * sA;
  Bm += blockIdx.z * sB;
  C += blockIdx.z * sC;
  const int m0 = blockIdx.y * MB, n0 = blockIdx.x * NB;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int wm = (warp / 2) * 32, wn = (warp % 2) * 64;  // warp's 32 x 64
  const uint4 zero = make_uint4(0, 0, 0, 0);
  float acc[2][8][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  for (int k0 = 0; k0 < K; k0 += KB) {
    for (int e = threadIdx.x; e < MB * KB / 8; e += MNT) {
      const int r = e / (KB / 8), c = (e % (KB / 8)) * 8;
      const int gm = m0 + r, gk = k0 + c;
      *reinterpret_cast<uint4*>(&As[r * SKP + c]) =
          (gm < M && gk < K)
              ? *reinterpret_cast<const uint4*>(A + static_cast<size_t>(gm) * lda + gk)
              : zero;
    }
    if (BT) {
      for (int e = threadIdx.x; e < NB * KB / 8; e += MNT) {
        const int r = e / (KB / 8), c = (e % (KB / 8)) * 8;
        const int gn = n0 + r, gk = k0 + c;
        *reinterpret_cast<uint4*>(&Bs[r * SKP + c]) =
            (gn < N && gk < K)
                ? *reinterpret_cast<const uint4*>(Bm + static_cast<size_t>(gn) * ldb + gk)
                : zero;
      }
    } else {
      for (int e = threadIdx.x; e < KB * NB / 8; e += MNT) {
        const int r = e / (NB / 8), c = (e % (NB / 8)) * 8;
        const int gk = k0 + r, gn = n0 + c;
        *reinterpret_cast<uint4*>(&Bs[r * SNP + c]) =
            (gk < K && gn < N)
                ? *reinterpret_cast<const uint4*>(Bm + static_cast<size_t>(gk) * ldb + gn)
                : zero;
      }
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < KB; kk += 16) {
      uint32_t af[2][4];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
        ldsm_x4(af[mi], &As[(wm + mi * 16 + lane % 16) * SKP + kk + (lane / 16) * 8]);
#pragma unroll
      for (int nj = 0; nj < 4; ++nj) {
        uint32_t bfr[4];
        if (BT)
          ldsm_x4(bfr, &Bs[(wn + nj * 16 + lane % 8 + (lane / 16) * 8) * SKP
                           + kk + ((lane / 8) % 2) * 8]);
        else
          ldsm_x4_t(bfr, &Bs[(kk + lane % 8 + ((lane / 8) % 2) * 8) * SNP
                             + wn + nj * 16 + (lane / 16) * 8]);
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) {
          mma16816(acc[mi][2 * nj], af[mi], bfr[0], bfr[1]);
          mma16816(acc[mi][2 * nj + 1], af[mi], bfr[2], bfr[3]);
        }
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 8; ++ni)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int gm = m0 + wm + mi * 16 + lane / 4 + h * 8;
        const int gn = n0 + wn + ni * 8 + (lane % 4) * 2;
        if (gm >= M) continue;
        TC* row = C + static_cast<size_t>(gm) * ldc;
        if (gn < N) put(row + gn, alpha * acc[mi][ni][2 * h]);
        if (gn + 1 < N) put(row + gn + 1, alpha * acc[mi][ni][2 * h + 1]);
      }
}

// One block per row: P[:T] = softmax(S[:T]) in bf16, P[T:Tp] = 0.
__global__ void __launch_bounds__(NT)
softmax_rows_bf16(const float* __restrict__ S, bf16* __restrict__ P, int T,
                  int Tp) {
  const float* row = S + static_cast<size_t>(blockIdx.x) * Tp;
  bf16* prow = P + static_cast<size_t>(blockIdx.x) * Tp;
  float mx = -1e30f;
  for (int t = threadIdx.x; t < T; t += NT) mx = fmaxf(mx, row[t]);
  mx = block_reduce(mx, true);
  float sum = 0.f;
  for (int t = threadIdx.x; t < T; t += NT) sum += expf(row[t] - mx);
  sum = block_reduce(sum, false);
  for (int t = threadIdx.x; t < Tp; t += NT)
    prow[t] = __float2bfloat16_rn(t < T ? expf(row[t] - mx) / sum : 0.f);
}

int run_bf16(const bf16* q, const bf16* k, const bf16* v, bf16* out,
             float* ws, int B, int M, int Tn, int D, float scale,
             cudaStream_t stream) {
  const int Tp = (Tn + 7) / 8 * 8;
  float* S = ws;
  bf16* P = reinterpret_cast<bf16*>(ws + static_cast<size_t>(B) * M * Tp);
  const dim3 g1((Tn + NB - 1) / NB, (M + MB - 1) / MB, B);
  gemm_tc<true, float><<<g1, MNT, 0, stream>>>(
      q, k, S, M, Tn, D, scale, D, D, Tp, static_cast<long long>(M) * D,
      static_cast<long long>(Tn) * D, static_cast<long long>(M) * Tp);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  softmax_rows_bf16<<<B * M, NT, 0, stream>>>(S, P, Tn, Tp);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const dim3 g3((D + NB - 1) / NB, (M + MB - 1) / MB, B);
  gemm_tc<false, bf16><<<g3, MNT, 0, stream>>>(
      P, v, out, M, D, Tn, 1.f, Tp, D, D, static_cast<long long>(M) * Tp,
      static_cast<long long>(Tn) * D, static_cast<long long>(M) * D);
  return cudaGetLastError();
}

int run_f32(const float* q, const float* k, const float* v, float* out,
            float* ws, int B, int M, int Tn, int D, float scale,
            cudaStream_t stream) {
  const dim3 g1((Tn + TN - 1) / TN, (M + TM - 1) / TM, B);
  gemm_f32<true><<<g1, NT, 0, stream>>>(
      q, k, ws, M, Tn, D, scale,
      static_cast<long long>(M) * D, static_cast<long long>(Tn) * D,
      static_cast<long long>(M) * Tn);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  softmax_rows<<<B * M, NT, 0, stream>>>(ws, Tn);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const dim3 g3((D + TN - 1) / TN, (M + TM - 1) / TM, B);
  gemm_f32<false><<<g3, NT, 0, stream>>>(
      ws, v, out, M, D, Tn, 1.f,
      static_cast<long long>(M) * Tn, static_cast<long long>(Tn) * D,
      static_cast<long long>(M) * D);
  return cudaGetLastError();
}

}  // namespace

// Bytes of the workspace memcom_xattn_fwd needs (see the note above).
extern "C" long long memcom_xattn_workspace_bytes(int B, int M, int T,
                                                  int dtype) {
  if (dtype == 1) return 6LL * B * M * ((T + 7) / 8 * 8);
  return 4LL * B * M * T;
}

// ws: memcom_xattn_workspace_bytes(B, M, T, dtype) bytes, 16-byte aligned.
// dtype: 0 = float32, 1 = bfloat16 (D % 8 == 0).  Returns a cudaError_t
// (0 = launched).
extern "C" int memcom_xattn_fwd(const void* q, const void* k, const void* v,
                                void* out, float* ws, int B, int M, int T,
                                int D, float scale, int dtype, void* stream) {
  if (B < 0 || M < 0 || T <= 0 || D <= 0) return cudaErrorInvalidValue;
  if (B == 0 || M == 0) return cudaSuccess;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return run_f32(static_cast<const float*>(q), static_cast<const float*>(k),
                   static_cast<const float*>(v), static_cast<float*>(out), ws,
                   B, M, T, D, scale, st);
  if (dtype == 1 && D % 8 == 0)
    return run_bf16(static_cast<const bf16*>(q), static_cast<const bf16*>(k),
                    static_cast<const bf16*>(v), static_cast<bf16*>(out), ws,
                    B, M, T, D, scale, st);
  return cudaErrorInvalidValue;
}
