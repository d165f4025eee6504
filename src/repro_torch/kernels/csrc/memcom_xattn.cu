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
// Why two products: the TPU kernel keeps a (bm, D) f32 accumulator and the
// Q tile resident across the T sweep.  At D = 2304 and bm = 64 that
// accumulator alone is 590 KB, more than the 256 KB register file of an
// SM, so D is tiled on both sides and the softmax sits between a logits
// product (contraction D) and an output product (contraction T).  Three
// variants (kernels/memcom_xattn.py::variant_for picks one):
//
// * "wgmma" (bf16, D % 64 == 0, 16-byte aligned q/k/v; any T up to
//   WGMMA_MAX_T): two kernels on wgmma, the softmax folded into them.
//   1. xattn_logits_wgmma: S = scale Q K^T in (64 LG_NWG) x LG_BN tiles
//      (128 x 128), Q and K both K-major (row-major in D) in the 128-byte
//      swizzle, 64-deep D slabs through the slab ring of wgmma_sm90.cuh on
//      a persistent grid.  Columns at or past T are -inf (the TPU kernel's
//      col < t_total).  Its epilogue is the softmax's first half: for each
//      row of the tile it writes m_j (the tile's row maximum), l_j = sum
//      exp(S - m_j) in float32 from the unrounded values, and P~ =
//      exp(S - m_j) rounded to bf16 (every value in (0, 1]).
//   2. xattn_out_wgmma: O = sum_j diag(c_j) P~_j V_j with c_j =
//      exp(m_j - m_row) / l_row, m_row = max_j m_j, l_row = sum_j
//      exp(m_j - m_row) l_j, and c_j = 0 where m_j lies 100 or more below
//      m_row (no ratio of two tiles' scales is formed: nothing overflows).
//      A block owns a (64 OUT_NWG) x OUT_BN tile of O (128 x 256) and one
//      of `nsplit` stretches of T: it reduces its rows' (m_j, l_j) to c_j
//      in shared memory while its first slabs load, then walks its stretch
//      in 64-deep slabs through the slab ring — P~ the K-major A operand,
//      V the MN-major B operand (row by row, transpose bit set) — and
//      scales each landed A slab in shared memory by its rows' c_j (each
//      thread its own cp.async pieces, rounded to bf16 again) before the
//      barrier that shows it to wgmma.  So P is rounded to bf16 twice: P~,
//      then c_j P~.  (A from registers, ldmatrix and scaled there, with no
//      group in flight, was 5-10% slower: PERF.md section 6.)
//      The tile leaves through shared memory in short loops (the fully
//      unrolled per-fragment epilogue cost microseconds a block): every
//      block stores its partial tile into its idle ring; the nsplit blocks
//      of a tile are one thread block cluster, and after a cluster barrier
//      each adds the nsplit partials of its share of the rows, in split
//      order, from its own and its peers' shared memory, and stores them:
//      deterministic, no atomics, no workspace.
//   The output kernel also stores each row's lse = m_row + ln l_row (one
//   block of each row tile), which the backward reads; the other variants'
//   row kernels store theirs likewise.
//   Workspace: P~ (B,M,Tp) bf16, Tp = T rounded up to 8, zero in columns
//   T..Tp, then the (m_j, l_j) pairs (B, ceil(T/LG_BN), M) float2: 3.2 MB
//   at the shape above (9.4 MB for "mma_sync").
//   Split rule (the wrapper's num_splits): as many splits as keep one wave
//   of output blocks (one an SM) up to FILL_SPLITS, and at least as many
//   as keep a split within SPLIT_SLABS_MAX slabs (its c_j fit the CT_MAX
//   table); at most MAX_SPLITS (a portable cluster).  The tiles and the
//   rule are set from device times (scripts/xattn_times.py, PERF.md
//   section 6): gemma2-2b's 36 output tiles take 3 splits, granite's 24
//   take 4, mistral-7b's 96 take the 2 its 6144 tokens need.
// * "mma_sync" (bf16, D % 8 == 0): three launches through an f32
//   workspace:
//   1. logits: S = scale * Q K^T, a tiled (M x T, contraction D) product
//      written to an f32 workspace (B,M,Tp), Tp = T rounded up to 8;
//   2. rows:   one block per row turns S into P = softmax(S);
//   3. output: O = P V, a tiled (M x D, contraction T) product.
//   Both products on mma.sync m16n8k16 (f32 accumulate, ldmatrix from
//   padded shared tiles; 64 x 128 x 32 block tiles, four warps of 32 x
//   64), P stored in bf16 for the second.  Workspace 6*B*M*Tp bytes: S
//   written once and read once, P written once and read once per
//   128-column tile of O.
// * float32: the same three passes on the CUDA cores (one 64x64x16
//   shared-memory tiled kernel, 4x4 outputs per thread) so that it
//   matches the float32 reference to 1e-4; its workspace is 4*B*M*T
//   bytes, P overwriting S.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cmath>
#include <cstdint>

#include "mma_sm80.cuh"
#include "wgmma_sm90.cuh"

namespace {

using bf16 = __nv_bfloat16;
using mma_sm80::ldsm_x4;
using mma_sm80::ldsm_x4_t;
using mma_sm80::mma16816;
constexpr int NT = 256;  // threads of the softmax and float32 GEMM blocks
constexpr unsigned FULL = 0xffffffffu;

// ---- float32: CUDA-core products, softmax -------------------------------

constexpr int TM = 64, TN = 64, TK = 16;  // float32 GEMM block tile

// C[m][n] = alpha * sum_k A(m, k) * B(k, n), per batch (blockIdx.z), in
// float32 on the CUDA cores.  A(m, k) = A[k*M + m] when AT (A stored K x
// M: the backward's dS^T and P^T), else A[m*K + k] (row-major M x K).
// B(k, n) = Bm[n*K + k] when BT (B stored N x K), else Bm[k*N + n] (B
// stored K x N).  C is row-major M x N.
template <bool AT, bool BT>
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
      const size_t at = AT ? static_cast<size_t>(gk) * M + gm
                           : static_cast<size_t>(gm) * K + gk;
      As[kk][mm] = (gm < M && gk < K) ? A[at] : 0.f;
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

// One block per row of S (B*M rows of length T): S <- softmax(S) in place;
// lse (may be null) <- the row's logsumexp.
__global__ void __launch_bounds__(NT)
softmax_rows(float* __restrict__ S, float* __restrict__ lse, int T) {
  float* row = S + static_cast<size_t>(blockIdx.x) * T;
  float mx = -1e30f;
  for (int t = threadIdx.x; t < T; t += NT) mx = fmaxf(mx, row[t]);
  mx = block_reduce(mx, true);
  float sum = 0.f;
  for (int t = threadIdx.x; t < T; t += NT) sum += expf(row[t] - mx);
  sum = block_reduce(sum, false);
  if (lse != nullptr && threadIdx.x == 0) lse[blockIdx.x] = mx + logf(sum);
  for (int t = threadIdx.x; t < T; t += NT) row[t] = expf(row[t] - mx) / sum;
}


// ---- bfloat16: tensor-core products -------------------------------------

constexpr int MB = 64, NB = 128, KB = 32, MNT = 128;  // block tile, threads
constexpr int SKP = KB + 8;   // padded row of a k-contiguous tile (80 bytes)
constexpr int SNP = NB + 8;   // padded row of an n-contiguous tile (272 bytes)
constexpr int SMP = MB + 8;   // padded row of an m-contiguous A tile (144 bytes)

__device__ __forceinline__ void put(float* p, float x) { *p = x; }
__device__ __forceinline__ void put(bf16* p, float x) { *p = __float2bfloat16_rn(x); }

// C[m][n] = alpha * sum_k A(m, k) * B(k, n), per batch (blockIdx.z), bf16
// in, f32 accumulate.  A(m, k) = A[m*lda + k] (M x K row-major), or, when
// AT, A[k*lda + m] (stored K x M: the backward's dS^T Q and P^T dO; the
// tile is staged m-contiguous and ldmatrix transposes it).  B(k, n) =
// Bm[n*ldb + k] when BT (stored N x K), else Bm[k*ldb + n] (K x N).  C is
// M x N with row stride ldc.  Operands are read 8 elements at a time along
// their contiguous axis: every stride is a multiple of 8, K is one too when
// BT (else A's rows run on into zero padding up to lda), M when AT (or the
// rows of A run on into zero padding up to lda) and N when not BT; tiles
// past M, N or K are zero-filled.
template <bool AT, bool BT, typename TC>
__global__ void __launch_bounds__(MNT)
gemm_tc(const bf16* __restrict__ A, const bf16* __restrict__ Bm,
        TC* __restrict__ C, int M, int N, int K, float alpha, int lda,
        int ldb, int ldc, long long sA, long long sB, long long sC) {
  static_assert(KB * SMP <= MB * SKP, "the transposed A tile fits As");
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
    if (AT) {
      for (int e = threadIdx.x; e < KB * MB / 8; e += MNT) {
        const int r = e / (MB / 8), c = (e % (MB / 8)) * 8;
        const int gk = k0 + r, gm = m0 + c;
        *reinterpret_cast<uint4*>(&As[r * SMP + c]) =
            (gk < K && gm < M)
                ? *reinterpret_cast<const uint4*>(A + static_cast<size_t>(gk) * lda + gm)
                : zero;
      }
    } else {
      for (int e = threadIdx.x; e < MB * KB / 8; e += MNT) {
        const int r = e / (KB / 8), c = (e % (KB / 8)) * 8;
        const int gm = m0 + r, gk = k0 + c;
        *reinterpret_cast<uint4*>(&As[r * SKP + c]) =
            (gm < M && gk < K)
                ? *reinterpret_cast<const uint4*>(A + static_cast<size_t>(gm) * lda + gk)
                : zero;
      }
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
      for (int mi = 0; mi < 2; ++mi) {
        if (AT)  // matrices (m 0-7 | 8-15) x (k 0-7 | 8-15), k-major rows
          ldsm_x4_t(af[mi], &As[(kk + lane % 8 + (lane / 16) * 8) * SMP + wm
                                + mi * 16 + ((lane / 8) % 2) * 8]);
        else
          ldsm_x4(af[mi], &As[(wm + mi * 16 + lane % 16) * SKP + kk + (lane / 16) * 8]);
      }
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

// One block per row: P[:T] = softmax(S[:T]) in bf16, P[T:Tp] = 0; lse
// (may be null) <- the row's logsumexp.
__global__ void __launch_bounds__(NT)
softmax_rows_bf16(const float* __restrict__ S, bf16* __restrict__ P,
                  float* __restrict__ lse, int T, int Tp) {
  const float* row = S + static_cast<size_t>(blockIdx.x) * Tp;
  bf16* prow = P + static_cast<size_t>(blockIdx.x) * Tp;
  float mx = -1e30f;
  for (int t = threadIdx.x; t < T; t += NT) mx = fmaxf(mx, row[t]);
  mx = block_reduce(mx, true);
  float sum = 0.f;
  for (int t = threadIdx.x; t < T; t += NT) sum += expf(row[t] - mx);
  sum = block_reduce(sum, false);
  if (lse != nullptr && threadIdx.x == 0) lse[blockIdx.x] = mx + logf(sum);
  for (int t = threadIdx.x; t < Tp; t += NT)
    prow[t] = __float2bfloat16_rn(t < T ? expf(row[t] - mx) / sum : 0.f);
}

int run_bf16(const bf16* q, const bf16* k, const bf16* v, bf16* out,
             float* lse, float* ws, int B, int M, int Tn, int D, float scale,
             cudaStream_t stream) {
  const int Tp = (Tn + 7) / 8 * 8;
  float* S = ws;
  bf16* P = reinterpret_cast<bf16*>(ws + static_cast<size_t>(B) * M * Tp);
  const dim3 g1((Tn + NB - 1) / NB, (M + MB - 1) / MB, B);
  gemm_tc<false, true, float><<<g1, MNT, 0, stream>>>(
      q, k, S, M, Tn, D, scale, D, D, Tp, static_cast<long long>(M) * D,
      static_cast<long long>(Tn) * D, static_cast<long long>(M) * Tp);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  softmax_rows_bf16<<<B * M, NT, 0, stream>>>(S, P, lse, Tn, Tp);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const dim3 g3((D + NB - 1) / NB, (M + MB - 1) / MB, B);
  gemm_tc<false, false, bf16><<<g3, MNT, 0, stream>>>(
      P, v, out, M, D, Tn, 1.f, Tp, D, D, static_cast<long long>(M) * Tp,
      static_cast<long long>(Tn) * D, static_cast<long long>(M) * D);
  return cudaGetLastError();
}

int run_f32(const float* q, const float* k, const float* v, float* out,
            float* lse, float* ws, int B, int M, int Tn, int D, float scale,
            cudaStream_t stream) {
  const dim3 g1((Tn + TN - 1) / TN, (M + TM - 1) / TM, B);
  gemm_f32<false, true><<<g1, NT, 0, stream>>>(
      q, k, ws, M, Tn, D, scale,
      static_cast<long long>(M) * D, static_cast<long long>(Tn) * D,
      static_cast<long long>(M) * Tn);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  softmax_rows<<<B * M, NT, 0, stream>>>(ws, lse, Tn);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const dim3 g3((D + TN - 1) / TN, (M + TM - 1) / TM, B);
  gemm_f32<false, false><<<g3, NT, 0, stream>>>(
      ws, v, out, M, D, Tn, 1.f,
      static_cast<long long>(M) * Tn, static_cast<long long>(Tn) * D,
      static_cast<long long>(M) * D);
  return cudaGetLastError();
}

// ---- backward: dq, dk, dv ---------------------------------------------------
//
// Contract: kernels/plain.py::memcom_xattn_bwd_ref — P = softmax(scale Q
// K^T), dP = dO V^T, dS = P o (dP - rowsum(P o dP)), dQ = scale dS K, dK =
// scale dS^T Q, dV = P^T dO.  What bounds it on an H100: 5 * 2 M T D flops
// against q, k, v, dO and the three gradients once each: operations at the
// compress shapes (7.25e10 flops, 0.073 ms, at 2x512 x 3072 x 2304).
// Three variants (kernels/memcom_xattn.py::bwd_variant_for picks one):
// * "wgmma" (bf16, D % 64 == 0, 16-byte aligned inputs; any T): three
//   launches, from the forward's out and lse (B, M) float32:
//   1. xattn_bwd_dot: D_i = rowsum(dO o O) in float32, a warp a row (the
//      identity rowsum(P o dP) = dO . sum_t P_t V_t = rowsum(dO o O); O is
//      the forward's bf16 output).
//   2. xattn_bwd_sdp_wgmma: S = Q K^T and dP = dO V^T on 128 x 96 tiles
//      of (M, T) (wgmma m64n96k16), 64-deep D slabs through the slab ring
//      on a persistent grid, both products in one group a slab from one
//      ring stage of four slabs (56 KB; 4 stages).  The forward logits
//      kernel's 128 x 128 tiles made 1.45 waves of the card at gemma2-2b's
//      training shape (192 tiles, one block an SM: the two accumulators
//      hold 96 registers a thread) and left room for 3 stages; 96 columns
//      make 1.94 waves (256 tiles) with 4 stages, 0.0989 -> 0.0682 ms
//      (PERF.md section 6).  Its epilogue forms P = exp(scale S - lse) and
//      dS = P o (dP - D_i) in float32 from the unrounded accumulators and
//      stores both rounded to bf16: the float32 S and dP never reach
//      memory.
//   3. xattn_bwd_grad_wgmma: one launch of 128 x 256 gradient tiles on
//      wgmma m64n256k16 through a 4-stage slab ring, B read MN-major (K,
//      Q, dO stored row by row), one block a tile (the hardware dispatches
//      them in index order: heaviest first).  dQ tiles first: rows of M,
//      A = dS K-major, contraction T split bwd_num_splits ways across a
//      thread block cluster whose blocks add their partial tiles from each
//      other's shared memory in split order (tile_out, the forward output
//      kernel's epilogue).  Then dK and dV tiles: rows of T, contraction M
//      (8 slabs at M = 512), A = dS^T or P^T read straight from the (M,
//      Tp) workspace as an MN-major A operand (transpose-A bit).  The
//      scale is applied as a tile leaves.  Split rule (the wrapper's
//      bwd_num_splits): the fewest splits, at most GRAD_MAX_SPLITS, that
//      keep a dQ split's slabs within the mean slabs a block of the card
//      walks (one block an SM), so that no dQ block outlasts the rest:
//      gemma2-2b's and mistral-7b's training shapes take 1, granite's 2.
//   Workspace: P and dS (B, M, Tp) bf16 (zero in columns T..Tp) and D_i (B,
//   M) float32: 4 B M Tp + 4 B M bytes (12.6 MB at 2x512 x 3072).  No
//   atomics: a call is deterministic.
// * "mma_sync" (bf16, D % 8 == 0): five products and a row pass, each
//   product one launch of gemm_tc above on mma.sync: S and dP (contraction
//   D) into float32, softmax_bwd_rows_bf16 (P and dS in bf16), then dQ
//   (contraction T) and dK, dV (contraction M, A transposed: the AT case).
//   Six launches; workspace S and dP in float32 and P and dS in bf16
//   ((B, M, Tp) each, zero in columns T..Tp): 12 B M Tp bytes.
// * float32: the same on the CUDA cores (gemm_f32, softmax_bwd_rows; P in
//   S's place and dS in dP's: 8 B M T bytes).

// float32: one block per row; S <- P = softmax(S), dP <- dS = P o (dP -
// rowsum(P o dP)), in place.
__global__ void __launch_bounds__(NT)
softmax_bwd_rows(float* __restrict__ S, float* __restrict__ dP, int T) {
  float* srow = S + static_cast<size_t>(blockIdx.x) * T;
  float* drow = dP + static_cast<size_t>(blockIdx.x) * T;
  float mx = -1e30f;
  for (int t = threadIdx.x; t < T; t += NT) mx = fmaxf(mx, srow[t]);
  mx = block_reduce(mx, true);
  float sum = 0.f;
  for (int t = threadIdx.x; t < T; t += NT) sum += expf(srow[t] - mx);
  sum = block_reduce(sum, false);
  float r = 0.f;
  for (int t = threadIdx.x; t < T; t += NT) {
    const float p = expf(srow[t] - mx) / sum;
    srow[t] = p;
    r += p * drow[t];
  }
  r = block_reduce(r, false);
  for (int t = threadIdx.x; t < T; t += NT) drow[t] = srow[t] * (drow[t] - r);
}

// bf16: one block per row of S and dP (row stride Tp, float32); writes P
// and dS in bf16 (row stride Tp, 0 in columns T..Tp).
__global__ void __launch_bounds__(NT)
softmax_bwd_rows_bf16(const float* __restrict__ S, const float* __restrict__ dP,
                      bf16* __restrict__ P, bf16* __restrict__ dS, int T,
                      int Tp) {
  const size_t off = static_cast<size_t>(blockIdx.x) * Tp;
  const float* srow = S + off;
  const float* drow = dP + off;
  float mx = -1e30f;
  for (int t = threadIdx.x; t < T; t += NT) mx = fmaxf(mx, srow[t]);
  mx = block_reduce(mx, true);
  float sum = 0.f;
  for (int t = threadIdx.x; t < T; t += NT) sum += expf(srow[t] - mx);
  sum = block_reduce(sum, false);
  const float inv = 1.f / sum;
  float r = 0.f;
  for (int t = threadIdx.x; t < T; t += NT) r += expf(srow[t] - mx) * inv * drow[t];
  r = block_reduce(r, false);
  for (int t = threadIdx.x; t < Tp; t += NT) {
    const float p = t < T ? expf(srow[t] - mx) * inv : 0.f;
    P[off + t] = __float2bfloat16_rn(p);
    dS[off + t] = __float2bfloat16_rn(t < T ? p * (drow[t] - r) : 0.f);
  }
}

int run_bwd_bf16(const bf16* q, const bf16* k, const bf16* v, const bf16* dout,
                 bf16* dq, bf16* dk, bf16* dv, float* ws, int B, int M,
                 int Tn, int D, float scale, cudaStream_t st) {
  const int Tp = (Tn + 7) / 8 * 8;
  const size_t n = static_cast<size_t>(B) * M * Tp;
  float* S = ws;
  float* dP = S + n;
  bf16* P = reinterpret_cast<bf16*>(dP + n);
  bf16* dS = P + n;
  const long long sMD = static_cast<long long>(M) * D;
  const long long sTD = static_cast<long long>(Tn) * D;
  const long long sMT = static_cast<long long>(M) * Tp;
  const dim3 gs((Tn + NB - 1) / NB, (M + MB - 1) / MB, B);
  gemm_tc<false, true, float><<<gs, MNT, 0, st>>>(
      q, k, S, M, Tn, D, scale, D, D, Tp, sMD, sTD, sMT);
  gemm_tc<false, true, float><<<gs, MNT, 0, st>>>(
      dout, v, dP, M, Tn, D, 1.f, D, D, Tp, sMD, sTD, sMT);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  softmax_bwd_rows_bf16<<<B * M, NT, 0, st>>>(S, dP, P, dS, Tn, Tp);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const dim3 gq((D + NB - 1) / NB, (M + MB - 1) / MB, B);
  gemm_tc<false, false, bf16><<<gq, MNT, 0, st>>>(
      dS, k, dq, M, D, Tn, scale, Tp, D, D, sMT, sTD, sMD);
  const dim3 gk((D + NB - 1) / NB, (Tn + MB - 1) / MB, B);
  gemm_tc<true, false, bf16><<<gk, MNT, 0, st>>>(
      dS, q, dk, Tn, D, M, scale, Tp, D, D, sMT, sMD, sTD);
  gemm_tc<true, false, bf16><<<gk, MNT, 0, st>>>(
      P, dout, dv, Tn, D, M, 1.f, Tp, D, D, sMT, sMD, sTD);
  return cudaGetLastError();
}

int run_bwd_f32(const float* q, const float* k, const float* v,
                const float* dout, float* dq, float* dk, float* dv, float* ws,
                int B, int M, int Tn, int D, float scale, cudaStream_t st) {
  const size_t n = static_cast<size_t>(B) * M * Tn;
  float* S = ws;
  float* dP = S + n;
  const long long sMD = static_cast<long long>(M) * D;
  const long long sTD = static_cast<long long>(Tn) * D;
  const long long sMT = static_cast<long long>(M) * Tn;
  const dim3 gs((Tn + TN - 1) / TN, (M + TM - 1) / TM, B);
  gemm_f32<false, true><<<gs, NT, 0, st>>>(q, k, S, M, Tn, D, scale, sMD,
                                           sTD, sMT);
  gemm_f32<false, true><<<gs, NT, 0, st>>>(dout, v, dP, M, Tn, D, 1.f, sMD,
                                           sTD, sMT);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  softmax_bwd_rows<<<B * M, NT, 0, st>>>(S, dP, Tn);  // S <- P, dP <- dS
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const dim3 gq((D + TN - 1) / TN, (M + TM - 1) / TM, B);
  gemm_f32<false, false><<<gq, NT, 0, st>>>(dP, k, dq, M, D, Tn, scale, sMT,
                                            sTD, sMD);
  const dim3 gk((D + TN - 1) / TN, (Tn + TM - 1) / TM, B);
  gemm_f32<true, false><<<gk, NT, 0, st>>>(dP, q, dk, Tn, D, M, scale, sMT,
                                           sMD, sTD);
  gemm_f32<true, false><<<gk, NT, 0, st>>>(S, dout, dv, Tn, D, M, 1.f, sMT,
                                           sMD, sTD);
  return cudaGetLastError();
}

// ---- bfloat16 on wgmma: the "wgmma" variant -------------------------------

// The tiles: (64 LG_NWG) x LG_BN logits tiles through LG_STAGES ring
// stages, (64 OUT_NWG) x OUT_BN output tiles through OUT_STAGES.
constexpr int LG_BN = 128;      // columns of a logits tile: one (m_j, l_j)
constexpr int LG_NWG = 2;
constexpr int LG_STAGES = 4;
constexpr int OUT_NWG = 2;
constexpr int OUT_BN = 256;
constexpr int OUT_STAGES = 4;
constexpr int MAX_SPLITS = 8;   // splits of T a tile: a portable cluster
constexpr int FILL_SPLITS = 4;  // splits that only fill the card, at most
constexpr int CT_MAX = 32;      // c_j a block holds for each of its rows
// The most 64-deep slabs of T one split walks: its slabs touch at most
// ceil(slabs / (LG_BN / 64)) + 1 <= CT_MAX logits tiles.
constexpr int SPLIT_SLABS_MAX = (CT_MAX - 1) * (LG_BN / 64);
constexpr float C_CUT = 100.f;  // m_row - m_j at which c_j is 0
constexpr float LOG2E = 1.4426950408889634f, LN2 = 0.6931471805599453f;

template <int NWG, int BN, bool OUT>
struct XCfg {
  static constexpr int STAGES = OUT ? OUT_STAGES : LG_STAGES;  // slab ring
  static constexpr int NT = 128 * NWG, BM = 64 * NWG;
  static constexpr int A_BYTES = NWG * 8192;        // BM rows x 64
  static constexpr int B_BYTES = BN * 128;          // K: BN x 64; V: 64 x BN
  static constexpr int STAGE = A_BYTES + B_BYTES;
  static constexpr int RING = STAGES * STAGE;
  static constexpr int C_BYTES = OUT ? BM * CT_MAX * 4 : 0;  // c_j table
  static constexpr size_t SMEM = 1024 + RING + C_BYTES;  // + 1024-B align
  static constexpr int MINB = 2 * SMEM <= 232448 - 2048 ? 2 : 1;  // an SM
  static_assert(BN % 64 == 0 && BN <= 256, "wgmma N: 64-column chunks");
  static_assert(!OUT || BM * (BN + 4) * 4 <= RING, "the tile leaves by the ring");
};


// S = scale Q K^T for the tiles (b, row tile, column tile) of a persistent
// grid; epilogue: P~ and (m_j, l_j) as the note above says.
template <int NWG, int BN>
__global__ void __launch_bounds__(XCfg<NWG, BN, false>::NT,
                                  XCfg<NWG, BN, false>::MINB)
xattn_logits_wgmma(const bf16* __restrict__ q, const bf16* __restrict__ k,
                   bf16* __restrict__ P, float2* __restrict__ ml, int M,
                   int Tn, int Tp, int D, float scale_log2, int tiles_m,
                   int tiles_n, int tiles) {
  namespace wg = wgmma_sm90;
  using K = XCfg<NWG, BN, false>;
  constexpr int NT = K::NT, BM = K::BM, STAGES = K::STAGES;
  extern __shared__ unsigned char smem_lg[];
  const uint32_t raw = wg::smem_addr(smem_lg);
  const uint32_t base = (raw + 1023u) & ~1023u;  // swizzle atoms: 1024 B
  const int tid = threadIdx.x, lane = tid % 32, warp = (tid % 128) / 32;
  const int grp = tid / 128;  // this thread's warpgroup
  const int nk = D / 64;
  const int mine = blockIdx.x < tiles ? (tiles - 1 - blockIdx.x) / gridDim.x + 1
                                      : 0;

  struct Tile {
    int b, m0, nt;
  };
  auto tile_of = [&](int t) {  // this block's t-th tile
    const int T_ = blockIdx.x + t * gridDim.x;
    const int r = T_ / tiles_n;
    return Tile{r / tiles_m, (r % tiles_m) * BM, T_ % tiles_n};
  };

  // This thread's share of a slab: Q rows rx + i NT/8 and K rows rx + i
  // NT/8, 16-byte piece px of the slab's 64 columns.
  constexpr int QI = BM * 8 / NT, KI = BN * 8 / NT;
  const int px = tid % 8, rx = tid / 8;
  const size_t step = static_cast<size_t>(NT / 8) * D;
  int c_t = 0, c_kt = 0;  // the load cursor: slab c_kt of tile c_t
  const bf16* c_q = q;
  const bf16* c_k = k;
  uint32_t c_qrows = 0, c_krows = 0;  // bit i: row i is below M / T
  auto enter = [&](int t) {
    const Tile tl = tile_of(t);
    const int n0 = tl.nt * BN;
    c_q = q + (static_cast<size_t>(tl.b) * M + tl.m0 + rx) * D + px * 8;
    c_k = k + (static_cast<size_t>(tl.b) * Tn + n0 + rx) * D + px * 8;
    c_qrows = c_krows = 0;
#pragma unroll
    for (int i = 0; i < QI; ++i)
      c_qrows |= static_cast<uint32_t>(tl.m0 + rx + i * (NT / 8) < M) << i;
#pragma unroll
    for (int i = 0; i < KI; ++i)
      c_krows |= static_cast<uint32_t>(n0 + rx + i * (NT / 8) < Tn) << i;
  };
  auto issue = [&](int s) {
    const int k0 = c_kt * 64;
    const uint32_t sA = base + s * K::STAGE, sB = sA + K::A_BYTES;
#pragma unroll
    for (int i = 0; i < QI; ++i) {
      const int r = rx + i * (NT / 8);
      const bool ok = c_qrows >> i & 1u;
      wg::cp_async16(sA + (r / 64) * 8192 + wg::sw128(r % 64, px),
                     ok ? c_q + i * step + k0 : q, ok);
    }
#pragma unroll
    for (int i = 0; i < KI; ++i) {
      const bool ok = c_krows >> i & 1u;
      wg::cp_async16(sB + wg::sw128(rx + i * (NT / 8), px),
                     ok ? c_k + i * step + k0 : k, ok);
    }
    if (++c_kt == nk) {
      c_kt = 0;
      if (++c_t < mine) enter(c_t);
    }
  };

  float acc[BN / 2];
#pragma unroll
  for (int j = 0; j < BN / 2; ++j) acc[j] = 0.f;
  // the softmax's first half on the accumulators (fragment layout of
  // wgmma_sm90.cuh), then P~ in 16-byte rows and (m_j, l_j)
  auto finish = [&](int t) {
    const Tile tl = tile_of(t);
    const int n0 = tl.nt * BN, q4 = lane % 4;
    float mt[2] = {-INFINITY, -INFINITY}, lt[2] = {0.f, 0.f};
#pragma unroll
    for (int n = 0; n < BN / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool ok = n0 + 8 * n + 2 * q4 + e % 2 < Tn;
        const float x = ok ? acc[4 * n + e] * scale_log2 : -INFINITY;
        acc[4 * n + e] = x;
        mt[e / 2] = fmaxf(mt[e / 2], x);
      }
#pragma unroll
    for (int h = 0; h < 2; ++h) {  // finite: column n0 < T is in every row
      mt[h] = fmaxf(mt[h], __shfl_xor_sync(FULL, mt[h], 1));
      mt[h] = fmaxf(mt[h], __shfl_xor_sync(FULL, mt[h], 2));
    }
#pragma unroll
    for (int n = 0; n < BN / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = wg::ex2(acc[4 * n + e] - mt[e / 2]);  // masked: 0
        acc[4 * n + e] = p;
        lt[e / 2] += p;
      }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      lt[h] += __shfl_xor_sync(FULL, lt[h], 1);
      lt[h] += __shfl_xor_sync(FULL, lt[h], 2);
      const int gm = tl.m0 + grp * 64 + warp * 16 + lane / 4 + 8 * h;
      bf16* prow = P + (static_cast<size_t>(tl.b) * M + gm) * Tp;
#pragma unroll
      for (int j = 0; j < BN / 32; ++j) {
        const uint4 v = wg::row8_bf16(acc, h, j, lane);
        const int gn = n0 + 8 * (4 * j + q4);
        if (gm < M && gn < Tp)  // Tp % 8 == 0: the 8 columns are whole
          *reinterpret_cast<uint4*>(prow + gn) = v;
      }
      if (gm < M && q4 == 0)
        ml[(static_cast<size_t>(tl.b) * tiles_n + tl.nt) * M + gm] =
            make_float2(mt[h] * LN2, lt[h]);
    }
  };

  if (mine > 0) enter(0);
  wg::ring_prime<STAGES>(mine * nk, issue);
  wg::ring_walk<STAGES>(
      mine, nk, issue, [](int, int) {},
      [&](int stage, int kt) {
        const uint32_t sA = base + stage * K::STAGE + grp * 8192;
        const uint32_t sB = base + stage * K::STAGE + K::A_BYTES;
#pragma unroll
        for (int ks = 0; ks < 4; ++ks)
          wg::mma_ss_n<BN, 0>(acc, wg::desc(sA + ks * 32, 16, 1024),
                              wg::desc(sB + ks * 32, 16, 1024),
                              kt > 0 || ks > 0);
      },
      [&] { wg::reg_fence(acc); }, finish);
}

// The cluster barrier in two halves: arrive (release: this thread's earlier
// shared-memory writes, its peers' included, become visible to the
// waiters), then wait (acquire).
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// The generic address of `p` (this block's shared memory) in block `rank`
// of the cluster.
__device__ __forceinline__ const float* cluster_map(const float* p, int rank) {
  uint64_t r;
  asm volatile("mapa.u64 %0, %1, %2;\n"
               : "=l"(r) : "l"(reinterpret_cast<uint64_t>(p)), "r"(rank));
  return reinterpret_cast<const float*>(r);
}

// The (64 NWG) x BN float32 tile `acc` (the fragments of a block's
// warpgroups) leaves through shared memory (row-major floats, rows TS
// apart) in short loops: its fragments are stored once, then each block of
// the cluster adds the nsplit partials of its share of the rows, in split
// order, reading its peers' shared memory, and stores them times `scale`
// as bf16 into rows m0.. (below `rows`) and columns n0.. (below D) of
// `out` (rows D apart).  `sm`: the block's 1024-aligned ring, free once
// every warpgroup's products are done; split: the block's cluster rank.
template <int NWG, int BN>
__device__ __forceinline__ void tile_out(const float (&acc)[BN / 2],
                                         unsigned char* sm,
                                         bf16* __restrict__ out, int rows,
                                         int D, int m0, int n0, int split,
                                         int nsplit, float scale) {
  namespace wg = wgmma_sm90;
  constexpr int NT = 128 * NWG, BM = 64 * NWG, TS = BN + 4;
  const int tid = threadIdx.x, lane = tid % 32, warp = (tid % 128) / 32;
  const int grp = tid / 128;
  __syncthreads();  // every warpgroup's products are done: the ring is free
  float* tile = reinterpret_cast<float*>(sm);
  const int q4 = lane % 4, r0 = grp * 64 + warp * 16 + lane / 4;
#pragma unroll
  for (int n = 0; n < BN / 8; ++n)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      *reinterpret_cast<float2*>(tile + (r0 + 8 * h) * TS + 8 * n + 2 * q4) =
          make_float2(acc[4 * n + 2 * h], acc[4 * n + 2 * h + 1]);
  if (nsplit > 1) cluster_sync();  // every block's tile is whole
  else __syncthreads();
  const float* src[MAX_SPLITS];
#pragma unroll
  for (int k = 0; k < MAX_SPLITS; ++k)
    src[k] = k < nsplit && k != split ? cluster_map(tile, k) : tile;
  const int share = (BM + nsplit - 1) / nsplit, r_lo = split * share;
  const int items = (min(BM, r_lo + share) - r_lo) * (BN / 8);
  // a thread's items e and e + NT together: their 4 nsplit reads of 16
  // bytes overlap (the peers' shared memory is a round trip away)
  for (int e0 = tid; e0 < items; e0 += 2 * NT) {
    float4 x[2][2][MAX_SPLITS];
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int e = min(e0 + u * NT, items - 1);
      const int at = (r_lo + e / (BN / 8)) * TS + (e % (BN / 8)) * 8;
#pragma unroll
      for (int k = 0; k < MAX_SPLITS; ++k)
        if (k < nsplit) {
          x[u][0][k] = *reinterpret_cast<const float4*>(src[k] + at);
          x[u][1][k] = *reinterpret_cast<const float4*>(src[k] + at + 4);
        }
    }
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int e = e0 + u * NT;
      float4 a = x[u][0][0], z = x[u][1][0];
#pragma unroll
      for (int k = 1; k < MAX_SPLITS; ++k)
        if (k < nsplit) {
          const float4 p = x[u][0][k], h = x[u][1][k];
          a.x += p.x; a.y += p.y; a.z += p.z; a.w += p.w;
          z.x += h.x; z.y += h.y; z.z += h.z; z.w += h.w;
        }
      const int gm = m0 + r_lo + e / (BN / 8), gn = n0 + (e % (BN / 8)) * 8;
      if (e < items && gm < rows && gn < D)
        *reinterpret_cast<uint4*>(out + static_cast<size_t>(gm) * D + gn) =
            make_uint4(wg::pack_bf16(a.x * scale, a.y * scale),
                       wg::pack_bf16(a.z * scale, a.w * scale),
                       wg::pack_bf16(z.x * scale, z.y * scale),
                       wg::pack_bf16(z.z * scale, z.w * scale));
    }
  }
  if (nsplit > 1) cluster_sync();  // no block leaves while a peer reads it
}

// Block (column tile, row tile, b * nsplit + split): O's 64 NWG x BN tile
// over the split's stretch of T; the nsplit blocks of a tile are one
// cluster and add their partials as the note above says.  One block of
// each row tile also stores its rows' lse = m_row + ln l_row (lse may be
// null).
template <int NWG, int BN>
__global__ void __launch_bounds__(XCfg<NWG, BN, true>::NT,
                                  XCfg<NWG, BN, true>::MINB)
xattn_out_wgmma(const bf16* __restrict__ P, const float2* __restrict__ ml,
                const bf16* __restrict__ v, bf16* __restrict__ out,
                float* __restrict__ lse, int M, int Tn, int Tp, int D,
                int ntl, int nsplit) {
  namespace wg = wgmma_sm90;
  using K = XCfg<NWG, BN, true>;
  constexpr int NT = K::NT, BM = K::BM, STAGES = K::STAGES;
  extern __shared__ unsigned char smem_out[];
  const uint32_t raw = wg::smem_addr(smem_out);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* sm = smem_out + (base - raw);
  float* cs = reinterpret_cast<float*>(sm + K::RING);  // [BM][CT_MAX]
  const int tid = threadIdx.x, lane = tid % 32, warp = (tid % 128) / 32;
  const int grp = tid / 128;
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM;
  const int b = blockIdx.z / nsplit, split = blockIdx.z % nsplit;
  // this split's slabs [s_lo, s_lo + nk) and the logits tiles they touch
  const int nk_all = (Tn + 63) / 64, per = (nk_all + nsplit - 1) / nsplit;
  const int s_lo = min(nk_all, split * per);
  const int nk = min(nk_all, s_lo + per) - s_lo;
  const int j_lo = s_lo * 64 / LG_BN;

  // This thread's share of a slab: P~ rows rx + i NT/8 at piece px; V rows
  // rw + i WRS at piece pw of BN / 8.
  constexpr int AI = BM * 8 / NT, WPR = BN / 8, VI = 64 * WPR / NT;
  constexpr int WRS = NT / WPR;
  const int px = tid % 8, rx = tid / 8, pw = tid % WPR, rw = tid / WPR;
  const bf16* a_row = P + (static_cast<size_t>(b) * M + m0 + rx) * Tp + px * 8;
  const size_t a_step = static_cast<size_t>(NT / 8) * Tp;
  const bf16* v_row = v + (static_cast<size_t>(b) * Tn + rw) * D + n0 + pw * 8;
  const size_t v_step = static_cast<size_t>(WRS) * D;
  const bool v_col = n0 + pw * 8 < D;  // D % 64 == 0: pieces are whole
  int c_kt = 0;
  auto issue = [&](int s) {
    const int k0 = (s_lo + c_kt++) * 64;
    const uint32_t sA = base + s * K::STAGE, sB = sA + K::A_BYTES;
#pragma unroll
    for (int i = 0; i < AI; ++i) {
      const int r = rx + i * (NT / 8);
      const bool ok = m0 + r < M && k0 + px * 8 < Tp;
      wg::cp_async16(sA + (r / 64) * 8192 + wg::sw128(r % 64, px),
                     ok ? a_row + i * a_step + k0 : P, ok);
    }
    const bf16* vk = v_row + static_cast<size_t>(k0) * D;
#pragma unroll
    for (int i = 0; i < VI; ++i) {
      const bool ok = v_col && k0 + rw + i * WRS < Tn;
      wg::cp_async16(sB + (pw / 8) * 8192 + wg::sw128(rw + i * WRS, pw % 8),
                     ok ? vk + i * v_step : v, ok);
    }
  };
  wg::ring_prime<STAGES>(nk, issue);

  // c_j of the block's rows for the split's logits tiles, while the first
  // slabs load: two neighbouring lanes a row, each over every other tile
  {
    const int r = tid / 2, half = tid % 2, row = m0 + r;
    const float2* mr = ml + static_cast<size_t>(b) * ntl * M + row;
    float mx = -INFINITY, l = 0.f;
    // eight loads in flight at a time, then their online sum
    for (int j0 = half; row < M && j0 < ntl; j0 += 16) {
      float2 e[8];
#pragma unroll
      for (int u = 0; u < 8; ++u)
        e[u] = j0 + 2 * u < ntl ? mr[static_cast<size_t>(j0 + 2 * u) * M]
                                : make_float2(-INFINITY, 0.f);
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        if (e[u].y == 0.f) continue;  // past ntl
        if (e[u].x > mx) {
          l = l * expf(mx - e[u].x) + e[u].y;
          mx = e[u].x;
        } else {
          l += e[u].y * expf(e[u].x - mx);
        }
      }
    }
    const float mo = __shfl_xor_sync(FULL, mx, 1);
    const float lo = __shfl_xor_sync(FULL, l, 1);
    const float mrow = fmaxf(mx, mo);
    const float lrow = (l > 0.f ? l * expf(mx - mrow) : 0.f)
                     + (lo > 0.f ? lo * expf(mo - mrow) : 0.f);
    if (lse != nullptr && blockIdx.x == 0 && split == 0 && half == 0 &&
        row < M)
      lse[static_cast<size_t>(b) * M + row] = mrow + logf(lrow);
    const int j_hi = nk > 0 ? ((s_lo + nk) * 64 - 1) / LG_BN : j_lo - 1;
    float mj[CT_MAX / 2];
#pragma unroll
    for (int u = 0; u < CT_MAX / 2; ++u) {
      const int j = j_lo + half + 2 * u;
      mj[u] = row < M && j <= j_hi ? mr[static_cast<size_t>(j) * M].x
                                   : -INFINITY;
    }
#pragma unroll
    for (int u = 0; u < CT_MAX / 2; ++u)
      cs[r * CT_MAX + half + 2 * u] =
          mrow - mj[u] < C_CUT ? expf(mj[u] - mrow) / lrow : 0.f;
  }
  __syncthreads();

  float acc[BN / 2];
#pragma unroll
  for (int j = 0; j < BN / 2; ++j) acc[j] = 0.f;
  // scale this thread's own landed pieces of the A slab by their rows' c_j
  auto land = [&](int stage, int kt) {
    const int jj = (s_lo + kt) * 64 / LG_BN - j_lo;
#pragma unroll
    for (int i = 0; i < AI; ++i) {
      const int r = rx + i * (NT / 8);
      const float c = cs[r * CT_MAX + jj];
      uint4* p = reinterpret_cast<uint4*>(
          sm + stage * K::STAGE + (r / 64) * 8192 + wg::sw128(r % 64, px));
      uint4 x = *p;
      uint32_t* w = reinterpret_cast<uint32_t*>(&x);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const __nv_bfloat162 h = *reinterpret_cast<const __nv_bfloat162*>(&w[e]);
        w[e] = wg::pack_bf16(__low2float(h) * c, __high2float(h) * c);
      }
      *p = x;
    }
  };
  auto finish = [&](int) {
    tile_out<NWG, BN>(acc, sm, out + static_cast<size_t>(b) * M * D, M, D,
                      m0, n0, split, nsplit, 1.f);
  };
  wg::ring_walk<STAGES>(
      1, nk, issue, land,
      [&](int stage, int kt) {
        const uint32_t sA = base + stage * K::STAGE + grp * 8192;
        const uint32_t sB = base + stage * K::STAGE + K::A_BYTES;
#pragma unroll
        for (int ks = 0; ks < 4; ++ks)
          wg::mma_ss_n<BN, 1>(acc, wg::desc(sA + ks * 32, 16, 1024),
                              wg::desc(sB + ks * 2048, 8192, 1024),
                              kt > 0 || ks > 0);
      },
      [&] { wg::reg_fence(acc); }, finish);
}

template <int NWG, int BN>
int launch_logits(const bf16* q, const bf16* k, bf16* P, float2* ml, int B,
                  int M, int Tn, int Tp, int D, float scale,
                  cudaStream_t st) {
  using K = XCfg<NWG, BN, false>;
  const auto kernel = xattn_logits_wgmma<NWG, BN>;
  static unsigned ready = 0;
  static int per_sm = 0;  // resident blocks an SM (one card type a process)
  int dev = 0, sms = 0;
  cudaError_t err = wgmma_sm90::with_smem(kernel, K::SMEM, ready, &dev);
  if (err != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess)
    return err;
  if (per_sm == 0 &&
      (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, kernel, K::NT, K::SMEM)) != cudaSuccess)
    return err;
  const long long tiles_m = (M + K::BM - 1) / K::BM;
  const long long tiles_n = (Tn + BN - 1) / BN;
  const long long tiles = tiles_m * tiles_n * B;
  if (tiles > (1LL << 31) - 1 || per_sm < 1) return cudaErrorInvalidValue;
  const int grid = static_cast<int>(
      tiles < static_cast<long long>(sms) * per_sm ? tiles : sms * per_sm);
  kernel<<<grid, K::NT, K::SMEM, st>>>(
      q, k, P, ml, M, Tn, Tp, D, scale * LOG2E, static_cast<int>(tiles_m),
      static_cast<int>(tiles_n), static_cast<int>(tiles));
  return cudaGetLastError();
}

template <int NWG, int BN>
int launch_out(const bf16* P, const float2* ml, const bf16* v, bf16* out,
               float* lse, int B, int M, int Tn, int Tp, int D, int ntl,
               int nsplit, cudaStream_t st) {
  using K = XCfg<NWG, BN, true>;
  const auto kernel = xattn_out_wgmma<NWG, BN>;
  static unsigned ready = 0;
  int dev = 0;
  const int nk_all = (Tn + 63) / 64;
  if (D % 64 || nsplit < 1 || nsplit > MAX_SPLITS ||
      (nk_all + nsplit - 1) / nsplit > SPLIT_SLABS_MAX ||
      static_cast<long long>(B) * nsplit > 65535 ||
      (M + K::BM - 1) / K::BM > 65535)
    return cudaErrorInvalidValue;
  cudaError_t err = wgmma_sm90::with_smem(kernel, K::SMEM, ready, &dev);
  if (err != cudaSuccess) return err;
  if (nsplit == 1) {  // no cluster
    kernel<<<dim3((D + BN - 1) / BN, (M + K::BM - 1) / K::BM, B), K::NT,
             K::SMEM, st>>>(P, ml, v, out, lse, M, Tn, Tp, D, ntl, 1);
    return cudaGetLastError();
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((D + BN - 1) / BN, (M + K::BM - 1) / K::BM, B * nsplit);
  cfg.blockDim = dim3(K::NT);
  cfg.dynamicSmemBytes = K::SMEM;
  cfg.stream = st;
  cudaLaunchAttribute cluster[1];
  cluster[0].id = cudaLaunchAttributeClusterDimension;
  cluster[0].val.clusterDim.x = 1;
  cluster[0].val.clusterDim.y = 1;
  cluster[0].val.clusterDim.z = nsplit;
  cfg.attrs = cluster;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, P, ml, v, out, lse, M, Tn, Tp, D,
                           ntl, nsplit);
  return err != cudaSuccess ? err : cudaGetLastError();
}

int run_wgmma(const bf16* q, const bf16* k, const bf16* v, bf16* out,
              float* lse, void* ws, int B, int M, int Tn, int D, float scale,
              int nsplit, cudaStream_t st) {
  const int Tp = (Tn + 7) / 8 * 8, ntl = (Tn + LG_BN - 1) / LG_BN;
  bf16* P = static_cast<bf16*>(ws);
  float2* ml = reinterpret_cast<float2*>(P + static_cast<size_t>(B) * M * Tp);
  const int err = launch_logits<LG_NWG, LG_BN>(q, k, P, ml, B, M, Tn, Tp, D,
                                               scale, st);
  if (err != cudaSuccess) return err;
  return launch_out<OUT_NWG, OUT_BN>(P, ml, v, out, lse, B, M, Tn, Tp, D,
                                     ntl, nsplit, st);
}

// ---- backward on wgmma: the "wgmma" backward -------------------------------
//
// Three launches (see the backward's note): xattn_bwd_dot (D_i), then
// xattn_bwd_sdp_wgmma (P and dS), then xattn_bwd_grad_wgmma (dQ, dK, dV).

constexpr int SDP_NWG = 2;      // warpgroups of an S / dP tile: 128 rows
constexpr int SDP_BN = 96;      // columns of an S / dP tile
constexpr int SDP_STAGES = 4;   // ring stages of Q, dO, K and V slabs
constexpr int GRAD_MAX_SPLITS = 4;  // splits of T a dQ tile, at most

struct SdpCfg {
  static constexpr int NT = 128 * SDP_NWG, BM = 64 * SDP_NWG, BN = SDP_BN;
  static constexpr int STAGES = SDP_STAGES;
  static constexpr int A_BYTES = SDP_NWG * 8192;  // Q or dO: BM rows x 64
  static constexpr int B_BYTES = BN * 128;        // K or V: BN rows x 64
  static constexpr int STAGE = 2 * (A_BYTES + B_BYTES);
  static constexpr size_t SMEM = 1024 + STAGES * STAGE;  // + 1024-B align
  static_assert(SMEM <= 232448, "an SM's shared memory");
};
using GradCfg = XCfg<OUT_NWG, OUT_BN, true>;
constexpr size_t GRAD_SMEM = 1024 + GradCfg::RING;  // no c_j table

// D_i = rowsum(dO o O) in float32 over `rows` rows of D (D % 8 == 0,
// 16-byte rows), one warp a row.
__global__ void __launch_bounds__(NT)
xattn_bwd_dot(const bf16* __restrict__ out, const bf16* __restrict__ dout,
              float* __restrict__ di, long long rows, int D) {
  const long long row = static_cast<long long>(blockIdx.x) * (NT / 32)
                        + threadIdx.x / 32;
  if (row >= rows) return;  // the whole warp leaves together
  const int lane = threadIdx.x % 32;
  const uint4* o = reinterpret_cast<const uint4*>(out + row * D);
  const uint4* g = reinterpret_cast<const uint4*>(dout + row * D);
  float s = 0.f;
  for (int i = lane; i < D / 8; i += 32) {
    const uint4 a = o[i], c = g[i];
    const __nv_bfloat162* pa = reinterpret_cast<const __nv_bfloat162*>(&a);
    const __nv_bfloat162* pc = reinterpret_cast<const __nv_bfloat162*>(&c);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float2 x = __bfloat1622float2(pa[e]), y = __bfloat1622float2(pc[e]);
      s += x.x * y.x;
      s += x.y * y.y;
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(FULL, s, off);
  if (lane == 0) di[row] = s;
}

// S = Q K^T and dP = dO V^T for the (BM x BN) tiles (b, row tile, column
// tile) of a persistent grid: each stage of the slab ring holds the
// 64-deep D slabs of Q, dO (K-major A) and K, V (K-major B), and one
// group of wgmma a slab runs both products.  Epilogue, from the unrounded
// float32 accumulators: P = exp(scale S - lse_row) (0 at columns >= T),
// dS = P o (dP - D_row), both rounded to bf16 and stored in 16-byte row
// pieces to columns < Tp of rows < M.
__global__ void __launch_bounds__(SdpCfg::NT, 1)
xattn_bwd_sdp_wgmma(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, const bf16* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ di, bf16* __restrict__ P,
                    bf16* __restrict__ dS, int M, int Tn, int Tp, int D,
                    float scale_log2, int tiles_m, int tiles_n, int tiles) {
  namespace wg = wgmma_sm90;
  using C = SdpCfg;
  constexpr int NT = C::NT, BM = C::BM, BN = C::BN, STAGES = C::STAGES;
  extern __shared__ unsigned char smem_sdp[];
  const uint32_t raw = wg::smem_addr(smem_sdp);
  const uint32_t base = (raw + 1023u) & ~1023u;  // swizzle atoms: 1024 B
  const int tid = threadIdx.x, lane = tid % 32, warp = (tid % 128) / 32;
  const int grp = tid / 128;
  const int nk = D / 64;
  const int mine = blockIdx.x < tiles ? (tiles - 1 - blockIdx.x) / gridDim.x + 1
                                      : 0;
  struct Tile {
    int b, m0, nt;
  };
  auto tile_of = [&](int t) {  // this block's t-th tile
    const int T_ = blockIdx.x + t * gridDim.x;
    const int r = T_ / tiles_n;
    return Tile{r / tiles_m, (r % tiles_m) * BM, T_ % tiles_n};
  };

  // This thread's share of a slab: Q / dO rows rx + i NT/8 and K / V rows
  // rx + i NT/8, 16-byte piece px of the slab's 64 columns.
  constexpr int QI = BM * 8 / NT, KI = BN * 8 / NT;
  const int px = tid % 8, rx = tid / 8;
  const size_t step = static_cast<size_t>(NT / 8) * D;
  int c_t = 0, c_kt = 0;     // the load cursor: slab c_kt of tile c_t
  size_t c_qo = 0, c_ko = 0;  // element offsets of the first Q and K rows
  uint32_t c_qrows = 0, c_krows = 0;  // bit i: row i is below M / T
  auto enter = [&](int t) {
    const Tile tl = tile_of(t);
    const int n0 = tl.nt * BN;
    c_qo = (static_cast<size_t>(tl.b) * M + tl.m0 + rx) * D + px * 8;
    c_ko = (static_cast<size_t>(tl.b) * Tn + n0 + rx) * D + px * 8;
    c_qrows = c_krows = 0;
#pragma unroll
    for (int i = 0; i < QI; ++i)
      c_qrows |= static_cast<uint32_t>(tl.m0 + rx + i * (NT / 8) < M) << i;
#pragma unroll
    for (int i = 0; i < KI; ++i)
      c_krows |= static_cast<uint32_t>(n0 + rx + i * (NT / 8) < Tn) << i;
  };
  auto issue = [&](int s) {
    const int k0 = c_kt * 64;
    const uint32_t sQ = base + s * C::STAGE, sO = sQ + C::A_BYTES;
    const uint32_t sK = sO + C::A_BYTES, sV = sK + C::B_BYTES;
#pragma unroll
    for (int i = 0; i < QI; ++i) {
      const int r = rx + i * (NT / 8);
      const bool ok = c_qrows >> i & 1u;
      const size_t at = c_qo + i * step + k0;
      const uint32_t to = (r / 64) * 8192 + wg::sw128(r % 64, px);
      wg::cp_async16(sQ + to, ok ? q + at : q, ok);
      wg::cp_async16(sO + to, ok ? dout + at : dout, ok);
    }
#pragma unroll
    for (int i = 0; i < KI; ++i) {
      const bool ok = c_krows >> i & 1u;
      const size_t at = c_ko + i * step + k0;
      const uint32_t to = wg::sw128(rx + i * (NT / 8), px);
      wg::cp_async16(sK + to, ok ? k + at : k, ok);
      wg::cp_async16(sV + to, ok ? v + at : v, ok);
    }
    if (++c_kt == nk) {
      c_kt = 0;
      if (++c_t < mine) enter(c_t);
    }
  };

  float sacc[BN / 2], pacc[BN / 2];  // S and dP (then P and dS)
#pragma unroll
  for (int j = 0; j < BN / 2; ++j) sacc[j] = pacc[j] = 0.f;
  auto finish = [&](int t) {
    const Tile tl = tile_of(t);
    const int n0 = tl.nt * BN, q4 = lane % 4;
    int gm[2];
    float l2[2], dd[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      gm[h] = tl.m0 + grp * 64 + warp * 16 + lane / 4 + 8 * h;
      const size_t r = static_cast<size_t>(tl.b) * M + gm[h];
      l2[h] = gm[h] < M ? lse[r] * LOG2E : 0.f;
      dd[h] = gm[h] < M ? di[r] : 0.f;
    }
#pragma unroll
    for (int n = 0; n < BN / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool ok = n0 + 8 * n + 2 * q4 + e % 2 < Tn;
        const float p =
            ok ? wg::ex2(sacc[4 * n + e] * scale_log2 - l2[e / 2]) : 0.f;
        pacc[4 * n + e] = p * (pacc[4 * n + e] - dd[e / 2]);
        sacc[4 * n + e] = p;
      }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const size_t ro = (static_cast<size_t>(tl.b) * M + gm[h]) * Tp;
#pragma unroll
      for (int j = 0; j < BN / 32; ++j) {
        const uint4 pv = wg::row8_bf16(sacc, h, j, lane);  // every lane
        const uint4 dv = wg::row8_bf16(pacc, h, j, lane);
        const int gn = n0 + 8 * (4 * j + q4);
        if (gm[h] < M && gn < Tp) {  // Tp % 8 == 0: the 8 columns are whole
          *reinterpret_cast<uint4*>(P + ro + gn) = pv;
          *reinterpret_cast<uint4*>(dS + ro + gn) = dv;
        }
      }
    }
  };

  if (mine > 0) enter(0);
  wg::ring_prime<STAGES>(mine * nk, issue);
  wg::ring_walk<STAGES>(
      mine, nk, issue, [](int, int) {},
      [&](int stage, int kt) {
        const uint32_t sQ = base + stage * C::STAGE + grp * 8192;
        const uint32_t sO = sQ + C::A_BYTES;
        const uint32_t sK = base + stage * C::STAGE + 2 * C::A_BYTES;
        const uint32_t sV = sK + C::B_BYTES;
#pragma unroll
        for (int ks = 0; ks < 4; ++ks)
          wg::mma_ss_n<BN, 0>(sacc, wg::desc(sQ + ks * 32, 16, 1024),
                              wg::desc(sK + ks * 32, 16, 1024),
                              kt > 0 || ks > 0);
#pragma unroll
        for (int ks = 0; ks < 4; ++ks)
          wg::mma_ss_n<BN, 0>(pacc, wg::desc(sO + ks * 32, 16, 1024),
                              wg::desc(sV + ks * 32, 16, 1024),
                              kt > 0 || ks > 0);
      },
      [&] {
        wg::reg_fence(sacc);
        wg::reg_fence(pacc);
      },
      finish);
}

// One (64 OUT_NWG) x OUT_BN gradient tile over `nk` 64-deep contraction
// slabs from slab s_lo, through the slab ring; B (K, Q or dO: contraction
// rows, D columns) is read MN-major.
// * TA = false, dQ: rows r0.. of M, contraction T.  A = dS (B, M, Tp) is
//   read K-major, rows of M at 16-byte pieces of T.
// * TA = true, dK or dV: rows r0.. of T, contraction M.  A = dS^T or P^T:
//   the (B, M, Tp) workspace read as an MN-major A, a slab's 64 rows of M
//   at 16-byte pieces of the tile's T columns (warpgroup g's 64 rows of
//   the output are 64-column chunk g).
// The tile leaves by tile_out (times `scale`, rows below `rows`).
template <bool TA>
__device__ __forceinline__ void grad_tile(
    const bf16* __restrict__ A, const bf16* __restrict__ Bm,
    bf16* __restrict__ out, int b, int r0, int n0, int rows, int s_lo, int nk,
    int M, int Tn, int Tp, int D, float scale, int split, int nsplit,
    unsigned char* smem_raw) {
  namespace wg = wgmma_sm90;
  using K = GradCfg;
  constexpr int NT = K::NT, BM = K::BM, BN = OUT_BN, STAGES = K::STAGES;
  const uint32_t raw = wg::smem_addr(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* sm = smem_raw + (base - raw);
  const int tid = threadIdx.x, grp = tid / 128;
  const int kdim = TA ? M : Tn;  // B's rows
  // A: 4 pieces a thread.  K-major: rows ax + i NT/8 of BM at piece px of
  // 8; MN-major: contraction rows ax + i NT/APR of 64 at piece px of APR.
  constexpr int APR = TA ? BM / 8 : 8, AI = 64 * BM / 8 / NT;
  const int px = tid % APR, ax = tid / APR;
  // B: contraction rows rw + i WRS at piece pw of BN / 8
  constexpr int WPR = BN / 8, VI = 64 * WPR / NT, WRS = NT / WPR;
  const int pw = tid % WPR, rw = tid / WPR;
  const bool b_col = n0 + pw * 8 < D;  // D % 64 == 0: pieces are whole
  const bf16* b_row = Bm + (static_cast<size_t>(b) * kdim + rw) * D + n0
                      + pw * 8;
  int c_kt = 0;
  auto issue = [&](int s) {
    const int k0 = (s_lo + c_kt++) * 64;
    const uint32_t sA = base + s * K::STAGE, sB = sA + K::A_BYTES;
#pragma unroll
    for (int i = 0; i < AI; ++i) {
      const int r = ax + i * (NT / APR);
      if constexpr (TA) {
        const bool ok = k0 + r < M && r0 + px * 8 < Tp;
        wg::cp_async16(
            sA + (px / 8) * 8192 + wg::sw128(r, px % 8),
            ok ? A + (static_cast<size_t>(b) * M + k0 + r) * Tp + r0 + px * 8
               : A,
            ok);
      } else {
        const bool ok = r0 + r < M && k0 + px * 8 < Tp;
        wg::cp_async16(
            sA + (r / 64) * 8192 + wg::sw128(r % 64, px),
            ok ? A + (static_cast<size_t>(b) * M + r0 + r) * Tp + k0 + px * 8
               : A,
            ok);
      }
    }
    const bf16* bk = b_row + static_cast<size_t>(k0) * D;
#pragma unroll
    for (int i = 0; i < VI; ++i) {
      const bool ok = b_col && k0 + rw + i * WRS < kdim;
      wg::cp_async16(sB + (pw / 8) * 8192 + wg::sw128(rw + i * WRS, pw % 8),
                     ok ? bk + static_cast<size_t>(i) * WRS * D : Bm, ok);
    }
  };
  wg::ring_prime<STAGES>(nk, issue);
  float acc[BN / 2];
#pragma unroll
  for (int j = 0; j < BN / 2; ++j) acc[j] = 0.f;
  wg::ring_walk<STAGES>(
      1, nk, issue, [](int, int) {},
      [&](int stage, int kt) {
        const uint32_t sA = base + stage * K::STAGE + grp * 8192;
        const uint32_t sB = base + stage * K::STAGE + K::A_BYTES;
#pragma unroll
        for (int ks = 0; ks < 4; ++ks)
          wg::mma_ss_n<BN, 1, TA ? 1 : 0>(
              acc,
              TA ? wg::desc(sA + ks * 2048, 8192, 1024)
                 : wg::desc(sA + ks * 32, 16, 1024),
              wg::desc(sB + ks * 2048, 8192, 1024), kt > 0 || ks > 0);
      },
      [&] { wg::reg_fence(acc); },
      [&](int) {
        tile_out<OUT_NWG, BN>(acc, sm, out + static_cast<size_t>(b) * rows * D,
                              rows, D, r0, n0, split, nsplit, scale);
      });
}

// The gradient blocks, heaviest first: blocks [0, q_blocks) are the dQ
// tiles' splits (block i: split i % nsplit, the cluster rank, of tile i /
// nsplit; tiles ordered (b, row tile, column tile)), then one block each
// for the kv_units dK and dV tiles (unit u: dK for u even, dV for u odd,
// of tile u / 2; tiles ordered (b, row tile of T, column tile)); blocks
// past them (the last cluster's padding) leave.
__global__ void __launch_bounds__(GradCfg::NT, 1)
xattn_bwd_grad_wgmma(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ dout,
                     const bf16* __restrict__ P, const bf16* __restrict__ dS,
                     bf16* __restrict__ dq, bf16* __restrict__ dk,
                     bf16* __restrict__ dv, int M, int Tn, int Tp, int D,
                     float scale, int q_blocks, int kv_units, int nsplit) {
  extern __shared__ unsigned char smem_gr[];
  constexpr int BM = GradCfg::BM, BN = OUT_BN;
  const int ntd = (D + BN - 1) / BN;
  const int blk = static_cast<int>(blockIdx.x);
  if (blk < q_blocks) {
    const int tile = blk / nsplit, split = blk % nsplit;
    const int ntm = (M + BM - 1) / BM;
    const int nt = tile % ntd, r = tile / ntd;
    const int nk_all = (Tn + 63) / 64, per = (nk_all + nsplit - 1) / nsplit;
    const int s_lo = min(nk_all, split * per);
    grad_tile<false>(dS, k, dq, r / ntm, (r % ntm) * BM, nt * BN, M, s_lo,
                     min(nk_all, s_lo + per) - s_lo, M, Tn, Tp, D, scale,
                     split, nsplit, smem_gr);
    return;
  }
  const int u = blk - q_blocks;
  if (u >= kv_units) return;
  const bool is_dv = u % 2;
  const int tile = u / 2, ntt = (Tn + BM - 1) / BM;
  const int nt = tile % ntd, r = tile / ntd;
  grad_tile<true>(is_dv ? P : dS, is_dv ? dout : q, is_dv ? dv : dk, r / ntt,
                  (r % ntt) * BM, nt * BN, Tn, 0, (M + 63) / 64, M, Tn, Tp, D,
                  is_dv ? 1.f : scale, 0, 1, smem_gr);
}

int run_bwd_wgmma(const bf16* q, const bf16* k, const bf16* v,
                  const bf16* out, const float* lse, const bf16* dout,
                  bf16* dq, bf16* dk, bf16* dv, void* ws, int B, int M,
                  int Tn, int D, float scale, int nsplit, cudaStream_t st) {
  const int Tp = (Tn + 7) / 8 * 8;
  const size_t n = static_cast<size_t>(B) * M * Tp;
  bf16* P = static_cast<bf16*>(ws);
  bf16* dS = P + n;
  float* di = reinterpret_cast<float*>(dS + n);
  // the gradient grid: dQ splits, then dK / dV tiles, padded to clusters
  const long long ntd = (D + OUT_BN - 1) / OUT_BN;
  const long long q_blocks =
      static_cast<long long>(B) * ((M + GradCfg::BM - 1) / GradCfg::BM) * ntd
      * nsplit;
  const long long kv_units =
      2LL * B * ((Tn + GradCfg::BM - 1) / GradCfg::BM) * ntd;
  const long long grad_blocks =
      q_blocks + (kv_units + nsplit - 1) / nsplit * nsplit;
  const long long tiles_m = (M + SdpCfg::BM - 1) / SdpCfg::BM;
  const long long tiles_n = (Tn + SdpCfg::BN - 1) / SdpCfg::BN;
  const long long tiles = tiles_m * tiles_n * B;
  if (D % 64 || nsplit < 1 || nsplit > GRAD_MAX_SPLITS ||
      grad_blocks > (1LL << 31) - 1 || tiles > (1LL << 31) - 1)
    return cudaErrorInvalidValue;

  const long long rows = static_cast<long long>(B) * M;
  xattn_bwd_dot<<<static_cast<unsigned>((rows + NT / 32 - 1) / (NT / 32)), NT,
                  0, st>>>(out, dout, di, rows, D);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  static unsigned ready_sdp = 0, ready_grad = 0;
  static int per_sm = 0;  // resident S / dP blocks an SM
  int dev = 0, sms = 0;
  if ((err = wgmma_sm90::with_smem(xattn_bwd_sdp_wgmma, SdpCfg::SMEM,
                                   ready_sdp, &dev)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess)
    return err;
  if (per_sm == 0 &&
      (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, xattn_bwd_sdp_wgmma, SdpCfg::NT, SdpCfg::SMEM)) !=
          cudaSuccess)
    return err;
  if (per_sm < 1) return cudaErrorInvalidValue;
  const int grid = static_cast<int>(
      tiles < static_cast<long long>(sms) * per_sm ? tiles : sms * per_sm);
  xattn_bwd_sdp_wgmma<<<grid, SdpCfg::NT, SdpCfg::SMEM, st>>>(
      q, k, v, dout, lse, di, P, dS, M, Tn, Tp, D, scale * LOG2E,
      static_cast<int>(tiles_m), static_cast<int>(tiles_n),
      static_cast<int>(tiles));
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  if ((err = wgmma_sm90::with_smem(xattn_bwd_grad_wgmma, GRAD_SMEM,
                                   ready_grad, &dev)) != cudaSuccess)
    return err;
  const int qb = static_cast<int>(q_blocks), kvu = static_cast<int>(kv_units);
  if (nsplit == 1) {  // no cluster
    xattn_bwd_grad_wgmma<<<static_cast<unsigned>(grad_blocks), GradCfg::NT,
                           GRAD_SMEM, st>>>(q, k, dout, P, dS, dq, dk, dv, M,
                                            Tn, Tp, D, scale, qb, kvu, 1);
    return cudaGetLastError();
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(grad_blocks));
  cfg.blockDim = dim3(GradCfg::NT);
  cfg.dynamicSmemBytes = GRAD_SMEM;
  cfg.stream = st;
  cudaLaunchAttribute cluster[1];
  cluster[0].id = cudaLaunchAttributeClusterDimension;
  cluster[0].val.clusterDim.x = nsplit;
  cluster[0].val.clusterDim.y = 1;
  cluster[0].val.clusterDim.z = 1;
  cfg.attrs = cluster;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, xattn_bwd_grad_wgmma, q, k, dout,
                           static_cast<const bf16*>(P),
                           static_cast<const bf16*>(dS), dq, dk, dv, M, Tn,
                           Tp, D, scale, qb, kvu, nsplit);
  return err != cudaSuccess ? err : cudaGetLastError();
}

}  // namespace


// Bytes of the workspace memcom_xattn_fwd needs (see the note above).
// variant (bfloat16): 0 = "mma_sync", 1 = "wgmma"; float32 takes 0.
extern "C" long long memcom_xattn_workspace_bytes(int B, int M, int T,
                                                  int dtype, int variant) {
  const long long Tp = (T + 7) / 8 * 8;
  if (dtype == 1 && variant == 1)
    return 2LL * B * M * Tp + 8LL * B * M * ((T + LG_BN - 1) / LG_BN);
  if (dtype == 1) return 6LL * B * M * Tp;
  return 4LL * B * M * T;
}

// ws: memcom_xattn_workspace_bytes(B, M, T, dtype, variant) bytes, 16-byte
// aligned.  dtype: 0 = float32, 1 = bfloat16.  variant (bfloat16): 0 =
// "mma_sync" (D % 8 == 0), 1 = "wgmma" (D % 64 == 0, 16-byte aligned q,
// k, v, out and ws, and nsplit splits of T within MAX_SPLITS and
// SPLIT_SLABS_MAX); float32 takes 0.  lse (B, M) float32, may be null:
// each row's logsumexp of scale Q K^T.  Returns a cudaError_t (0 =
// launched).
extern "C" int memcom_xattn_fwd(const void* q, const void* k, const void* v,
                                void* out, void* lse, void* ws, int B, int M,
                                int T, int D, float scale, int dtype,
                                int variant, int nsplit, void* stream) {
  if (B < 0 || M < 0 || T <= 0 || D <= 0) return cudaErrorInvalidValue;
  if (B == 0 || M == 0) return cudaSuccess;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* lf = static_cast<float*>(lse);
  if (dtype == 0 && variant == 0)
    return run_f32(static_cast<const float*>(q), static_cast<const float*>(k),
                   static_cast<const float*>(v), static_cast<float*>(out), lf,
                   static_cast<float*>(ws), B, M, T, D, scale, st);
  if (dtype != 1) return cudaErrorInvalidValue;
  const bf16* qb = static_cast<const bf16*>(q);
  const bf16* kb = static_cast<const bf16*>(k);
  const bf16* vb = static_cast<const bf16*>(v);
  bf16* ob = static_cast<bf16*>(out);
  if (variant == 0 && D % 8 == 0)
    return run_bf16(qb, kb, vb, ob, lf, static_cast<float*>(ws), B, M, T, D,
                    scale, st);
  const auto aligned = [](const void* p) {
    return reinterpret_cast<uintptr_t>(p) % 16 == 0;
  };
  if (variant == 1 && D % 64 == 0 && aligned(q) && aligned(k) &&
      aligned(v) && aligned(out) && aligned(ws))
    return run_wgmma(qb, kb, vb, ob, lf, ws, B, M, T, D, scale, nsplit, st);
  return cudaErrorInvalidValue;
}

// Bytes of the workspace memcom_xattn_bwd needs (see the backward's note).
// variant (bfloat16): 0 = "mma_sync", 1 = "wgmma"; float32 takes 0.
extern "C" long long memcom_xattn_bwd_workspace_bytes(int B, int M, int T,
                                                      int dtype,
                                                      int variant) {
  const long long Tp = (T + 7) / 8 * 8;
  if (dtype == 1 && variant == 1) return 4LL * B * M * Tp + 4LL * B * M;
  if (dtype == 1) return 12LL * B * M * Tp;
  return 8LL * B * M * T;
}

// dq (B,M,D), dk and dv (B,T,D) of O = softmax(scale Q K^T) V given dout
// (B,M,D), all in one type, contiguous; ws:
// memcom_xattn_bwd_workspace_bytes(B, M, T, dtype, variant) bytes.  dtype
// 0 = float32 (variant 0); 1 = bfloat16 with 16-byte aligned q, k, v, dout
// and ws: variant 0 = "mma_sync" (D % 8 == 0), 1 = "wgmma" (D % 64 == 0,
// out (B,M,D) the forward's output, 16-byte aligned, and lse (B,M) float32
// its rows' logsumexp; dQ's T split nsplit ways, 1..GRAD_MAX_SPLITS).  out
// and lse are read by the wgmma variant alone.  Returns a cudaError_t (0 =
// launched).
extern "C" int memcom_xattn_bwd(const void* q, const void* k, const void* v,
                                const void* out, const void* lse,
                                const void* dout, void* dq, void* dk,
                                void* dv, void* ws, int B, int M, int T, int D,
                                float scale, int dtype, int variant,
                                int nsplit, void* stream) {
  if (B < 0 || M < 0 || T <= 0 || D <= 0) return cudaErrorInvalidValue;
  if (B == 0 || M == 0) return cudaSuccess;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && variant == 0)
    return run_bwd_f32(static_cast<const float*>(q), static_cast<const float*>(k),
                       static_cast<const float*>(v),
                       static_cast<const float*>(dout), static_cast<float*>(dq),
                       static_cast<float*>(dk), static_cast<float*>(dv),
                       static_cast<float*>(ws), B, M, T, D, scale, st);
  const auto aligned = [](const void* p) {
    return reinterpret_cast<uintptr_t>(p) % 16 == 0;
  };
  if (dtype != 1 || !(aligned(q) && aligned(k) && aligned(v) &&
                      aligned(dout) && aligned(ws)))
    return cudaErrorInvalidValue;
  const bf16* qb = static_cast<const bf16*>(q);
  const bf16* kb = static_cast<const bf16*>(k);
  const bf16* vb = static_cast<const bf16*>(v);
  const bf16* gb = static_cast<const bf16*>(dout);
  bf16* dqb = static_cast<bf16*>(dq);
  bf16* dkb = static_cast<bf16*>(dk);
  bf16* dvb = static_cast<bf16*>(dv);
  if (variant == 0 && D % 8 == 0)
    return run_bwd_bf16(qb, kb, vb, gb, dqb, dkb, dvb,
                        static_cast<float*>(ws), B, M, T, D, scale, st);
  if (variant == 1 && D % 64 == 0 && out != nullptr && lse != nullptr &&
      aligned(out) && aligned(dq) && aligned(dk) && aligned(dv))
    return run_bwd_wgmma(qb, kb, vb, static_cast<const bf16*>(out),
                         static_cast<const float*>(lse), gb, dqb, dkb, dvb,
                         ws, B, M, T, D, scale, nsplit, st);
  return cudaErrorInvalidValue;
}
