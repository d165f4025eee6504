// Mamba2 SSD (state-space duality) chunked scan for Hopper (sm_90a), CUDA C++.
//
// Replaces: src/repro/kernels/ssd_scan.py::ssd (the Pallas TPU kernel,
// ssd_scan.py:93).  Contract: src/repro/kernels/ref.py::ssd_ref (plain
// twin: plain.ssd_ref) —
//   x (B,S,H,P), dt (B,S,H) f32, A (H,) f32, Bm / Cm (B,S,G,N), h0
//   (B,H,P,N) f32 or null (zeros)  ->  y (B,S,H,P) in x's type, hf
//   (B,H,P,N) f32, with h_t = e^{dt_t A} h_{t-1} + dt_t x_t B_tᵀ and
//   y_t = h_t C_t per head; head h reads group h / (H / G).
//
// Per chunk of Q tokens, in the accumulation type (float32 for bf16
// inputs, float64 for float32 inputs):
//   cum   = cumsum(dt · A)                       inclusive
//   W_ij  = (C_i · B_j) e^{cum_i - cum_j} dt_j   for j <= i, else 0
//   y_i   = Σ_j W_ij x_j + e^{cum_i} (state C_i)
//   state = state e^{cum_Q} + Σ_j e^{cum_Q - cum_j} dt_j x_j B_jᵀ
// Only j <= i is ever exponentiated: above the diagonal the exponent is
// positive and e^{…} overflows float32 once dt·|A| sums past ~88 within a
// chunk, where a 0/1 mask would turn inf·0 into NaN.  Every exponent taken
// is <= 0.  Rows past S load dt = 0, x = B = C = 0: an exact no-op.
//
// What bounds it on an H100: at mamba2-370m's prefill (B 1, S ~3080, H 32,
// P 64, G 1, N 128) the scan must move 29.3 MB (x and y, B and C in bf16,
// dt, the initial and final state in float32): 0.0088 ms at 3.35 TB/s.
// Its operations are fewer at any chunk length Q (2Q(N + P) + 4NP per token
// and head; 3.3 GFLOP at Q = 1, 4.4 at this kernel's Q = 32, 12.9 at the
// TPU's 256): 0.0033-0.0130 ms at the 989 TFLOP/s bf16 tensor rate.  So
// the bound is bytes.  This kernel runs on the CUDA cores in float32 (67
// TFLOP/s), so it stays far from it; tensor cores for C·Bᵀ and W·x, TMA,
// and a chunk-parallel two-pass state are later work.
//
// Design:
// * The Pallas grid (B, H, nc) walks the chunks in order with the (P, N)
//   state in VMEM.  Here the chunk loop runs inside the block.  State row
//   p only meets x[:, p] and y[:, p], so the P rows split into tiles of
//   PT = 16: grid (P / PT, H, B) gives 4 · 32 = 128 blocks at the prefill
//   shape (one block per (b, h) would fill 32 of the 132 SMs).  Each P tile
//   recomputes the chunk's C·Bᵀ (2Q²N of its work), the price of the
//   parallelism.
// * The chunk is Q = 32 tokens, not the TPU's 256: per token the block
//   pays 2QN for C·Bᵀ and 4N·PT for the state, so a short chunk does less
//   work; a (256, 256) f32 decay tile alone (256 KB) would not fit a
//   block's 227 KB of shared memory.  The function does not depend on Q.
// * Types: bf16 inputs accumulate in float32 (the main path).  float32
//   inputs accumulate in float64, one step wider than the inputs as bf16
//   is summed in float32.  Where a row of y is the cancelled remainder of
//   its terms (C_i·B_i near 0 when the decay leaves only j = i), float32
//   sums stray ~5e-4 of the row's scale from the exact scan, past the
//   1e-4 rule that holds float32 results to their plain version.
// * Shared memory holds the chunk's B and C (Q x N, rows padded by 4 so
//   that float4 reads of eight rows hit 32 distinct banks), the PT x N
//   state, x's Q x PT tile and W (Q x Q+1): 49 KB at N = 128 in float32,
//   98 KB in float64; dynamic.
// * One thread sums cum in token order (torch.cumsum's order), and
//   warp 0 takes the exponentials (lane = token).  W: each thread takes
//   rows (i, i + 16) x columns (j, j + 16) and skips the block that lies
//   wholly above the diagonal.  y: each thread takes one p of rows i and
//   i + 16.  State: each thread owns one column n of eight state rows.

#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

using bf16 = __nv_bfloat16;
constexpr int Q = 32;      // tokens per chunk: one per lane of warp 0
constexpr int PT = 16;     // state rows (head dims) per block
constexpr int NT = 256;    // threads per block
constexpr int NMAX = 256;  // largest d_state

// The accumulation type of each input type, and the scalar helpers in it.
template <typename T> struct AccOf { using type = float; };
template <> struct AccOf<float> { using type = double; };

__device__ __forceinline__ float widen(bf16 v) { return __bfloat162float(v); }
__device__ __forceinline__ double widen(float v) { return v; }
__device__ __forceinline__ void store(float* p, double v) {
  *p = static_cast<float>(v);
}
__device__ __forceinline__ void store(bf16* p, float v) {
  *p = __float2bfloat16_rn(v);
}
__device__ __forceinline__ float exp_(float v) { return expf(v); }
__device__ __forceinline__ double exp_(double v) { return exp(v); }
// product and sum rounded apart (never fused), as torch.cumsum of dt * A
__device__ __forceinline__ float mul_add_rn(float c, float a, float b) {
  return __fadd_rn(c, __fmul_rn(a, b));
}
__device__ __forceinline__ double mul_add_rn(double c, double a, double b) {
  return __dadd_rn(c, __dmul_rn(a, b));
}

template <typename A> struct Four { A x, y, z, w; };
__device__ __forceinline__ Four<float> ld4(const float* p) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  return {v.x, v.y, v.z, v.w};
}
__device__ __forceinline__ Four<double> ld4(const double* p) {
  const double2 a = *reinterpret_cast<const double2*>(p);
  const double2 b = *reinterpret_cast<const double2*>(p + 2);
  return {a.x, a.y, b.x, b.y};
}
template <typename A>
__device__ __forceinline__ A dot4(Four<A> a, Four<A> b) {
  return a.x * b.x + a.y * b.y + a.z * b.z + a.w * b.w;
}

// Shared-memory elements of the accumulation type.
constexpr size_t smem_elems(int N) {
  return static_cast<size_t>(2 * Q + PT) * (N + 4) + Q * PT + Q * (Q + 1)
         + 4 * Q + 1;
}

// One block: batch row b = blockIdx.z, head h = blockIdx.y, state rows
// [p0, p0 + PT) with p0 = blockIdx.x * PT, every chunk in order.
template <typename T>
__global__ void __launch_bounds__(NT)
ssd_scan(const T* __restrict__ x, const float* __restrict__ dt,
         const float* __restrict__ A, const T* __restrict__ Bm,
         const T* __restrict__ Cm, const float* __restrict__ h0,
         T* __restrict__ y, float* __restrict__ hf, int S, int H, int P,
         int G, int N) {
  using Acc = typename AccOf<T>::type;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Acc* smem = reinterpret_cast<Acc*>(smem_raw);
  const int NS = N + 4;        // padded row of B, C and the state
  Acc* sB = smem;              // [Q][NS]
  Acc* sC = sB + Q * NS;       // [Q][NS]
  Acc* sH = sC + Q * NS;       // [PT][NS] state rows p0 .. p0 + PT
  Acc* sX = sH + PT * NS;      // [Q][PT]
  Acc* sW = sX + Q * PT;       // [Q][Q + 1]
  Acc* sDt = sW + Q * (Q + 1); // [Q] dt_j
  Acc* sE = sDt + Q;           // [Q] e^{cum_i}
  Acc* sSeg = sE + Q;          // [Q] e^{cum_Q - cum_j} dt_j
  Acc* sCum = sSeg + Q;        // [Q] cum_i, then [Q] = e^{cum_Q}

  const int p0 = blockIdx.x * PT, h = blockIdx.y, b = blockIdx.z;
  const int g = h / (H / G);
  const int t = threadIdx.x;
  const Acc a_h = A[h];
  const size_t head_state = (static_cast<size_t>(b) * H + h) * P;

  for (int e = t; e < PT * N; e += NT) {
    const int p = e / N, n = e % N;
    sH[p * NS + n] = (h0 != nullptr && p0 + p < P)
                         ? static_cast<Acc>(h0[(head_state + p0 + p) * N + n])
                         : Acc(0);
  }

  for (int s0 = 0; s0 < S; s0 += Q) {
    // ---- 1. the chunk's B, C, x tile and dt, widened ----
    for (int e = t; e < Q * N; e += NT) {
      const int r = e / N, n = e % N, s = s0 + r;
      Acc bv = 0, cv = 0;
      if (s < S) {
        const size_t off =
            ((static_cast<size_t>(b) * S + s) * G + g) * N + n;
        bv = widen(Bm[off]);
        cv = widen(Cm[off]);
      }
      sB[r * NS + n] = bv;
      sC[r * NS + n] = cv;
    }
    for (int e = t; e < Q * PT; e += NT) {
      const int r = e / PT, p = e % PT, s = s0 + r;
      sX[e] = (s < S && p0 + p < P)
                  ? widen(x[((static_cast<size_t>(b) * S + s) * H + h) * P
                            + p0 + p])
                  : Acc(0);
    }
    if (t < Q) {
      const int s = s0 + t;
      sDt[t] = s < S ? static_cast<Acc>(
                           dt[(static_cast<size_t>(b) * S + s) * H + h])
                     : Acc(0);
    }
    __syncthreads();

    // ---- 2. cum = cumsum(dt · A) over the chunk (warp 0) ----
    if (t < 32) {
      if (t == 0) {
        // in token order, as torch.cumsum sums the plain version's cum:
        // e^{cum_i - cum_j} carries cum's rounding (~|cum| ulp)
        Acc c = 0;
        for (int i = 0; i < Q; ++i) {
          c = mul_add_rn(c, sDt[i], a_h);
          sCum[i] = c;
        }
      }
      __syncwarp();
      const Acc c = sCum[t], last = sCum[Q - 1];
      sE[t] = exp_(c);
      sSeg[t] = exp_(last - c) * sDt[t];
      __syncwarp();
      if (t == 0) sCum[Q] = exp_(last);
    }
    __syncthreads();

    // ---- 3. W = (C Bᵀ ∘ L ∘ dt_j), lower triangle ----
    {
      const int i0 = t / 16, j0 = t % 16;  // rows i0, i0 + 16; cols j0, j0 + 16
      // a00: (i0, j0), a10: (i0 + 16, j0), a11: (i0 + 16, j0 + 16)
      Acc a00 = 0, a10 = 0, a11 = 0;
      for (int n = 0; n < N; n += 4) {
        const Four<Acc> c0 = ld4(&sC[i0 * NS + n]);
        const Four<Acc> c1 = ld4(&sC[(i0 + 16) * NS + n]);
        const Four<Acc> b0 = ld4(&sB[j0 * NS + n]);
        const Four<Acc> b1 = ld4(&sB[(j0 + 16) * NS + n]);
        a00 += dot4(c0, b0);
        a10 += dot4(c1, b0);
        a11 += dot4(c1, b1);
      }
      // (i0, j0 + 16) lies above the diagonal: W is 0 there
      const int i1 = i0 + 16, j1 = j0 + 16;
      sW[i0 * (Q + 1) + j0] =
          j0 <= i0 ? a00 * exp_(sCum[i0] - sCum[j0]) * sDt[j0] : Acc(0);
      sW[i0 * (Q + 1) + j1] = 0;
      sW[i1 * (Q + 1) + j0] = a10 * exp_(sCum[i1] - sCum[j0]) * sDt[j0];
      sW[i1 * (Q + 1) + j1] =
          j1 <= i1 ? a11 * exp_(sCum[i1] - sCum[j1]) * sDt[j1] : Acc(0);
    }
    __syncthreads();

    // ---- 4. y = W x + e^{cum_i} (state C_i), rows i0 and i0 + 16 ----
    {
      const int p = t % PT, i0 = t / PT, i1 = i0 + 16;
      Acc c0 = 0, c1 = 0;
      for (int n = 0; n < N; n += 4) {
        const Four<Acc> hv = ld4(&sH[p * NS + n]);
        c0 += dot4(ld4(&sC[i0 * NS + n]), hv);
        c1 += dot4(ld4(&sC[i1 * NS + n]), hv);
      }
      Acc y0 = 0, y1 = 0;
      for (int j = 0; j <= i0; ++j) y0 += sW[i0 * (Q + 1) + j] * sX[j * PT + p];
      for (int j = 0; j <= i1; ++j) y1 += sW[i1 * (Q + 1) + j] * sX[j * PT + p];
      y0 += sE[i0] * c0;
      y1 += sE[i1] * c1;
      if (p0 + p < P) {
        const size_t col = static_cast<size_t>(h) * P + p0 + p;
        const size_t rs = static_cast<size_t>(H) * P;
        if (s0 + i0 < S)
          store(&y[(static_cast<size_t>(b) * S + s0 + i0) * rs + col], y0);
        if (s0 + i1 < S)
          store(&y[(static_cast<size_t>(b) * S + s0 + i1) * rs + col], y1);
      }
    }
    __syncthreads();

    // ---- 5. state = state e^{cum_Q} + Σ_j x_j (seg_j B_j)ᵀ ----
    {
      const Acc dlast = sCum[Q];
      for (int e = t; e < N * (PT / 8); e += NT) {
        const int n = e % N, r0 = 8 * (e / N);  // column n of rows r0 .. r0 + 8
        Acc acc[8] = {};
        for (int j = 0; j < Q; ++j) {
          const Acc bj = sB[j * NS + n] * sSeg[j];
          const Four<Acc> xa = ld4(&sX[j * PT + r0]);
          const Four<Acc> xb = ld4(&sX[j * PT + r0 + 4]);
          acc[0] += xa.x * bj;
          acc[1] += xa.y * bj;
          acc[2] += xa.z * bj;
          acc[3] += xa.w * bj;
          acc[4] += xb.x * bj;
          acc[5] += xb.y * bj;
          acc[6] += xb.z * bj;
          acc[7] += xb.w * bj;
        }
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          Acc* st = &sH[(r0 + k) * NS + n];
          *st = *st * dlast + acc[k];
        }
      }
    }
    __syncthreads();
  }

  for (int e = t; e < PT * N; e += NT) {
    const int p = e / N, n = e % N;
    if (p0 + p < P)
      hf[(head_state + p0 + p) * N + n] = static_cast<float>(sH[p * NS + n]);
  }
}

template <typename T>
int launch(const void* x, const void* dt, const void* A, const void* Bm,
           const void* Cm, const void* h0, void* y, void* hf, int B, int S,
           int H, int P, int G, int N, cudaStream_t stream) {
  const size_t smem = smem_elems(N) * sizeof(typename AccOf<T>::type);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_scan<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((P + PT - 1) / PT, H, B);
  ssd_scan<T><<<grid, NT, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(A), static_cast<const T*>(Bm),
      static_cast<const T*>(Cm), static_cast<const float*>(h0),
      static_cast<T*>(y), static_cast<float*>(hf), S, H, P, G, N);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 float32, 1 bfloat16 (x, Bm, Cm and y); dt, A, h0 and hf are
// float32.  h0 may be null (a zero initial state).
extern "C" int ssd_scan_fwd(const void* x, const void* dt, const void* A,
                            const void* Bm, const void* Cm, const void* h0,
                            void* y, void* hf, int B, int S, int H, int P,
                            int G, int N, int dtype, void* stream) {
  if (B < 1 || S < 1 || H < 1 || P < 1 || G < 1 || N < 4 || N > NMAX
      || N % 4 || H % G || H > 65535 || B > 65535)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(x, dt, A, Bm, Cm, h0, y, hf, B, S, H, P, G, N, st);
  if (dtype == 1)
    return launch<bf16>(x, dt, A, Bm, Cm, h0, y, hf, B, S, H, P, G, N, st);
  return cudaErrorInvalidValue;
}
