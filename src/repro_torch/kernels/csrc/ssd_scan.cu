// Mamba2 SSD (state-space duality) scan for Hopper (sm_90a), CUDA C++: two
// variants behind two entry points.
//
// Replaces: src/repro/kernels/ssd_scan.py::ssd (the Pallas TPU kernel,
// ssd_scan.py:93, pallas_call at :115).  Contract:
// src/repro/kernels/ref.py::ssd_ref (plain twin: plain.ssd_ref) —
//   x (B,S,H,P), dt (B,S,H) f32, A (H,) f32, Bm / Cm (B,S,G,N), h0
//   (B,H,P,N) f32 or null (zeros)  ->  y (B,S,H,P) in x's type, hf
//   (B,H,P,N) f32, with h_t = e^{dt_t A} h_{t-1} + dt_t x_t B_tᵀ and
//   y_t = h_t C_t per head; head h reads group h / (H / G).
//
// Per chunk of Q tokens, in float32:
//   cum   = cumsum(dt · A)                       inclusive
//   W_ij  = (C_i · B_j) e^{cum_i - cum_j} dt_j   for j <= i, else 0
//   y_i   = Σ_j W_ij x_j + e^{cum_i} (state C_i)
//   state = state e^{cum_Q} + Σ_j e^{cum_Q - cum_j} dt_j x_j B_jᵀ
// Only j <= i is ever exponentiated: above the diagonal the exponent is
// positive and e^{…} overflows float32 once dt·|A| sums past ~88 within a
// chunk, where a 0/1 mask would turn inf·0 into NaN.  Every exponent taken
// is <= 0.  Rows past S load dt = 0, x = B = C = 0: an exact no-op.
//
// What bounds it on an H100: at mamba2-370m's prefill (B 1, S 3084, H 32,
// P 64, G 1, N 128) the contract moves 29,335,168 bytes (x and y, B and C
// in bf16, dt, the initial and final state in float32): 0.0088 ms at 3.35
// TB/s.  Its operations are fewer at any chunk length (2Q(N + P) + 4NP per
// token and head: 3.3 GFLOP at Q = 1, 5 GFLOP at Q = 128 with C·Bᵀ shared
// by a group's heads): ~0.005 ms at the 989 TFLOP/s bf16 tensor rate.  So
// the bound is bytes.
//
// ---- "chunked" (ssd_scan_chunked_fwd): bf16, P 64, N 128 --------------
// The variant of the main path: mamba2-370m's prefill.  Chunks of Q_ =
// 128 tokens (Q 64 was slower on an H100, PERF.md section 6; the wrapper's
// CHUNK_Q sizes the scratch), three kernels on the caller's stream:
// 1. ssd_chunk_states, grid (chunk, head block, batch): cum by a warp scan,
//    seg_j = e^{cum_Q - cum_j} dt_j, the chunk's own state S_c = (x∘seg)ᵀ B
//    (P x Q times Q x N) on mma.sync m16n8k16, and e^{cum_Q}.  The block's
//    heads (up to HB1_MAX = 4 of one group) share one load of B; S_c goes
//    out through shared memory in rows of 512 bytes.
// 2. ssd_state_pass, grid (P·N / 1024, head, batch), serial over chunks,
//    float32 elementwise: writes the state entering chunk c, then h = h ·
//    e^{cum_Q(c)} + S_c; the last h is the final state.
// 3. ssd_chunk_outputs, grid (chunk, head block, batch): C·Bᵀ once per
//    block in registers (each warp owns 16 rows i and the j-tiles at or
//    below the diagonal), reused by the block's heads (up to HB3_MAX = 8):
//    per head W from it in registers (e^{…} on the SFU's ex2), y = W x +
//    e^{cum_i} (C h_inᵀ) on mma.sync, y in bf16.
// Each block's tiles (B, C, and per head x and the entering state) come
// by cp.async; the next head's tiles load while this head computes.
// Bytes the design moves at the prefill, Q = 128 (25 chunks): x and B
// twice (phases 1 and 3), C, dt twice, y, h0 and hf, and the chunk states
// four times (phase 1 writes S_c in float32, phase 2 reads it and writes
// the entering state as a bf16 pair, phase 3 reads the pair): 16 bytes x
// 6,553,600 state elements = 104.9 MB of 148.0 MB: 0.044 ms at 3.35 TB/s.
// The chunk states are the cost; chip_smoke.py prints this count beside
// the contract's.
// Rounding.  x, B and C arrive in bf16, so C·Bᵀ and every product with x
// or B is exact on bf16 tensor cores.  The three float32 operands go to
// the tensor cores as sums of bf16 terms, one product each into one
// float32 sum: x∘seg (phase 1) and the entering state (phase 3) as a
// hi/lo pair (hi = bf16(v), lo = bf16(v - hi): ~2^-17 of v), W (phase 3)
// as hi/mid/lo (~2^-25).  One bf16 rounding (2^-9) of the entering state
// misses the 2e-2 scaled gate at mamba2-370m's widths, and a hi/lo pair
// of W the max abs gate at dt·|A| = 25 a token: y_i ≈ W_ii x_i there,
// hundreds of elements of y exceed 4, where a bf16 ulp is 3.1e-2, and
// 2^-17 of W moves some of them to the other bf16 neighbour.  W_ii x_i
// stays out of the tensor cores: C_i·B_i is summed on the CUDA cores
// with TwoSum, W_ii carried as a float32 pair, and diag_odd adds W_ii x_i
// last and rounds to odd, so y's bf16 rounding follows the sum and not
// its float32 rounding.  At dt·|A| = 25 an element of y past 4 lay
// within float32 rounding of a bf16 tie on the card; summed on the
// tensor cores (whose sums drop low bits), y rounded to the other
// neighbour than the plain version's, 3.1e-2 away.
// cum is summed in another order than torch.cumsum's: lane l sums tokens
// l·Q/32 .. in token order, a Hillis-Steele scan adds the lanes' totals,
// and each partial gets its lane's exclusive prefix.  plain.
// ssd_chunk_parallel restates the three phases with this order and these
// rounding points; tests/test_torch_ssd_chunked.py holds it to the JAX
// package, dt·|A| = 25 included, and chip_smoke.py holds the kernel to
// plain.ssd_ref under the unchanged gates.  Figures: PERF.md section 6.
//
// ---- "sequential" (ssd_scan_fwd): float32 and bf16, any P, N <= 256 ----
// The port's first kernel, kept whole: float32 calls, bf16 calls shorter
// than the wrapper's CHUNKED_MIN_S, and bf16 calls whose P or N the
// chunked variant does not take.  Types: bf16 inputs accumulate
// in float32, float32 inputs in float64, one step wider than the inputs
// as bf16 is summed in float32 (where a row of y is the cancelled
// remainder of its terms, C_i·B_i near 0 when the decay leaves only j = i,
// float32 sums stray ~5e-4 of the row's scale from the exact scan, past
// the 1e-4 rule that holds float32 results to their plain version).
// * The Pallas grid (B, H, nc) walks the chunks in order with the (P, N)
//   state in VMEM.  Here the chunk loop runs inside the block.  State row
//   p only meets x[:, p] and y[:, p], so the P rows split into tiles of
//   PT = 16: grid (P / PT, H, B).  Each P tile recomputes the chunk's C·Bᵀ.
// * The chunk is Q = 32 tokens; CUDA cores, no prefetch: 97 dependent
//   chunk steps at the prefill (PERF.md section 6 has its times).
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

#include "mma_sm80.cuh"
#include "wgmma_sm90.cuh"  // cp.async

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

// ---- the chunked variant --------------------------------------------------

namespace {
namespace chunked {

using mma_sm80::ldsm_x4;
using mma_sm80::ldsm_x4_t;
using mma_sm80::mma16816;
using mma_sm80::pack_bf16;
using mma_sm80::smem_addr;

constexpr int NT = 256;     // threads of a phase 1 or phase 3 block: 8 warps
// heads of one group a block takes, at most: phase 1 (B shared), phase 3
// (C·Bᵀ shared; more heads a block amortize its C, B loads and C·Bᵀ)
constexpr int HB1_MAX = 4;
constexpr int HB3_MAX = 8;
constexpr int Q_ = 128;     // tokens a chunk
constexpr int P_ = 64;      // the head dim the instance takes
constexpr int N_ = 128;     // the d_state the instance takes
constexpr int PASS_NT = 256;  // threads of a phase 2 block, 4 elements each
constexpr int PASS_U = 8;     // chunk states phase 2 loads ahead
constexpr unsigned FULL = 0xffffffffu;

template <int Q, int P, int N>
struct Cfg {
  static constexpr int NS = N + 8;  // padded bf16 row of B, C, state planes
  static constexpr int PS = P + 8;  // padded bf16 row of x (16-byte shift
                                    // a row: ldmatrix rows hit 8 bank sets)
  static constexpr int KN = N / 16;  // k16 steps over N
  // phase 1: P/16 m-tiles of the state; the warps of one m-tile split N
  static constexpr int S_MT = P / 16;
  static constexpr int S_NW = N / (8 / S_MT);  // state columns a warp
  static constexpr int S_NT = S_NW / 8;
  // phase 3: Q/16 m-tiles of rows i; the warps of one m-tile split P
  static constexpr int MT = Q / 16;
  static constexpr int WP = 8 / MT;
  static constexpr int PW = P / WP;  // y columns a warp
  static constexpr int NPT = PW / 8;
  static_assert(Q % 32 == 0 && MT * WP == 8, "8 warps over Q / 16 m-tiles");
  static_assert(8 % S_MT == 0 && S_NT % 2 == 0 && NPT % 2 == 0,
                "n8 tiles go in pairs (ldmatrix x4)");
  static constexpr int SS = N + 4;  // padded float32 row of a staged state
  static constexpr size_t states_smem =  // B, x double-buffered, dt, seg,
      (static_cast<size_t>(Q) * NS + 2 * Q * PS) * 2  // the staged state
      + (2 * HB1_MAX * Q + P * SS) * 4;
  static constexpr size_t outputs_smem =  // C, B; x and both planes x 2
      (static_cast<size_t>(2) * Q * NS + 2 * (Q * PS + 2 * P * NS)) * 2
      + 2 * HB3_MAX * Q * 4;
};

// Asynchronous copy of a ROWS x COLS bf16 tile (global row stride ld) into
// shared memory (row stride sld); rows at or past `valid` are zeros.
template <int ROWS, int COLS>
__device__ __forceinline__ void load_tile(bf16* dst, int sld, const bf16* src,
                                          size_t ld, int valid) {
  constexpr int CH = COLS / 8;  // 16-byte pieces a row
  for (int e = threadIdx.x; e < ROWS * CH; e += NT) {
    const int r = e / CH, k = e % CH;
    const bool ok = r < valid;
    wgmma_sm90::cp_async16(smem_addr(dst + r * sld + k * 8),
                           ok ? src + r * ld + k * 8 : src, ok);
  }
}

// dt of the block's heads for the chunk, [hh][r], 0 past S.
template <int Q>
__device__ __forceinline__ void load_dt(float* sDt, const float* dt, int b,
                                        int s0, int S, int H, int h0, int hb) {
  for (int e = threadIdx.x; e < Q * hb; e += NT) {
    const int r = e / hb, hh = e % hb, s = s0 + r;
    sDt[hh * Q + r] =
        s < S ? dt[(static_cast<size_t>(b) * S + s) * H + h0 + hh] : 0.f;
  }
}

// One warp: cum = cumsum(dt · a) over the chunk, inclusive.  Lane l sums
// tokens l·Q/32 .. in token order, a Hillis-Steele scan adds the lanes'
// totals, and each partial gets its lane's exclusive prefix: another order
// than torch.cumsum's (plain.ssd_chunk_parallel restates it).  Each product
// and sum rounded apart, never fused.
template <int Q>
__device__ __forceinline__ void chunk_cumsum(const float* sdt, float a,
                                             float* scum, int lane) {
  constexpr int PER = Q / 32;
  float part[PER];
  float run = 0.f;
#pragma unroll
  for (int k = 0; k < PER; ++k) {
    run = __fadd_rn(run, __fmul_rn(sdt[lane * PER + k], a));
    part[k] = run;
  }
  float v = run;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float o = __shfl_up_sync(FULL, v, off);
    if (lane >= off) v = __fadd_rn(v, o);
  }
  float excl = __shfl_up_sync(FULL, v, 1);
  if (lane == 0) excl = 0.f;
#pragma unroll
  for (int k = 0; k < PER; ++k) scum[lane * PER + k] = __fadd_rn(excl, part[k]);
}

// v (two floats) as a hi/lo pair of bf16x2: hi = bf16(v), lo = bf16(v - hi).
__device__ __forceinline__ void split(float v0, float v1, uint32_t& hi,
                                      uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(v0, v1);
  const float2 hf = __bfloat1622float2(h);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = pack_bf16(v0 - hf.x, v1 - hf.y);
}

// v as three bf16x2 terms: hi = bf16(v), then the rest split as above.
__device__ __forceinline__ void split3(float v0, float v1, uint32_t& hi,
                                       uint32_t& mid, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(v0, v1);
  const float2 hf = __bfloat1622float2(h);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  split(v0 - hf.x, v1 - hf.y, mid, lo);
}

// s + e = a + b exactly (TwoSum; additions only, so nothing is fused).
__device__ __forceinline__ void two_sum(float a, float b, float& s, float& e) {
  s = __fadd_rn(a, b);
  const float bb = __fsub_rn(s, a);
  e = __fadd_rn(__fsub_rn(a, __fsub_rn(s, bb)), __fsub_rn(b, bb));
}

// (wh + wl) x + rest rounded to float32, then to odd where that rounding
// dropped something, so that y's rounding to bf16 is the rounding of the
// sum itself and not of its float32 rounding (round to odd).  At dt·|A| =
// 25 a token y_i is W_ii x_i plus ~1e-10 of it from the other tokens, and
// an element of y can lie that close to a bf16 tie.
__device__ __forceinline__ float diag_odd(float wh, float wl, float x,
                                          float rest) {
  const float p = __fmul_rn(wh, x);
  const float pe = __fmaf_rn(wh, x, -p);  // wh x - p, exact
  float s, e;
  two_sum(p, rest, s, e);
  const float err = __fadd_rn(__fadd_rn(e, pe), __fmul_rn(wl, x));
  uint32_t u = __float_as_uint(s);
  if (err != 0.f && !(u & 1u) && (u << 1) != 0u)
    u = (err > 0.f) == (s > 0.f) ? u + 1u : u - 1u;  // away from / to 0
  return __uint_as_float(u);
}

// x∘seg for an A fragment register of x (two tokens' values of one p).
__device__ __forceinline__ void split_scaled(uint32_t xv, float s0, float s1,
                                             uint32_t& hi, uint32_t& lo) {
  const float2 f = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&xv));
  split(f.x * s0, f.y * s1, hi, lo);
}

// ---- phase 1: each chunk's own state ----
// GRAD (the backward's mirror): x is dy, Bm is Cm and seg_j is E_j =
// e^{cum_j}, so S_c is the chunk's dS_c = Σ_k E_k dy_kᵀ C_k.
template <int Q, int P, int N, bool GRAD = false>
__global__ void __launch_bounds__(NT)
ssd_chunk_states(const bf16* __restrict__ x, const float* __restrict__ dt,
                 const float* __restrict__ A, const bf16* __restrict__ Bm,
                 float* __restrict__ states, float* __restrict__ decay, int S,
                 int H, int G, int hb) {
  using C_ = Cfg<Q, P, N>;
  constexpr int NS = C_::NS, PS = C_::PS;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sB = reinterpret_cast<bf16*>(smem_raw);    // [Q][NS]
  bf16* sX = sB + Q * NS;                          // [2][Q][PS]
  float* sDt = reinterpret_cast<float*>(sX + 2 * Q * PS);  // [HB1_MAX][Q]
  float* sSeg = sDt + HB1_MAX * Q;                 // [HB1_MAX][Q]
  float* sS = sSeg + HB1_MAX * Q;                  // [P][SS] S_c, staged

  const int c = blockIdx.x, h0 = blockIdx.y * hb, b = blockIdx.z;
  const int nc = gridDim.x, g = h0 / (H / G), s0 = c * Q;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const size_t tok0 = static_cast<size_t>(b) * S + s0;
  auto load_x = [&](int hh) {
    load_tile<Q, P>(sX + (hh & 1) * Q * PS, PS,
                    x + (tok0 * H + h0 + hh) * P, static_cast<size_t>(H) * P,
                    S - s0);
  };

  load_tile<Q, N>(sB, NS, Bm + (tok0 * G + g) * N,
                  static_cast<size_t>(G) * N, S - s0);
  load_x(0);
  wgmma_sm90::cp_async_commit();
  if (hb > 1) load_x(1);
  wgmma_sm90::cp_async_commit();
  load_dt<Q>(sDt, dt, b, s0, S, H, h0, hb);
  __syncthreads();
  if (warp < hb) {
    float* cum = sSeg + warp * Q;  // cum first, then seg in place
    chunk_cumsum<Q>(sDt + warp * Q, A[h0 + warp], cum, lane);
    __syncwarp();
    const float last = cum[Q - 1];
    __syncwarp();  // every lane has read cum_Q before seg overwrites it
#pragma unroll
    for (int k = 0; k < Q / 32; ++k) {
      const int j = lane + 32 * k;
      cum[j] = GRAD ? expf(cum[j]) : expf(last - cum[j]) * sDt[warp * Q + j];
    }
    if (lane == 0)
      decay[(static_cast<size_t>(b) * nc + c) * H + h0 + warp] = expf(last);
  }

  const int mt = warp % C_::S_MT, p0 = 16 * mt;
  const int n0 = (warp / C_::S_MT) * C_::S_NW;
  for (int hh = 0; hh < hb; ++hh) {
    wgmma_sm90::cp_async_wait<1>();
    __syncthreads();
    const bf16* X = sX + (hh & 1) * Q * PS;
    const float* seg = sSeg + hh * Q;
    float acc[C_::S_NT][4];
#pragma unroll
    for (int n = 0; n < C_::S_NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
#pragma unroll
    for (int ks = 0; ks < Q / 16; ++ks) {
      // A = (x∘seg)ᵀ: m = p, k = token, from x stored [token][p]
      uint32_t a[4], ahi[4], alo[4];
      ldsm_x4_t(a, X + (ks * 16 + lane % 8 + 8 * (lane / 16)) * PS + p0
                       + 8 * ((lane / 8) % 2));
      const float* sg = seg + ks * 16 + 2 * (lane % 4);
      split_scaled(a[0], sg[0], sg[1], ahi[0], alo[0]);
      split_scaled(a[1], sg[0], sg[1], ahi[1], alo[1]);
      split_scaled(a[2], sg[8], sg[9], ahi[2], alo[2]);
      split_scaled(a[3], sg[8], sg[9], ahi[3], alo[3]);
#pragma unroll
      for (int np = 0; np < C_::S_NT / 2; ++np) {
        uint32_t bb[4];  // B: k = token, n, stored [token][n]
        ldsm_x4_t(bb, sB + (ks * 16 + lane % 8 + 8 * ((lane / 8) % 2)) * NS
                          + n0 + np * 16 + 8 * (lane / 16));
        mma16816(acc[2 * np], ahi, bb[0], bb[1]);
        mma16816(acc[2 * np], alo, bb[0], bb[1]);
        mma16816(acc[2 * np + 1], ahi, bb[2], bb[3]);
        mma16816(acc[2 * np + 1], alo, bb[2], bb[3]);
      }
    }
    // S_c through shared memory, so that a warp stores 512 bytes in a row
    // (from the fragments it would store 32-byte pieces of 8 rows, which
    // was slower on an H100)
#pragma unroll
    for (int n = 0; n < C_::S_NT; ++n) {
      const int col = n0 + 8 * n + 2 * (lane % 4), row = p0 + lane / 4;
      *reinterpret_cast<float2*>(sS + row * C_::SS + col) =
          make_float2(acc[n][0], acc[n][1]);
      *reinterpret_cast<float2*>(sS + (row + 8) * C_::SS + col) =
          make_float2(acc[n][2], acc[n][3]);
    }
    __syncthreads();  // buffer hh & 1 is free again; S_c is staged
    float* out = states
        + ((static_cast<size_t>(b) * nc + c) * H + h0 + hh) * P * N;
    for (int e = threadIdx.x; e < P * N / 4; e += NT) {
      const int row = e / (N / 4), col = 4 * (e % (N / 4));
      *reinterpret_cast<float4*>(out + row * N + col) =
          *reinterpret_cast<const float4*>(sS + row * C_::SS + col);
    }
    if (hh + 2 < hb) load_x(hh + 2);
    wgmma_sm90::cp_async_commit();
  }
}

// ---- phase 2: the state entering each chunk, and the final state ----
// Element e of head (b, h): h_e = h0_e (or 0); per chunk c, the entering
// state goes out as a bf16 hi/lo pair (two planes of P·N), then h_e = h_e ·
// e^{cum_Q(c)} + S_c,e.  Four elements a thread.  hf may be null.
// REV (the backward's mirror): chunks last to first, h0 is dhf, S_c is
// dS_c, the pair written for chunk c is G_c, the gradient of the state
// leaving it, and hf receives dh0 = e^{cum_Q(0)} G_0 + dS_0.
template <bool REV = false>
__global__ void __launch_bounds__(PASS_NT)
ssd_state_pass(const float* __restrict__ states,
               const float* __restrict__ decay, const float* __restrict__ h0,
               bf16* __restrict__ hin, float* __restrict__ hf, int nc, int H,
               int PN) {
  const int e = 4 * (blockIdx.x * PASS_NT + threadIdx.x);
  if (e >= PN) return;
  const int h = blockIdx.y, b = blockIdx.z;
  const size_t head = static_cast<size_t>(b) * H + h;
  float4 st = h0 != nullptr
                  ? *reinterpret_cast<const float4*>(h0 + head * PN + e)
                  : make_float4(0.f, 0.f, 0.f, 0.f);
  for (int c0 = 0; c0 < nc; c0 += PASS_U) {
    float4 sc[PASS_U];
    float d[PASS_U];
#pragma unroll
    for (int u = 0; u < PASS_U; ++u) {
      if (c0 + u < nc) {
        const int c = REV ? nc - 1 - c0 - u : c0 + u;
        const size_t slot = (static_cast<size_t>(b) * nc + c) * H + h;
        sc[u] = *reinterpret_cast<const float4*>(states + slot * PN + e);
        d[u] = decay[slot];
      }
    }
#pragma unroll
    for (int u = 0; u < PASS_U; ++u) {
      if (c0 + u < nc) {
        const int c = REV ? nc - 1 - c0 - u : c0 + u;
        const size_t slot = (static_cast<size_t>(b) * nc + c) * H + h;
        uint2 hi, lo;
        split(st.x, st.y, hi.x, lo.x);
        split(st.z, st.w, hi.y, lo.y);
        *reinterpret_cast<uint2*>(hin + slot * 2 * PN + e) = hi;
        *reinterpret_cast<uint2*>(hin + slot * 2 * PN + PN + e) = lo;
        st.x = __fadd_rn(__fmul_rn(st.x, d[u]), sc[u].x);  // not fused, as
        st.y = __fadd_rn(__fmul_rn(st.y, d[u]), sc[u].y);  // the restatement
        st.z = __fadd_rn(__fmul_rn(st.z, d[u]), sc[u].z);
        st.w = __fadd_rn(__fmul_rn(st.w, d[u]), sc[u].w);
      }
    }
  }
  if (hf != nullptr) *reinterpret_cast<float4*>(hf + head * PN + e) = st;
}

// ---- phase 3: each chunk's outputs ----
template <int Q, int P, int N>
__global__ void __launch_bounds__(NT, 1)
ssd_chunk_outputs(const bf16* __restrict__ x, const float* __restrict__ dt,
                  const float* __restrict__ A, const bf16* __restrict__ Bm,
                  const bf16* __restrict__ Cm, const bf16* __restrict__ hin,
                  bf16* __restrict__ y, int S, int H, int G, int hb) {
  using C_ = Cfg<Q, P, N>;
  constexpr int NS = C_::NS, PS = C_::PS, MT = C_::MT, NPT = C_::NPT;
  constexpr int HEAD = Q * PS + 2 * P * NS;  // one head's tiles (bf16)
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sC = reinterpret_cast<bf16*>(smem_raw);  // [Q][NS]
  bf16* sB = sC + Q * NS;                        // [Q][NS]
  bf16* sHead = sB + Q * NS;  // [2] x {x [Q][PS], hi [P][NS], lo [P][NS]}
  float* sDt = reinterpret_cast<float*>(sHead + 2 * HEAD);  // [HB3_MAX][Q]
  float* sCum = sDt + HB3_MAX * Q;                           // [HB3_MAX][Q]

  const int c = blockIdx.x, h0 = blockIdx.y * hb, b = blockIdx.z;
  const int nc = gridDim.x, g = h0 / (H / G), s0 = c * Q;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const size_t tok0 = static_cast<size_t>(b) * S + s0;
  auto load_head = [&](int hh) {
    bf16* d = sHead + (hh & 1) * HEAD;
    load_tile<Q, P>(d, PS, x + (tok0 * H + h0 + hh) * P,
                    static_cast<size_t>(H) * P, S - s0);
    const bf16* planes =
        hin + ((static_cast<size_t>(b) * nc + c) * H + h0 + hh) * 2 * P * N;
    load_tile<2 * P, N>(d + Q * PS, NS, planes, N, 2 * P);
  };

  const size_t gb = (tok0 * G + g) * N;
  load_tile<Q, N>(sC, NS, Cm + gb, static_cast<size_t>(G) * N, S - s0);
  load_tile<Q, N>(sB, NS, Bm + gb, static_cast<size_t>(G) * N, S - s0);
  load_head(0);
  wgmma_sm90::cp_async_commit();
  if (hb > 1) load_head(1);
  wgmma_sm90::cp_async_commit();
  load_dt<Q>(sDt, dt, b, s0, S, H, h0, hb);
  __syncthreads();
  if (warp < hb)
    chunk_cumsum<Q>(sDt + warp * Q, A[h0 + warp], sCum + warp * Q, lane);
  wgmma_sm90::cp_async_wait<1>();
  __syncthreads();

  // warp: rows i0 .. i0 + 16, y columns pw0 .. pw0 + PW
  const int mt = warp % MT, i0 = 16 * mt, pw0 = (warp / MT) * C_::PW;
  uint32_t cf[C_::KN][4];  // C's A fragments, rows i0.., all of N
#pragma unroll
  for (int ks = 0; ks < C_::KN; ++ks)
    ldsm_x4(cf[ks], sC + (i0 + lane % 16) * NS + ks * 16 + 8 * (lane / 16));
  // C·Bᵀ for j-tiles (of 8) at or below the diagonal; the rest stay 0
  float cb[2 * MT][4];
#pragma unroll
  for (int jt = 0; jt < 2 * MT; ++jt)
#pragma unroll
    for (int e = 0; e < 4; ++e) cb[jt][e] = 0.f;
#pragma unroll
  for (int jp = 0; jp < MT; ++jp) {
    if (jp > mt) continue;
#pragma unroll
    for (int ks = 0; ks < C_::KN; ++ks) {
      uint32_t bb[4];  // k = n, n = token j, stored [j][n]
      ldsm_x4(bb, sB + (jp * 16 + lane % 8 + 8 * (lane / 16)) * NS + ks * 16
                      + 8 * ((lane / 8) % 2));
      mma16816(cb[2 * jp], cf[ks], bb[0], bb[1]);
      mma16816(cb[2 * jp + 1], cf[ks], bb[2], bb[3]);
    }
  }

  const int r0 = i0 + lane / 4, r1 = r0 + 8;  // this lane's rows
  // C_i·B_i of rows r0 and r1 as ds + dc, summed on the CUDA cores from
  // the exact bf16 products with TwoSum (the tensor cores drop the low
  // bits of their sums); a quad of lanes shares a row, N / 4 products each
  float ds[2], dc[2];
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int i = half ? r1 : r0;
    float sum = 0.f, comp = 0.f, e;
    for (int n = lane % 4; n < N; n += 4) {
      two_sum(sum, __fmul_rn(__bfloat162float(sC[i * NS + n]),
                             __bfloat162float(sB[i * NS + n])), sum, e);
      comp = __fadd_rn(comp, e);
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      const float so = __shfl_xor_sync(FULL, sum, off);
      const float co = __shfl_xor_sync(FULL, comp, off);
      two_sum(sum, so, sum, e);
      comp = __fadd_rn(comp, __fadd_rn(co, e));
    }
    ds[half] = sum;
    dc[half] = comp;
  }
  for (int hh = 0; hh < hb; ++hh) {
    if (hh > 0) {
      wgmma_sm90::cp_async_wait<1>();
      __syncthreads();
    }
    const bf16* X = sHead + (hh & 1) * HEAD;
    const bf16* Hi = X + Q * PS;
    const bf16* Lo = Hi + P * NS;
    const float* cum = sCum + hh * Q;
    const float* dtv = sDt + hh * Q;
    float acc[NPT][4];
#pragma unroll
    for (int n = 0; n < NPT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
    // C h_inᵀ: k = n, n = p, the state stored [p][n] as hi and lo planes
#pragma unroll
    for (int ks = 0; ks < C_::KN; ++ks)
#pragma unroll
      for (int pp = 0; pp < NPT / 2; ++pp) {
        const int off = (pw0 + pp * 16 + lane % 8 + 8 * (lane / 16)) * NS
                        + ks * 16 + 8 * ((lane / 8) % 2);
        uint32_t bh[4], bl[4];
        ldsm_x4(bh, Hi + off);
        ldsm_x4(bl, Lo + off);
        mma16816(acc[2 * pp], cf[ks], bh[0], bh[1]);
        mma16816(acc[2 * pp], cf[ks], bl[0], bl[1]);
        mma16816(acc[2 * pp + 1], cf[ks], bh[2], bh[3]);
        mma16816(acc[2 * pp + 1], cf[ks], bl[2], bl[3]);
      }
    const float c0 = cum[r0], c1 = cum[r1];
    const float e0 = expf(c0), e1 = expf(c1);
#pragma unroll
    for (int n = 0; n < NPT; ++n) {
      acc[n][0] *= e0; acc[n][1] *= e0;
      acc[n][2] *= e1; acc[n][3] *= e1;
    }
    // + W x over the j-steps at or below the diagonal, W_ii x_i aside
#pragma unroll
    for (int kk = 0; kk < MT; ++kk) {
      if (kk > mt) continue;
      float w[2][4];
#pragma unroll
      for (int half = 0; half < 2; ++half)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int j = (2 * kk + half) * 8 + 2 * (lane % 4) + (e & 1);
          const int i = e < 2 ? r0 : r1;
          // the exponent is taken below the diagonal only.  2^{d log2 e}
          // on the SFU (expf's range reduction was slower on an H100); the
          // product d·log2 e adds |d|·2^-24 to the exponent, ~1e-6 of W
          // at |d| <= 16
          w[half][e] = j < i ? cb[2 * kk + half][e]
                                    * wgmma_sm90::ex2(((e < 2 ? c0 : c1) - cum[j])
                                                      * 1.4426950408889634f)
                                    * dtv[j]
                              : 0.f;
        }
      uint32_t aw[3][4];  // W as three bf16 terms
      split3(w[0][0], w[0][1], aw[0][0], aw[1][0], aw[2][0]);
      split3(w[0][2], w[0][3], aw[0][1], aw[1][1], aw[2][1]);
      split3(w[1][0], w[1][1], aw[0][2], aw[1][2], aw[2][2]);
      split3(w[1][2], w[1][3], aw[0][3], aw[1][3], aw[2][3]);
#pragma unroll
      for (int dp = 0; dp < NPT / 2; ++dp) {
        uint32_t bb[4];  // k = token j, n = p, x stored [j][p]
        ldsm_x4_t(bb, X + (kk * 16 + lane % 8 + 8 * ((lane / 8) % 2)) * PS
                          + pw0 + dp * 16 + 8 * (lane / 16));
#pragma unroll
        for (int t = 0; t < 3; ++t) {
          mma16816(acc[2 * dp], aw[t], bb[0], bb[1]);
          mma16816(acc[2 * dp + 1], aw[t], bb[2], bb[3]);
        }
      }
    }
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = half ? r1 : r0, s = s0 + r;
      if (s >= S) continue;
      // W_ii = C_i·B_i e^0 dt_i as wh + wl
      const float wh = __fmul_rn(ds[half], dtv[r]);
      const float wl = __fadd_rn(__fmaf_rn(ds[half], dtv[r], -wh),
                                 __fmul_rn(dc[half], dtv[r]));
      bf16* row = y + ((static_cast<size_t>(b) * S + s) * H + h0 + hh) * P;
#pragma unroll
      for (int n = 0; n < NPT; ++n) {
        const int p = pw0 + 8 * n + 2 * (lane % 4);
        const float2 xi = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(X + r * PS + p));
        *reinterpret_cast<uint32_t*>(row + p) =
            pack_bf16(diag_odd(wh, wl, xi.x, acc[n][2 * half]),
                      diag_odd(wh, wl, xi.y, acc[n][2 * half + 1]));
      }
    }
    __syncthreads();  // buffer hh & 1 is free again
    if (hh + 2 < hb) load_head(hh + 2);
    wgmma_sm90::cp_async_commit();
  }
}

int launch(const void* x, const void* dt, const void* A, const void* Bm,
           const void* Cm, const void* h0, void* y, void* hf, void* states,
           void* hin, void* decay, int B, int S, int H, int G,
           cudaStream_t stream) {
  constexpr int Q = Q_;
  using C_ = Cfg<Q, P_, N_>;
  const int rep = H / G;  // the largest power of 2 up to HB*_MAX dividing it
  const int hb1 = rep % 4 == 0 ? 4 : rep % 2 == 0 ? 2 : 1;
  const int hb3 = rep % 8 == 0 ? 8 : hb1;
  const int nc = (S + Q - 1) / Q;
  cudaError_t err = cudaFuncSetAttribute(
      ssd_chunk_states<Q, P_, N_>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(C_::states_smem));
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(ssd_chunk_outputs<Q, P_, N_>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(C_::outputs_smem));
  if (err != cudaSuccess) return err;
  const bf16* xb = static_cast<const bf16*>(x);
  const float* dtf = static_cast<const float*>(dt);
  const float* Af = static_cast<const float*>(A);
  const bf16* Bb = static_cast<const bf16*>(Bm);
  float* st = static_cast<float*>(states);
  float* dc = static_cast<float*>(decay);
  bf16* hn = static_cast<bf16*>(hin);
  ssd_chunk_states<Q, P_, N_><<<dim3(nc, H / hb1, B), NT, C_::states_smem,
                                stream>>>(xb, dtf, Af, Bb, st, dc, S, H, G,
                                          hb1);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const int PN = P_ * N_;
  const dim3 pass_grid((PN / 4 + PASS_NT - 1) / PASS_NT, H, B);
  ssd_state_pass<false><<<pass_grid, PASS_NT, 0, stream>>>(
      st, dc, static_cast<const float*>(h0), hn, static_cast<float*>(hf), nc,
      H, PN);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  ssd_chunk_outputs<Q, P_, N_><<<dim3(nc, H / hb3, B), NT, C_::outputs_smem,
                                 stream>>>(xb, dtf, Af, Bb,
                                           static_cast<const bf16*>(Cm), hn,
                                           static_cast<bf16*>(y), S, H, G,
                                           hb3);
  return cudaGetLastError();
}

}  // namespace chunked
}  // namespace

// bf16 x, Bm, Cm and y, and h0 if given, 16-byte aligned; dt, A, h0 and
// hf float32; h0 may be null.  P = 64, N = 128.  Scratch from the caller:
// states float32 (B, nc, H, P, N), hin bf16 (B, nc, H, 2, P, N) and decay
// float32 (B, nc, H), nc = ceil(S / Q_).  Three kernels on `stream`;
// returns the first launch error, 0 if none.
extern "C" int ssd_scan_chunked_fwd(const void* x, const void* dt,
                                    const void* A, const void* Bm,
                                    const void* Cm, const void* h0, void* y,
                                    void* hf, void* states, void* hin,
                                    void* decay, int B, int S, int H, int P,
                                    int G, int N, void* stream) {
  if (B < 1 || S < 1 || H < 1 || G < 1 || H % G || P != chunked::P_
      || N != chunked::N_ || B > 65535 || H > 65535)
    return cudaErrorInvalidValue;
  return chunked::launch(x, dt, A, Bm, Cm, h0, y, hf, states, hin, decay, B,
                         S, H, G, static_cast<cudaStream_t>(stream));
}

// ---- the sequential backward (ssd_scan_bwd): float32 and bf16, any P, --
// ---- N <= 128: float32 calls, bf16 calls shorter than CHUNKED_MIN_S and
// ---- the widths the chunked backward (below) does not take ------------
//
// Replaces the gradient JAX forms for src/repro/kernels/ssd_scan.py::ssd by
// differentiating its plain path (ref.py::ssd_ref; the JAX package defines
// no custom_vjp).  Contract: plain.ssd_bwd_ref — cotangents dy (B,S,H,P)
// and dhf (B,H,P,N) float32 (null: zeros) in; dx in x's type, ddt
// (B,S,H) and dA (H,) float32, dB / dC (B,S,G,N) in B's type, dh0 float32
// (when there is an initial state) out.  With a_t = e^{dt_t A}:
//   dh_t = a_{t+1} dh_{t+1} + dy_t C_tᵀ        dh_S = dhf + dy_S C_Sᵀ
//   dC_t = h_tᵀ dy_t   dx_t = dt_t dh_t B_t   dB_t = dt_t dh_tᵀ x_t
//   ddt_t = A a_t <dh_t, h_{t-1}> + <dh_t, x_t B_tᵀ>
//   dA = Σ_t dt_t a_t <dh_t, h_{t-1}>          dh0 = a_1 dh_1
//
// One block per (P tile of PT rows, head, batch row), as the sequential
// forward, in two walks over 32-token chunks:
// 1. Forward: the states are recomputed from the initial state (the
//    forward's step 5 alone) and the state entering every chunk, the
//    walk's checkpoints, goes to a scratch in the accumulation type
//    (B, nc, H, P, N).  No state is ever reversed: h_{t-1} = (h_t - …) /
//    a_t overflows once dt·|A| is large.  The Function's forward keeps no
//    state: this walk reads only x, B and dt and costs a fraction of the
//    second.
// 2. Backward, chunks last to first, carrying G = the gradient of the
//    state leaving the chunk (dhf for the last).  Within a chunk, with
//    cum_i = Σ_{j<=i} dt_j A, E_i = e^{cum_i}, D_i = e^{cum_Q - cum_i},
//    L_ki = e^{cum_k - cum_i} (k >= i), M_ki = (C_k·B_i) L_ki, Z_ki = dy_k·
//    x_i over the tile's rows, T_ki = Z_ki L_ki and h_in the checkpoint:
//      u_i   = dh_i B_i = Σ_{k>=i} M_ki dy_k + D_i G B_i,  dx_i = dt_i u_i
//      dB_i  = dt_i (D_i Gᵀ x_i + Σ_{k>=i} T_ki C_k)
//      dC_i  = Σ_{j<=i} T_ij dt_j B_j + E_i h_inᵀ dy_i
//      a_t <dh_t, h_{t-1}> = e^{cum_Q} <G, h_in> + Σ_{j<t} D_j dt_j x_j·
//              (G B_j) + Σ_{k>=t} E_k dy_k·(h_in C_k) + Σ_{k>=t>j} M_kj
//              dt_j Z_kj
//      G     <- e^{cum_Q} G + Σ_k E_k dy_k C_kᵀ
//    Every exponent is <= 0 and no two large terms cancel: the decay
//    term is formed from products that carry their own e^{…}, so at dt·
//    |A| = 25 a token it is as accurate, relative to its own (tiny) size,
//    as at small decays.  (Forming it from the identity a_t <dh_t,
//    h_{t-1}> = <dh_t, h_t> - dt_t <dh_t, x_t B_tᵀ> instead subtracts two
//    terms of the size of dy·y: in float32 at dt·|A| = 25 that leaves dA
//    wrong by far more than its own size.)
// dx and dh0 are whole in one block.  dB, dC, ddt and dA are sums over the
// P tiles (and dB / dC over the H / G heads of a group, dA over the batch
// rows): each block writes its partial sums to a workspace in the
// accumulation type, and ssd_bwd_reduce adds them in a fixed order — no
// atomics, so two runs are bit-identical.  Types: bf16 inputs accumulate
// in float32, float32 inputs in float64, as the sequential forward.
// What bounds it: the contract moves x, dy and dx (P a token and head), B,
// C, dB and dC (N a token and group), dt and ddt: 83 MB at mamba2-370m's
// training shape (B 2, S 3072, H 32, P 64, G 1, N 128), 0.025 ms at 3.35
// TB/s, above its least operations (12 P N a token and head: 0.020 ms at
// 989 TFLOP/s); this design adds the
// checkpoints (written and read once, 0.2 GB there) and the workspaces
// (4 P tiles x dB and dC partials: 0.8 GB), and walks 2 x 96 dependent
// chunk steps on the CUDA cores.  The chunked backward below takes the
// main path's calls.  PERF.md section 6 has both variants' times.

namespace {
namespace bwd {

constexpr int N_MAX = 128;  // d_state the backward takes

constexpr size_t smem_elems(int N) {
  return static_cast<size_t>(2 * Q + 2 * PT) * (N + 4) + 5 * Q * PT
         + 3 * Q * (Q + 1) + 8 * Q + 1 + NT;
}

// The workspace, in Acc elements: checkpoints (B, nc, H, P, N), then the
// partial sums of dB and dC (tiles, B, S, H, N) each, of ddt (tiles, B, S,
// H) and of dA (tiles, B, H).
struct Ws {
  size_t hin, db, dc, dd, da, total;
  __host__ __device__ Ws(int B, int S, int H, int P, int N) {
    const size_t nc = (S + Q - 1) / Q, nt = (P + PT - 1) / PT;
    hin = 0;
    db = hin + static_cast<size_t>(B) * nc * H * P * N;
    dc = db + nt * B * S * static_cast<size_t>(H) * N;
    dd = dc + nt * B * S * static_cast<size_t>(H) * N;
    da = dd + nt * B * S * static_cast<size_t>(H);
    total = da + nt * B * static_cast<size_t>(H);
  }
};

template <typename T>
__global__ void __launch_bounds__(NT)
ssd_bwd(const T* __restrict__ x, const float* __restrict__ dt,
        const float* __restrict__ A, const T* __restrict__ Bm,
        const T* __restrict__ Cm, const float* __restrict__ h0,
        const T* __restrict__ dy, const float* __restrict__ dhf,
        T* __restrict__ dx, float* __restrict__ dh0,
        typename AccOf<T>::type* __restrict__ ws, int S, int H, int P,
        int G, int N) {
  using Acc = typename AccOf<T>::type;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Acc* smem = reinterpret_cast<Acc*>(smem_raw);
  const int NS = N + 4;
  Acc* sB = smem;               // [Q][NS]
  Acc* sC = sB + Q * NS;        // [Q][NS]
  Acc* sH = sC + Q * NS;        // [PT][NS] state (walk 1), h_in (walk 2)
  Acc* sG = sH + PT * NS;       // [PT][NS] the carried gradient G
  Acc* sX = sG + PT * NS;       // [Q][PT]
  Acc* sDY = sX + Q * PT;       // [Q][PT]
  Acc* sU = sDY + Q * PT;       // [Q][PT] u_i
  Acc* sWv = sU + Q * PT;       // [Q][PT] G B_i
  Acc* sHC = sWv + Q * PT;      // [Q][PT] h_in C_i
  Acc* sM = sHC + Q * PT;       // [Q][Q + 1] M_ij, j <= i
  Acc* sZ = sM + Q * (Q + 1);   // [Q][Q + 1] Z_ij = dy_i·x_j, j <= i
  Acc* sT = sZ + Q * (Q + 1);   // [Q][Q + 1] Z_ij L_ij
  Acc* sDt = sT + Q * (Q + 1);  // [Q]
  Acc* sE = sDt + Q;            // [Q] e^{cum_i}
  Acc* sD = sE + Q;             // [Q] e^{cum_Q - cum_i}
  Acc* sQv = sD + Q;            // [Q] q_i = x_i·u_i
  Acc* sSig = sQv + Q;          // [Q] D_i dt_i x_i·(G B_i)
  Acc* sTau = sSig + Q;         // [Q] E_i dy_i·(h_in C_i)
  Acc* sDl = sTau + Q;          // [Q] a_t <dh_t, h_{t-1}> (the tile's part)
  Acc* sCum = sDl + Q;          // [Q + 1] cum_i, then [Q] = e^{cum_Q}
  Acc* sRed = sCum + Q + 1;     // [NT]

  const int pt = blockIdx.x, p0 = pt * PT, h = blockIdx.y, b = blockIdx.z;
  const int Bsz = gridDim.z;
  const int g = h / (H / G);
  const int t = threadIdx.x;
  const Acc a_h = A[h];
  const int nc = (S + Q - 1) / Q;
  const size_t head_state = (static_cast<size_t>(b) * H + h) * P;
  const Ws layout(Bsz, S, H, P, N);
  Acc* hin = ws + layout.hin;
  // partial sums of this tile: [b][s][h] (x N for dB and dC)
  const size_t part = static_cast<size_t>(pt) * Bsz * S * H;
  Acc* wsB = ws + layout.db + part * N;
  Acc* wsC = ws + layout.dc + part * N;
  Acc* wsD = ws + layout.dd + part;
  auto ckpt = [&](int c, int p) {  // row p of chunk c's checkpoint
    return hin + ((static_cast<size_t>(b) * nc + c) * H + h) * P * N
           + static_cast<size_t>(p0 + p) * N;
  };
  auto tok = [&](int s) {  // (b, s, h)
    return (static_cast<size_t>(b) * S + s) * H + h;
  };

  // chunk s0's B (and C), x (and dy) tiles and dt, widened; zeros past S
  auto load = [&](int s0, bool grads) {
    for (int e = t; e < Q * N; e += NT) {
      const int r = e / N, n = e % N, s = s0 + r;
      Acc bv = 0, cv = 0;
      if (s < S) {
        const size_t off = ((static_cast<size_t>(b) * S + s) * G + g) * N + n;
        bv = widen(Bm[off]);
        if (grads) cv = widen(Cm[off]);
      }
      sB[r * NS + n] = bv;
      if (grads) sC[r * NS + n] = cv;
    }
    for (int e = t; e < Q * PT; e += NT) {
      const int r = e / PT, p = e % PT, s = s0 + r;
      const bool ok = s < S && p0 + p < P;
      const size_t off = tok(s) * P + p0 + p;
      sX[e] = ok ? widen(x[off]) : Acc(0);
      if (grads) sDY[e] = ok ? widen(dy[off]) : Acc(0);
    }
    if (t < Q) {
      const int s = s0 + t;
      sDt[t] = s < S ? static_cast<Acc>(dt[tok(s)]) : Acc(0);
    }
  };
  // cum over the chunk (one thread, token order, as the forward), then
  // warp 0: sE, sD and sCum[Q] = e^{cum_Q}
  auto decays = [&] {
    if (t < 32) {
      if (t == 0) {
        Acc c = 0;
        for (int i = 0; i < Q; ++i) {
          c = mul_add_rn(c, sDt[i], a_h);
          sCum[i] = c;
        }
      }
      __syncwarp();
      const Acc c = sCum[t], last = sCum[Q - 1];
      sE[t] = exp_(c);
      sD[t] = exp_(last - c);
      __syncwarp();
      if (t == 0) sCum[Q] = exp_(last);
    }
  };

  // ---- walk 1: the checkpoints ----
  for (int e = t; e < PT * N; e += NT) {
    const int p = e / N, n = e % N;
    sH[p * NS + n] = (h0 != nullptr && p0 + p < P)
                         ? static_cast<Acc>(h0[(head_state + p0 + p) * N + n])
                         : Acc(0);
  }
  __syncthreads();
  for (int c = 0; c < nc; ++c) {
    for (int e = t; e < PT * N; e += NT) {
      const int p = e / N, n = e % N;
      if (p0 + p < P) ckpt(c, p)[n] = sH[p * NS + n];
    }
    load(c * Q, false);
    __syncthreads();
    decays();
    __syncthreads();
    // state = state e^{cum_Q} + Σ_j x_j (D_j dt_j B_j)ᵀ (the forward's step 5)
    {
      const Acc dlast = sCum[Q];
      for (int e = t; e < N * (PT / 8); e += NT) {
        const int n = e % N, r0 = 8 * (e / N);
        Acc acc[8] = {};
        for (int j = 0; j < Q; ++j) {
          const Acc bj = sB[j * NS + n] * (sD[j] * sDt[j]);
#pragma unroll
          for (int k = 0; k < 8; ++k) acc[k] += sX[j * PT + r0 + k] * bj;
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

  // ---- walk 2: the gradients, chunks last to first ----
  for (int e = t; e < PT * N; e += NT) {
    const int p = e / N, n = e % N;
    sG[p * NS + n] = (dhf != nullptr && p0 + p < P)
                         ? static_cast<Acc>(dhf[(head_state + p0 + p) * N + n])
                         : Acc(0);
  }
  Acc dA_acc = 0;  // thread 0: Σ_t dt_t a_t <dh_t, h_{t-1}>, token order
                   // within a chunk, chunks last to first
  for (int c = nc - 1; c >= 0; --c) {
    const int s0 = c * Q;
    load(s0, true);
    for (int e = t; e < PT * N; e += NT) {
      const int p = e / N, n = e % N;
      sH[p * NS + n] = p0 + p < P ? ckpt(c, p)[n] : Acc(0);
    }
    __syncthreads();
    decays();
    __syncthreads();

    // M, Z and T at (i0, j0), (i1, j0), (i1, j1); (i0, j1) lies above the
    // diagonal
    {
      const int i0 = t / 16, j0 = t % 16, i1 = i0 + 16, j1 = j0 + 16;
      Acc m00 = 0, m10 = 0, m11 = 0;
      for (int n = 0; n < N; n += 4) {
        const Four<Acc> c0 = ld4(&sC[i0 * NS + n]);
        const Four<Acc> c1 = ld4(&sC[i1 * NS + n]);
        const Four<Acc> b0 = ld4(&sB[j0 * NS + n]);
        const Four<Acc> b1 = ld4(&sB[j1 * NS + n]);
        m00 += dot4(c0, b0);
        m10 += dot4(c1, b0);
        m11 += dot4(c1, b1);
      }
      Acc z00 = 0, z10 = 0, z11 = 0;
      for (int p = 0; p < PT; ++p) {
        const Acc y0 = sDY[i0 * PT + p], y1 = sDY[i1 * PT + p];
        const Acc x0 = sX[j0 * PT + p], x1 = sX[j1 * PT + p];
        z00 += y0 * x0;
        z10 += y1 * x0;
        z11 += y1 * x1;
      }
      const Acc l00 = j0 <= i0 ? exp_(sCum[i0] - sCum[j0]) : Acc(0);
      const Acc l10 = exp_(sCum[i1] - sCum[j0]);
      const Acc l11 = j1 <= i1 ? exp_(sCum[i1] - sCum[j1]) : Acc(0);
      const int r0 = i0 * (Q + 1), r1 = i1 * (Q + 1);
      sM[r0 + j0] = m00 * l00;
      sM[r0 + j1] = 0;
      sM[r1 + j0] = m10 * l10;
      sM[r1 + j1] = m11 * l11;
      sZ[r0 + j0] = j0 <= i0 ? z00 : Acc(0);
      sZ[r0 + j1] = 0;
      sZ[r1 + j0] = z10;
      sZ[r1 + j1] = j1 <= i1 ? z11 : Acc(0);
      sT[r0 + j0] = z00 * l00;
      sT[r0 + j1] = 0;
      sT[r1 + j0] = z10 * l10;
      sT[r1 + j1] = z11 * l11;
    }
    // G B_i and h_in C_i, rows i0 and i0 + 16 of column p
    {
      const int p = t % PT, i0 = t / PT, i1 = i0 + 16;
      Acc w0 = 0, w1 = 0, k0 = 0, k1 = 0;
      for (int n = 0; n < N; n += 4) {
        const Four<Acc> gv = ld4(&sG[p * NS + n]);
        const Four<Acc> hv = ld4(&sH[p * NS + n]);
        w0 += dot4(gv, ld4(&sB[i0 * NS + n]));
        w1 += dot4(gv, ld4(&sB[i1 * NS + n]));
        k0 += dot4(hv, ld4(&sC[i0 * NS + n]));
        k1 += dot4(hv, ld4(&sC[i1 * NS + n]));
      }
      sWv[i0 * PT + p] = w0;
      sWv[i1 * PT + p] = w1;
      sHC[i0 * PT + p] = k0;
      sHC[i1 * PT + p] = k1;
    }
    // <G, h_in> over the tile: each thread's part, then a tree in a fixed
    // order
    {
      Acc s = 0;
      for (int e = t; e < PT * N; e += NT) {
        const int p = e / N, n = e % N;
        s += sG[p * NS + n] * sH[p * NS + n];
      }
      sRed[t] = s;
    }
    __syncthreads();
    for (int half = NT / 2; half > 0; half >>= 1) {
      if (t < half) sRed[t] += sRed[t + half];
      __syncthreads();
    }

    // u_i = Σ_{k>=i} M_ki dy_k + D_i G B_i; dx_i = dt_i u_i
    {
      const int p = t % PT, i0 = t / PT, i1 = i0 + 16;
      Acc u0 = sD[i0] * sWv[i0 * PT + p], u1 = sD[i1] * sWv[i1 * PT + p];
      for (int k = i0; k < Q; ++k) u0 += sM[k * (Q + 1) + i0] * sDY[k * PT + p];
      for (int k = i1; k < Q; ++k) u1 += sM[k * (Q + 1) + i1] * sDY[k * PT + p];
      sU[i0 * PT + p] = u0;
      sU[i1 * PT + p] = u1;
      if (p0 + p < P) {
        if (s0 + i0 < S) store(&dx[tok(s0 + i0) * P + p0 + p], sDt[i0] * u0);
        if (s0 + i1 < S) store(&dx[tok(s0 + i1) * P + p0 + p], sDt[i1] * u1);
      }
    }
    __syncthreads();

    // the token's scalars: q_i, σ_i, τ_i
    if (t < Q) {
      Acc q = 0, sg = 0, ta = 0;
      for (int p = 0; p < PT; ++p) {
        const Acc xv = sX[t * PT + p];
        q += xv * sU[t * PT + p];
        sg += xv * sWv[t * PT + p];
        ta += sDY[t * PT + p] * sHC[t * PT + p];
      }
      sQv[t] = q;
      sSig[t] = sD[t] * sDt[t] * sg;
      sTau[t] = sE[t] * ta;
    }
    __syncthreads();

    // a_t <dh_t, h_{t-1}> and the tile's part of ddt_t
    if (t < Q) {
      Acc dl = sCum[Q] * sRed[0];
      for (int j = 0; j < t; ++j) dl += sSig[j];
      for (int k = t; k < Q; ++k) dl += sTau[k];
      for (int k = t; k < Q; ++k) {
        const Acc* mk = &sM[k * (Q + 1)];
        const Acc* zk = &sZ[k * (Q + 1)];
        for (int j = 0; j < t; ++j) dl += mk[j] * sDt[j] * zk[j];
      }
      sDl[t] = dl;
      if (s0 + t < S) wsD[tok(s0 + t)] = a_h * dl + sQv[t];
    }
    // dB_i and dC_i, the tile's parts
    for (int e = t; e < Q * N; e += NT) {
      const int i = e / N, n = e % N;
      if (s0 + i >= S) continue;
      Acc gx = 0, hy = 0;
      for (int p = 0; p < PT; ++p) {
        gx += sG[p * NS + n] * sX[i * PT + p];
        hy += sH[p * NS + n] * sDY[i * PT + p];
      }
      Acc tb = 0, tc = 0;
      for (int k = i; k < Q; ++k) tb += sT[k * (Q + 1) + i] * sC[k * NS + n];
      for (int j = 0; j <= i; ++j)
        tc += sT[i * (Q + 1) + j] * (sDt[j] * sB[j * NS + n]);
      const size_t off = tok(s0 + i) * N + n;
      wsB[off] = sDt[i] * (sD[i] * gx + tb);
      wsC[off] = tc + sE[i] * hy;
    }
    __syncthreads();
    if (t == 0)
      for (int i = 0; i < Q; ++i) dA_acc += sDt[i] * sDl[i];

    // G <- G e^{cum_Q} + Σ_k dy_k (E_k C_k)ᵀ
    {
      const Acc dlast = sCum[Q];
      for (int e = t; e < N * (PT / 8); e += NT) {
        const int n = e % N, r0 = 8 * (e / N);
        Acc acc[8] = {};
        for (int k = 0; k < Q; ++k) {
          const Acc ck = sC[k * NS + n] * sE[k];
#pragma unroll
          for (int r = 0; r < 8; ++r) acc[r] += sDY[k * PT + r0 + r] * ck;
        }
#pragma unroll
        for (int r = 0; r < 8; ++r) {
          Acc* st = &sG[(r0 + r) * NS + n];
          *st = *st * dlast + acc[r];
        }
      }
    }
    __syncthreads();
  }

  if (dh0 != nullptr)
    for (int e = t; e < PT * N; e += NT) {
      const int p = e / N, n = e % N;
      if (p0 + p < P)
        dh0[(head_state + p0 + p) * N + n] = static_cast<float>(sG[p * NS + n]);
    }
  if (t == 0)
    ws[layout.da + (static_cast<size_t>(pt) * Bsz + b) * H + h] = dA_acc;
}

// The tiles' partial sums, added in a fixed order: dB / dC over the
// group's heads (outer) and the tiles (inner), ddt over the tiles, dA over
// the batch rows (outer) and the tiles (inner).
template <typename T>
__global__ void __launch_bounds__(NT)
ssd_bwd_reduce(const typename AccOf<T>::type* __restrict__ ws,
               T* __restrict__ dB, T* __restrict__ dC,
               float* __restrict__ ddt, float* __restrict__ dA, int Bsz,
               int S, int H, int P, int G, int N) {
  using Acc = typename AccOf<T>::type;
  const Ws layout(Bsz, S, H, P, N);
  const int nt = (P + PT - 1) / PT, rep = H / G;
  const size_t bs = static_cast<size_t>(Bsz) * S;
  const size_t n1 = bs * G * N, n2 = n1 + bs * H, n3 = n2 + H;
  for (size_t i = blockIdx.x * static_cast<size_t>(NT) + threadIdx.x; i < n3;
       i += static_cast<size_t>(gridDim.x) * NT) {
    if (i < n1) {
      const size_t n = i % N, r = i / N, gg = r % G, row = r / G;
      Acc sb = 0, sc = 0;
      for (int hh = gg * rep; hh < (gg + 1) * rep; ++hh)
        for (int p = 0; p < nt; ++p) {
          const size_t off = ((p * bs + row) * H + hh) * N + n;
          sb += ws[layout.db + off];
          sc += ws[layout.dc + off];
        }
      store(&dB[i], sb);
      store(&dC[i], sc);
    } else if (i < n2) {
      const size_t j = i - n1;
      Acc s = 0;
      for (int p = 0; p < nt; ++p) s += ws[layout.dd + p * bs * H + j];
      ddt[j] = static_cast<float>(s);
    } else {
      const size_t hh = i - n2;
      Acc s = 0;
      for (int bb = 0; bb < Bsz; ++bb)
        for (int p = 0; p < nt; ++p)
          s += ws[layout.da + (static_cast<size_t>(p) * Bsz + bb) * H + hh];
      dA[hh] = static_cast<float>(s);
    }
  }
}

template <typename T>
int launch(const void* x, const void* dt, const void* A, const void* Bm,
           const void* Cm, const void* h0, const void* dy, const void* dhf,
           void* dx, void* ddt, void* dA, void* dB, void* dC, void* dh0,
           void* ws, int B, int S, int H, int P, int G, int N,
           cudaStream_t stream) {
  using Acc = typename AccOf<T>::type;
  const size_t smem = smem_elems(N) * sizeof(Acc);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_bwd<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((P + PT - 1) / PT, H, B);
  ssd_bwd<T><<<grid, NT, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(A), static_cast<const T*>(Bm),
      static_cast<const T*>(Cm), static_cast<const float*>(h0),
      static_cast<const T*>(dy), static_cast<const float*>(dhf),
      static_cast<T*>(dx), static_cast<float*>(dh0), static_cast<Acc*>(ws),
      S, H, P, G, N);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const size_t items = static_cast<size_t>(B) * S * (G * N + H) + H;
  const size_t blocks = (items + NT - 1) / NT;
  ssd_bwd_reduce<T><<<static_cast<unsigned>(blocks < 4096 ? blocks : 4096),
                      NT, 0, stream>>>(
      static_cast<const Acc*>(ws), static_cast<T*>(dB), static_cast<T*>(dC),
      static_cast<float*>(ddt), static_cast<float*>(dA), B, S, H, P, G, N);
  return cudaGetLastError();
}

}  // namespace bwd
}  // namespace

// Bytes of the workspace ssd_scan_bwd takes (dtype 0 float32, 1 bfloat16).
extern "C" long long ssd_scan_bwd_workspace(int B, int S, int H, int P,
                                            int N, int dtype) {
  const bwd::Ws layout(B, S, H, P, N);
  return static_cast<long long>(layout.total)
         * (dtype == 0 ? sizeof(double) : sizeof(float));
}

// The gradient of ssd_scan_fwd / ssd_scan_chunked_fwd.  x, Bm, Cm, dy and
// the outputs dx, dB, dC in one dtype (0 float32, 1 bfloat16); dt, A, h0,
// dhf and ddt, dA, dh0 float32; all contiguous.  h0 and dhf may be null
// (zeros); dh0 is written when not null.  ws: ssd_scan_bwd_workspace
// bytes.  N a multiple of 4 up to 128.  Two kernels on `stream`; returns
// the first launch error, 0 if none.
extern "C" int ssd_scan_bwd(const void* x, const void* dt, const void* A,
                            const void* Bm, const void* Cm, const void* h0,
                            const void* dy, const void* dhf, void* dx,
                            void* ddt, void* dA, void* dB, void* dC,
                            void* dh0, void* ws, int B, int S, int H, int P,
                            int G, int N, int dtype, void* stream) {
  if (B < 1 || S < 1 || H < 1 || P < 1 || G < 1 || N < 4 || N > bwd::N_MAX
      || N % 4 || H % G || H > 65535 || B > 65535)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return bwd::launch<float>(x, dt, A, Bm, Cm, h0, dy, dhf, dx, ddt, dA, dB,
                              dC, dh0, ws, B, S, H, P, G, N, st);
  if (dtype == 1)
    return bwd::launch<bf16>(x, dt, A, Bm, Cm, h0, dy, dhf, dx, ddt, dA, dB,
                             dC, dh0, ws, B, S, H, P, G, N, st);
  return cudaErrorInvalidValue;
}

// ---- the chunked backward (ssd_scan_chunked_bwd): bf16, P 64, N 128 -----
//
// The backward of the main path: mamba2-370m's training call (B 2, S 3072,
// H 32, P 64, G 1, N 128), the contract of plain.ssd_bwd_ref as above.
// Chunks of Q_ = 128 tokens, built on the forward's phases; six kernels on
// the caller's stream:
// 1-2. ssd_chunk_states and ssd_state_pass, the forward's, unchanged: the
//    state entering each chunk as the forward's bf16 hi/lo pair, bit for
//    bit the forward's own (the Function keeps only the inputs).
// 3. ssd_chunk_states<GRAD>, the mirror of phase 1 with dy for x, C for B
//    and E_k = e^{cum_k} for seg: dS_c = Σ_k E_k dy_kᵀ C_k (P x N), on
//    mma.sync with dy∘E as a hi/lo pair.
// 4. ssd_state_pass<REV>, the mirror of phase 2, chunks last to first from
//    dhf (or 0): G_{c-1} = e^{cum_Q(c)} G_c + dS_c, float32 elementwise;
//    it writes each chunk's G_c (the gradient of the state leaving it) as
//    a hi/lo pair and gives dh0.
// 5. ssd_chunk_grads, grid (chunk, head block, batch row) as phase 3, 8
//    warps each owning 16 rows i of the chunk, per head of the block (up
//    to HBG_MAX = 4 of one group, which share the chunk's B and C):
//      u  = D∘(B Gᵀ) + Mᵀ dy               dx = dt∘u
//      dB = dt∘(D∘(X G) + Tᵀ C)            dC = (T∘dt_j) B + E∘(dy h_in)
//    with D_i = e^{cum_Q - cum_i}, E_i = e^{cum_i}, L_ki = e^{cum_k - cum_i}
//    (k >= i only: every exponent <= 0), M_ki = (C_k·B_i) L_ki and T_ki =
//    (dy_k·x_i) L_ki, formed a 16 x 16 tile at a time in registers (Mᵀ and
//    Tᵀ for the rows' columns k >= i, T for j <= i) and fed straight back
//    into the tensor cores.  The decay term a_t <dh_t, h_{t-1}> is
//    plain.ssd_bwd_chunked's four sums, none of which cancels another:
//    c1 = e^{cum_Q} <G, h_in>, the prefix sums of σ_j = D_j dt_j x_j·(G
//    B_j), the suffix sums of τ_k = E_k dy_k·(h_in C_k), and Σ_{k>=t>j}
//    Y_kj (Y_kj = M_kj dt_j Z_kj) as the prefix sums of (Σ_{k>j} Y_kj -
//    Σ_{i<j} Y_ji), the column and row sums of Y within the chunk; all P
//    rows of a head are in the block, so ddt_t = A dl_t + x_t·u_t is whole
//    there.  dB and dC are summed over the block's heads in order (into a
//    float32 workspace that only this block touches), dA over the chunk.
// 6. ssd_grad_reduce adds dB and dC over the head blocks of a group and dA
//    over chunks and batch rows, in a fixed order: no atomics anywhere, so
//    two calls are bit-identical.
// Rounding.  The float32 operands that enter the tensor cores go as bf16
// hi/lo pairs (~2^-17 of the value), one product each into a float32 sum:
// dy∘E (phase 3), G and h_in (the passes' pairs), M and T (in registers).
// x, dy, B and C are bf16 and enter as they are.  plain.
// ssd_bwd_chunk_parallel restates these phases and rounding points;
// tests/test_torch_ssd_bwd_chunked.py holds it to jax.vjp of ref.ssd_ref.
// What bounds it: the contract moves 83 MB at the training call (x, dy,
// dx, B, C, dB, dC, dt, ddt once): 0.025 ms at 3.35 TB/s.  This design
// adds the chunk states, moved eight times in all as float32 states,
// hi/lo pairs and dS (2 x 24 x 32 x 64 x 128 elements, 16 bytes each
// pass: 403 MB), x, B and dt read twice, and the float32 dB / dC
// workspace (50 MB written and read): ~570 MB, 0.17 ms.  Its workspace is
// ssd_scan_chunked_bwd_workspace's 201 MB at that call (the sequential
// kernel's: 1.01 GB).  PERF.md section 6 has its times.

namespace {
namespace chunked {

constexpr int HBG_MAX = 4;  // heads of one group a gradient block takes

template <int Q, int P, int N>
struct GradCfg {
  static constexpr int NS = N + 8, PS = P + 8;  // padded bf16 rows
  static constexpr int NW = NT / 32;
  static_assert(Q == 16 * NW, "one 16-row strip of the chunk a warp");
  static_assert(P % 16 == 0 && N % 16 == 0, "whole k16 steps");
  static constexpr size_t smem =  // C, B; x, dy; G and h_in pairs
      (static_cast<size_t>(2) * Q * NS + 2 * Q * PS + 4 * P * NS) * 2
      + (2 * HBG_MAX * Q + 4 * Q + NW * Q + NW) * 4;
};

__device__ __forceinline__ float2 bf2(const bf16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}
// The sum over the four lanes of a quad (one row of an mma fragment).
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(FULL, v, 1);
  return v + __shfl_xor_sync(FULL, v, 2);
}
// Exclusive prefix sums over the chunk, lane l holding tokens l·PER ..:
// each lane in token order, then a Hillis-Steele scan of the lanes' totals.
template <int PER>
__device__ __forceinline__ void prefix_excl(const float (&v)[PER],
                                            float (&out)[PER], int lane) {
  float run = 0.f;
#pragma unroll
  for (int k = 0; k < PER; ++k) {
    out[k] = run;
    run += v[k];
  }
  float tot = run;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float o = __shfl_up_sync(FULL, tot, off);
    if (lane >= off) tot += o;
  }
  float excl = __shfl_up_sync(FULL, tot, 1);
  if (lane == 0) excl = 0.f;
#pragma unroll
  for (int k = 0; k < PER; ++k) out[k] += excl;
}
// Inclusive suffix sums over the chunk: the mirror of prefix_excl.
template <int PER>
__device__ __forceinline__ void suffix_incl(const float (&v)[PER],
                                            float (&out)[PER], int lane) {
  float run = 0.f;
#pragma unroll
  for (int k = PER - 1; k >= 0; --k) {
    run += v[k];
    out[k] = run;
  }
  float tot = run;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float o = __shfl_down_sync(FULL, tot, off);
    if (lane + off < 32) tot += o;
  }
  float excl = __shfl_down_sync(FULL, tot, 1);
  if (lane == 31) excl = 0.f;
#pragma unroll
  for (int k = 0; k < PER; ++k) out[k] += excl;
}

// acc[n] (+)= A (16 rows of `a`, k over K) x plane (k = its rows, n = its
// columns: the operand stored [k][n]) for 16 x (8 NT8) outputs, the plane
// given as a hi/lo pair.
template <int K, int NT8>
__device__ __forceinline__ void mma_rows_kn(float (&acc)[NT8][4],
                                            const bf16* a, int lda,
                                            const bf16* hi, const bf16* lo,
                                            int ldp, int lane) {
#pragma unroll
  for (int ks = 0; ks < K / 16; ++ks) {
    uint32_t af[4];
    ldsm_x4(af, a + (lane % 16) * lda + ks * 16 + 8 * (lane / 16));
#pragma unroll
    for (int np = 0; np < NT8 / 2; ++np) {
      const int off = (ks * 16 + lane % 8 + 8 * ((lane / 8) % 2)) * ldp
                      + np * 16 + 8 * (lane / 16);
      uint32_t bh[4], bl[4];
      ldsm_x4_t(bh, hi + off);
      ldsm_x4_t(bl, lo + off);
      mma16816(acc[2 * np], af, bh[0], bh[1]);
      mma16816(acc[2 * np], af, bl[0], bl[1]);
      mma16816(acc[2 * np + 1], af, bh[2], bh[3]);
      mma16816(acc[2 * np + 1], af, bl[2], bl[3]);
    }
  }
}

// acc[n] += (hi + lo) (a 16 x 16 A tile as two bf16 fragments) x 16 rows of
// `b` from row k0 (k = its rows, n = its columns), 8 NT8 columns.
template <int NT8>
__device__ __forceinline__ void mma_tile_kn(float (&acc)[NT8][4],
                                            const uint32_t (&hi)[4],
                                            const uint32_t (&lo)[4],
                                            const bf16* b, int ldb, int k0,
                                            int lane) {
#pragma unroll
  for (int np = 0; np < NT8 / 2; ++np) {
    uint32_t bb[4];
    ldsm_x4_t(bb, b + (k0 + lane % 8 + 8 * ((lane / 8) % 2)) * ldb + np * 16
                      + 8 * (lane / 16));
    mma16816(acc[2 * np], hi, bb[0], bb[1]);
    mma16816(acc[2 * np], lo, bb[0], bb[1]);
    mma16816(acc[2 * np + 1], hi, bb[2], bb[3]);
    mma16816(acc[2 * np + 1], lo, bb[2], bb[3]);
  }
}

// t[half] = rows i (16 of `a`) · rows k0 .. k0 + 16 of `b` over K: a 16 x
// 16 tile of A Bᵀ, both stored row by row.
template <int K>
__device__ __forceinline__ void mma_tile_abt(float (&t)[2][4], const bf16* a,
                                             int lda, const bf16* b, int ldb,
                                             int k0, int lane) {
#pragma unroll
  for (int e = 0; e < 4; ++e) t[0][e] = t[1][e] = 0.f;
#pragma unroll
  for (int ks = 0; ks < K / 16; ++ks) {
    uint32_t af[4], bb[4];
    ldsm_x4(af, a + (lane % 16) * lda + ks * 16 + 8 * (lane / 16));
    ldsm_x4(bb, b + (k0 + lane % 8 + 8 * (lane / 16)) * ldb + ks * 16
                    + 8 * ((lane / 8) % 2));
    mma16816(t[0], af, bb[0], bb[1]);
    mma16816(t[1], af, bb[2], bb[3]);
  }
}

// A 16 x 16 tile in the accumulator layout as the A fragment of the next
// product, hi/lo.
__device__ __forceinline__ void split_tile(const float (&v)[2][4],
                                           uint32_t (&hi)[4],
                                           uint32_t (&lo)[4]) {
  split(v[0][0], v[0][1], hi[0], lo[0]);
  split(v[0][2], v[0][3], hi[1], lo[1]);
  split(v[1][0], v[1][1], hi[2], lo[2]);
  split(v[1][2], v[1][3], hi[3], lo[3]);
}

// ---- phase 5: each chunk's gradients ----
template <int Q, int P, int N>
__global__ void __launch_bounds__(NT, 1)
ssd_chunk_grads(const bf16* __restrict__ x, const float* __restrict__ dt,
                const float* __restrict__ A, const bf16* __restrict__ Bm,
                const bf16* __restrict__ Cm, const bf16* __restrict__ dy,
                const bf16* __restrict__ hin, const bf16* __restrict__ gin,
                bf16* __restrict__ dx, float* __restrict__ ddt,
                float* __restrict__ wsB, float* __restrict__ wsC,
                float* __restrict__ dApart, int S, int H, int G, int hb) {
  using C_ = GradCfg<Q, P, N>;
  constexpr int NS = C_::NS, PS = C_::PS, NW = C_::NW;
  constexpr float LOG2E = 1.4426950408889634f;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sC = reinterpret_cast<bf16*>(smem_raw);  // [Q][NS]
  bf16* sB = sC + Q * NS;                        // [Q][NS]
  bf16* sX = sB + Q * NS;                        // [Q][PS]
  bf16* sDY = sX + Q * PS;                       // [Q][PS]
  bf16* sGh = sDY + Q * PS;                      // [P][NS] G: hi, lo
  bf16* sGl = sGh + P * NS;
  bf16* sHh = sGl + P * NS;                      // [P][NS] h_in: hi, lo
  bf16* sHl = sHh + P * NS;
  float* sDt = reinterpret_cast<float*>(sHl + P * NS);  // [HBG_MAX][Q]
  float* sCum = sDt + HBG_MAX * Q;                       // [HBG_MAX][Q]
  float* sSig = sCum + HBG_MAX * Q;  // [Q] σ_i
  float* sTau = sSig + Q;            // [Q] τ_i
  float* sQv = sTau + Q;             // [Q] x_i·u_i
  float* sColY = sQv + Q;            // [Q] Σ_{k>i} Y_ki
  float* sRowY = sColY + Q;          // [NW][Q] Σ_{i<k} Y_ki over a warp's i
  float* sRed = sRowY + NW * Q;      // [NW]

  const int c = blockIdx.x, h0 = blockIdx.y * hb, b = blockIdx.z;
  const int nc = gridDim.x, nhb = gridDim.y, hblk = blockIdx.y;
  const int g = h0 / (H / G), s0 = c * Q, valid = S - s0;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, t4 = lane % 4;
  const size_t tok0 = static_cast<size_t>(b) * S + s0;
  const int mt = warp, i0 = 16 * mt;           // this warp's rows
  const int r0 = i0 + lane / 4, r1 = r0 + 8;  // this lane's rows

  const size_t gb = (tok0 * G + g) * N;
  load_tile<Q, N>(sC, NS, Cm + gb, static_cast<size_t>(G) * N, valid);
  load_tile<Q, N>(sB, NS, Bm + gb, static_cast<size_t>(G) * N, valid);
  wgmma_sm90::cp_async_commit();
  load_dt<Q>(sDt, dt, b, s0, S, H, h0, hb);
  __syncthreads();
  if (warp < hb)
    chunk_cumsum<Q>(sDt + warp * Q, A[h0 + warp], sCum + warp * Q, lane);

  for (int hh = 0; hh < hb; ++hh) {
    const int h = h0 + hh;
    {
      const size_t xo = (tok0 * H + h) * P;
      const size_t slot = ((static_cast<size_t>(b) * nc + c) * H + h) * 2 * P * N;
      load_tile<Q, P>(sX, PS, x + xo, static_cast<size_t>(H) * P, valid);
      load_tile<Q, P>(sDY, PS, dy + xo, static_cast<size_t>(H) * P, valid);
      load_tile<2 * P, N>(sGh, NS, gin + slot, N, 2 * P);
      load_tile<2 * P, N>(sHh, NS, hin + slot, N, 2 * P);
      wgmma_sm90::cp_async_commit();
    }
    wgmma_sm90::cp_async_wait<0>();
    __syncthreads();
    const float* cum = sCum + hh * Q;
    const float* dtv = sDt + hh * Q;
    const float cQ = cum[Q - 1], cr0 = cum[r0], cr1 = cum[r1];
    const float dR0 = expf(cQ - cr0), dR1 = expf(cQ - cr1);  // D_i
    const float eR0 = expf(cr0), eR1 = expf(cr1);            // E_i

    // u = D∘(B Gᵀ), then σ_i = dt_i x_i·u_i from it
    float au[P / 8][4];
#pragma unroll
    for (int n = 0; n < P / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) au[n][e] = 0.f;
#pragma unroll
    for (int ks = 0; ks < N / 16; ++ks) {
      uint32_t af[4];
      ldsm_x4(af, sB + (i0 + lane % 16) * NS + ks * 16 + 8 * (lane / 16));
#pragma unroll
      for (int pp = 0; pp < P / 16; ++pp) {
        // k = n, n = p: G stored [p][n] as hi and lo planes
        const int off = (pp * 16 + lane % 8 + 8 * (lane / 16)) * NS
                        + ks * 16 + 8 * ((lane / 8) % 2);
        uint32_t bh[4], bl[4];
        ldsm_x4(bh, sGh + off);
        ldsm_x4(bl, sGl + off);
        mma16816(au[2 * pp], af, bh[0], bh[1]);
        mma16816(au[2 * pp], af, bl[0], bl[1]);
        mma16816(au[2 * pp + 1], af, bh[2], bh[3]);
        mma16816(au[2 * pp + 1], af, bl[2], bl[3]);
      }
    }
    {
      float sg0 = 0.f, sg1 = 0.f;
#pragma unroll
      for (int n = 0; n < P / 8; ++n) {
        au[n][0] *= dR0; au[n][1] *= dR0;
        au[n][2] *= dR1; au[n][3] *= dR1;
        const int p = 8 * n + 2 * t4;
        const float2 x0 = bf2(sX + r0 * PS + p), x1 = bf2(sX + r1 * PS + p);
        sg0 += x0.x * au[n][0] + x0.y * au[n][1];
        sg1 += x1.x * au[n][2] + x1.y * au[n][3];
      }
      sg0 = quad_sum(sg0);
      sg1 = quad_sum(sg1);
      if (t4 == 0) {
        sSig[r0] = dtv[r0] * sg0;
        sSig[r1] = dtv[r1] * sg1;
      }
    }

    // dB (before dt) = D∘(X G)
    float ab[N / 8][4];
#pragma unroll
    for (int n = 0; n < N / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) ab[n][e] = 0.f;
    mma_rows_kn<P, N / 8>(ab, sX + i0 * PS, PS, sGh, sGl, NS, lane);
#pragma unroll
    for (int n = 0; n < N / 8; ++n) {
      ab[n][0] *= dR0; ab[n][1] *= dR0;
      ab[n][2] *= dR1; ab[n][3] *= dR1;
    }

    // the columns k >= i, a 16-column tile at a time: Mᵀ and Tᵀ, then u +=
    // Mᵀ dy and dB += Tᵀ C; Y's row and column sums
    float cy0 = 0.f, cy1 = 0.f;  // Σ_{k>i} Y_ki, rows r0 / r1, my columns
    for (int kk = mt; kk < Q / 16; ++kk) {
      float cb[2][4], zt[2][4];
      mma_tile_abt<N>(cb, sB + i0 * NS, NS, sC, NS, kk * 16, lane);  // B_i·C_k
      mma_tile_abt<P>(zt, sX + i0 * PS, PS, sDY, PS, kk * 16, lane);  // x_i·dy_k
      float m[2][4], t[2][4];
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        float ys0 = 0.f, ys1 = 0.f;  // Y of my two rows, columns +0 / +1
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = e < 2 ? r0 : r1;
          const int k = kk * 16 + 8 * half + 2 * t4 + (e & 1);
          float mv = 0.f, tv = 0.f, yv = 0.f;
          if (k >= i) {
            const float l = wgmma_sm90::ex2((cum[k] - (e < 2 ? cr0 : cr1))
                                            * LOG2E);
            mv = cb[half][e] * l;
            tv = zt[half][e] * l;
            if (k > i) yv = mv * dtv[i] * zt[half][e];
          }
          m[half][e] = mv;
          t[half][e] = tv;
          if (e < 2) cy0 += yv; else cy1 += yv;
          if (e & 1) ys1 += yv; else ys0 += yv;
        }
        // the column sums over the warp's 16 rows: the 8 lanes of a column
#pragma unroll
        for (int off = 4; off < 32; off <<= 1) {
          ys0 += __shfl_xor_sync(FULL, ys0, off);
          ys1 += __shfl_xor_sync(FULL, ys1, off);
        }
        if (lane < 4) {
          float* ry = sRowY + warp * Q + kk * 16 + 8 * half + 2 * t4;
          ry[0] = ys0;
          ry[1] = ys1;
        }
      }
      uint32_t hi[4], lo[4];
      split_tile(m, hi, lo);
      mma_tile_kn<P / 8>(au, hi, lo, sDY, PS, kk * 16, lane);
      split_tile(t, hi, lo);
      mma_tile_kn<N / 8>(ab, hi, lo, sC, NS, kk * 16, lane);
    }
    cy0 = quad_sum(cy0);
    cy1 = quad_sum(cy1);
    if (t4 == 0) {
      sColY[r0] = cy0;
      sColY[r1] = cy1;
    }

    // dx = dt∘u and x_i·u_i; dB's part of this head into the workspace
    {
      float q0 = 0.f, q1 = 0.f;
#pragma unroll
      for (int n = 0; n < P / 8; ++n) {
        const int p = 8 * n + 2 * t4;
        const float2 x0 = bf2(sX + r0 * PS + p), x1 = bf2(sX + r1 * PS + p);
        q0 += x0.x * au[n][0] + x0.y * au[n][1];
        q1 += x1.x * au[n][2] + x1.y * au[n][3];
      }
      q0 = quad_sum(q0);
      q1 = quad_sum(q1);
      if (t4 == 0) {
        sQv[r0] = q0;
        sQv[r1] = q1;
      }
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = half ? r1 : r0;
        if (r >= valid) continue;
        const float d = dtv[r];
        bf16* row = dx + ((tok0 + r) * H + h) * P;
#pragma unroll
        for (int n = 0; n < P / 8; ++n)
          *reinterpret_cast<uint32_t*>(row + 8 * n + 2 * t4) =
              pack_bf16(d * au[n][2 * half], d * au[n][2 * half + 1]);
        float* wrow = wsB + ((tok0 + r) * nhb + hblk) * N;
#pragma unroll
        for (int n = 0; n < N / 8; ++n) {
          float2* p2 = reinterpret_cast<float2*>(wrow + 8 * n + 2 * t4);
          float2 v = make_float2(d * ab[n][2 * half], d * ab[n][2 * half + 1]);
          if (hh > 0) {
            const float2 o = *p2;
            v = make_float2(o.x + v.x, o.y + v.y);
          }
          *p2 = v;
        }
      }
    }

    // dC = E∘(dy h_in) + (T∘dt_j) B over the columns j <= i; τ from the
    // first term
#pragma unroll
    for (int n = 0; n < N / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) ab[n][e] = 0.f;
    mma_rows_kn<P, N / 8>(ab, sDY + i0 * PS, PS, sHh, sHl, NS, lane);
    {
      float ta0 = 0.f, ta1 = 0.f;
#pragma unroll
      for (int n = 0; n < N / 8; ++n) {
        ab[n][0] *= eR0; ab[n][1] *= eR0;
        ab[n][2] *= eR1; ab[n][3] *= eR1;
        const int col = 8 * n + 2 * t4;
        const float2 c0 = bf2(sC + r0 * NS + col), c1 = bf2(sC + r1 * NS + col);
        ta0 += c0.x * ab[n][0] + c0.y * ab[n][1];
        ta1 += c1.x * ab[n][2] + c1.y * ab[n][3];
      }
      ta0 = quad_sum(ta0);
      ta1 = quad_sum(ta1);
      if (t4 == 0) {
        sTau[r0] = ta0;
        sTau[r1] = ta1;
      }
    }
    for (int jj = 0; jj <= mt; ++jj) {
      float z[2][4];
      mma_tile_abt<P>(z, sDY + i0 * PS, PS, sX, PS, jj * 16, lane);  // dy_i·x_j
#pragma unroll
      for (int half = 0; half < 2; ++half)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = e < 2 ? r0 : r1;
          const int j = jj * 16 + 8 * half + 2 * t4 + (e & 1);
          z[half][e] = j <= i ? z[half][e]
                                    * wgmma_sm90::ex2(((e < 2 ? cr0 : cr1)
                                                       - cum[j]) * LOG2E)
                                    * dtv[j]
                              : 0.f;
        }
      uint32_t hi[4], lo[4];
      split_tile(z, hi, lo);
      mma_tile_kn<N / 8>(ab, hi, lo, sB, NS, jj * 16, lane);
    }
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = half ? r1 : r0;
      if (r >= valid) continue;
      float* wrow = wsC + ((tok0 + r) * nhb + hblk) * N;
#pragma unroll
      for (int n = 0; n < N / 8; ++n) {
        float2* p2 = reinterpret_cast<float2*>(wrow + 8 * n + 2 * t4);
        float2 v = make_float2(ab[n][2 * half], ab[n][2 * half + 1]);
        if (hh > 0) {
          const float2 o = *p2;
          v = make_float2(o.x + v.x, o.y + v.y);
        }
        *p2 = v;
      }
    }

    // <G, h_in> over the head's state, each warp's part
    {
      float gh = 0.f;
      for (int e = threadIdx.x; e < P * N / 2; e += NT) {
        const int p = 2 * e / N, n = 2 * e % N;
        const float2 ga = bf2(sGh + p * NS + n), gl = bf2(sGl + p * NS + n);
        const float2 ha = bf2(sHh + p * NS + n), hl = bf2(sHl + p * NS + n);
        gh += (ga.x + gl.x) * (ha.x + hl.x) + (ga.y + gl.y) * (ha.y + hl.y);
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) gh += __shfl_xor_sync(FULL, gh, off);
      if (lane == 0) sRed[warp] = gh;
    }
    __syncthreads();

    // a_t <dh_t, h_{t-1}> = c1 + Σ_{j<t} (σ_j + Σ_{k>j} Y_kj - Σ_{i<j} Y_ji)
    // + Σ_{k>=t} τ_k; ddt and this chunk's part of dA
    if (warp == 0) {
      constexpr int PER = Q / 32;
      float c1 = 0.f;
#pragma unroll
      for (int w = 0; w < NW; ++w) c1 += sRed[w];
      c1 *= expf(cQ);
      float v[PER], ta[PER], pre[PER], suf[PER];
#pragma unroll
      for (int k = 0; k < PER; ++k) {
        const int tk = lane * PER + k;
        float ry = 0.f;
        for (int w = 0; w <= tk / 16; ++w) ry += sRowY[w * Q + tk];
        v[k] = sSig[tk] + sColY[tk] - ry;
        ta[k] = sTau[tk];
      }
      prefix_excl<PER>(v, pre, lane);
      suffix_incl<PER>(ta, suf, lane);
      const float a_h = A[h];
      float da = 0.f;
#pragma unroll
      for (int k = 0; k < PER; ++k) {
        const int tk = lane * PER + k;
        const float dl = c1 + pre[k] + suf[k];
        if (tk < valid) ddt[(tok0 + tk) * H + h] = a_h * dl + sQv[tk];
        da += dtv[tk] * dl;
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) da += __shfl_xor_sync(FULL, da, off);
      if (lane == 0) dApart[(static_cast<size_t>(b) * nc + c) * H + h] = da;
    }
    __syncthreads();  // the tiles and the token scratch are free again
  }
}

// ---- phase 6: dB and dC over a group's head blocks, dA over the chunks --
template <int N>
__global__ void __launch_bounds__(NT)
ssd_grad_reduce(const float* __restrict__ wsB, const float* __restrict__ wsC,
                const float* __restrict__ dApart, bf16* __restrict__ dB,
                bf16* __restrict__ dC, float* __restrict__ dA, int Bsz, int S,
                int H, int G, int nc, int nhb) {
  const int per = nhb / G;  // head blocks of a group
  const size_t n1 = static_cast<size_t>(Bsz) * S * G * N, n2 = n1 + H;
  for (size_t i = blockIdx.x * static_cast<size_t>(NT) + threadIdx.x; i < n2;
       i += static_cast<size_t>(gridDim.x) * NT) {
    if (i < n1) {
      const size_t n = i % N, r = i / N, gg = r % G, row = r / G;
      float sb = 0.f, sc = 0.f;
      for (int j = 0; j < per; ++j) {
        const size_t off = (row * nhb + gg * per + j) * N + n;
        sb += wsB[off];
        sc += wsC[off];
      }
      dB[i] = __float2bfloat16_rn(sb);
      dC[i] = __float2bfloat16_rn(sc);
    } else {
      const size_t hh = i - n1;
      float s = 0.f;
      for (int bb = 0; bb < Bsz; ++bb)
        for (int cc = 0; cc < nc; ++cc)
          s += dApart[(static_cast<size_t>(bb) * nc + cc) * H + hh];
      dA[hh] = s;
    }
  }
}

// Heads of one group a block takes: the largest power of 2 up to `most`
// dividing H / G.
inline int heads_per_block(int H, int G, int most) {
  const int rep = H / G;
  int hb = 1;
  while (hb * 2 <= most && rep % (hb * 2) == 0) hb *= 2;
  return hb;
}

// The chunked backward's workspace, in bytes, each piece 256-byte aligned:
// chunk states / dS float32 (B, nc, H, P, N), decay float32 (B, nc, H),
// h_in and G pairs bf16 (B, nc, H, 2, P, N) each, dB and dC float32 (B, S,
// H / hb, N) each, dA float32 (B, nc, H).
struct BwdWs {
  size_t states, decay, hin, gin, db, dc, da, total;
  BwdWs(int B, int S, int H, int G) {
    const size_t nc = (S + Q_ - 1) / Q_, PN = static_cast<size_t>(P_) * N_;
    const size_t nhb = H / heads_per_block(H, G, HBG_MAX);
    auto up = [](size_t v) { return (v + 255) / 256 * 256; };
    states = 0;
    decay = states + up(B * nc * H * PN * 4);
    hin = decay + up(B * nc * H * 4);
    gin = hin + up(B * nc * H * 2 * PN * 2);
    db = gin + up(B * nc * H * 2 * PN * 2);
    dc = db + up(static_cast<size_t>(B) * S * nhb * N_ * 4);
    da = dc + up(static_cast<size_t>(B) * S * nhb * N_ * 4);
    total = da + up(B * nc * H * 4);
  }
};

int launch_bwd(const void* x, const void* dt, const void* A, const void* Bm,
               const void* Cm, const void* h0, const void* dy,
               const void* dhf, void* dx, void* ddt, void* dA, void* dB,
               void* dC, void* dh0, void* ws, int B, int S, int H, int G,
               cudaStream_t stream) {
  constexpr int Q = Q_;
  using C_ = Cfg<Q, P_, N_>;
  using GC = GradCfg<Q, P_, N_>;
  const int hb1 = heads_per_block(H, G, HB1_MAX);
  const int hbg = heads_per_block(H, G, HBG_MAX);
  const int nc = (S + Q - 1) / Q, PN = P_ * N_;
  cudaError_t err;
  if ((err = cudaFuncSetAttribute(ssd_chunk_states<Q, P_, N_, false>,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  static_cast<int>(C_::states_smem)))
          != cudaSuccess ||
      (err = cudaFuncSetAttribute(ssd_chunk_states<Q, P_, N_, true>,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  static_cast<int>(C_::states_smem)))
          != cudaSuccess ||
      (err = cudaFuncSetAttribute(ssd_chunk_grads<Q, P_, N_>,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  static_cast<int>(GC::smem))) != cudaSuccess)
    return err;
  const BwdWs L(B, S, H, G);
  unsigned char* w = static_cast<unsigned char*>(ws);
  float* states = reinterpret_cast<float*>(w + L.states);
  float* decay = reinterpret_cast<float*>(w + L.decay);
  bf16* hin = reinterpret_cast<bf16*>(w + L.hin);
  bf16* gin = reinterpret_cast<bf16*>(w + L.gin);
  float* wsB = reinterpret_cast<float*>(w + L.db);
  float* wsC = reinterpret_cast<float*>(w + L.dc);
  float* dApart = reinterpret_cast<float*>(w + L.da);
  const bf16* xb = static_cast<const bf16*>(x);
  const bf16* dyb = static_cast<const bf16*>(dy);
  const bf16* Bb = static_cast<const bf16*>(Bm);
  const bf16* Cb = static_cast<const bf16*>(Cm);
  const float* dtf = static_cast<const float*>(dt);
  const float* Af = static_cast<const float*>(A);
  const dim3 grid1(nc, H / hb1, B);
  const dim3 pass_grid((PN / 4 + PASS_NT - 1) / PASS_NT, H, B);
  ssd_chunk_states<Q, P_, N_, false><<<grid1, NT, C_::states_smem, stream>>>(
      xb, dtf, Af, Bb, states, decay, S, H, G, hb1);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  ssd_state_pass<false><<<pass_grid, PASS_NT, 0, stream>>>(
      states, decay, static_cast<const float*>(h0), hin, nullptr, nc, H, PN);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  ssd_chunk_states<Q, P_, N_, true><<<grid1, NT, C_::states_smem, stream>>>(
      dyb, dtf, Af, Cb, states, decay, S, H, G, hb1);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  ssd_state_pass<true><<<pass_grid, PASS_NT, 0, stream>>>(
      states, decay, static_cast<const float*>(dhf), gin,
      static_cast<float*>(dh0), nc, H, PN);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  ssd_chunk_grads<Q, P_, N_><<<dim3(nc, H / hbg, B), NT, GC::smem, stream>>>(
      xb, dtf, Af, Bb, Cb, dyb, hin, gin, static_cast<bf16*>(dx),
      static_cast<float*>(ddt), wsB, wsC, dApart, S, H, G, hbg);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const size_t items = static_cast<size_t>(B) * S * G * N_ + H;
  const size_t blocks = (items + NT - 1) / NT;
  ssd_grad_reduce<N_><<<static_cast<unsigned>(blocks < 4096 ? blocks : 4096),
                        NT, 0, stream>>>(
      wsB, wsC, dApart, static_cast<bf16*>(dB), static_cast<bf16*>(dC),
      static_cast<float*>(dA), B, S, H, G, nc, H / hbg);
  return cudaGetLastError();
}

}  // namespace chunked
}  // namespace

// Bytes of the workspace ssd_scan_chunked_bwd takes.
extern "C" long long ssd_scan_chunked_bwd_workspace(int B, int S, int H,
                                                    int G) {
  if (B < 1 || S < 1 || H < 1 || G < 1 || H % G) return -1;
  return static_cast<long long>(chunked::BwdWs(B, S, H, G).total);
}

// The gradient of ssd_scan_chunked_fwd: bf16 x, Bm, Cm, dy and dx, dB, dC
// (x, Bm, Cm, dy and h0 / dhf, if given, 16-byte aligned); dt, A, h0, dhf
// and ddt, dA, dh0 float32; all contiguous.  h0 and dhf may be null
// (zeros); dh0 is written when not null.  P = 64, N = 128.  ws:
// ssd_scan_chunked_bwd_workspace bytes.  Six kernels on `stream`; returns
// the first launch error, 0 if none.
extern "C" int ssd_scan_chunked_bwd(const void* x, const void* dt,
                                    const void* A, const void* Bm,
                                    const void* Cm, const void* h0,
                                    const void* dy, const void* dhf,
                                    void* dx, void* ddt, void* dA, void* dB,
                                    void* dC, void* dh0, void* ws, int B,
                                    int S, int H, int P, int G, int N,
                                    void* stream) {
  if (B < 1 || S < 1 || H < 1 || G < 1 || H % G || P != chunked::P_
      || N != chunked::N_ || B > 65535 || H > 65535)
    return cudaErrorInvalidValue;
  return chunked::launch_bwd(x, dt, A, Bm, Cm, h0, dy, dhf, dx, ddt, dA, dB,
                             dC, dh0, ws, B, S, H, G,
                             static_cast<cudaStream_t>(stream));
}
