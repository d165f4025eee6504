// Paged decode attention for Hopper (sm_90a), CUDA C++: attention of each
// slot's last S query rows through its block table into a shared KV pool.
//
// Replaces: src/repro/kernels/paged_attention.py::paged_flash_decode (the
// Pallas TPU kernel).  Contract: jnp_impl.paged_decode_attention_lengths
// (plain twin: plain.paged_decode_attention_ref).
//
//   q (B,S,Hq,D), k_pool / v_pool (N,bs,Hkv,D), tables (B,nb) int32,
//   lengths (B,) int32  ->  out (B,S,Hq,D) in q's type.
//   Query row r of slot b sits at position lengths[b] - S + r and sees the
//   positions p <= that one; position p of slot b lives in pool block
//   tables[b, p / bs] at offset p % bs.  Softcap is applied to the scaled
//   logits before the mask; a row that sees no key gives 0.
//
// What bounds it on an H100: a decode step reads every visible K/V row of
// its slot once and does 4 * D flops per (query row, key) pair, 2-4 query
// rows per KV row at the gemma2-2b / mistral-7b GQA widths: far below the
// 295 flops per byte where the tensor cores would be the limit, so it is
// bound by bytes.  The products run on the CUDA cores in float32.
//
// Design:
// * The Pallas grid (B, Hq, nb) walks the table once per *query head*, so
//   every K/V block is streamed G = Hq/Hkv times.  Here one thread block
//   owns one (slot, KV head, split) and takes all G*S query rows of that
//   KV head together (rows ordered (s, g), q head = hk*G + g), so each
//   visible K/V row is read once per KV head.  More than RMAX rows (a wide
//   fused or speculative step) take several row groups on grid x.
// * No scalar prefetch: the block reads its own table entries and walks
//   only positions below lengths[b] (at most the table's nb * bs), in
//   tiles of TK = 32 positions that may straddle pool blocks.  Unused
//   table entries (block 0) are never read.
// * Scores: warp w takes the tile's keys w, w + 4, ...; its 32 lanes
//   split the head dim (lane + 32 i, coalesced in global memory and
//   conflict-free against the query rows staged in shared memory as f32)
//   and reduce with shuffles.  The online softmax (running max and sum per
//   row, f32) is one warp per row with lane = key.  P V: each thread owns
//   CPT columns of RPT rows, its accumulators in registers, and reads V
//   rows straight from global memory, coalesced across threads.
// * Split KV: B * Hkv = 16 blocks at the main-path shape, on 132 SMs, so
//   the table columns are cut into `nsplit` chunks until about two waves
//   of blocks fill the card; each chunk's partial goes to a float32
//   workspace and split_kv.cuh's combine_splits merges them through their
//   lse.  Chunks past a slot's length see no key and weigh nothing.
// wgmma/TMA and cp.async pipelining of the K/V rows are later work.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cstdint>

#include "split_kv.cuh"

namespace {

using split_kv::NEG;
constexpr int NT = 128;    // threads per block
constexpr int NW = NT / 32;
constexpr int TK = 32;     // positions per tile (one per lane in the softmax)
constexpr int RMAX = 16;   // query rows per block
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void from_f(float* p, float x) { *p = x; }
__device__ __forceinline__ void from_f(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(FULL, x, o);
  return x;
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(FULL, x, o));
  return x;
}

// With nsplit > 1, block z = b * nsplit + split covers table columns
// [split * cols, (split + 1) * cols) and writes its partial to o_part /
// lse_part instead of out.
template <typename T, int D>
__global__ void __launch_bounds__(NT)
paged_decode(const T* __restrict__ q, const T* __restrict__ kp,
             const T* __restrict__ vp, const int* __restrict__ tables,
             const int* __restrict__ lengths, T* __restrict__ out,
             float* __restrict__ o_part, float* __restrict__ lse_part, int B,
             int S, int Hq, int Hkv, int bs, int nb, float scale,
             float softcap, int nsplit, int cols) {
  constexpr int EPL = D / 32;                 // score elements per lane
  constexpr int NCOL = D < NT ? D : NT;       // threads across the columns
  constexpr int NRG = NT / NCOL;              // row groups of threads
  constexpr int CPT = D / NCOL;               // columns per thread
  constexpr int RPT = RMAX / NRG;             // rows per thread
  __shared__ float Qs[RMAX * D];
  __shared__ float Ss[RMAX][TK];              // scores, then probabilities
  __shared__ float m_s[RMAX], l_s[RMAX], corr_s[RMAX];
  __shared__ long long koff[TK];              // element offset of each key row

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int G = Hq / Hkv;
  const int R = S * G;
  const int r0 = blockIdx.x * RMAX;
  const int nr = min(RMAX, R - r0);
  const int hk = blockIdx.y;
  const int b = blockIdx.z / nsplit;
  const int split = blockIdx.z % nsplit;
  const int len = lengths[b];
  const int ncol = min(nb, (max(len, 0) + bs - 1) / bs);
  const int c_lo = split * cols;
  const int c_hi = min(ncol, c_lo + cols);
  const int p_lo = c_lo * bs;
  const int p_hi = min(c_hi * bs, len);  // this block's positions [p_lo, p_hi)
  const int* tbl = tables + static_cast<size_t>(b) * nb;

  for (int e = tid; e < RMAX * D; e += NT) {
    const int r = e / D, d = e % D;
    float x = 0.f;
    if (r < nr) {
      const int rho = r0 + r, s = rho / G, g = rho % G;
      x = to_f(q[((static_cast<size_t>(b) * S + s) * Hq + hk * G + g) * D + d]);
    }
    Qs[e] = x;
  }
  if (tid < RMAX) {
    m_s[tid] = NEG;
    l_s[tid] = 0.f;
  }

  const int d0 = tid % NCOL, rg = tid / NCOL;
  float acc[RPT][CPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i)
#pragma unroll
    for (int j = 0; j < CPT; ++j) acc[i][j] = 0.f;

  for (int p0 = p_lo; p0 < p_hi; p0 += TK) {
    const int nk = min(TK, p_hi - p0);
    __syncthreads();  // Qs staged; the previous tile's Ss / koff reads done
    // ---- scores: S[r][c] = scale * q_r . k_c, capped ----
    for (int c = warp; c < nk; c += NW) {
      const int p = p0 + c;
      const long long off =
          ((static_cast<long long>(tbl[p / bs]) * bs + p % bs) * Hkv + hk) * D;
      if (lane == 0) koff[c] = off;
      float kf[EPL];
#pragma unroll
      for (int i = 0; i < EPL; ++i) kf[i] = to_f(kp[off + lane + 32 * i]);
      for (int r = 0; r < nr; ++r) {
        float dot = 0.f;
#pragma unroll
        for (int i = 0; i < EPL; ++i) dot += kf[i] * Qs[r * D + lane + 32 * i];
        dot = warp_sum(dot);
        if (lane == 0) {
          float x = dot * scale;
          if (softcap != 0.f) x = softcap * tanhf(x / softcap);
          Ss[r][c] = x;
        }
      }
    }
    __syncthreads();
    // ---- online softmax: one warp per row, lane = key ----
    for (int r = warp; r < nr; r += NW) {
      const int q_pos = len - S + (r0 + r) / G;
      const int p = p0 + lane;
      const bool ok = lane < nk && p <= q_pos;
      const float x = ok ? Ss[r][lane] : NEG;
      const float m_old = m_s[r];
      const float m_new = fmaxf(m_old, warp_max(x));
      const float corr = expf(m_old - m_new);
      const float pr = ok ? expf(x - m_new) : 0.f;
      const float sum = warp_sum(pr);
      Ss[r][lane] = pr;
      if (lane == 0) {
        m_s[r] = m_new;
        l_s[r] = l_s[r] * corr + sum;
        corr_s[r] = corr;
      }
    }
    __syncthreads();
    // ---- O = O * corr + P V ----
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int r = rg + NRG * i;
      if (r < nr) {
        const float cr = corr_s[r];
#pragma unroll
        for (int j = 0; j < CPT; ++j) acc[i][j] *= cr;
      }
    }
#pragma unroll 4
    for (int c = 0; c < nk; ++c) {
      const T* vrow = vp + koff[c];
      float vv[CPT];
#pragma unroll
      for (int j = 0; j < CPT; ++j) vv[j] = to_f(vrow[d0 + NCOL * j]);
#pragma unroll
      for (int i = 0; i < RPT; ++i) {
        const int r = rg + NRG * i;
        if (r < nr) {
          const float pr = Ss[r][c];
#pragma unroll
          for (int j = 0; j < CPT; ++j) acc[i][j] += pr * vv[j];
        }
      }
    }
  }
  __syncthreads();  // the last tile's m_s / l_s (or the initial ones)

#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int r = rg + NRG * i;
    if (r >= nr) continue;
    const int rho = r0 + r, s = rho / G, h = hk * G + rho % G;
    const size_t row = (static_cast<size_t>(b) * S + s) * Hq + h;
    const size_t prow = static_cast<size_t>(split) * B * S * Hq + row;
    const float l = l_s[r];
    const float inv = l > 0.f ? 1.f / l : 0.f;
#pragma unroll
    for (int j = 0; j < CPT; ++j) {
      const int d = d0 + NCOL * j;
      if (nsplit == 1) from_f(out + row * D + d, acc[i][j] * inv);
      else o_part[prow * D + d] = acc[i][j] * inv;
    }
    if (nsplit > 1 && d0 == 0) lse_part[prow] = l > 0.f ? m_s[r] + logf(l) : NEG;
  }
}

template <typename T, int D>
int launch(const void* q, const void* kp, const void* vp, const int* tables,
           const int* lengths, void* out, float* ws, int B, int S, int Hq,
           int Hkv, int bs, int nb, float scale, float softcap, int nsplit,
           cudaStream_t stream) {
  const int rows = S * (Hq / Hkv);
  const int out_rows = B * S * Hq;
  const int cols = (nb + nsplit - 1) / nsplit;
  float* o_part = ws;
  float* lse_part = ws + static_cast<size_t>(nsplit) * out_rows * D;
  dim3 grid((rows + RMAX - 1) / RMAX, Hkv, B * nsplit);
  paged_decode<T, D><<<grid, NT, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(kp),
      static_cast<const T*>(vp), tables, lengths, static_cast<T*>(out),
      o_part, lse_part, B, S, Hq, Hkv, bs, nb, scale, softcap, nsplit, cols);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || nsplit == 1) return err;
  split_kv::combine_splits<T><<<out_rows, D / 4, 0, stream>>>(
      o_part, lse_part, static_cast<T*>(out), nullptr, out_rows, D, nsplit);
  return cudaGetLastError();
}

template <typename T>
int launch_d(int D, const void* q, const void* kp, const void* vp,
             const int* tables, const int* lengths, void* out, float* ws,
             int B, int S, int Hq, int Hkv, int bs, int nb, float scale,
             float softcap, int nsplit, cudaStream_t st) {
  if (D == 64)
    return launch<T, 64>(q, kp, vp, tables, lengths, out, ws, B, S, Hq, Hkv,
                         bs, nb, scale, softcap, nsplit, st);
  if (D == 128)
    return launch<T, 128>(q, kp, vp, tables, lengths, out, ws, B, S, Hq, Hkv,
                          bs, nb, scale, softcap, nsplit, st);
  if (D == 256)
    return launch<T, 256>(q, kp, vp, tables, lengths, out, ws, B, S, Hq, Hkv,
                          bs, nb, scale, softcap, nsplit, st);
  return cudaErrorInvalidValue;
}

}  // namespace

// How many table-column chunks paged_decode_fwd takes on a card with `sms`
// multiprocessors: split while the unsplit grid has fewer than 2 * sms
// blocks, keeping at least TK positions per chunk.  With n > 1 the caller
// passes a float32 workspace of n * B * S * Hq * (D + 1) elements.
extern "C" int paged_decode_splits(int B, int S, int Hq, int Hkv, int nb,
                                   int bs, int sms) {
  if (B <= 0 || S <= 0 || Hkv <= 0 || Hq % Hkv != 0 || nb <= 0 || bs <= 0)
    return 1;
  const int rows = S * (Hq / Hkv);
  const long long blocks =
      static_cast<long long>((rows + RMAX - 1) / RMAX) * Hkv * B;
  const int min_cols = (TK + bs - 1) / bs;
  const int most = (nb + min_cols - 1) / min_cols;  // chunks of >= TK keys
  if (blocks >= 2LL * sms || most <= 1) return 1;
  const int want = static_cast<int>((2LL * sms + blocks - 1) / blocks);
  const int n = want < most ? want : most;
  const int chunk = (nb + n - 1) / n;
  return (nb + chunk - 1) / chunk;
}

// dtype: 0 = float32, 1 = bfloat16; D = 64, 128 or 256.  Returns a
// cudaError_t (0 = launched).
extern "C" int paged_decode_fwd(const void* q, const void* k_pool,
                                const void* v_pool, const int* tables,
                                const int* lengths, void* out, float* ws,
                                int B, int S, int Hq, int Hkv, int D, int bs,
                                int nb, float scale, float softcap,
                                int nsplit, int dtype, void* stream) {
  if (Hkv <= 0 || Hq % Hkv != 0 || bs <= 0 || nb <= 0 || nsplit < 1 ||
      (nsplit > 1 && ws == nullptr))
    return cudaErrorInvalidValue;
  if (B == 0 || S == 0) return cudaSuccess;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_d<float>(D, q, k_pool, v_pool, tables, lengths, out, ws, B,
                           S, Hq, Hkv, bs, nb, scale, softcap, nsplit, st);
  if (dtype == 1)
    return launch_d<__nv_bfloat16>(D, q, k_pool, v_pool, tables, lengths, out,
                                   ws, B, S, Hq, Hkv, bs, nb, scale, softcap,
                                   nsplit, st);
  return cudaErrorInvalidValue;
}
