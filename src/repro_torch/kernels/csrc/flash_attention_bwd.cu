// Backward of the position-masked GQA flash attention for Hopper (sm_90a),
// CUDA C++.
//
// Replaces: the gradient that JAX forms for src/repro/kernels/
// flash_attention.py::flash_attention by differentiating the jnp path (the
// Pallas kernel defines no custom_vjp).  Contract: kernels/plain.py::
// attention_bwd_ref —
//   x = scale q.k, s = cap tanh(x / cap) (s = x without a cap), P = exp(s -
//   lse) on the visible pairs (kv_pos >= 0 and, under `causal`, kv_pos <=
//   q_pos; 0 elsewhere), dP = dO V^T, D_i = rowsum(dO o O) - dlse_i,
//   dS = P o (dP - D_i) o (1 - (s / cap)^2),
//   dq = scale dS K, dk = scale dS^T Q, dv = P^T dO,
// dk and dv summed over the G = Hq / Hkv query heads of each KV head.  A
// row that sees no key (lse -1e30) has P = 0 and gets no gradient.
//
// What bounds it on an H100: the five products (S and dP, recomputed in
// both passes below, dV, dK, dQ) do 2 * 5 * pairs * D flops against q, k,
// v, out, dout and the three gradients once each; at the training shapes
// (512 x 512 rows of 8 heads of 256) that is operations.
//
// Design: deterministic, no float atomics, so that a restarted run on the
// card reproduces its loss curve bit for bit.  Three launches:
// * flash_bwd_dot: D_i, one warp a row.
// * dK and dV: one block per (KV tile, KV head, batch) keeps its K and V
//   tile in shared memory and walks the query rows of every head of its
//   group (the forward's GQA fold: row rho = s * G + g is query s of head
//   hk * G + g); per query tile it recomputes S, the cap and P from the
//   saved lse, forms dP and dS, and adds P^T dO and dS^T Q into dV and dK
//   held in registers.  Tiles with no visible pair (the causal upper
//   triangle, holes) are skipped whole.
// * dQ: one block per (tile of query rows, KV head, batch) keeps its Q and
//   dO rows and walks the KV tiles, adding dS K into dQ.
// Two variants of the two gradient kernels:
// * bf16 at D = 64, 128, 256 (every bf16 call: the forward takes no other
//   head dim): flash_bwd_dkdv_tc / flash_bwd_dq_tc, 64 x 64 tiles, all
//   five products on mma.sync m16n8k16 with f32 accumulate (their own
//   note below); P and dS rounded to bf16 for the second product, as the
//   forward rounds P.
// * float32: flash_bwd_dkdv / flash_bwd_dq on the CUDA cores, 32 x 32 tiles staged in float32 shared memory (at D =
//   256 the K, V, Q and dO tiles are 4 x 32 x 260 floats, 133 KB: dynamic
//   shared memory); a thread owns one row and every eighth group of four
//   columns of the gradient.  Its ceiling is the 67 TFLOP/s float32 rate;
//   it matches the float32 reference to 1e-4.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <climits>
#include <cmath>
#include <cstdint>

#include "mma_sm80.cuh"

namespace {

using bf16 = __nv_bfloat16;
constexpr int BR = 32;   // query rows (rho) per tile
constexpr int BC = 32;   // kv rows per tile
constexpr int NT = 256;  // threads of the two gradient kernels
constexpr int PSTR = BC + 1;       // row stride of the P and dS tiles
constexpr float NO_ROW = 1e30f;    // lse of a row past the end: P = 0
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float dot4(float4 a, float4 b) {
  return a.x * b.x + a.y * b.y + a.z * b.z + a.w * b.w;
}
__device__ __forceinline__ void fma4(float4& acc, float s, float4 x) {
  acc.x += s * x.x; acc.y += s * x.y; acc.z += s * x.z; acc.w += s * x.w;
}

// D_i = rowsum(dO o O) - dlse_i over rows (B*Sq*Hq) of D; dlse may be null.
template <typename T>
__global__ void __launch_bounds__(NT)
flash_bwd_dot(const T* __restrict__ out, const T* __restrict__ dout,
              const float* __restrict__ dlse, float* __restrict__ di,
              long long rows, int D) {
  const long long row = static_cast<long long>(blockIdx.x) * (NT / 32)
                        + threadIdx.x / 32;
  if (row >= rows) return;  // the whole warp leaves together
  const int lane = threadIdx.x % 32;
  const T* o = out + row * D;
  const T* g = dout + row * D;
  float s = 0.f;
  for (int d = lane; d < D; d += 32) s += to_f(o[d]) * to_f(g[d]);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(FULL, s, off);
  if (lane == 0) di[row] = s - (dlse != nullptr ? dlse[row] : 0.f);
}

// BR rows of a (B, S, H, D) tensor into float32 shared memory (row stride
// DP), row r of the tile = row0 + r of the G-fold: rho -> (s = rho / G,
// head hk * G + rho % G); G = 1 reads kv rows of head hk.  Rows past n are 0.
__device__ void stage(float* dst, const float* __restrict__ src, int b, int row0,
                      int n, int G, int S, int H, int hk, int D, int DP) {
#pragma unroll 1
  for (int e = threadIdx.x; e < BR * D; e += NT) {
    const int r = e / D, d = e % D;
    const int rho = row0 + r;
    float x = 0.f;
    if (rho < n)
      x = to_f(src[((static_cast<size_t>(b) * S + rho / G) * H + hk * G
                    + rho % G) * D + d]);
    dst[r * DP + d] = x;
  }
}

// The row facts of a query tile: q positions (INT_MIN past the end), lse
// (NO_ROW past the end: P = 0) and D_i.
__device__ void stage_rows(int* qps, float* lses, float* dis,
                           const int* __restrict__ q_pos,
                           const float* __restrict__ lse,
                           const float* __restrict__ di, int b, int row0,
                           int rows, int G, int Sq, int Hq, int hk) {
  if (threadIdx.x < BR) {
    const int rho = row0 + threadIdx.x;
    if (rho < rows) {
      const int s = rho / G;
      const size_t r = (static_cast<size_t>(b) * Sq + s) * Hq + hk * G + rho % G;
      qps[threadIdx.x] = q_pos[static_cast<size_t>(b) * Sq + s];
      lses[threadIdx.x] = lse[r];
      dis[threadIdx.x] = di[r];
    } else {
      qps[threadIdx.x] = INT_MIN;
      lses[threadIdx.x] = NO_ROW;
      dis[threadIdx.x] = 0.f;
    }
  }
}

// P and dS of one BR x BC tile into shared memory (row stride PSTR).  Thread
// t owns rows t / 16 and t / 16 + 16, columns t % 16 and t % 16 + 16.
__device__ void tile_p_ds(const float* Qs, const float* dOs, const float* Ks,
                          const float* Vs, int D, int DP, const int* qps,
                          const float* lses, const float* dis,
                          const int* kvps, int causal, float scale,
                          float softcap, float* Ps, float* dSs) {
  const int ii = threadIdx.x / 16, jj = threadIdx.x % 16;
  float s[2][2] = {{0.f, 0.f}, {0.f, 0.f}};
  float dp[2][2] = {{0.f, 0.f}, {0.f, 0.f}};
#pragma unroll 2
  for (int d = 0; d < D; d += 4) {
    const float4 q0 = ld4(Qs + ii * DP + d), q1 = ld4(Qs + (ii + 16) * DP + d);
    const float4 o0 = ld4(dOs + ii * DP + d), o1 = ld4(dOs + (ii + 16) * DP + d);
    const float4 k0 = ld4(Ks + jj * DP + d), k1 = ld4(Ks + (jj + 16) * DP + d);
    const float4 v0 = ld4(Vs + jj * DP + d), v1 = ld4(Vs + (jj + 16) * DP + d);
    s[0][0] += dot4(q0, k0); s[0][1] += dot4(q0, k1);
    s[1][0] += dot4(q1, k0); s[1][1] += dot4(q1, k1);
    dp[0][0] += dot4(o0, v0); dp[0][1] += dot4(o0, v1);
    dp[1][0] += dot4(o1, v0); dp[1][1] += dot4(o1, v1);
  }
#pragma unroll
  for (int a = 0; a < 2; ++a)
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const int i = ii + 16 * a, j = jj + 16 * c;
      const int kp = kvps[j];
      const bool ok = kp >= 0 && (!causal || kp <= qps[i]);
      float x = s[a][c] * scale, f = 1.f;
      if (softcap != 0.f) {
        const float t = tanhf(x / softcap);
        x = softcap * t;
        f = 1.f - t * t;
      }
      const float p = ok ? expf(x - lses[i]) : 0.f;
      Ps[i * PSTR + j] = p;
      dSs[i * PSTR + j] = p * (dp[a][c] - dis[i]) * f;
    }
}

struct Smem {
  float *A0, *A1, *B0, *B1, *Ps, *dSs, *lses, *dis;
  int *qps, *kvps;
};

__device__ Smem carve(float* sm, int DP) {
  Smem m;
  m.A0 = sm;
  m.A1 = m.A0 + BC * DP;
  m.B0 = m.A1 + BC * DP;
  m.B1 = m.B0 + BR * DP;
  m.Ps = m.B1 + BR * DP;
  m.dSs = m.Ps + BR * PSTR;
  m.lses = m.dSs + BR * PSTR;
  m.dis = m.lses + BR;
  m.qps = reinterpret_cast<int*>(m.dis + BR);
  m.kvps = m.qps + BR;
  return m;
}

size_t smem_bytes(int D) {
  const int DP = D + 4;
  return sizeof(float) * (static_cast<size_t>(2 * BC + 2 * BR) * DP
                          + 2 * BR * PSTR + 2 * BR) + sizeof(int) * (BR + BC);
}

__device__ void stage_kvpos(int* kvps, const int* __restrict__ kv_pos, int b,
                            int kv0, int Skv) {
  if (threadIdx.x < BC) {
    const int j = kv0 + threadIdx.x;
    kvps[threadIdx.x] = j < Skv ? kv_pos[static_cast<size_t>(b) * Skv + j] : -1;
  }
}

// Whether a (query tile, kv tile) pair holds a visible pair at all: some
// key valid and, under causal, the smallest valid kv position at most the
// tile's largest q position.  Read by every thread from shared memory, so
// the verdict is uniform across the block.
__device__ bool tile_live(const int* qps, const int* kvps, int causal) {
  int kv_lo = INT_MAX;
  for (int c = 0; c < BC; ++c)
    if (kvps[c] >= 0) kv_lo = min(kv_lo, kvps[c]);
  if (kv_lo == INT_MAX) return false;
  if (!causal) return true;
  int q_hi = INT_MIN;
  for (int r = 0; r < BR; ++r) q_hi = max(q_hi, qps[r]);
  return kv_lo <= q_hi;
}

template <int NC>
__global__ void __launch_bounds__(NT)
flash_bwd_dkdv(const float* __restrict__ q, const float* __restrict__ k,
               const float* __restrict__ v, const float* __restrict__ dout,
               const float* __restrict__ lse, const float* __restrict__ di,
               const int* __restrict__ q_pos, const int* __restrict__ kv_pos,
               float* __restrict__ dk, float* __restrict__ dv, int Sq, int Skv,
               int Hq, int Hkv, int D, float scale, float softcap,
               int causal) {
  extern __shared__ __align__(16) float sm_kv[];
  const int DP = D + 4;
  const Smem m = carve(sm_kv, DP);
  float *Ks = m.A0, *Vs = m.A1, *Qs = m.B0, *dOs = m.B1;
  const int G = Hq / Hkv, rows = Sq * G;
  const int kv0 = blockIdx.x * BC, hk = blockIdx.y, b = blockIdx.z;
  const int jr = threadIdx.x / 8, dl = threadIdx.x % 8;

  stage(Ks, k, b, kv0, Skv, 1, Skv, Hkv, hk, D, DP);
  stage(Vs, v, b, kv0, Skv, 1, Skv, Hkv, hk, D, DP);
  stage_kvpos(m.kvps, kv_pos, b, kv0, Skv);

  float4 ak[NC], av[NC];
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    ak[c] = make_float4(0.f, 0.f, 0.f, 0.f);
    av[c] = ak[c];
  }
  for (int row0 = 0; row0 < rows; row0 += BR) {
    __syncthreads();  // the previous tile's reads are done
    stage_rows(m.qps, m.lses, m.dis, q_pos, lse, di, b, row0, rows, G, Sq,
               Hq, hk);
    __syncthreads();
    if (!tile_live(m.qps, m.kvps, causal)) continue;
    stage(Qs, q, b, row0, rows, G, Sq, Hq, hk, D, DP);
    stage(dOs, dout, b, row0, rows, G, Sq, Hq, hk, D, DP);
    __syncthreads();
    tile_p_ds(Qs, dOs, Ks, Vs, D, DP, m.qps, m.lses, m.dis, m.kvps, causal,
              scale, softcap, m.Ps, m.dSs);
    __syncthreads();
#pragma unroll 4
    for (int i = 0; i < BR; ++i) {
      const float p = m.Ps[i * PSTR + jr], ds = m.dSs[i * PSTR + jr];
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const int d = (c * 8 + dl) * 4;
        if (d < D) {
          fma4(av[c], p, ld4(dOs + i * DP + d));
          fma4(ak[c], ds, ld4(Qs + i * DP + d));
        }
      }
    }
  }
  const int j = kv0 + jr;
  if (j >= Skv) return;
  const size_t base = ((static_cast<size_t>(b) * Skv + j) * Hkv + hk) * D;
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    const int d = (c * 8 + dl) * 4;
    if (d >= D) continue;
    const float kx[4] = {ak[c].x, ak[c].y, ak[c].z, ak[c].w};
    const float vx[4] = {av[c].x, av[c].y, av[c].z, av[c].w};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      dk[base + d + e] = scale * kx[e];
      dv[base + d + e] = vx[e];
    }
  }
}

template <int NC>
__global__ void __launch_bounds__(NT)
flash_bwd_dq(const float* __restrict__ q, const float* __restrict__ k,
             const float* __restrict__ v, const float* __restrict__ dout,
             const float* __restrict__ lse, const float* __restrict__ di,
             const int* __restrict__ q_pos, const int* __restrict__ kv_pos,
             float* __restrict__ dq, int Sq, int Skv, int Hq, int Hkv, int D,
             float scale, float softcap, int causal) {
  extern __shared__ __align__(16) float sm_q[];
  const int DP = D + 4;
  const Smem m = carve(sm_q, DP);
  float *Ks = m.A0, *Vs = m.A1, *Qs = m.B0, *dOs = m.B1;
  const int G = Hq / Hkv, rows = Sq * G;
  const int row0 = blockIdx.x * BR, hk = blockIdx.y, b = blockIdx.z;
  const int ir = threadIdx.x / 8, dl = threadIdx.x % 8;

  stage(Qs, q, b, row0, rows, G, Sq, Hq, hk, D, DP);
  stage(dOs, dout, b, row0, rows, G, Sq, Hq, hk, D, DP);
  stage_rows(m.qps, m.lses, m.dis, q_pos, lse, di, b, row0, rows, G, Sq, Hq,
             hk);

  float4 aq[NC];
#pragma unroll
  for (int c = 0; c < NC; ++c) aq[c] = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int kv0 = 0; kv0 < Skv; kv0 += BC) {
    __syncthreads();  // the previous tile's reads are done
    stage_kvpos(m.kvps, kv_pos, b, kv0, Skv);
    __syncthreads();
    if (!tile_live(m.qps, m.kvps, causal)) continue;
    stage(Ks, k, b, kv0, Skv, 1, Skv, Hkv, hk, D, DP);
    stage(Vs, v, b, kv0, Skv, 1, Skv, Hkv, hk, D, DP);
    __syncthreads();
    tile_p_ds(Qs, dOs, Ks, Vs, D, DP, m.qps, m.lses, m.dis, m.kvps, causal,
              scale, softcap, m.Ps, m.dSs);
    __syncthreads();
#pragma unroll 4
    for (int j = 0; j < BC; ++j) {
      const float ds = m.dSs[ir * PSTR + j];
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const int d = (c * 8 + dl) * 4;
        if (d < D) fma4(aq[c], ds, ld4(Ks + j * DP + d));
      }
    }
  }
  const int rho = row0 + ir;
  if (rho >= rows) return;
  const size_t base = ((static_cast<size_t>(b) * Sq + rho / G) * Hq + hk * G
                       + rho % G) * D;
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    const int d = (c * 8 + dl) * 4;
    if (d >= D) continue;
    const float x[4] = {aq[c].x, aq[c].y, aq[c].z, aq[c].w};
#pragma unroll
    for (int e = 0; e < 4; ++e) dq[base + d + e] = scale * x[e];
  }
}

// ---- bf16 on the tensor cores: mma.sync m16n8k16, f32 accumulate ---------
//
// The same two passes on 64 x 64 tiles, eight warps a block.  Warp w owns
// rows 16 (w % 4) of the block's tile and half w / 4 of the other axis:
// it computes its 16 x 32 share of S and dP (contraction D), writes P and
// dS (bf16) into shared memory, and after a barrier adds its rows' 16 x
// D/2 share of the gradient products (contraction 64), reading the whole
// P / dS rows back through ldmatrix.  So the accumulators are D/4 floats a
// thread per gradient (64 at D = 256) and no product is computed twice.
constexpr int TB = 64;             // rows of every tile
constexpr int TPS = TB + 8;        // padded row of the P / dS tiles (bf16)
constexpr int TNT = 256;           // threads: 8 warps

template <int HD>
struct TcSmem {
  static constexpr int SP = HD + 8;  // padded row of a Q/K/V/dO tile
  static constexpr size_t bytes =
      sizeof(bf16) * (4 * TB * SP + 2 * TB * TPS) + sizeof(float) * 2 * TB
      + sizeof(int) * 2 * TB;
};

// 64 rows of a (B, S, H, HD) bf16 tensor into shared memory (row stride
// SP), rows of the G-fold as in `stage`; rows past n are 0.
template <int HD>
__device__ void stage_tc(bf16* dst, const bf16* __restrict__ src, int b,
                         int row0, int n, int G, int S, int H, int hk) {
  constexpr int SP = HD + 8, V8 = HD / 8;
  const uint4 zero = make_uint4(0, 0, 0, 0);
  for (int e = threadIdx.x; e < TB * V8; e += TNT) {
    const int r = e / V8, c = (e % V8) * 8;
    const int rho = row0 + r;
    uint4 val = zero;
    if (rho < n)
      val = *reinterpret_cast<const uint4*>(
          src + ((static_cast<size_t>(b) * S + rho / G) * H + hk * G + rho % G)
                    * HD + c);
    *reinterpret_cast<uint4*>(dst + r * SP + c) = val;
  }
}

__device__ bool tile_live_tc(const int* qps, const int* kvps, int causal) {
  int kv_lo = INT_MAX;
  for (int c = 0; c < TB; ++c)
    if (kvps[c] >= 0) kv_lo = min(kv_lo, kvps[c]);
  if (kv_lo == INT_MAX) return false;
  if (!causal) return true;
  int q_hi = INT_MIN;
  for (int r = 0; r < TB; ++r) q_hi = max(q_hi, qps[r]);
  return kv_lo <= q_hi;
}

// acc[4][4] (+)= rows [16 rg, +16) of A (row-major, stride SP) times the
// 32 rows [n0, n0 + 32) of Bm read as the column operand (B(k, n) =
// Bm[n][k]), contraction HD: S = Q K^T and its kin.
template <int HD>
__device__ __forceinline__ void mma_rows_t(float (&acc)[4][4], const bf16* A,
                                           const bf16* Bm, int rg, int n0) {
  constexpr int SP = HD + 8;
  const int lane = threadIdx.x % 32;
#pragma unroll
  for (int n = 0; n < 4; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
#pragma unroll 4
  for (int ks = 0; ks < HD / 16; ++ks) {
    uint32_t a[4];
    mma_sm80::ldsm_x4(a, A + (16 * rg + lane % 16) * SP + ks * 16 + (lane / 16) * 8);
#pragma unroll
    for (int np = 0; np < 2; ++np) {
      uint32_t bb[4];
      mma_sm80::ldsm_x4(bb, Bm + (n0 + np * 16 + lane % 8 + (lane / 16) * 8) * SP
                                + ks * 16 + ((lane / 8) % 2) * 8);
      mma_sm80::mma16816(acc[2 * np], a, bb[0], bb[1]);
      mma_sm80::mma16816(acc[2 * np + 1], a, bb[2], bb[3]);
    }
  }
}

// acc[HD/16][4] += rows [16 rg, +16) of Pm (row-major 64 wide, stride TPS)
// times Bm (64 rows of HD, stride SP) restricted to columns [d0, d0 + HD/2):
// the gradient products (contraction over the tile's 64 rows).
template <int HD>
__device__ __forceinline__ void mma_rows_n(float (&acc)[HD / 16][4],
                                           const bf16* Pm, const bf16* Bm,
                                           int rg, int d0) {
  constexpr int SP = HD + 8;
  const int lane = threadIdx.x % 32;
#pragma unroll
  for (int kk = 0; kk < TB / 16; ++kk) {
    uint32_t a[4];
    mma_sm80::ldsm_x4(a, Pm + (16 * rg + lane % 16) * TPS + kk * 16 + (lane / 16) * 8);
#pragma unroll
    for (int dp = 0; dp < HD / 32; ++dp) {
      uint32_t bb[4];
      mma_sm80::ldsm_x4_t(bb, Bm + (kk * 16 + lane % 8 + ((lane / 8) % 2) * 8) * SP
                                  + d0 + dp * 16 + (lane / 16) * 8);
      mma_sm80::mma16816(acc[2 * dp], a, bb[0], bb[1]);
      mma_sm80::mma16816(acc[2 * dp + 1], a, bb[2], bb[3]);
    }
  }
}

// The gradient rows of one warp (16 rows from `row0 + 16 rg`, columns
// [d0, d0 + HD/2)) times `alpha` into out; `base(row)` the element offset
// of a row, -1 past the end.
template <int HD, typename F>
__device__ __forceinline__ void store_rows(bf16* out, const float (&acc)[HD / 16][4],
                                           int rg, int d0, float alpha, F base) {
  const int lane = threadIdx.x % 32;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const long long off = base(16 * rg + lane / 4 + 8 * h);
    if (off < 0) continue;
#pragma unroll
    for (int j = 0; j < HD / 16; ++j) {
      const int d = d0 + j * 8 + (lane % 4) * 2;
      *reinterpret_cast<uint32_t*>(out + off + d) = mma_sm80::pack_bf16(
          alpha * acc[j][2 * h], alpha * acc[j][2 * h + 1]);
    }
  }
}

template <int HD>
__global__ void __launch_bounds__(TNT, 1)
flash_bwd_dkdv_tc(const bf16* __restrict__ q, const bf16* __restrict__ k,
                  const bf16* __restrict__ v, const bf16* __restrict__ dout,
                  const float* __restrict__ lse, const float* __restrict__ di,
                  const int* __restrict__ q_pos, const int* __restrict__ kv_pos,
                  bf16* __restrict__ dk, bf16* __restrict__ dv, int Sq,
                  int Skv, int Hq, int Hkv, float scale, float softcap,
                  int causal) {
  constexpr int SP = HD + 8;
  extern __shared__ __align__(16) unsigned char smem_kv_tc[];
  bf16* Ks = reinterpret_cast<bf16*>(smem_kv_tc);
  bf16* Vs = Ks + TB * SP;
  bf16* Qs = Vs + TB * SP;
  bf16* dOs = Qs + TB * SP;
  bf16* Pt = dOs + TB * SP;     // P^T: kv rows x q columns
  bf16* dSt = Pt + TB * TPS;    // dS^T
  float* lses = reinterpret_cast<float*>(dSt + TB * TPS);
  float* dis = lses + TB;
  int* qps = reinterpret_cast<int*>(dis + TB);
  int* kvps = qps + TB;
  const int G = Hq / Hkv, rows = Sq * G;
  const int kv0 = blockIdx.x * TB, hk = blockIdx.y, b = blockIdx.z;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int rg = warp % 4, half = warp / 4;

  stage_tc<HD>(Ks, k, b, kv0, Skv, 1, Skv, Hkv, hk);
  stage_tc<HD>(Vs, v, b, kv0, Skv, 1, Skv, Hkv, hk);
  if (threadIdx.x < TB) {
    const int j = kv0 + threadIdx.x;
    kvps[threadIdx.x] = j < Skv ? kv_pos[static_cast<size_t>(b) * Skv + j] : -1;
  }
  float acc_k[HD / 16][4], acc_v[HD / 16][4];
#pragma unroll
  for (int j = 0; j < HD / 16; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc_k[j][e] = acc_v[j][e] = 0.f;
  // this lane's kv rows of the S^T tile: 16 rg + lane / 4 (+ 8)
  int kp[2];

  for (int row0 = 0; row0 < rows; row0 += TB) {
    __syncthreads();  // the previous tile's reads are done
    if (threadIdx.x < TB) {
      const int rho = row0 + threadIdx.x;
      if (rho < rows) {
        const int s = rho / G;
        const size_t r = (static_cast<size_t>(b) * Sq + s) * Hq + hk * G + rho % G;
        qps[threadIdx.x] = q_pos[static_cast<size_t>(b) * Sq + s];
        lses[threadIdx.x] = lse[r];
        dis[threadIdx.x] = di[r];
      } else {
        qps[threadIdx.x] = INT_MIN;
        lses[threadIdx.x] = NO_ROW;
        dis[threadIdx.x] = 0.f;
      }
    }
    __syncthreads();
    if (!tile_live_tc(qps, kvps, causal)) continue;
    stage_tc<HD>(Qs, q, b, row0, rows, G, Sq, Hq, hk);
    stage_tc<HD>(dOs, dout, b, row0, rows, G, Sq, Hq, hk);
    __syncthreads();
    kp[0] = kvps[16 * rg + lane / 4];
    kp[1] = kvps[16 * rg + lane / 4 + 8];
    float st[4][4], dpt[4][4];
    mma_rows_t<HD>(st, Ks, Qs, rg, 32 * half);
    mma_rows_t<HD>(dpt, Vs, dOs, rg, 32 * half);
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float p2[2], d2[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = 32 * half + n * 8 + (lane % 4) * 2 + e;  // q column
          float x = st[n][2 * h + e] * scale, f = 1.f;
          if (softcap != 0.f) {
            const float t = tanhf(x / softcap);
            x = softcap * t;
            f = 1.f - t * t;
          }
          const bool ok = kp[h] >= 0 && (!causal || kp[h] <= qps[c]);
          const float p = ok ? expf(x - lses[c]) : 0.f;
          p2[e] = p;
          d2[e] = p * (dpt[n][2 * h + e] - dis[c]) * f;
        }
        const int at = (16 * rg + lane / 4 + 8 * h) * TPS + 32 * half + n * 8
                       + (lane % 4) * 2;
        *reinterpret_cast<uint32_t*>(Pt + at) = mma_sm80::pack_bf16(p2[0], p2[1]);
        *reinterpret_cast<uint32_t*>(dSt + at) = mma_sm80::pack_bf16(d2[0], d2[1]);
      }
    __syncthreads();
    mma_rows_n<HD>(acc_v, Pt, dOs, rg, half * HD / 2);
    mma_rows_n<HD>(acc_k, dSt, Qs, rg, half * HD / 2);
  }
  const auto base = [&](int r) -> long long {
    const int j = kv0 + r;
    return j < Skv ? ((static_cast<long long>(b) * Skv + j) * Hkv + hk) * HD : -1;
  };
  store_rows<HD>(dk, acc_k, rg, half * HD / 2, scale, base);
  store_rows<HD>(dv, acc_v, rg, half * HD / 2, 1.f, base);
}

template <int HD>
__global__ void __launch_bounds__(TNT, 1)
flash_bwd_dq_tc(const bf16* __restrict__ q, const bf16* __restrict__ k,
                const bf16* __restrict__ v, const bf16* __restrict__ dout,
                const float* __restrict__ lse, const float* __restrict__ di,
                const int* __restrict__ q_pos, const int* __restrict__ kv_pos,
                bf16* __restrict__ dq, int Sq, int Skv, int Hq, int Hkv,
                float scale, float softcap, int causal) {
  constexpr int SP = HD + 8;
  extern __shared__ __align__(16) unsigned char smem_q_tc[];
  bf16* Ks = reinterpret_cast<bf16*>(smem_q_tc);
  bf16* Vs = Ks + TB * SP;
  bf16* Qs = Vs + TB * SP;
  bf16* dOs = Qs + TB * SP;
  bf16* dSs = dOs + TB * SP;    // dS: q rows x kv columns
  float* lses = reinterpret_cast<float*>(dSs + 2 * TB * TPS);
  float* dis = lses + TB;
  int* qps = reinterpret_cast<int*>(dis + TB);
  int* kvps = qps + TB;
  const int G = Hq / Hkv, rows = Sq * G;
  const int row0 = blockIdx.x * TB, hk = blockIdx.y, b = blockIdx.z;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int rg = warp % 4, half = warp / 4;

  stage_tc<HD>(Qs, q, b, row0, rows, G, Sq, Hq, hk);
  stage_tc<HD>(dOs, dout, b, row0, rows, G, Sq, Hq, hk);
  if (threadIdx.x < TB) {
    const int rho = row0 + threadIdx.x;
    if (rho < rows) {
      const int s = rho / G;
      const size_t r = (static_cast<size_t>(b) * Sq + s) * Hq + hk * G + rho % G;
      qps[threadIdx.x] = q_pos[static_cast<size_t>(b) * Sq + s];
      lses[threadIdx.x] = lse[r];
      dis[threadIdx.x] = di[r];
    } else {
      qps[threadIdx.x] = INT_MIN;
      lses[threadIdx.x] = NO_ROW;
      dis[threadIdx.x] = 0.f;
    }
  }
  float acc_q[HD / 16][4];
#pragma unroll
  for (int j = 0; j < HD / 16; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc_q[j][e] = 0.f;

  for (int kv0 = 0; kv0 < Skv; kv0 += TB) {
    __syncthreads();  // the previous tile's reads are done
    if (threadIdx.x < TB) {
      const int j = kv0 + threadIdx.x;
      kvps[threadIdx.x] = j < Skv ? kv_pos[static_cast<size_t>(b) * Skv + j] : -1;
    }
    __syncthreads();
    if (!tile_live_tc(qps, kvps, causal)) continue;
    stage_tc<HD>(Ks, k, b, kv0, Skv, 1, Skv, Hkv, hk);
    stage_tc<HD>(Vs, v, b, kv0, Skv, 1, Skv, Hkv, hk);
    __syncthreads();
    float sc[4][4], dp[4][4];
    mma_rows_t<HD>(sc, Qs, Ks, rg, 32 * half);
    mma_rows_t<HD>(dp, dOs, Vs, rg, 32 * half);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = 16 * rg + lane / 4 + 8 * h;  // q row
      const int qp = qps[r];
      const float l = lses[r], dd = dis[r];
#pragma unroll
      for (int n = 0; n < 4; ++n) {
        float d2[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = 32 * half + n * 8 + (lane % 4) * 2 + e;  // kv column
          float x = sc[n][2 * h + e] * scale, f = 1.f;
          if (softcap != 0.f) {
            const float t = tanhf(x / softcap);
            x = softcap * t;
            f = 1.f - t * t;
          }
          const int kp = kvps[c];
          const bool ok = kp >= 0 && (!causal || kp <= qp);
          const float p = ok ? expf(x - l) : 0.f;
          d2[e] = p * (dp[n][2 * h + e] - dd) * f;
        }
        *reinterpret_cast<uint32_t*>(dSs + r * TPS + 32 * half + n * 8
                                     + (lane % 4) * 2) =
            mma_sm80::pack_bf16(d2[0], d2[1]);
      }
    }
    __syncthreads();
    mma_rows_n<HD>(acc_q, dSs, Ks, rg, half * HD / 2);
  }
  const auto base = [&](int r) -> long long {
    const int rho = row0 + r;
    return rho < rows ? ((static_cast<long long>(b) * Sq + rho / G) * Hq
                         + hk * G + rho % G) * HD : -1;
  };
  store_rows<HD>(dq, acc_q, rg, half * HD / 2, scale, base);
}

template <int HD>
int run_tc(const bf16* q, const bf16* k, const bf16* v, const bf16* out,
           const bf16* dout, const float* lse, const float* dlse,
           const int* q_pos, const int* kv_pos, bf16* dq, bf16* dk, bf16* dv,
           float* di, int B, int Sq, int Skv, int Hq, int Hkv, float scale,
           float softcap, int causal, cudaStream_t st) {
  const long long rows = static_cast<long long>(B) * Sq * Hq;
  flash_bwd_dot<bf16><<<static_cast<unsigned>((rows + NT / 32 - 1) / (NT / 32)),
                        NT, 0, st>>>(out, dout, dlse, di, rows, HD);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int smem = static_cast<int>(TcSmem<HD>::bytes);
  err = cudaFuncSetAttribute(flash_bwd_dkdv_tc<HD>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  flash_bwd_dkdv_tc<HD><<<dim3((Skv + TB - 1) / TB, Hkv, B), TNT, smem, st>>>(
      q, k, v, dout, lse, di, q_pos, kv_pos, dk, dv, Sq, Skv, Hq, Hkv, scale,
      softcap, causal);
  err = cudaGetLastError();
  if (err != cudaSuccess || dq == nullptr) return err;
  err = cudaFuncSetAttribute(flash_bwd_dq_tc<HD>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const int G = Hq / Hkv;
  flash_bwd_dq_tc<HD><<<dim3((Sq * G + TB - 1) / TB, Hkv, B), TNT, smem, st>>>(
      q, k, v, dout, lse, di, q_pos, kv_pos, dq, Sq, Skv, Hq, Hkv, scale,
      softcap, causal);
  return cudaGetLastError();
}

template <int NC>
int run(const float* q, const float* k, const float* v, const float* out,
        const float* dout, const float* lse, const float* dlse,
        const int* q_pos, const int* kv_pos, float* dq, float* dk, float* dv,
        float* di, int B, int Sq,
        int Skv, int Hq, int Hkv, int D, float scale, float softcap,
        int causal, cudaStream_t st) {
  const long long rows = static_cast<long long>(B) * Sq * Hq;
  flash_bwd_dot<float><<<static_cast<unsigned>((rows + NT / 32 - 1)
                                                / (NT / 32)),
                         NT, 0, st>>>(out, dout, dlse, di, rows, D);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const size_t smem = smem_bytes(D);
  err = cudaFuncSetAttribute(flash_bwd_dkdv<NC>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const int G = Hq / Hkv;
  flash_bwd_dkdv<NC><<<dim3((Skv + BC - 1) / BC, Hkv, B), NT, smem, st>>>(
      q, k, v, dout, lse, di, q_pos, kv_pos, dk, dv, Sq, Skv, Hq, Hkv, D,
      scale, softcap, causal);
  err = cudaGetLastError();
  if (err != cudaSuccess || dq == nullptr) return err;
  err = cudaFuncSetAttribute(flash_bwd_dq<NC>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  flash_bwd_dq<NC><<<dim3((Sq * G + BR - 1) / BR, Hkv, B), NT, smem, st>>>(
      q, k, v, dout, lse, di, q_pos, kv_pos, dq, Sq, Skv, Hq, Hkv, D, scale,
      softcap, causal);
  return cudaGetLastError();
}

// The float32 kernels for a head dim D % 4 == 0 up to 256: NC float4
// groups of columns a thread.
int dispatch(const void* q, const void* k, const void* v, const void* out,
             const void* dout, const float* lse, const float* dlse,
             const int* q_pos, const int* kv_pos, void* dq, void* dk,
             void* dv, float* di, int B, int Sq, int Skv, int Hq, int Hkv,
             int D, float scale, float softcap, int causal, cudaStream_t st) {
  const auto c = [](const void* p) { return static_cast<const float*>(p); };
  const auto m = [](void* p) { return static_cast<float*>(p); };
#define FLASH_BWD_RUN(NC)                                                   \
  return run<NC>(c(q), c(k), c(v), c(out), c(dout), lse, dlse, q_pos,       \
                 kv_pos, m(dq), m(dk), m(dv), di, B, Sq, Skv, Hq, Hkv, D,   \
                 scale, softcap, causal, st)
  if (D <= 32) FLASH_BWD_RUN(1);
  if (D <= 64) FLASH_BWD_RUN(2);
  if (D <= 128) FLASH_BWD_RUN(4);
  FLASH_BWD_RUN(8);
#undef FLASH_BWD_RUN
}

}  // namespace

// q/out/dout/dq (B,Sq,Hq,D), k/v/dk/dv (B,Skv,Hkv,D) in one type (dtype 0 =
// float32, 1 = bfloat16), contiguous; lse (B,Sq,Hq) float32 from the
// forward; dlse the same shape or null; q_pos (B,Sq) / kv_pos (B,Skv)
// int32; di a (B,Sq,Hq) float32 scratch.  dq null: dk and dv only.  D % 4
// == 0 and D <= 256 (float32) or D = 64, 128, 256 (bf16; 16-byte aligned
// q, k, v, dout), Hq % Hkv == 0.  Returns a cudaError_t (0 = launched).
extern "C" int flash_attention_bwd(const void* q, const void* k, const void* v,
                                   const void* out, const void* dout,
                                   const float* lse, const float* dlse,
                                   const int* q_pos, const int* kv_pos,
                                   void* dq, void* dk, void* dv, float* di,
                                   int B, int Sq, int Skv, int Hq, int Hkv,
                                   int D, float scale, float softcap,
                                   int causal, int dtype, void* stream) {
  if (B < 0 || Sq < 0 || Skv < 0 || Hkv <= 0 || Hq % Hkv || D <= 0 || D % 4
      || D > 256)
    return cudaErrorInvalidValue;
  if (B == 0 || Sq == 0 || Skv == 0) return cudaSuccess;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch(q, k, v, out, dout, lse, dlse, q_pos, kv_pos, dq, dk, dv,
                    di, B, Sq, Skv, Hq, Hkv, D, scale, softcap, causal, st);
  if (dtype == 1 && (D == 64 || D == 128 || D == 256)) {
    const auto c = [](const void* p) { return static_cast<const bf16*>(p); };
    const auto m = [](void* p) { return static_cast<bf16*>(p); };
#define FLASH_BWD_TC(HD)                                                      \
  return run_tc<HD>(c(q), c(k), c(v), c(out), c(dout), lse, dlse, q_pos,     \
                    kv_pos, m(dq), m(dk), m(dv), di, B, Sq, Skv, Hq, Hkv,     \
                    scale, softcap, causal, st)
    if (D == 64) FLASH_BWD_TC(64);
    if (D == 128) FLASH_BWD_TC(128);
    FLASH_BWD_TC(256);
#undef FLASH_BWD_TC
  }
  return cudaErrorInvalidValue;
}
