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
// What bounds it on an H100: the five products (S and dP, recomputed for
// dK/dV and for dQ below, dV, dK, dQ) do 2 * 5 * pairs * D flops against
// q, k, v, out, dout and the three gradients once each; at the training
// shapes (512 x 512 rows of 8 heads of 256) the bytes and the operations
// bound it within a factor of 1.5 of each other.  The wgmma variant runs
// ~9x that bound there: a tile's loads, products and exp run one after
// another (PERF.md section 6).
//
// Design: deterministic, no float atomics, so that a restarted run on the
// card reproduces its loss curve bit for bit.  D_i first (flash_bwd_dot,
// one warp a row); then dK/dV from blocks that each own a KV tile and walk
// the query rows of every head of its group (the forward's GQA fold: row
// rho = s * G + g is query s of head hk * G + g), and dQ from blocks that
// each own a tile of query rows and walk the KV tiles; tiles with no
// visible pair (the causal upper triangle, holes) are skipped whole.
// Three variants:
// * flash_bwd_wgmma (bf16 at (D, Dv) = (64, 64), (128, 128), (256, 256)
//   and MLA's (192, 128); kernels/flash_attention.py::bwd_variant_for
//   sends it the bf16 calls): all five products on
//   wgmma, the streamed tiles through a cp.async ring, both kinds of block
//   in one launch, heaviest first (its own note below).  Two launches.
// * flash_bwd_dkdv_tc / flash_bwd_dq_tc (bf16 at D = 64, 128, 256):
//   64 x 64 tiles, all five products on mma.sync m16n8k16 with f32
//   accumulate (their own note below), synchronous loads.  Three launches.
// Both round P and dS to bf16 for the second product, as the forward
// rounds P.
// * float32 (Dv == D, or (192, 128)): flash_bwd_dkdv / flash_bwd_dq on
//   the CUDA cores, 32 x 32 tiles staged in float32 shared memory (at D =
//   256 the K, V, Q and dO tiles are 4 x 32 x 260 floats, 133 KB: dynamic
//   shared memory); a thread owns one row and every eighth group of four
//   columns of the gradient.  Its ceiling is the 67 TFLOP/s float32 rate;
//   it matches the float32 reference to 1e-4.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <climits>
#include <cmath>
#include <cstdint>
#include <type_traits>

#include "mma_sm80.cuh"
#include "tile_class.cuh"
#include "wgmma_sm90.cuh"

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
// Also zeroes the ncnt merge counters of flash_bwd_wgmma (cnt may be null).
template <typename T>
__global__ void __launch_bounds__(NT)
flash_bwd_dot(const T* __restrict__ out, const T* __restrict__ dout,
              const float* __restrict__ dlse, float* __restrict__ di,
              long long rows, int D, int* __restrict__ cnt = nullptr,
              int ncnt = 0) {
  for (long long i = static_cast<long long>(blockIdx.x) * NT + threadIdx.x;
       i < ncnt; i += static_cast<long long>(gridDim.x) * NT)
    cnt[i] = 0;
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
                          const float* Vs, int D, int Dv, int DP, const int* qps,
                          const float* lses, const float* dis,
                          const int* kvps, int causal, float scale,
                          float softcap, float* Ps, float* dSs) {
  const int ii = threadIdx.x / 16, jj = threadIdx.x % 16;
  float s[2][2] = {{0.f, 0.f}, {0.f, 0.f}};
  float dp[2][2] = {{0.f, 0.f}, {0.f, 0.f}};
#pragma unroll 2
  for (int d = 0; d < D; d += 4) {  // S over the key width
    const float4 q0 = ld4(Qs + ii * DP + d), q1 = ld4(Qs + (ii + 16) * DP + d);
    const float4 k0 = ld4(Ks + jj * DP + d), k1 = ld4(Ks + (jj + 16) * DP + d);
    s[0][0] += dot4(q0, k0); s[0][1] += dot4(q0, k1);
    s[1][0] += dot4(q1, k0); s[1][1] += dot4(q1, k1);
  }
#pragma unroll 2
  for (int d = 0; d < Dv; d += 4) {  // dP over the value width
    const float4 o0 = ld4(dOs + ii * DP + d), o1 = ld4(dOs + (ii + 16) * DP + d);
    const float4 v0 = ld4(Vs + jj * DP + d), v1 = ld4(Vs + (jj + 16) * DP + d);
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
               int Hq, int Hkv, int D, int Dv, float scale, float softcap,
               int causal) {
  extern __shared__ __align__(16) float sm_kv[];
  const int DP = D + 4;
  const Smem m = carve(sm_kv, DP);
  float *Ks = m.A0, *Vs = m.A1, *Qs = m.B0, *dOs = m.B1;
  const int G = Hq / Hkv, rows = Sq * G;
  const int kv0 = blockIdx.x * BC, hk = blockIdx.y, b = blockIdx.z;
  const int jr = threadIdx.x / 8, dl = threadIdx.x % 8;

  stage(Ks, k, b, kv0, Skv, 1, Skv, Hkv, hk, D, DP);
  stage(Vs, v, b, kv0, Skv, 1, Skv, Hkv, hk, Dv, DP);
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
    stage(dOs, dout, b, row0, rows, G, Sq, Hq, hk, Dv, DP);
    __syncthreads();
    tile_p_ds(Qs, dOs, Ks, Vs, D, Dv, DP, m.qps, m.lses, m.dis, m.kvps,
              causal, scale, softcap, m.Ps, m.dSs);
    __syncthreads();
#pragma unroll 4
    for (int i = 0; i < BR; ++i) {
      const float p = m.Ps[i * PSTR + jr], ds = m.dSs[i * PSTR + jr];
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const int d = (c * 8 + dl) * 4;
        if (d < Dv) fma4(av[c], p, ld4(dOs + i * DP + d));
        if (d < D) fma4(ak[c], ds, ld4(Qs + i * DP + d));
      }
    }
  }
  const int j = kv0 + jr;
  if (j >= Skv) return;
  const size_t row = (static_cast<size_t>(b) * Skv + j) * Hkv + hk;
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    const int d = (c * 8 + dl) * 4;
    const float kx[4] = {ak[c].x, ak[c].y, ak[c].z, ak[c].w};
    const float vx[4] = {av[c].x, av[c].y, av[c].z, av[c].w};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if (d < D) dk[row * D + d + e] = scale * kx[e];
      if (d < Dv) dv[row * Dv + d + e] = vx[e];
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
             int Dv, float scale, float softcap, int causal) {
  extern __shared__ __align__(16) float sm_q[];
  const int DP = D + 4;
  const Smem m = carve(sm_q, DP);
  float *Ks = m.A0, *Vs = m.A1, *Qs = m.B0, *dOs = m.B1;
  const int G = Hq / Hkv, rows = Sq * G;
  const int row0 = blockIdx.x * BR, hk = blockIdx.y, b = blockIdx.z;
  const int ir = threadIdx.x / 8, dl = threadIdx.x % 8;

  stage(Qs, q, b, row0, rows, G, Sq, Hq, hk, D, DP);
  stage(dOs, dout, b, row0, rows, G, Sq, Hq, hk, Dv, DP);
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
    stage(Vs, v, b, kv0, Skv, 1, Skv, Hkv, hk, Dv, DP);
    __syncthreads();
    tile_p_ds(Qs, dOs, Ks, Vs, D, Dv, DP, m.qps, m.lses, m.dis, m.kvps,
              causal, scale, softcap, m.Ps, m.dSs);
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

// ---- bf16 on wgmma: flash_bwd_wgmma ---------------------------------------
//
// One launch computes every gradient tile (after flash_bwd_dot's D_i): its
// grid holds two kinds of block, each pinning one 64-row tile pair in
// shared memory and streaming the other side's 64-row tiles through a
// cp.async ring (STAGES stages, 128B-swizzled, zero-filled past the end;
// the load of tile i + STAGES - 1 is in flight while tile i is
// multiplied), one barrier a tile:
// * a KV block (64 kv rows of one KV head) pins K and V and streams the
//   group's Q and dO tiles (64 rows of the G-fold rho = s * G + g) with
//   their q positions, lse and D_i.  Per tile: S^T = K Q^T and dP^T = V
//   dO^T (wgmma, both operands K-major in shared memory, HD/16 k-steps),
//   then on the accumulators P^T = exp(s - lse) (s capped) and dS^T =
//   P^T o (dP^T - D) o (1 - (s/cap)^2), rounded to bf16 as the A operand
//   of dV += P^T dO and dK += dS^T Q (the dO and Q tiles read MN-major:
//   the forward's O += P V).
// * a Q block (64 query rows of the G-fold) pins Q and dO and streams the
//   K and V tiles with their kv positions: S = Q K^T, dP = dO V^T, dS in
//   registers, dQ += dS K (K read MN-major).
// Both kinds are the same code with the roles of rows and columns swapped
// (bwd_walk<DK, DV, KV>).  K and Q tiles are DK wide, V and dO tiles DV
// wide: S (and dQ, dK) run over DK columns, dP (and dV) over DV.  Every streamed tile is classified once before the
// walk (tile_class.cuh: skipped tiles are neither loaded nor multiplied,
// mask-free ones read no positions).  Accumulators stay in registers and
// each block writes its own rows once: no atomics, deterministic.
// At D 64 and 128 one warpgroup owns the block: S and dP are m64n64k16,
// and P and dS pass to the gradient products in registers.  At D 256 a
// warpgroup cannot hold dK and dV over 256 columns (256 floats a thread),
// so two share a block's 64 pinned rows: each owns half the gradients'
// columns and computes S and dP for half the tile's columns (m64n32k16),
// the exp on its S while its dP runs, and the two hand their halves of P
// and dS to each other in shared memory (a second barrier a tile).  At
// (192, 128) one warpgroup would hold 160 gradient floats beside S and
// dP, so it runs as D 256 does: the gradients' 64-column chunks are dealt
// to the two groups in order, dK's (or dQ's) three as two and one, dV's
// two as one each; group 1 repeats dK's last chunk into its unused slot
// rather than branch around a product (so both run three gradient
// products a tile in a KV block, two in a Q block; the repeat is 10-12%
// of a tile's tensor work).  A tile pair's shared memory: pinned K (24 KB) and
// V (16 KB), two ring stages of Q and dO (41 KB each), P and dS (16 KB):
// 140 KB, one block an SM.
// Where the heaviest KV block would outlast the card's mean load (the
// Memory-LLM's first KV tile walks all 16 query tiles, twice the mean),
// each KV tile's walk over the query tiles is split between two blocks:
// each sums its half into float32 registers and writes it to a
// workspace; an integer counter (zeroed by flash_bwd_dot) tells the
// second to finish, which adds the other's half to its own and stores the
// tile.  Two float32 terms add the same either way round, so the result
// does not depend on which finishes first.  Where the load is even (a
// prompt against its prefix, the 3072-token source) the halves' merge
// costs more than it saves (measured, PERF.md section 6), so the host
// splits only when the heaviest KV block weighs more than 3/2 of the mean
// load of a block slot (SMs x resident blocks).
// The grid's blocks run heaviest first by a shape-only estimate (BwPlan,
// restated by kernels/flash_attention.py::bwd_plan): KV_COST x (its share
// of the visible query tiles, the larger half) for a KV block, Q_COST x
// (visible KV tiles) for a Q block, as if q positions end-aligned with the
// kv positions (q s at s + Skv - Sq); merged in descending weight (ties:
// KV blocks first); within a slot, KV heads then batches.
constexpr int WB = 64;          // rows of every tile
constexpr int BW_MAXT = 1024;   // streamed tiles a block may walk
constexpr int KV_COST = 4;      // products a KV block runs per tile
constexpr int Q_COST = 3;       // ... and a Q block
// split KV walks when the heaviest one weighs more than SPLIT_NUM /
// SPLIT_DEN of a block slot's mean load
constexpr int SPLIT_NUM = 3, SPLIT_DEN = 2;

// blocks of flash_bwd_wgmma<D, Dv> resident on an SM (shared memory and
// registers allow no more)
__host__ __device__ constexpr int blocks_per_sm(int D) {
  return D == 64 ? 3 : D == 128 ? 2 : 1;
}
constexpr float LOG2E = 1.4426950408889634f;

// Warpgroups a block: two where one cannot hold the gradients' columns in
// registers (dK and dV over 256 columns; at (192, 128) dK's 192 and dV's
// 128 beside S and dP)
__host__ __device__ constexpr int bw_groups(int DK, int DV) {
  return DK == 256 || DK != DV ? 2 : 1;
}
// 64-column chunks of dK / dQ (DK wide) a group owns: the chunks are dealt
// in order, so at (192, 128) group 0 owns two and group 1 one
__host__ __device__ constexpr int bw_kown(int DK, int DV) {
  return (DK / 64 + bw_groups(DK, DV) - 1) / bw_groups(DK, DV);
}
// ... and of dV (DV wide)
__host__ __device__ constexpr int bw_vown(int DK, int DV) {
  return DV / 64 / bw_groups(DK, DV);
}
// the float32 accumulators of one half of a split KV walk (its threads'
// dK and dV registers), as the workspace holds them
__host__ __device__ constexpr long long bw_half_floats(int DK, int DV) {
  return (bw_kown(DK, DV) + bw_vown(DK, DV)) * 32LL * 128 * bw_groups(DK, DV);
}

template <int DK, int DV>
struct BwCfg {
  static_assert(DK % 64 == 0 && DV % 64 == 0 && DV <= DK, "64-column chunks");
  static constexpr int NWG = bw_groups(DK, DV);     // warpgroups a block
  static_assert(NWG > 1 || DK == DV, "one group: S and dP in one loop");
  static_assert((DV / 64) % NWG == 0, "dV's chunks split evenly");
  static constexpr int NT = 128 * NWG;
  static constexpr int MINB = blocks_per_sm(DK);
  static constexpr int STAGES = DK == 64 ? 3 : 2;
  static constexpr int KC = DK / 64;              // dK / dQ chunks
  static constexpr int KOWN = bw_kown(DK, DV);    // ... a group's
  static constexpr int VOWN = bw_vown(DK, DV);    // dV chunks a group's
  static constexpr bool KEVEN = KC % NWG == 0;    // every group owns KOWN
  static_assert(KOWN >= VOWN, "the gradient loop runs over KOWN chunks");
  static constexpr int NS = WB / NWG;         // S / dP columns, a group's
  static constexpr int TK = WB * DK * 2;      // bytes of a 64-row tile: K, Q
  static constexpr int TV = WB * DV * 2;      // ... V, dO
  static constexpr int FACTS = 1024;                // a stage's row facts
  static constexpr int STAGE = TK + TV + FACTS;
  static constexpr int HAND = NWG > 1 ? 2 * WB * WB * 2 : 0;  // P and dS, bf16
  static constexpr size_t SMEM =
      1024 + TK + TV + STAGES * STAGE + HAND + BW_MAXT;
};

// S (S^T) or dP (dP^T) of a group's NS columns: m64n64k16 or m64n32k16
template <int N>
__device__ __forceinline__ void mma_first(float (&d)[N / 2], uint64_t da,
                                          uint64_t db, int accumulate) {
  if constexpr (N == 64) wgmma_sm90::mma_ss<0>(d, da, db, accumulate);
  else wgmma_sm90::mma_ss32<0>(d, da, db, accumulate);
}

// tanh from one ex2 and one division, within ~1e-7 of it (tanh.approx's
// 2^-11 relative error would move the cap factor 1 - tanh^2 by 1e-3
// where |tanh| is near 1)
__device__ __forceinline__ float tanh_ex2(float x) {
  const float e = wgmma_sm90::ex2(fminf(2.f * LOG2E * fabsf(x), 126.f));
  return copysignf(1.f - __fdividef(2.f, e + 1.f), x);
}

// The launch order of the grid (see above); __host__ too, for the host's
// block count.  A slot is one tile of either kind over all KV heads and
// batches.
struct BwPlan {
  int nq, nkv, rows, G, off, causal, with_q, split;  // split: 1 or 2

  // the last end-aligned position of q tile u
  __host__ __device__ int p_hi(int u) const {
    const int last = WB * u + WB - 1;
    return (last < rows - 1 ? last : rows - 1) / G + off;
  }
  // the first q tile whose last position reaches x (nq: none)
  __host__ __device__ int first_u(int x) const {
    const long long need = static_cast<long long>(G) * (x - off);
    if (need > rows - 1) return nq;
    const long long a = need - (WB - 1);
    return a <= 0 ? 0 : static_cast<int>((a + WB - 1) / WB);
  }
  __host__ __device__ int vis_kv(int t) const {
    return causal ? nq - first_u(WB * t) : nq;
  }
  __host__ __device__ int vis_q(int u) const {
    if (!causal) return nkv;
    const int p = p_hi(u);
    return p < 0 ? 0 : (p / WB + 1 < nkv ? p / WB + 1 : nkv);
  }
  // q tiles heavier than weight w
  __host__ __device__ int q_above(int w) const {
    const int v = w / Q_COST;  // Q_COST * vis_q(u) > w: vis_q(u) >= v + 1
    if (v + 1 > nkv) return 0;
    return causal ? nq - first_u(WB * v) : nq;
  }
  // KV block k is part k % split of KV tile k / split
  __host__ __device__ int kv_blocks() const { return nkv * split; }
  __host__ __device__ int kv_slot(int k) const {
    const int vis = vis_kv(k / split);
    return k + q_above(KV_COST * ((vis + split - 1) / split));
  }
  // the first query tile of part 1 of KV tile t: part 0 takes the larger
  // half of the visible tiles
  __host__ __device__ int mid(int t) const { return nq - vis_kv(t) / 2; }
  __host__ __device__ int slots() const {
    return kv_blocks() + (with_q ? nq : 0);
  }
  // slot i -> KV block (kv = true) or q tile
  __host__ __device__ void slot(int i, bool& kv, int& tile) const {
    if (!with_q) {
      kv = true;
      tile = i;
      return;
    }
    int lo = 0, hi = kv_blocks();  // lo: the KV blocks in slots <= i
    while (lo < hi) {
      const int m = (lo + hi) / 2;
      if (kv_slot(m) <= i) lo = m + 1;
      else hi = m;
    }
    kv = lo > 0 && kv_slot(lo - 1) == i;
    tile = kv ? lo - 1 : nq - 1 - (i - lo);
  }
};

// The plan of a call on a card of `sms` SMs: split KV walks in two when
// the heaviest KV block (KV tile 0's) weighs more than SPLIT_NUM /
// SPLIT_DEN of the total weight over the block slots.
BwPlan bw_plan(int B, int Sq, int Skv, int Hq, int Hkv, int D, int causal,
               bool with_q, int sms) {
  const int G = Hq / Hkv, nq = (Sq * G + WB - 1) / WB;
  BwPlan p{nq, (Skv + WB - 1) / WB, Sq * G, G, Skv - Sq, causal, with_q, 1};
  long long total = 0;
  for (int t = 0; t < p.nkv; ++t) total += KV_COST * p.vis_kv(t);
  for (int u = 0; with_q && u < nq; ++u) total += Q_COST * p.vis_q(u);
  const long long heavy = KV_COST * p.vis_kv(0);
  const long long slots = static_cast<long long>(sms) * blocks_per_sm(D);
  if (nq >= 2 && SPLIT_DEN * heavy * slots
                     > SPLIT_NUM * total * Hkv * static_cast<long long>(B))
    p.split = 2;
  return p;
}

// 64 rows of a pair of tensors of PK and PV 16-byte pieces a row (DK and
// DV columns), rows x0.. (element row row_of(x); rows past n zero-filled),
// into the 128B-swizzled 64-column chunks at d0 and d1, asynchronously.
// At equal widths one loop serves both: each element's row offset (a
// division by the GQA group on the query side) is reckoned once.
template <int PK, int PV, int NT, typename RowOf>
__device__ __forceinline__ void load_pair(uint32_t d0,
                                          const bf16* __restrict__ s0,
                                          uint32_t d1,
                                          const bf16* __restrict__ s1,
                                          int x0, int n, RowOf row_of) {
  const auto rows = [&](auto P_, uint32_t dst, const bf16* src, bool both) {
    constexpr int P = decltype(P_)::value;
#pragma unroll
    for (int i = 0; i < WB * P / NT; ++i) {
      const int e = threadIdx.x + NT * i;
      const int r = e / P, pc = e % P;
      const bool ok = x0 + r < n;
      const size_t off = ok ? row_of(x0 + r) * (P * 8) + pc * 8 : 0;
      const uint32_t o =
          (pc / 8) * (WB * 128) + wgmma_sm90::sw128(r, pc % 8);
      wgmma_sm90::cp_async16(dst + o, src + off, ok);
      if (both) wgmma_sm90::cp_async16(d1 + o, s1 + off, ok);
    }
  };
  if constexpr (PK == PV) {
    rows(std::integral_constant<int, PK>{}, d0, s0, true);
  } else {
    rows(std::integral_constant<int, PK>{}, d0, s0, false);
    rows(std::integral_constant<int, PV>{}, d1, s1, false);
  }
}

template <int DK, int DV, bool KV>
__device__ __forceinline__ void bwd_walk(
    const bf16* __restrict__ q, const bf16* __restrict__ k,
    const bf16* __restrict__ v, const bf16* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ di,
    const int* __restrict__ q_pos, const int* __restrict__ kv_pos,
    bf16* __restrict__ dq, bf16* __restrict__ dk, bf16* __restrict__ dv,
    int Sq, int Skv, int Hq, int Hkv, float scale, float softcap,
    int causal, int tile, int lo, int hi, int hk, int b, float* __restrict__ ws,
    int* __restrict__ cnt, int merge_id, int part, unsigned char* smem_raw) {
  namespace wg = wgmma_sm90;
  using namespace flash_tiles;
  using C = BwCfg<DK, DV>;
  constexpr int NT = C::NT, STAGES = C::STAGES;
  constexpr int KOWN = C::KOWN, VOWN = C::VOWN;
  constexpr int PK = DK / 8, PV = DV / 8;  // 16-byte pieces of a row
  const uint32_t raw = wg::smem_addr(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;  // swizzle atoms: 1024 B
  unsigned char* sm = smem_raw + (base - raw);
  // the pinned pair: (K, V) or (Q, dO), DK and DV wide
  const uint32_t sP0 = base, sP1 = base + C::TK;
  const uint32_t sRing = base + C::TK + C::TV;
  // two groups: P (P^T) and dS (dS^T) handed over in the A layout
  const uint32_t sPX = sRing + STAGES * C::STAGE, sDX = sPX + WB * WB * 2;
  unsigned char* cls = sm + C::TK + C::TV + STAGES * C::STAGE + C::HAND;

  const int G = Hq / Hkv, rows = Sq * G;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int grp = tid / 128;                       // this thread's warpgroup
  const int r_lo = (warp % 4) * 16 + lane / 4;     // its rows: r_lo, r_lo + 8
  const int* kvb = kv_pos + static_cast<size_t>(b) * Skv;
  const int* qpb = q_pos + static_cast<size_t>(b) * Sq;
  const int row0 = tile * WB;                      // first pinned row
  const int n_pin = KV ? Skv : rows, n_str = KV ? rows : Skv;
  // streamed tiles [lo, hi) of the (n_str + WB - 1) / WB
  // element row of folded q row rho, or of kv row j
  const auto qrow = [&](int rho) {
    return (static_cast<size_t>(b) * Sq + rho / G) * Hq + hk * G + rho % G;
  };
  const auto kvrow = [&](int j) {
    return (static_cast<size_t>(b) * Skv + j) * Hkv + hk;
  };
  const auto row_of = [&](bool kv_side, int x) {
    return kv_side ? kvrow(x) : qrow(x);
  };

  const auto pin_row = [&](int x) { return row_of(KV, x); };
  const auto str_row = [&](int x) { return row_of(!KV, x); };
  // the pinned pair (K, V) or (Q, dO); joins the first tile's group
  load_pair<PK, PV, NT>(sP0, KV ? k : q, sP1, KV ? v : dout, row0, n_pin,
                        pin_row);

  // classify every streamed tile against the pinned rows: warp w takes
  // tiles w, w + NT/32, ..., four at a time
  Span pin_span{INT_MAX, INT_MIN, 0};
  QRange pin_q{INT_MAX, INT_MIN};
  {
    const int x0 = row0 + lane, x1 = x0 + 32;
    if (KV)
      pin_span = warp_span(merge(span_of(x0 < Skv ? kvb[x0] : -1),
                                 span_of(x1 < Skv ? kvb[x1] : -1)));
    else
      pin_q = warp_qrange(merge(
          qrange_of(x0 < rows ? qpb[x0 / G] : 0, x0 < rows),
          qrange_of(x1 < rows ? qpb[x1 / G] : 0, x1 < rows)));
  }
  for (int t0 = lo + warp; t0 < hi; t0 += NT / 8) {
    int p[4][2];
#pragma unroll
    for (int u = 0; u < 4; ++u)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int x = (t0 + u * NT / 32) * WB + lane + 32 * h;
        p[u][h] = x < n_str ? (KV ? qpb[x / G] : kvb[x]) : -1;
      }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int t = t0 + u * NT / 32;
      int c;
      if (KV) {
        const int x = t * WB + lane;
        const QRange r = warp_qrange(merge(qrange_of(p[u][0], x < rows),
                                           qrange_of(p[u][1], x + 32 < rows)));
        c = tile_class(pin_span, r, causal);
      } else {
        c = tile_class(warp_span(merge(span_of(p[u][0]), span_of(p[u][1]))),
                       pin_q, causal);
      }
      if (lane == 0 && t < hi) cls[t] = static_cast<unsigned char>(c);
    }
  }

  // this thread's pinned rows: KV, their kv positions; Q, their q
  // positions, lse in base 2 and D_i (rows past the end: no P)
  int my_pos[2];
  float my_l2[2] = {0.f, 0.f}, my_d[2] = {0.f, 0.f};
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int x = row0 + r_lo + 8 * h;
    if (KV) {
      my_pos[h] = x < Skv ? kvb[x] : -1;
    } else if (x < rows) {
      const size_t o = qrow(x);
      my_pos[h] = qpb[x / G];
      my_l2[h] = lse[o] * LOG2E;
      my_d[h] = di[o];
    } else {
      my_pos[h] = INT_MIN;
      my_l2[h] = NO_ROW * LOG2E;
    }
  }
  __syncthreads();  // cls

  const auto next_tile = [&](int t) {
    while (t < hi && cls[t] == kSkip) ++t;
    return t;
  };
  // streamed tile t into `stage`: (Q, dO) and per row q position, lse and
  // D_i (KV blocks), or (K, V) and kv positions (Q blocks)
  const auto issue = [&](int stage, int t) {
    const uint32_t s0 = sRing + stage * C::STAGE, s1 = s0 + C::TK;
    const uint32_t sf = s1 + C::TV;
    const int x0 = t * WB;
    load_pair<PK, PV, NT>(s0, KV ? q : k, s1, KV ? dout : v, x0, n_str,
                          str_row);
    if (tid < WB) {
      const int x = x0 + tid;
      int* fp = reinterpret_cast<int*>(sm + (sf - base));
      if (KV) {
        float* fl = reinterpret_cast<float*>(fp + WB);
        if (x < rows) {
          const size_t o = qrow(x);
          wg::cp_async4(sf + 4 * tid, qpb + x / G);
          wg::cp_async4(sf + 4 * (WB + tid), lse + o);
          wg::cp_async4(sf + 4 * (2 * WB + tid), di + o);
        } else {
          fp[tid] = INT_MIN;
          fl[tid] = NO_ROW;
          fl[WB + tid] = 0.f;
        }
      } else if (x < Skv) {
        wg::cp_async4(sf + 4 * tid, kvb + x);
      } else {
        fp[tid] = -1;
      }
    }
  };

  int nxt = next_tile(lo);
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (nxt < hi) {
      issue(s, nxt);
      nxt = next_tile(nxt + 1);
    }
    wg::cp_async_commit();
  }

  // dK (KV) or dQ: this group's KOWN 64-column chunks, grp * KOWN + c
  // (one past DK, at (192, 128) group 1's second, repeats the last and is
  // never stored); dV (KV only): its VOWN chunks
  float ga[KOWN][32], gv[VOWN][32];
#pragma unroll
  for (int c = 0; c < KOWN; ++c)
#pragma unroll
    for (int j = 0; j < 32; ++j) ga[c][j] = 0.f;
#pragma unroll
  for (int c = 0; c < VOWN; ++c)
#pragma unroll
    for (int j = 0; j < 32; ++j) gv[c][j] = 0.f;
  // whether this group's chunk c of dK / dQ exists (uniform in a group)
  const auto owns = [&](int c) { return C::KEVEN || grp * KOWN + c < C::KC; };
  const bool capped = softcap != 0.f;
  const float inv_cap = capped ? scale / softcap : 0.f;

  int i = 0;
  for (int cur = next_tile(lo); cur < hi; cur = next_tile(cur + 1), ++i) {
    wg::cp_async_wait<STAGES - 2>();  // tile cur has landed (this thread's)
    wg::fence_proxy_async();
    // ... and every thread's; every group is also done with tile i - 1,
    // whose stage the next load overwrites
    __syncthreads();
    if (nxt < hi) {
      issue((i + STAGES - 1) % STAGES, nxt);
      nxt = next_tile(nxt + 1);
    }
    wg::cp_async_commit();
    const uint32_t s0 = sRing + (i % STAGES) * C::STAGE, s1 = s0 + C::TK;
    const int* fp = reinterpret_cast<const int*>(sm + (s1 + C::TV - base));
    const float* fl = reinterpret_cast<const float*>(fp + WB);
    const float* fd = fl + WB;

    // S (S^T) and dP (dP^T): the pinned rows against this group's NS
    // rows of the streamed tile, over DK and DV columns.  Two groups a
    // block: S and dP as two groups of products, the exp on S while dP
    // runs, P and dS handed over in shared memory.  One group (DK == DV):
    // one group of products, P and dS into the A fragments in registers
    // (the overlap measured no faster there, PERF.md section 6).
    constexpr int NS = C::NS, NE = NS / 2;  // elements a thread holds
    constexpr bool TWO = C::NWG > 1;
    float x[NE], y[NE];
#pragma unroll
    for (int j = 0; j < NE; ++j) x[j] = y[j] = 0.f;
    const uint32_t so = grp * NS * 128;
    wg::fence();
#pragma unroll
    for (int ks = 0; ks < DK / 16; ++ks) {
      const uint32_t ko = (ks / 4) * (WB * 128) + (ks % 4) * 32;
      mma_first<NS>(x, wg::desc(sP0 + ko, 16, 1024),
                    wg::desc(s0 + ko + so, 16, 1024), ks > 0);
      if constexpr (!TWO)
        mma_first<NS>(y, wg::desc(sP1 + ko, 16, 1024),
                      wg::desc(s1 + ko + so, 16, 1024), ks > 0);
    }
    if constexpr (TWO) {
      wg::commit();
#pragma unroll
      for (int ks = 0; ks < DV / 16; ++ks) {
        const uint32_t ko = (ks / 4) * (WB * 128) + (ks % 4) * 32;
        mma_first<NS>(y, wg::desc(sP1 + ko, 16, 1024),
                      wg::desc(s1 + ko + so, 16, 1024), ks > 0);
      }
    }
    wg::commit();

    // element j is (row r_lo + 8 ((j/2) % 2), column grp NS + 8 (j/4) +
    // 2 (lane % 4) + j % 2) of the tile; pairs (j, j + 1) are adjacent
    // columns, one bf16x2 of the next product's A operand
    const auto col = [&](int j) {
      return grp * NS + 8 * (j / 4) + 2 * (lane % 4) + (j % 2);
    };
    const auto hand = [&](uint32_t mat, int j) {  // shared address of pair j
      const int r = r_lo + 8 * ((j / 2) % 2), c = col(j);
      return mat + wg::sw128(r, c / 8) + (c % 8) * 2;
    };
    const bool masked = cls[cur] == kMasked;
    // P of element j from S in x[j], and its cap factor f
    const auto p_of = [&](int j, float& f) {
      const int h = (j / 2) % 2, c = col(j);
      const float l2 = KV ? fl[c] * LOG2E : my_l2[h];
      float s = x[j] * scale;
      f = 1.f;
      if (capped) {
        const float th = tanh_ex2(x[j] * inv_cap);
        s = softcap * th;
        f = 1.f - th * th;
      }
      float p = wg::ex2(fmaf(s, LOG2E, -l2));
      if (masked) {
        const int kp = KV ? my_pos[h] : fp[c];
        const int qp = KV ? fp[c] : my_pos[h];
        if (kp < 0 || (causal && kp > qp)) p = 0.f;
      }
      return p;
    };
    const auto d_of = [&](int j) {  // D_i of element j's query row
      return KV ? fd[col(j)] : my_d[(j / 2) % 2];
    };
    uint32_t ap[WB / 16][4], as[WB / 16][4];  // one group: A from registers
    if constexpr (TWO) {
      wg::wait<1>();  // S has landed; dP is in flight
      wg::reg_fence(x);
#pragma unroll
      for (int j = 0; j < NE; j += 2) {
        float f0, f1;
        const float p0 = p_of(j, f0), p1 = p_of(j + 1, f1);
        if (KV)
          *reinterpret_cast<uint32_t*>(sm + (hand(sPX, j) - base)) =
              wg::pack_bf16(p0, p1);
        x[j] = p0 * f0;  // dS = (P o f) o (dP - D)
        x[j + 1] = p1 * f1;
      }
      wg::wait<0>();
      wg::reg_fence(y);
#pragma unroll
      for (int j = 0; j < NE; j += 2)
        *reinterpret_cast<uint32_t*>(sm + (hand(sDX, j) - base)) =
            wg::pack_bf16(x[j] * (y[j] - d_of(j)),
                          x[j + 1] * (y[j + 1] - d_of(j + 1)));
      wg::fence_proxy_async();
      __syncthreads();  // both groups' halves of P and dS
    } else {
      wg::wait<0>();
      wg::reg_fence(x);
      wg::reg_fence(y);
#pragma unroll
      for (int j = 0; j < NE; ++j) {
        float f;
        const float p = p_of(j, f);
        x[j] = p;
        y[j] = p * (y[j] - d_of(j)) * f;
      }
#pragma unroll
      for (int kk = 0; kk < WB / 16; ++kk)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          ap[kk][r] = wg::pack_bf16(x[8 * kk + 2 * r], x[8 * kk + 2 * r + 1]);
          as[kk][r] = wg::pack_bf16(y[8 * kk + 2 * r], y[8 * kk + 2 * r + 1]);
        }
    }

    // dK += dS^T Q and dV += P^T dO, or dQ += dS K: the streamed tile's
    // rows are the contraction, read MN-major; A from registers (one
    // group) or from the handed-over P and dS
    wg::fence();
#pragma unroll
    for (int kk = 0; kk < WB / 16; ++kk)
#pragma unroll
      for (int c = 0; c < KOWN; ++c) {  // KOWN >= VOWN
        // a chunk past DK repeats the last one into a slot that is never
        // stored: no branch around a wgmma (ptxas serializes every wgmma
        // of a kernel that has one, C7520)
        const int ck = owns(c) ? grp * KOWN + c : C::KC - 1;
        const uint64_t b0 = wg::desc(s0 + ck * (WB * 128) + kk * 2048,
                                     WB * 128, 1024);
        const uint64_t b1 = wg::desc(
            s1 + (grp * VOWN + c) * (WB * 128) + kk * 2048, WB * 128, 1024);
        if constexpr (C::NWG == 1) {
          wg::mma_rs<1>(ga[c], as[kk], b0, 1);
          if (KV && c < VOWN) wg::mma_rs<1>(gv[c], ap[kk], b1, 1);
        } else {
          wg::mma_ss<1>(ga[c], wg::desc(sDX + kk * 32, 16, 1024), b0, 1);
          if (KV && c < VOWN)
            wg::mma_ss<1>(gv[c], wg::desc(sPX + kk * 32, 16, 1024), b1, 1);
        }
      }
    wg::commit();
    wg::wait<0>();
#pragma unroll
    for (int c = 0; c < KOWN; ++c) {
      wg::reg_fence(ga[c]);
      if (KV && c < VOWN) wg::reg_fence(gv[c]);
    }
    if constexpr (C::NWG == 1)
#pragma unroll
      for (int kk = 0; kk < WB / 16; ++kk) {
        wg::reg_fence(ap[kk]);
        wg::reg_fence(as[kk]);
      }
  }
  wg::cp_async_wait<0>();  // no copy outlives the block

  if (KV && ws != nullptr) {  // one half of the tile's walk: merge
    constexpr int NA = (KOWN + VOWN) * 32;  // accumulators a thread holds
    static_assert(static_cast<long long>(NA) * NT == bw_half_floats(DK, DV),
                  "the workspace's half");
    float* mine = ws + static_cast<size_t>(2 * merge_id + part) * NA * NT;
    const float* other =
        ws + static_cast<size_t>(2 * merge_id + 1 - part) * NA * NT;
#pragma unroll
    for (int c = 0; c < KOWN; ++c)
#pragma unroll
      for (int j = 0; j < 32; ++j) mine[(c * 32 + j) * NT + tid] = ga[c][j];
#pragma unroll
    for (int c = 0; c < VOWN; ++c)
#pragma unroll
      for (int j = 0; j < 32; ++j)
        mine[((KOWN + c) * 32 + j) * NT + tid] = gv[c][j];
    __threadfence();
    __syncthreads();
    __shared__ int first;
    if (tid == 0) first = atomicAdd(cnt + merge_id, 1) == 0;
    __syncthreads();
    if (first) return;  // the other half stores the tile
    __threadfence();
#pragma unroll
    for (int c = 0; c < KOWN; ++c)
#pragma unroll
      for (int j = 0; j < 32; ++j)
        ga[c][j] += __ldcg(other + (c * 32 + j) * NT + tid);
#pragma unroll
    for (int c = 0; c < VOWN; ++c)
#pragma unroll
      for (int j = 0; j < 32; ++j)
        gv[c][j] += __ldcg(other + ((KOWN + c) * 32 + j) * NT + tid);
  }

  // every pinned row is written, also one whose tiles were all skipped
#pragma unroll
  for (int c = 0; c < KOWN; ++c)
#pragma unroll
    for (int j = 0; j < 32; ++j) ga[c][j] *= scale;
  bf16* out_a = KV ? dk : dq;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int x = row0 + r_lo + 8 * h;
    const bool ok = x < n_pin;
    const size_t ro = ok ? row_of(KV, x) : 0;
#pragma unroll
    for (int c = 0; c < KOWN; ++c)
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) {
        const size_t at =
            ro * DK + (grp * KOWN + c) * 64 + 8 * (4 * jj + lane % 4);
        const uint4 pa = wg::row8_bf16(ga[c], h, jj, lane);  // every lane
        if (ok && owns(c)) *reinterpret_cast<uint4*>(out_a + at) = pa;
      }
#pragma unroll
    for (int c = 0; c < VOWN && KV; ++c)
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) {
        const size_t at =
            ro * DV + (grp * VOWN + c) * 64 + 8 * (4 * jj + lane % 4);
        const uint4 pv = wg::row8_bf16(gv[c], h, jj, lane);  // every lane
        if (ok) *reinterpret_cast<uint4*>(dv + at) = pv;
      }
  }
}

template <int DK, int DV>
__global__ void __launch_bounds__(BwCfg<DK, DV>::NT, BwCfg<DK, DV>::MINB)
flash_bwd_wgmma(const bf16* __restrict__ q, const bf16* __restrict__ k,
                const bf16* __restrict__ v, const bf16* __restrict__ dout,
                const float* __restrict__ lse, const float* __restrict__ di,
                const int* __restrict__ q_pos, const int* __restrict__ kv_pos,
                bf16* __restrict__ dq, bf16* __restrict__ dk,
                bf16* __restrict__ dv, float* __restrict__ ws,
                int* __restrict__ cnt, int B, int Sq, int Skv, int Hq,
                int Hkv, float scale, float softcap, int causal, BwPlan plan) {
  extern __shared__ unsigned char smem_bw[];
  const int per = Hkv * B;  // blocks of one slot
  const int hk = static_cast<int>(blockIdx.x % per) % Hkv;
  const int b = static_cast<int>(blockIdx.x % per) / Hkv;
  bool kv;
  int tile;
  plan.slot(static_cast<int>(blockIdx.x / per), kv, tile);
  if (kv) {
    const int t = tile / plan.split, part = tile % plan.split;
    const int m = plan.split > 1 ? plan.mid(t) : plan.nq;
    bwd_walk<DK, DV, true>(q, k, v, dout, lse, di, q_pos, kv_pos, dq, dk, dv, Sq,
                       Skv, Hq, Hkv, scale, softcap, causal, t,
                       part ? m : 0, part ? plan.nq : m, hk, b,
                       plan.split > 1 ? ws : nullptr, cnt,
                       (b * Hkv + hk) * plan.nkv + t, part, smem_bw);
  } else {
    bwd_walk<DK, DV, false>(q, k, v, dout, lse, di, q_pos, kv_pos, dq, dk, dv, Sq,
                        Skv, Hq, Hkv, scale, softcap, causal, tile, 0,
                        plan.nkv, hk, b, nullptr, nullptr, 0, 0, smem_bw);
  }
}

// flash_bwd_wgmma's workspace in bytes: each split KV tile's two float32
// halves of dK and dV, then one int counter a KV tile.
long long wgmma_workspace(const BwPlan& plan, int B, int Hkv, int D, int Dv) {
  const long long tiles = static_cast<long long>(plan.nkv) * Hkv * B;
  return tiles * ((plan.split > 1 ? 2 * bw_half_floats(D, Dv) * 4 : 0) + 4);
}

template <int DK, int DV>
int run_wgmma(const bf16* q, const bf16* k, const bf16* v, const bf16* out,
              const bf16* dout, const float* lse, const float* dlse,
              const int* q_pos, const int* kv_pos, bf16* dq, bf16* dk,
              bf16* dv, float* di, float* ws, int B, int Sq, int Skv, int Hq,
              int Hkv, float scale, float softcap, int causal, int sms,
              cudaStream_t st) {
  using C = BwCfg<DK, DV>;
  const BwPlan plan =
      bw_plan(B, Sq, Skv, Hq, Hkv, DK, causal, dq != nullptr, sms);
  if (plan.nq > BW_MAXT || plan.nkv > BW_MAXT) return cudaErrorInvalidValue;
  const long long blocks = static_cast<long long>(plan.slots()) * Hkv * B;
  if (blocks > INT_MAX) return cudaErrorInvalidValue;
  const long long rows = static_cast<long long>(B) * Sq * Hq;
  const int ncnt = plan.nkv * Hkv * B;
  int* cnt = reinterpret_cast<int*>(
      reinterpret_cast<char*>(ws)
      + wgmma_workspace(plan, B, Hkv, DK, DV) - 4LL * ncnt);
  flash_bwd_dot<bf16><<<static_cast<unsigned>((rows + NT / 32 - 1) / (NT / 32)),
                        NT, 0, st>>>(out, dout, dlse, di, rows, DV, cnt, ncnt);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  static unsigned ready = 0;
  int dev;
  err = wgmma_sm90::with_smem(flash_bwd_wgmma<DK, DV>, C::SMEM, ready, &dev);
  if (err != cudaSuccess) return err;
  flash_bwd_wgmma<DK, DV><<<static_cast<unsigned>(blocks), C::NT, C::SMEM, st>>>(
      q, k, v, dout, lse, di, q_pos, kv_pos, dq, dk, dv, ws, cnt, B, Sq, Skv,
      Hq, Hkv, scale, softcap, causal, plan);
  return cudaGetLastError();
}

template <int NC>
int run(const float* q, const float* k, const float* v, const float* out,
        const float* dout, const float* lse, const float* dlse,
        const int* q_pos, const int* kv_pos, float* dq, float* dk, float* dv,
        float* di, int B, int Sq,
        int Skv, int Hq, int Hkv, int D, int Dv, float scale, float softcap,
        int causal, cudaStream_t st) {
  const long long rows = static_cast<long long>(B) * Sq * Hq;
  flash_bwd_dot<float><<<static_cast<unsigned>((rows + NT / 32 - 1)
                                                / (NT / 32)),
                         NT, 0, st>>>(out, dout, dlse, di, rows, Dv);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const size_t smem = smem_bytes(D);
  err = cudaFuncSetAttribute(flash_bwd_dkdv<NC>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const int G = Hq / Hkv;
  flash_bwd_dkdv<NC><<<dim3((Skv + BC - 1) / BC, Hkv, B), NT, smem, st>>>(
      q, k, v, dout, lse, di, q_pos, kv_pos, dk, dv, Sq, Skv, Hq, Hkv, D, Dv,
      scale, softcap, causal);
  err = cudaGetLastError();
  if (err != cudaSuccess || dq == nullptr) return err;
  err = cudaFuncSetAttribute(flash_bwd_dq<NC>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  flash_bwd_dq<NC><<<dim3((Sq * G + BR - 1) / BR, Hkv, B), NT, smem, st>>>(
      q, k, v, dout, lse, di, q_pos, kv_pos, dq, Sq, Skv, Hq, Hkv, D, Dv,
      scale, softcap, causal);
  return cudaGetLastError();
}

// The float32 kernels for a head dim D % 4 == 0 up to 256 (a value width
// Dv <= D): NC float4 groups of columns a thread.
int dispatch(const void* q, const void* k, const void* v, const void* out,
             const void* dout, const float* lse, const float* dlse,
             const int* q_pos, const int* kv_pos, void* dq, void* dk,
             void* dv, float* di, int B, int Sq, int Skv, int Hq, int Hkv,
             int D, int Dv, float scale, float softcap, int causal,
             cudaStream_t st) {
  const auto c = [](const void* p) { return static_cast<const float*>(p); };
  const auto m = [](void* p) { return static_cast<float*>(p); };
#define FLASH_BWD_RUN(NC)                                                   \
  return run<NC>(c(q), c(k), c(v), c(out), c(dout), lse, dlse, q_pos,       \
                 kv_pos, m(dq), m(dk), m(dv), di, B, Sq, Skv, Hq, Hkv, D,   \
                 Dv, scale, softcap, causal, st)
  if (D <= 32) FLASH_BWD_RUN(1);
  if (D <= 64) FLASH_BWD_RUN(2);
  if (D <= 128) FLASH_BWD_RUN(4);
  FLASH_BWD_RUN(8);
#undef FLASH_BWD_RUN
}

}  // namespace

// q/dq (B,Sq,Hq,D), out/dout (B,Sq,Hq,Dv), k/dk (B,Skv,Hkv,D), v/dv
// (B,Skv,Hkv,Dv) in one type (dtype 0 = float32, 1 = bfloat16),
// contiguous; lse (B,Sq,Hq) float32 from the forward; dlse the same shape
// or null; q_pos (B,Sq) / kv_pos (B,Skv) int32; di a (B,Sq,Hq) float32
// scratch.  dq null: dk and dv only.  D % 4 == 0 and D <= 256 with Dv == D
// or (D, Dv) = (192, 128) (float32), or D = Dv = 64, 128, 256 (bf16, the
// mma.sync kernels; 16-byte aligned q, k, v, dout), Hq % Hkv == 0.
// Returns a cudaError_t (0 = launched).
extern "C" int flash_attention_bwd(const void* q, const void* k, const void* v,
                                   const void* out, const void* dout,
                                   const float* lse, const float* dlse,
                                   const int* q_pos, const int* kv_pos,
                                   void* dq, void* dk, void* dv, float* di,
                                   int B, int Sq, int Skv, int Hq, int Hkv,
                                   int D, int Dv, float scale, float softcap,
                                   int causal, int dtype, void* stream) {
  if (B < 0 || Sq < 0 || Skv < 0 || Hkv <= 0 || Hq % Hkv || D <= 0 || D % 4
      || D > 256 || !(Dv == D || (dtype == 0 && D == 192 && Dv == 128)))
    return cudaErrorInvalidValue;
  if (B == 0 || Sq == 0 || Skv == 0) return cudaSuccess;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch(q, k, v, out, dout, lse, dlse, q_pos, kv_pos, dq, dk, dv,
                    di, B, Sq, Skv, Hq, Hkv, D, Dv, scale, softcap, causal, st);
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

// The bytes of the workspace flash_attention_bwd_wgmma takes for a call
// at head widths (D, Dv) (with_q: dq wanted) on a card of `sms` SMs.
extern "C" long long flash_attention_bwd_wgmma_workspace(
    int B, int Sq, int Skv, int Hq, int Hkv, int D, int Dv, int causal,
    int with_q, int sms) {
  if (B <= 0 || Sq <= 0 || Skv <= 0 || Hkv <= 0 || Hq % Hkv || sms <= 0)
    return 0;
  return wgmma_workspace(
      bw_plan(B, Sq, Skv, Hq, Hkv, D, causal, with_q, sms), B, Hkv, D, Dv);
}

// The wgmma variant (flash_bwd_wgmma): bfloat16 at (D, Dv) = (64, 64),
// (128, 128), (256, 256) or (192, 128), at most 1024 64-row tiles of
// folded query rows (Sq * Hq / Hkv) and of kv rows; arguments as
// flash_attention_bwd's, sms the card's SM count and ws a 16-byte aligned
// workspace of flash_attention_bwd_wgmma_workspace bytes.  dq null: the
// KV blocks alone.  Returns a cudaError_t (0 = launched).
extern "C" int flash_attention_bwd_wgmma(
    const void* q, const void* k, const void* v, const void* out,
    const void* dout, const float* lse, const float* dlse, const int* q_pos,
    const int* kv_pos, void* dq, void* dk, void* dv, float* di, void* ws,
    int B, int Sq, int Skv, int Hq, int Hkv, int D, int Dv, float scale,
    float softcap, int causal, int sms, void* stream) {
  if (B < 0 || Sq < 0 || Skv < 0 || Hkv <= 0 || Hq % Hkv || ws == nullptr
      || sms <= 0)
    return cudaErrorInvalidValue;
  if (B == 0 || Sq == 0 || Skv == 0) return cudaSuccess;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto c = [](const void* p) { return static_cast<const bf16*>(p); };
  const auto m = [](void* p) { return static_cast<bf16*>(p); };
#define FLASH_BWD_WG(DK, DV)                                                  \
  if (D == DK && Dv == DV)                                                    \
    return run_wgmma<DK, DV>(c(q), c(k), c(v), c(out), c(dout), lse, dlse,   \
                             q_pos, kv_pos, m(dq), m(dk), m(dv), di,         \
                             static_cast<float*>(ws), B, Sq, Skv, Hq, Hkv,   \
                             scale, softcap, causal, sms, st);
  FLASH_BWD_WG(64, 64)
  FLASH_BWD_WG(128, 128)
  FLASH_BWD_WG(256, 256)
  FLASH_BWD_WG(192, 128)
#undef FLASH_BWD_WG
  return cudaErrorInvalidValue;
}

// flash_bwd_wgmma's block order, from the host's copy of its plan for a
// call at head widths (D, Dv) on a card of `sms` SMs: for each slot (a block of either kind over
// every KV head and batch) in launch order, kind (1: KV, 0: query), tile
// and part (of a KV tile's walk; 0 for a query tile) into out[3 i],
// out[3 i + 1], out[3 i + 2] (out holds 3 (2 nkv + nq) ints).  Returns the
// slot count (0 for shapes the kernel does not take).
extern "C" int flash_bwd_wgmma_slots(int B, int Sq, int Skv, int Hq, int Hkv,
                                     int D, int Dv, int causal, int with_q,
                                     int sms, int* out) {
  if (B <= 0 || Sq <= 0 || Skv <= 0 || Hkv <= 0 || Hq % Hkv || sms <= 0)
    return 0;
  const BwPlan plan = bw_plan(B, Sq, Skv, Hq, Hkv, D, causal, with_q, sms);
  for (int i = 0; i < plan.slots(); ++i) {
    bool kv;
    int k;
    plan.slot(i, kv, k);
    out[3 * i] = kv ? 1 : 0;
    out[3 * i + 1] = kv ? k / plan.split : k;
    out[3 * i + 2] = kv ? k % plan.split : 0;
  }
  return plan.slots();
}
