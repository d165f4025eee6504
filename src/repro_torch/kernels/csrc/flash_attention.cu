// Position-masked GQA flash attention for Hopper (sm_90a), CUDA C++.
//
// Replaces: src/repro/kernels/flash_attention.py::flash_attention (the Pallas
// TPU kernel).  Contract: src/repro/kernels/ref.py::attention_ref, including
// fully-masked query rows, which get output 0 and lse -1e30 (the `p = where(
// valid, p, 0)` guard that the Pallas kernel lacks).
//
//   q (B,Sq,Hq,D), k (B,Skv,Hkv,D), v (B,Skv,Hkv,D), q_pos (B,Sq), kv_pos
//   (B,Skv) int32  ->  out (B,Sq,Hq,D) in q's type, lse (B,Sq,Hq) float32.
//   A key is visible when kv_pos >= 0 and, under `causal`, kv_pos <= q_pos.
//   Softcap is applied to the scaled logits before the mask.
//
// What bounds it on an H100: at prefill shapes (Sq = Skv = 3072, D = 256)
// the two products do ~4*Sq*Skv/2*D*Hq flops against a few tens of MB, so
// it is bound by operations (the tensor cores); at decode (Sq = 1) it
// streams the KV cache once and is bound by bytes.  Two kernels share the
// tiling below: bf16 runs the products on the tensor cores (flash_fwd_tc,
// mma.sync, f32 accumulate) at head_dim 64/128/256, the widths of the
// ported configs (other bf16 widths are refused); float32 runs them on the
// CUDA cores (flash_fwd), whose ceiling is the 67 TFLOP/s f32 rate but
// which matches the float32 reference to 1e-4.  wgmma/TMA and load
// pipelining come later.
//
// Design:
// * The TPU grid walks KV blocks sequentially per (head, q-block).  Here
//   blocks run in parallel, so one thread block owns a tile of BQ query rows
//   of one KV head and loops over all KV tiles itself, carrying the online
//   softmax state (running max, sum, f32 accumulator) in registers.
// * GQA fold: the tile's rows are (s, g) pairs of the G = Hq/Hkv query heads
//   that share KV head hk (q head h = hk*G + g, i.e. hk = h // G), so each
//   K/V tile is loaded once for all G heads.
// * flash_fwd (float32): four threads own one query row: each holds 64 of
//   the row's <= 256 accumulator columns (16 float4 in registers, no spill
//   at D = 256, checked with -Xptxas -v) and 8 of the tile's 32 scores; row
//   max/sum reduce with two warp shuffles.  D = 256 needs ~142 KB of shared memory
//   for the Q, K, V and P tiles in f32 (above the 48 KB static limit), so
//   it is dynamic shared memory with cudaFuncSetAttribute.  Rows are padded
//   by 4 floats so the float4 reads of K and Q rows land in distinct banks.
// * flash_fwd_tc (bf16): four warps own 16 rows each (see its own note).
// * A KV tile whose smallest valid kv_pos exceeds the tile's largest q_pos
//   (causal), or that holds no valid key at all, is skipped whole: the
//   causal half of prefill and the unwritten tail of a decode cache cost
//   no arithmetic.
// * Split KV (flash-decoding): when the (q-tile, kv-head, batch) blocks
//   cannot fill the card (decode: B*Hkv = 16 blocks on 132 SMs), the KV
//   axis is cut into `nsplit` chunks, one block each; every block writes
//   its normalised partial output and lse to a float32 workspace and a
//   second kernel (split_kv.cuh) merges the partials exactly through
//   their lse.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <climits>
#include <cstdint>

#include "mma_sm80.cuh"
#include "split_kv.cuh"

namespace {

constexpr int BQ = 64;    // query rows per block
constexpr int BK = 32;    // kv rows per tile
constexpr int TPR = 4;    // threads per query row
constexpr int DMAX = 256;
constexpr int NJ = DMAX / (4 * TPR);  // float4 accumulator groups per thread
constexpr int PS = BK + 4;            // padded row stride of the P tile
using split_kv::NEG;
constexpr unsigned FULL = 0xffffffffu;

using split_kv::combine_splits;
using split_kv::load4;
using split_kv::store4;

// With nsplit > 1, block z = b * nsplit + split covers kv rows
// [split * kv_chunk, (split + 1) * kv_chunk) and writes its partial to
// o_part (nsplit, B*Sq*Hq, D) and lse_part (nsplit, B*Sq*Hq) instead of
// out / lse.
__global__ void __launch_bounds__(BQ * TPR)
flash_fwd(const float* __restrict__ q, const float* __restrict__ k,
          const float* __restrict__ v, const int* __restrict__ q_pos,
          const int* __restrict__ kv_pos, float* __restrict__ out,
          float* __restrict__ lse, float* __restrict__ o_part,
          float* __restrict__ lse_part, int B, int Sq, int Skv, int Hq,
          int Hkv, int D, float scale, float softcap, int causal, int nsplit,
          int kv_chunk) {
  constexpr int NT = BQ * TPR;
  const int G = Hq / Hkv;
  const int rows = Sq * G;
  const int row0 = blockIdx.x * BQ;
  const int hk = blockIdx.y;
  const int b = blockIdx.z / nsplit;
  const int split = blockIdx.z % nsplit;
  const int kv_begin = split * kv_chunk;
  const int kv_end = min(Skv, kv_begin + kv_chunk);
  const int tid = threadIdx.x;
  const int r = tid / TPR;
  const int sub = tid % TPR;
  const int DP = D + 4;
  const int D4 = D / 4;

  extern __shared__ float smem[];
  float* Qs = smem;               // BQ x DP
  float* Ks = Qs + BQ * DP;       // BK x DP
  float* Vs = Ks + BK * DP;       // BK x DP
  float* Ps = Vs + BK * DP;       // BQ x PS
  int* kvp = reinterpret_cast<int*>(Ps + BQ * PS);  // BK
  int* qps = kvp + BK;                              // BQ

#pragma unroll 1  // staging loops stay rolled: unrolled, they spill
  for (int e = tid; e < BQ * D4; e += NT) {
    const int rr = e / D4, d = (e % D4) * 4;
    const int rho = row0 + rr;
    float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
    if (rho < rows) {
      const int s = rho / G, g = rho % G;
      val = load4(q + ((static_cast<size_t>(b) * Sq + s) * Hq + hk * G + g) * D + d);
    }
    store4(&Qs[rr * DP + d], val);
  }
  if (tid < BQ) {
    const int rho = row0 + tid;
    // rows past the end sit below every key: all masked under causal
    qps[tid] = rho < rows ? q_pos[static_cast<size_t>(b) * Sq + rho / G] : INT_MIN;
  }
  __syncthreads();
  int q_hi = INT_MIN;
  for (int i = 0; i < BQ; ++i) q_hi = max(q_hi, qps[i]);
  const int my_qpos = qps[r];

  float m_run = NEG, l_run = 0.f;
  float4 acc[NJ];
#pragma unroll
  for (int j = 0; j < NJ; ++j) acc[j] = make_float4(0.f, 0.f, 0.f, 0.f);

  for (int kv0 = kv_begin; kv0 < kv_end; kv0 += BK) {
    __syncthreads();  // the previous tile's K/V/P/kvp reads are done
    if (tid < BK) {
      const int j = kv0 + tid;
      kvp[tid] = j < kv_end ? kv_pos[static_cast<size_t>(b) * Skv + j] : -1;
    }
    __syncthreads();
    int kv_lo = INT_MAX;
    for (int c = 0; c < BK; ++c) {
      const int p = kvp[c];
      if (p >= 0 && p < kv_lo) kv_lo = p;
    }
    // uniform across the block: nothing in this tile is visible to any row
    if (kv_lo == INT_MAX || (causal && kv_lo > q_hi)) continue;

#pragma unroll 1
    for (int e = tid; e < BK * D4; e += NT) {
      const int c = e / D4, d = (e % D4) * 4;
      const int j = kv0 + c;
      float4 kk = make_float4(0.f, 0.f, 0.f, 0.f), vv = kk;
      if (j < kv_end) {
        const size_t off = ((static_cast<size_t>(b) * Skv + j) * Hkv + hk) * D + d;
        kk = load4(k + off);
        vv = load4(v + off);
      }
      store4(&Ks[c * DP + d], kk);
      store4(&Vs[c * DP + d], vv);
    }
    __syncthreads();

    // scores for columns c = sub + 4*i of row r
    float sc[BK / TPR];
#pragma unroll
    for (int i = 0; i < BK / TPR; ++i) sc[i] = 0.f;
#pragma unroll 2  // deeper unrolling spills
    for (int d = 0; d < D; d += 4) {
      const float4 qv = load4(&Qs[r * DP + d]);
#pragma unroll
      for (int i = 0; i < BK / TPR; ++i) {
        const float4 kv4 = load4(&Ks[(sub + TPR * i) * DP + d]);
        sc[i] += qv.x * kv4.x + qv.y * kv4.y + qv.z * kv4.z + qv.w * kv4.w;
      }
    }
    float mt = NEG;
    bool ok[BK / TPR];
#pragma unroll
    for (int i = 0; i < BK / TPR; ++i) {
      const int p = kvp[sub + TPR * i];
      float x = sc[i] * scale;
      if (softcap != 0.f) x = softcap * tanhf(x / softcap);
      ok[i] = p >= 0 && (!causal || p <= my_qpos);
      sc[i] = ok[i] ? x : NEG;
      mt = fmaxf(mt, sc[i]);
    }
    mt = fmaxf(mt, __shfl_xor_sync(FULL, mt, 1));
    mt = fmaxf(mt, __shfl_xor_sync(FULL, mt, 2));
    const float m_new = fmaxf(m_run, mt);
    const float corr = expf(m_run - m_new);
    float psum = 0.f;
#pragma unroll
    for (int i = 0; i < BK / TPR; ++i) {
      const float p = ok[i] ? expf(sc[i] - m_new) : 0.f;
      psum += p;
      Ps[r * PS + sub + TPR * i] = p;
    }
    psum += __shfl_xor_sync(FULL, psum, 1);
    psum += __shfl_xor_sync(FULL, psum, 2);
    l_run = l_run * corr + psum;
    m_run = m_new;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      acc[j].x *= corr; acc[j].y *= corr; acc[j].z *= corr; acc[j].w *= corr;
    }
    __syncwarp();  // the row's P entries come from the same four lanes

    for (int c = 0; c < BK; ++c) {
      const float p = Ps[r * PS + c];
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int d = (sub + TPR * j) * 4;
        if (d < D) {
          const float4 vv = load4(&Vs[c * DP + d]);
          acc[j].x += p * vv.x; acc[j].y += p * vv.y;
          acc[j].z += p * vv.z; acc[j].w += p * vv.w;
        }
      }
    }
  }

  const int rho = row0 + r;
  if (rho < rows) {
    const int s = rho / G, h = hk * G + rho % G;
    const size_t row = (static_cast<size_t>(b) * Sq + s) * Hq + h;
    const size_t prow = static_cast<size_t>(split) * B * Sq * Hq + row;
    const bool any = l_run > 0.f;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int d = (sub + TPR * j) * 4;
      if (d < D) {
        float4 o = make_float4(0.f, 0.f, 0.f, 0.f);
        if (any) o = make_float4(acc[j].x / l_run, acc[j].y / l_run,
                                 acc[j].z / l_run, acc[j].w / l_run);
        if (nsplit == 1) store4(out + row * D + d, o);
        else store4(o_part + prow * D + d, o);
      }
    }
    if (sub == 0) {
      const float l = any ? m_run + logf(l_run) : NEG;
      if (nsplit == 1) lse[row] = l;
      else lse_part[prow] = l;
    }
  }
}

int kv_chunk_for(int Skv, int nsplit) {
  const int tiles = (Skv + BK - 1) / BK;
  return (tiles + nsplit - 1) / nsplit * BK;
}

// Fill about two waves of blocks: split the KV axis while the unsplit grid
// has fewer than 2 * sms blocks, keeping at least one KV tile per split.
int splits_for(int B, int Sq, int Skv, int Hq, int Hkv, int sms) {
  const int rows = Sq * (Hq / Hkv);
  const long long blocks =
      static_cast<long long>((rows + BQ - 1) / BQ) * Hkv * B;
  const int tiles = (Skv + BK - 1) / BK;
  if (blocks >= 2LL * sms || tiles <= 1) return 1;
  const int want = static_cast<int>((2LL * sms + blocks - 1) / blocks);
  const int n = want < tiles ? want : tiles;
  const int chunk = (tiles + n - 1) / n;
  return (tiles + chunk - 1) / chunk;
}


// ---- bfloat16 on the tensor cores ---------------------------------------
//
// The same contract and tiling as flash_fwd (64 rows x one KV head per
// block, 32-row KV tiles, split KV), for bf16 and head_dim HD in {64, 128,
// 256}: four warps own 16 rows each; S = Q K^T and O += P V run as bf16
// mma.sync m16n8k16 with f32 accumulators, Q/K/V staged in shared memory
// with rows padded by 16 bytes (ldmatrix conflict-free), the online
// softmax kept on the S accumulators, and P handed to the second product
// in registers as bf16.  At HD = 256 a thread holds 128 f32 of O.
template <int HD>
__global__ void __launch_bounds__(128)
flash_fwd_tc(const __nv_bfloat16* __restrict__ q,
             const __nv_bfloat16* __restrict__ k,
             const __nv_bfloat16* __restrict__ v,
             const int* __restrict__ q_pos, const int* __restrict__ kv_pos,
             __nv_bfloat16* __restrict__ out, float* __restrict__ lse,
             float* __restrict__ o_part, float* __restrict__ lse_part, int B,
             int Sq, int Skv, int Hq, int Hkv, float scale, float softcap,
             int causal, int nsplit, int kv_chunk) {
  using mma_sm80::bf16;
  constexpr int SP = HD + 8;   // padded shared row, bf16 elements
  constexpr int V8 = HD / 8;   // 16-byte vectors per row
  constexpr int NO = HD / 8;   // n8 tiles of a row of O
  extern __shared__ __align__(16) unsigned char smem_tc[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_tc);  // BQ x SP
  bf16* Ks = Qs + BQ * SP;                       // BK x SP
  bf16* Vs = Ks + BK * SP;                       // BK x SP
  int* kvp = reinterpret_cast<int*>(Vs + BK * SP);  // BK
  int* qps = kvp + BK;                              // BQ

  const int G = Hq / Hkv;
  const int rows = Sq * G;
  const int row0 = blockIdx.x * BQ;
  const int hk = blockIdx.y;
  const int b = blockIdx.z / nsplit;
  const int split = blockIdx.z % nsplit;
  const int kv_begin = split * kv_chunk;
  const int kv_end = min(Skv, kv_begin + kv_chunk);
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const uint4 zero = make_uint4(0, 0, 0, 0);

  for (int e = tid; e < BQ * V8; e += 128) {
    const int rr = e / V8, d = (e % V8) * 8;
    const int rho = row0 + rr;
    uint4 val = zero;
    if (rho < rows) {
      const int s = rho / G, g = rho % G;
      val = *reinterpret_cast<const uint4*>(
          q + ((static_cast<size_t>(b) * Sq + s) * Hq + hk * G + g) * HD + d);
    }
    *reinterpret_cast<uint4*>(Qs + rr * SP + d) = val;
  }
  if (tid < BQ) {
    const int rho = row0 + tid;
    qps[tid] = rho < rows ? q_pos[static_cast<size_t>(b) * Sq + rho / G] : INT_MIN;
  }
  __syncthreads();
  int q_hi = INT_MIN;
  for (int i = 0; i < BQ; ++i) q_hi = max(q_hi, qps[i]);
  const int r_lo = warp * 16 + lane / 4;  // this lane's rows: r_lo, r_lo + 8
  const int qp[2] = {qps[r_lo], qps[r_lo + 8]};

  float m_run[2] = {NEG, NEG}, l_run[2] = {0.f, 0.f};
  float acc[NO][4];
#pragma unroll
  for (int j = 0; j < NO; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

  for (int kv0 = kv_begin; kv0 < kv_end; kv0 += BK) {
    __syncthreads();  // the previous tile's K/V/kvp reads are done
    if (tid < BK) {
      const int j = kv0 + tid;
      kvp[tid] = j < kv_end ? kv_pos[static_cast<size_t>(b) * Skv + j] : -1;
    }
    __syncthreads();
    int kv_lo = INT_MAX;
    for (int c = 0; c < BK; ++c) {
      const int p = kvp[c];
      if (p >= 0 && p < kv_lo) kv_lo = p;
    }
    if (kv_lo == INT_MAX || (causal && kv_lo > q_hi)) continue;

    for (int e = tid; e < BK * V8; e += 128) {
      const int c = e / V8, d = (e % V8) * 8;
      const int j = kv0 + c;
      uint4 kk = zero, vv = zero;
      if (j < kv_end) {
        const size_t off = ((static_cast<size_t>(b) * Skv + j) * Hkv + hk) * HD + d;
        kk = *reinterpret_cast<const uint4*>(k + off);
        vv = *reinterpret_cast<const uint4*>(v + off);
      }
      *reinterpret_cast<uint4*>(Ks + c * SP + d) = kk;
      *reinterpret_cast<uint4*>(Vs + c * SP + d) = vv;
    }
    __syncthreads();

    // S (16 x 32 per warp) = Q K^T, four n8 tiles of kv columns
    float sc[4][4];
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[n][e] = 0.f;
#pragma unroll
    for (int ks = 0; ks < HD / 16; ++ks) {
      uint32_t a[4];
      mma_sm80::ldsm_x4(a, Qs + (warp * 16 + lane % 16) * SP + ks * 16
                               + (lane / 16) * 8);
#pragma unroll
      for (int np = 0; np < 2; ++np) {
        uint32_t bb[4];
        mma_sm80::ldsm_x4(bb, Ks + (np * 16 + lane % 8 + (lane / 16) * 8) * SP
                                  + ks * 16 + ((lane / 8) % 2) * 8);
        mma_sm80::mma16816(sc[2 * np], a, bb[0], bb[1]);
        mma_sm80::mma16816(sc[2 * np + 1], a, bb[2], bb[3]);
      }
    }

    // scale, cap, mask; online softmax on the accumulators (a row's four
    // lanes are lane^1, lane^2 of each other)
    bool ok[4][4];
    float mt[2] = {NEG, NEG};
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int p = kvp[n * 8 + (lane % 4) * 2 + (e & 1)];
        float x = sc[n][e] * scale;
        if (softcap != 0.f) x = softcap * tanhf(x / softcap);
        ok[n][e] = p >= 0 && (!causal || p <= qp[e / 2]);
        sc[n][e] = x;
        if (ok[n][e]) mt[e / 2] = fmaxf(mt[e / 2], x);
      }
    float corr[2], psum[2] = {0.f, 0.f};
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mt[h] = fmaxf(mt[h], __shfl_xor_sync(FULL, mt[h], 1));
      mt[h] = fmaxf(mt[h], __shfl_xor_sync(FULL, mt[h], 2));
      const float m_new = fmaxf(m_run[h], mt[h]);
      corr[h] = expf(m_run[h] - m_new);
      m_run[h] = m_new;
    }
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = ok[n][e] ? expf(sc[n][e] - m_run[e / 2]) : 0.f;
        sc[n][e] = p;
        psum[e / 2] += p;
      }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      psum[h] += __shfl_xor_sync(FULL, psum[h], 1);
      psum[h] += __shfl_xor_sync(FULL, psum[h], 2);
      l_run[h] = l_run[h] * corr[h] + psum[h];
    }
#pragma unroll
    for (int j = 0; j < NO; ++j) {
      acc[j][0] *= corr[0]; acc[j][1] *= corr[0];
      acc[j][2] *= corr[1]; acc[j][3] *= corr[1];
    }

    // O += P V: P (16 x 32) from the accumulators, two k16 steps
#pragma unroll
    for (int kk = 0; kk < 2; ++kk) {
      uint32_t a[4];
      a[0] = mma_sm80::pack_bf16(sc[2 * kk][0], sc[2 * kk][1]);
      a[1] = mma_sm80::pack_bf16(sc[2 * kk][2], sc[2 * kk][3]);
      a[2] = mma_sm80::pack_bf16(sc[2 * kk + 1][0], sc[2 * kk + 1][1]);
      a[3] = mma_sm80::pack_bf16(sc[2 * kk + 1][2], sc[2 * kk + 1][3]);
#pragma unroll
      for (int dp = 0; dp < HD / 16; ++dp) {
        uint32_t bb[4];
        mma_sm80::ldsm_x4_t(bb, Vs + (kk * 16 + lane % 8 + ((lane / 8) % 2) * 8) * SP
                                    + dp * 16 + (lane / 16) * 8);
        mma_sm80::mma16816(acc[2 * dp], a, bb[0], bb[1]);
        mma_sm80::mma16816(acc[2 * dp + 1], a, bb[2], bb[3]);
      }
    }
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int rho = row0 + r_lo + 8 * h;
    if (rho >= rows) continue;
    const int s = rho / G, hq = hk * G + rho % G;
    const size_t row = (static_cast<size_t>(b) * Sq + s) * Hq + hq;
    const size_t prow = static_cast<size_t>(split) * B * Sq * Hq + row;
    const bool any = l_run[h] > 0.f;
    const float inv = any ? 1.f / l_run[h] : 0.f;
#pragma unroll
    for (int j = 0; j < NO; ++j) {
      const int d = j * 8 + (lane % 4) * 2;
      const float x = acc[j][2 * h] * inv, y = acc[j][2 * h + 1] * inv;
      if (nsplit == 1)
        *reinterpret_cast<uint32_t*>(out + row * HD + d) = mma_sm80::pack_bf16(x, y);
      else
        *reinterpret_cast<float2*>(o_part + prow * HD + d) = make_float2(x, y);
    }
    if (lane % 4 == 0) {
      const float l = any ? m_run[h] + logf(l_run[h]) : NEG;
      if (nsplit == 1) lse[row] = l;
      else lse_part[prow] = l;
    }
  }
}

size_t smem_bytes_tc(int HD) {
  return sizeof(__nv_bfloat16) * static_cast<size_t>(BQ + 2 * BK) * (HD + 8)
       + sizeof(int) * (BK + BQ);
}

template <int HD>
int launch_tc(const void* q, const void* k, const void* v, const int* q_pos,
              const int* kv_pos, void* out, float* lse, float* ws, int B,
              int Sq, int Skv, int Hq, int Hkv, float scale, float softcap,
              int causal, int nsplit, cudaStream_t stream) {
  const size_t smem = smem_bytes_tc(HD);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_tc<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const int rows = Sq * (Hq / Hkv);
  const int out_rows = B * Sq * Hq;
  float* o_part = ws;
  float* lse_part = ws + static_cast<size_t>(nsplit) * out_rows * HD;
  dim3 grid((rows + BQ - 1) / BQ, Hkv, B * nsplit);
  flash_fwd_tc<HD><<<grid, 128, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), q_pos, kv_pos,
      static_cast<__nv_bfloat16*>(out), lse, o_part, lse_part, B, Sq, Skv, Hq,
      Hkv, scale, softcap, causal, nsplit,
      nsplit == 1 ? Skv : kv_chunk_for(Skv, nsplit));
  err = cudaGetLastError();
  if (err != cudaSuccess || nsplit == 1) return err;
  combine_splits<__nv_bfloat16><<<out_rows, DMAX / 4, 0, stream>>>(
      o_part, lse_part, static_cast<__nv_bfloat16*>(out), lse, out_rows, HD,
      nsplit);
  return cudaGetLastError();
}

size_t smem_bytes(int D) {
  return sizeof(float) * (static_cast<size_t>(BQ + 2 * BK) * (D + 4) + BQ * PS)
       + sizeof(int) * (BK + BQ);
}

int launch(const void* q, const void* k, const void* v, const int* q_pos,
           const int* kv_pos, void* out, float* lse, float* ws, int B, int Sq,
           int Skv, int Hq, int Hkv, int D, float scale, float softcap,
           int causal, int nsplit, cudaStream_t stream) {
  const size_t smem = smem_bytes(D);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const int rows = Sq * (Hq / Hkv);
  const int out_rows = B * Sq * Hq;
  float* o_part = ws;
  float* lse_part = ws + static_cast<size_t>(nsplit) * out_rows * D;
  dim3 grid((rows + BQ - 1) / BQ, Hkv, B * nsplit);
  flash_fwd<<<grid, BQ * TPR, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), q_pos, kv_pos, static_cast<float*>(out),
      lse, o_part, lse_part, B, Sq, Skv, Hq, Hkv, D, scale, softcap, causal,
      nsplit, nsplit == 1 ? Skv : kv_chunk_for(Skv, nsplit));
  err = cudaGetLastError();
  if (err != cudaSuccess || nsplit == 1) return err;
  combine_splits<float><<<out_rows, DMAX / 4, 0, stream>>>(
      o_part, lse_part, static_cast<float*>(out), lse, out_rows, D, nsplit);
  return cudaGetLastError();
}

}  // namespace

// How many KV splits flash_attention_fwd takes for this problem on a card
// with `sms` multiprocessors; with n > 1 the caller passes a float32
// workspace of n * B * Sq * Hq * (D + 1) elements.
extern "C" int flash_attention_splits(int B, int Sq, int Skv, int Hq, int Hkv,
                                      int sms) {
  if (B <= 0 || Sq <= 0 || Skv <= 0 || Hkv <= 0 || Hq % Hkv != 0) return 1;
  return splits_for(B, Sq, Skv, Hq, Hkv, sms);
}

// dtype: 0 = float32 (D % 4 == 0, D <= 256), 1 = bfloat16 (D = 64, 128 or
// 256).  Returns a cudaError_t (0 = launched).
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v,
                                   const int* q_pos, const int* kv_pos,
                                   void* out, float* lse, float* ws, int B,
                                   int Sq, int Skv, int Hq, int Hkv, int D,
                                   float scale, float softcap, int causal,
                                   int nsplit, int dtype, void* stream) {
  if (D <= 0 || D > DMAX || D % 4 != 0 || Hkv <= 0 || Hq % Hkv != 0 ||
      nsplit < 1 || (nsplit > 1 && ws == nullptr))
    return cudaErrorInvalidValue;
  if (B == 0 || Sq == 0) return cudaSuccess;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch(q, k, v, q_pos, kv_pos, out, lse, ws, B, Sq, Skv, Hq,
                         Hkv, D, scale, softcap, causal, nsplit, st);
  if (dtype == 1 && D == 64)
    return launch_tc<64>(q, k, v, q_pos, kv_pos, out, lse, ws, B, Sq, Skv, Hq,
                         Hkv, scale, softcap, causal, nsplit, st);
  if (dtype == 1 && D == 128)
    return launch_tc<128>(q, k, v, q_pos, kv_pos, out, lse, ws, B, Sq, Skv,
                          Hq, Hkv, scale, softcap, causal, nsplit, st);
  if (dtype == 1 && D == 256)
    return launch_tc<256>(q, k, v, q_pos, kv_pos, out, lse, ws, B, Sq, Skv,
                          Hq, Hkv, scale, softcap, causal, nsplit, st);
  return cudaErrorInvalidValue;
}
