// Position-masked GQA flash attention for Hopper (sm_90a), CUDA C++.
//
// Replaces: src/repro/kernels/flash_attention.py::flash_attention (the Pallas
// TPU kernel).  Contract: src/repro/kernels/ref.py::attention_ref, including
// fully-masked query rows, which get output 0 and lse -1e30 (the `p = where(
// valid, p, 0)` guard that the Pallas kernel lacks).
//
//   q (B,Sq,Hq,D), k (B,Skv,Hkv,D), v (B,Skv,Hkv,Dv), q_pos (B,Sq), kv_pos
//   (B,Skv) int32  ->  out (B,Sq,Hq,Dv) in q's type, lse (B,Sq,Hq) float32.
//   (D, Dv): (64,64), (128,128), (256,256); MLA's (192,128) (its prefill,
//   per-head keys of nope + rope against values of v_head_dim) and
//   (576,512) (its absorbed decode, one latent head).
//   A key is visible when kv_pos >= 0 and, under `causal`, kv_pos <= q_pos.
//   Softcap is applied to the scaled logits before the mask.
//
// What bounds it on an H100: at prefill shapes (Sq = Skv = 3072, D = 256)
// the two products do ~4*Sq*Skv/2*D*Hq flops against a few tens of MB, so
// it is bound by operations (the tensor cores): 0.0391 ms at gemma2-2b's
// source prefill, 0.0293 ms at granite's, 0.313 ms at mistral-7b's
// 6144-token prompt; at decode (Sq = 1) it streams the KV cache once and
// is bound by bytes.  Three kernels:
// * flash_fwd_wgmma (bf16, (D, Dv) = (64, 64), (128, 128), (256, 256),
//   (192, 128), unsplit): wgmma on both
//   products, K/V through a cp.async ring of 64-row tiles, tiles classified
//   once (skipped / mask-free / masked), softmax in base 2 with
//   tanh.approx under a cap, heaviest causal blocks first (its own note
//   below).  The wrapper (kernels/flash_attention.py::variant_for) sends
//   it every bf16 call that flash_fwd_tc would split at most 4 ways:
//   prefills, the Memory-LLM, prompts, decode over many slots.
// * flash_fwd_tc (bf16 calls split more ways: decode over few slots, a
//   short prompt against a long prefix; and every call at (576, 512)):
//   mma.sync m16n8k16 with f32 accumulate over 32-row tiles, synchronous
//   loads, split KV.
// * flash_fwd (float32, D and Dv <= 256): the CUDA cores, whose ceiling is
//   the 67 TFLOP/s f32 rate but which matches the float32 reference to
//   1e-4 (full tanhf and expf).
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
#include <cmath>
#include <cstdint>

#include "mma_sm80.cuh"
#include "split_kv.cuh"
#include "tile_class.cuh"
#include "wgmma_sm90.cuh"

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
// o_part (nsplit, B*Sq*Hq, Dv) and lse_part (nsplit, B*Sq*Hq) instead of
// out / lse.
__global__ void __launch_bounds__(BQ * TPR)
flash_fwd(const float* __restrict__ q, const float* __restrict__ k,
          const float* __restrict__ v, const int* __restrict__ q_pos,
          const int* __restrict__ kv_pos, float* __restrict__ out,
          float* __restrict__ lse, float* __restrict__ o_part,
          float* __restrict__ lse_part, int B, int Sq, int Skv, int Hq,
          int Hkv, int D, int Dv, float scale, float softcap, int causal,
          int nsplit, int kv_chunk) {
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
  const int DP = D + 4, DPV = Dv + 4;
  const int D4 = D / 4, DV4 = Dv / 4;

  extern __shared__ float smem[];
  float* Qs = smem;               // BQ x DP
  float* Ks = Qs + BQ * DP;       // BK x DP
  float* Vs = Ks + BK * DP;       // BK x DPV
  float* Ps = Vs + BK * DPV;      // BQ x PS
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
      float4 kk = make_float4(0.f, 0.f, 0.f, 0.f);
      if (j < kv_end)
        kk = load4(k + ((static_cast<size_t>(b) * Skv + j) * Hkv + hk) * D + d);
      store4(&Ks[c * DP + d], kk);
    }
#pragma unroll 1
    for (int e = tid; e < BK * DV4; e += NT) {
      const int c = e / DV4, d = (e % DV4) * 4;
      const int j = kv0 + c;
      float4 vv = make_float4(0.f, 0.f, 0.f, 0.f);
      if (j < kv_end)
        vv = load4(v + ((static_cast<size_t>(b) * Skv + j) * Hkv + hk) * Dv + d);
      store4(&Vs[c * DPV + d], vv);
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
        if (d < Dv) {
          const float4 vv = load4(&Vs[c * DPV + d]);
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
      if (d < Dv) {
        float4 o = make_float4(0.f, 0.f, 0.f, 0.f);
        if (any) o = make_float4(acc[j].x / l_run, acc[j].y / l_run,
                                 acc[j].z / l_run, acc[j].w / l_run);
        if (nsplit == 1) store4(out + row * Dv + d, o);
        else store4(o_part + prow * Dv + d, o);
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


// ---- tile classification (tile_class.cuh), shared by flash_fwd_tc and
// flash_fwd_wgmma ----------------------------------------------------------
using flash_tiles::kFree;
using flash_tiles::kMasked;
using flash_tiles::kSkip;
using flash_tiles::merge;
using flash_tiles::QRange;
using flash_tiles::qrange_of;
using flash_tiles::Span;
using flash_tiles::span_of;
using flash_tiles::tile_class;
using flash_tiles::warp_qrange;
using flash_tiles::warp_span;


// ---- bfloat16 on the tensor cores ---------------------------------------
//
// The same contract and tiling as flash_fwd (64 rows x one KV head per
// block, 32-row KV tiles, split KV), for bf16 at the (DK, DV) pairs above:
// four warps own 16 rows each; S = Q K^T and O += P V run as bf16
// mma.sync m16n8k16 with f32 accumulators, Q/K/V staged in shared memory
// with rows padded by 16 bytes (ldmatrix conflict-free at every pair's
// widths), the online softmax kept on the S accumulators, and P handed to
// the second product in registers as bf16.  A thread holds DV / 2 f32 of
// O, 128 at DV = 256.  At DV = 512 (MLA's absorbed decode) that would be
// 256, past the register file: there NCG = 2 warps share each 16-row
// group, each computes the group's S (the 576-wide products twice; a
// decode step is bound by bytes) and keeps 256 of the 512 columns of O,
// so a block runs 8 warps.  Shared memory at (576, 512): Q 74.8 KB, K
// 37.4 KB, V 33.3 KB a block.
template <int DK, int DV>
struct TcCfg {
  static constexpr int NCG = DV > 256 ? 2 : 1;  // warps sharing a row group
  static constexpr int NT = 128 * NCG;
  static constexpr int SPK = DK + 8;   // padded shared rows, bf16 elements
  static constexpr int SPV = DV + 8;
  static constexpr int DVW = DV / NCG; // columns of O a warp keeps
  static constexpr int NO = DVW / 8;   // its n8 tiles
  static_assert(DK % 16 == 0 && DVW % 16 == 0, "k16 / n16 tiling");
};

template <int DK, int DV>
__global__ void __launch_bounds__(TcCfg<DK, DV>::NT)
flash_fwd_tc(const __nv_bfloat16* __restrict__ q,
             const __nv_bfloat16* __restrict__ k,
             const __nv_bfloat16* __restrict__ v,
             const int* __restrict__ q_pos, const int* __restrict__ kv_pos,
             __nv_bfloat16* __restrict__ out, float* __restrict__ lse,
             float* __restrict__ o_part, float* __restrict__ lse_part, int B,
             int Sq, int Skv, int Hq, int Hkv, float scale, float softcap,
             int causal, int nsplit, int kv_chunk) {
  using mma_sm80::bf16;
  using C = TcCfg<DK, DV>;
  static_assert(BK == 32, "the tile verdict reads one kv position a lane");
  constexpr int SPK = C::SPK, SPV = C::SPV, NT = C::NT, NO = C::NO;
  constexpr int K8 = DK / 8, V8 = DV / 8;  // 16-byte vectors per row
  extern __shared__ __align__(16) unsigned char smem_tc[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_tc);  // BQ x SPK
  bf16* Ks = Qs + BQ * SPK;                      // BK x SPK
  bf16* Vs = Ks + BK * SPK;                      // BK x SPV
  int* kvp = reinterpret_cast<int*>(Vs + BK * SPV);  // BK
  int* qps = kvp + BK;                               // BQ

  const int G = Hq / Hkv;
  const int rows = Sq * G;
  const int row0 = blockIdx.x * BQ;
  const int hk = blockIdx.y;
  const int b = blockIdx.z / nsplit;
  const int split = blockIdx.z % nsplit;
  const int kv_begin = split * kv_chunk;
  const int kv_end = min(Skv, kv_begin + kv_chunk);
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int rw = warp % 4;         // the warp's 16-row group
  const int c0 = (warp / 4) * C::DVW;  // and its first column of O
  const uint4 zero = make_uint4(0, 0, 0, 0);

  for (int e = tid; e < BQ * K8; e += NT) {
    const int rr = e / K8, d = (e % K8) * 8;
    const int rho = row0 + rr;
    uint4 val = zero;
    if (rho < rows) {
      const int s = rho / G, g = rho % G;
      val = *reinterpret_cast<const uint4*>(
          q + ((static_cast<size_t>(b) * Sq + s) * Hq + hk * G + g) * DK + d);
    }
    *reinterpret_cast<uint4*>(Qs + rr * SPK + d) = val;
  }
  if (tid < BQ) {
    const int rho = row0 + tid;
    qps[tid] = rho < rows ? q_pos[static_cast<size_t>(b) * Sq + rho / G] : INT_MIN;
  }
  __syncthreads();
  const QRange qr = warp_qrange(merge(qrange_of(qps[lane], row0 + lane < rows),
                                      qrange_of(qps[lane + 32],
                                                row0 + lane + 32 < rows)));
  const int r_lo = rw * 16 + lane / 4;  // this lane's rows: r_lo, r_lo + 8
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
    // BK == 32: one kv position a lane, the same verdict in every warp
    if (tile_class(warp_span(span_of(kvp[lane])), qr, causal) == kSkip)
      continue;

    for (int e = tid; e < BK * K8; e += NT) {
      const int c = e / K8, d = (e % K8) * 8;
      const int j = kv0 + c;
      uint4 kk = zero;
      if (j < kv_end)
        kk = *reinterpret_cast<const uint4*>(
            k + ((static_cast<size_t>(b) * Skv + j) * Hkv + hk) * DK + d);
      *reinterpret_cast<uint4*>(Ks + c * SPK + d) = kk;
    }
    for (int e = tid; e < BK * V8; e += NT) {
      const int c = e / V8, d = (e % V8) * 8;
      const int j = kv0 + c;
      uint4 vv = zero;
      if (j < kv_end)
        vv = *reinterpret_cast<const uint4*>(
            v + ((static_cast<size_t>(b) * Skv + j) * Hkv + hk) * DV + d);
      *reinterpret_cast<uint4*>(Vs + c * SPV + d) = vv;
    }
    __syncthreads();

    // S (16 x 32 per warp) = Q K^T, four n8 tiles of kv columns
    float sc[4][4];
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[n][e] = 0.f;
#pragma unroll
    for (int ks = 0; ks < DK / 16; ++ks) {
      uint32_t a[4];
      mma_sm80::ldsm_x4(a, Qs + (rw * 16 + lane % 16) * SPK + ks * 16
                               + (lane / 16) * 8);
#pragma unroll
      for (int np = 0; np < 2; ++np) {
        uint32_t bb[4];
        mma_sm80::ldsm_x4(bb, Ks + (np * 16 + lane % 8 + (lane / 16) * 8) * SPK
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

    // O += P V on this warp's columns: P (16 x 32) from the accumulators,
    // two k16 steps
#pragma unroll
    for (int kk = 0; kk < 2; ++kk) {
      uint32_t a[4];
      a[0] = mma_sm80::pack_bf16(sc[2 * kk][0], sc[2 * kk][1]);
      a[1] = mma_sm80::pack_bf16(sc[2 * kk][2], sc[2 * kk][3]);
      a[2] = mma_sm80::pack_bf16(sc[2 * kk + 1][0], sc[2 * kk + 1][1]);
      a[3] = mma_sm80::pack_bf16(sc[2 * kk + 1][2], sc[2 * kk + 1][3]);
#pragma unroll
      for (int dp = 0; dp < NO / 2; ++dp) {
        uint32_t bb[4];
        mma_sm80::ldsm_x4_t(bb, Vs + (kk * 16 + lane % 8 + ((lane / 8) % 2) * 8) * SPV
                                    + c0 + dp * 16 + (lane / 16) * 8);
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
      const int d = c0 + j * 8 + (lane % 4) * 2;
      const float x = acc[j][2 * h] * inv, y = acc[j][2 * h + 1] * inv;
      if (nsplit == 1)
        *reinterpret_cast<uint32_t*>(out + row * DV + d) = mma_sm80::pack_bf16(x, y);
      else
        *reinterpret_cast<float2*>(o_part + prow * DV + d) = make_float2(x, y);
    }
    if (lane % 4 == 0 && c0 == 0) {
      const float l = any ? m_run[h] + logf(l_run[h]) : NEG;
      if (nsplit == 1) lse[row] = l;
      else lse_part[prow] = l;
    }
  }
}

template <int DK, int DV>
size_t smem_bytes_tc() {
  using C = TcCfg<DK, DV>;
  return sizeof(__nv_bfloat16) * static_cast<size_t>(
             (BQ + BK) * C::SPK + BK * C::SPV)
       + sizeof(int) * (BK + BQ);
}

// The split merge's threads: one for 4 columns of the widest row.
constexpr int combine_threads(int Dv) { return (Dv > DMAX ? Dv : DMAX) / 4; }

template <int DK, int DV>
int launch_tc(const void* q, const void* k, const void* v, const int* q_pos,
              const int* kv_pos, void* out, float* lse, float* ws, int B,
              int Sq, int Skv, int Hq, int Hkv, float scale, float softcap,
              int causal, int nsplit, cudaStream_t stream) {
  const size_t smem = smem_bytes_tc<DK, DV>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_tc<DK, DV>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const int rows = Sq * (Hq / Hkv);
  const int out_rows = B * Sq * Hq;
  float* o_part = ws;
  float* lse_part = ws + static_cast<size_t>(nsplit) * out_rows * DV;
  dim3 grid((rows + BQ - 1) / BQ, Hkv, B * nsplit);
  flash_fwd_tc<DK, DV><<<grid, TcCfg<DK, DV>::NT, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), q_pos, kv_pos,
      static_cast<__nv_bfloat16*>(out), lse, o_part, lse_part, B, Sq, Skv, Hq,
      Hkv, scale, softcap, causal, nsplit,
      nsplit == 1 ? Skv : kv_chunk_for(Skv, nsplit));
  err = cudaGetLastError();
  if (err != cudaSuccess || nsplit == 1) return err;
  combine_splits<__nv_bfloat16><<<out_rows, combine_threads(DV), 0, stream>>>(
      o_part, lse_part, static_cast<__nv_bfloat16*>(out), lse, out_rows, DV,
      nsplit);
  return cudaGetLastError();
}

// ---- bfloat16 on wgmma --------------------------------------------------
//
// flash_fwd_wgmma<DK, DV> (key width DK, value width DV: (64, 64),
// (128, 128), (256, 256) and MLA's (192, 128)): NWG consumer warpgroups
// (128 threads each) own 64 (query, head-in-group) rows of one KV head
// apiece, so a block holds 64 * NWG rows and every K/V tile it loads
// serves all of them; the block walks 64-row KV tiles:
// * S = Q K^T is wgmma m64n64k16 with Q and K in shared memory (both
//   K-major: rows of DK), DK/16 k-steps; O += P V takes P from the S
//   accumulators in registers (bf16) and V rows as the MN-major B
//   operand (transpose bit), DV/64 n64 products per k-step.  f32
//   accumulators: O is DV/2 registers a thread.
// * K, V and the tile's kv positions arrive through a ring of STAGES
//   shared-memory stages filled by cp.async (128B-swizzled, zero-filled
//   past Skv), one barrier a tile: the load of tile i + STAGES - 1 is in
//   flight while tile i is computed.  Q is loaded once, by hand (64 rows
//   are 64/G positions x G heads, which no rectangular box covers at
//   G = 3).
// * Every tile is classified once before the loop (tile_class, all warps
//   in parallel) against the block's rows; skipped tiles are neither
//   loaded nor computed, mask-free tiles read no positions.
// * Softmax in base 2: log2(e) is folded into the scale, or, with a cap,
//   into cap * tanh.approx(x / cap); lse is written in natural log.
// * Row blocks run heaviest first: blockIdx.x is the KV head and the row
//   block is reversed on blockIdx.y, so the causal blocks that see every
//   KV tile start in the first wave.
// Each warpgroup runs its tile serially (S, wait, softmax, P V, wait), so
// an SM needs several in flight: at DK 256 shared memory holds one block
// an SM, and NWG = 2 doubles the warps there; at DK 64 three one-group
// blocks fit an SM and do better than one two-group block.  NWG is fixed
// by DK (1 at 64, 2 at 128, 192 and 256), from both counts timed on an
// H100 (PERF.md section 6).  At (192, 128) a stage (24 KB of K, 16 KB of
// V) and two warpgroups' Q (48 KB) leave room for three stages in one
// block an SM (173 KB).
constexpr int WBK = 64;      // kv rows of a tile, rows of a warpgroup
constexpr int WMAXT = 1024;  // kv tiles a call may have: Skv <= 65536
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

template <int DK, int DV>
struct WCfg {
  static_assert(DK % 64 == 0 && DV % 64 == 0, "64-column chunks");
  static constexpr int NWG = DK == 64 ? 1 : 2;   // consumer warpgroups
  // (192, 128): a stage is 41 KB, so a third fits beside 48 KB of Q
  static constexpr int STAGES = DK == 64 || DK != DV ? 3 : 2;
  static constexpr int NT = 128 * NWG;           // threads
  static constexpr int BM = 64 * NWG;            // rows of a block
  static constexpr int CV = DV / 64;             // 64-column chunks of O
  static constexpr int QW_BYTES = 64 * DK * 2;   // Q of one warpgroup
  static constexpr int K_BYTES = WBK * DK * 2;   // K of one tile
  static constexpr int V_BYTES = WBK * DV * 2;   // V of one tile
  static constexpr int STAGE = K_BYTES + V_BYTES + 1024;  // + kv positions
  static constexpr size_t SMEM =
      1024 + NWG * QW_BYTES + STAGES * STAGE + WMAXT;
};

template <int DK, int DV>
__global__ void __launch_bounds__(WCfg<DK, DV>::NT, 1)
flash_fwd_wgmma(const __nv_bfloat16* __restrict__ q,
                const __nv_bfloat16* __restrict__ k,
                const __nv_bfloat16* __restrict__ v,
                const int* __restrict__ q_pos, const int* __restrict__ kv_pos,
                __nv_bfloat16* __restrict__ out, float* __restrict__ lse,
                int Sq, int Skv, int Hq, int Hkv, float scale_log2,
                float cap_log2, float inv_cap, int capped, int causal) {
  namespace wg = wgmma_sm90;
  using C = WCfg<DK, DV>;
  constexpr int NWG = C::NWG, STAGES = C::STAGES, NT = C::NT, BM = C::BM;
  constexpr int PK = DK / 8, PV = DV / 8;  // 16-byte pieces of a row
  extern __shared__ unsigned char smem_wg[];
  const uint32_t raw = wg::smem_addr(smem_wg);
  const uint32_t base = (raw + 1023u) & ~1023u;  // swizzle atoms: 1024 B
  unsigned char* sm = smem_wg + (base - raw);
  const uint32_t sRing = base + NWG * C::QW_BYTES;
  unsigned char* cls = sm + NWG * C::QW_BYTES + STAGES * C::STAGE;

  const int G = Hq / Hkv;
  const int rows = Sq * G;
  const int hk = blockIdx.x;
  const int row0 = (gridDim.y - 1 - blockIdx.y) * BM;
  const int b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int grp = tid / 128;                   // this thread's warpgroup
  const uint32_t sQ = base + grp * C::QW_BYTES;  // ... and its 64 Q rows
  const int nt = (Skv + WBK - 1) / WBK;
  const int* kvb = kv_pos + static_cast<size_t>(b) * Skv;
  const int* qpb = q_pos + static_cast<size_t>(b) * Sq;

  auto qpos_of = [&](int r) {  // rows past the end sit below every key
    const int rho = row0 + r;
    return rho < rows ? qpb[rho / G] : INT_MIN;
  };
  QRange qr{INT_MAX, INT_MIN};
#pragma unroll
  for (int r = lane; r < BM; r += 32)
    qr = merge(qr, qrange_of(qpos_of(r), row0 + r < rows));
  qr = warp_qrange(qr);
  const int r_lo = warp * 16 + lane / 4;  // this thread's rows: r_lo, r_lo + 8
  const int qrow[2] = {qpos_of(r_lo), qpos_of(r_lo + 8)};

  // classify every tile: warp w takes tiles w, w + NT/32, ..., four loads
  // in flight at a time
  for (int t0 = warp; t0 < nt; t0 += NT / 8) {
    int p[4][2];
#pragma unroll
    for (int u = 0; u < 4; ++u)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int j = (t0 + u * NT / 32) * WBK + lane + 32 * h;
        p[u][h] = j < Skv ? kvb[j] : -1;
      }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int t = t0 + u * NT / 32;
      const Span s = warp_span(merge(span_of(p[u][0]), span_of(p[u][1])));
      if (lane == 0 && t < nt)
        cls[t] = static_cast<unsigned char>(tile_class(s, qr, causal));
    }
  }

  // Q, once (it joins the first tile's cp.async group): warpgroup i's 64
  // rows in chunks of 64 rows x 64 columns
#pragma unroll
  for (int i = 0; i < BM * PK / NT; ++i) {
    const int e = tid + NT * i;
    const int r = e / PK, pc = e % PK;
    const int rho = row0 + r;
    const bool ok = rho < rows;
    const __nv_bfloat16* src =
        ok ? q + ((static_cast<size_t>(b) * Sq + rho / G) * Hq + hk * G +
                  rho % G) * DK + pc * 8
           : q;
    wg::cp_async16(base + (r / 64) * C::QW_BYTES + (pc / 8) * 8192 +
                       wg::sw128(r % 64, pc % 8),
                   src, ok);
  }
  __syncthreads();  // cls

  auto next_tile = [&](int t) {
    while (t < nt && cls[t] == kSkip) ++t;
    return t;
  };
  auto issue = [&](int stage, int t) {
    const uint32_t sK = sRing + stage * C::STAGE;
    const uint32_t sV = sK + C::K_BYTES;
    const int kv0 = t * WBK;
    // K (DK columns) and V (DV columns), one loop at equal widths
#pragma unroll
    for (int i = 0; i < WBK * PK / NT; ++i) {
      const int e = tid + NT * i;
      const int r = e / PK, pc = e % PK;
      const int j = kv0 + r;
      const bool ok = j < Skv;
      const size_t row = ok ? (static_cast<size_t>(b) * Skv + j) * Hkv + hk
                            : 0;
      const uint32_t o = (pc / 8) * (WBK * 128) + wg::sw128(r, pc % 8);
      wg::cp_async16(sK + o, k + (ok ? row * DK + pc * 8 : 0), ok);
      if constexpr (DK == DV)
        wg::cp_async16(sV + o, v + (ok ? row * DV + pc * 8 : 0), ok);
    }
    if constexpr (DK != DV) {
#pragma unroll
      for (int i = 0; i < WBK * PV / NT; ++i) {
        const int e = tid + NT * i;
        const int r = e / PV, pc = e % PV;
        const int j = kv0 + r;
        const bool ok = j < Skv;
        const size_t off =
            ok ? ((static_cast<size_t>(b) * Skv + j) * Hkv + hk) * DV + pc * 8
               : 0;
        wg::cp_async16(sV + (pc / 8) * (WBK * 128) + wg::sw128(r, pc % 8),
                       v + off, ok);
      }
    }
    if (tid < WBK) {
      const uint32_t dst = sV + C::V_BYTES + 4 * tid;
      if (kv0 + tid < Skv) wg::cp_async4(dst, kvb + kv0 + tid);
      else *reinterpret_cast<int*>(sm + (dst - base)) = -1;
    }
  };

  int nxt = next_tile(0);
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (nxt < nt) {
      issue(s, nxt);
      nxt = next_tile(nxt + 1);
    }
    wg::cp_async_commit();
  }

  float o[C::CV][32];
#pragma unroll
  for (int c = 0; c < C::CV; ++c)
#pragma unroll
    for (int j = 0; j < 32; ++j) o[c][j] = 0.f;
  float m_run[2] = {NEG, NEG}, l_run[2] = {0.f, 0.f};

  int i = 0;
  for (int cur = next_tile(0); cur < nt; cur = next_tile(cur + 1), ++i) {
    wg::cp_async_wait<STAGES - 2>();  // tile cur has landed (this thread's part)
    wg::fence_proxy_async();
    // ... and every thread's; every warp is also done with tile i - 1,
    // whose stage the next load overwrites
    __syncthreads();
    if (nxt < nt) {
      issue((i + STAGES - 1) % STAGES, nxt);
      nxt = next_tile(nxt + 1);
    }
    wg::cp_async_commit();
    const uint32_t sK = sRing + (i % STAGES) * C::STAGE;
    const uint32_t sV = sK + C::K_BYTES;
    const int* kvs = reinterpret_cast<const int*>(sm + (sV - base) + C::V_BYTES);

    float s[32];
#pragma unroll
    for (int j = 0; j < 32; ++j) s[j] = 0.f;
    wg::fence();
#pragma unroll
    for (int ks = 0; ks < DK / 16; ++ks)
      wg::mma_ss<0>(s,
                    wg::desc(sQ + (ks / 4) * 8192 + (ks % 4) * 32, 16, 1024),
                    wg::desc(sK + (ks / 4) * (WBK * 128) + (ks % 4) * 32, 16, 1024),
                    ks > 0);
    wg::commit();
    wg::wait<0>();
    wg::reg_fence(s);

    // scale (and cap) in base 2, mask, online softmax on the accumulators
    const bool masked = cls[cur] == kMasked;
    float mt[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      float x = capped ? cap_log2 * wg::tanh_approx(s[j] * inv_cap)
                       : s[j] * scale_log2;
      if (masked) {
        const int p = kvs[8 * (j / 4) + 2 * (lane % 4) + (j % 2)];
        if (p < 0 || (causal && p > qrow[(j / 2) % 2])) x = -INFINITY;
      }
      s[j] = x;
      mt[(j / 2) % 2] = fmaxf(mt[(j / 2) % 2], x);
    }
    float corr[2], ps[2] = {0.f, 0.f};
    bool moved = false;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mt[h] = fmaxf(mt[h], __shfl_xor_sync(FULL, mt[h], 1));
      mt[h] = fmaxf(mt[h], __shfl_xor_sync(FULL, mt[h], 2));
      const float m_new = fmaxf(m_run[h], mt[h]);  // finite: m_run >= NEG
      moved |= m_new != m_run[h];
      corr[h] = wg::ex2(m_run[h] - m_new);
      m_run[h] = m_new;
    }
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      const float p = wg::ex2(s[j] - m_run[(j / 2) % 2]);  // masked: 0
      s[j] = p;
      ps[(j / 2) % 2] += p;
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      ps[h] += __shfl_xor_sync(FULL, ps[h], 1);
      ps[h] += __shfl_xor_sync(FULL, ps[h], 2);
      l_run[h] = l_run[h] * corr[h] + ps[h];
    }
    if (__any_sync(FULL, moved))  // no row max of the warp moved: corr = 1
#pragma unroll
      for (int c = 0; c < C::CV; ++c)
#pragma unroll
        for (int j = 0; j < 32; ++j) o[c][j] *= corr[(j / 2) % 2];

    uint32_t a[WBK / 16][4];
#pragma unroll
    for (int kk = 0; kk < WBK / 16; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r)
        a[kk][r] = wg::pack_bf16(s[8 * kk + 2 * r], s[8 * kk + 2 * r + 1]);
    wg::fence();
#pragma unroll
    for (int kk = 0; kk < WBK / 16; ++kk)
#pragma unroll
      for (int c = 0; c < C::CV; ++c)
        wg::mma_rs<1>(o[c], a[kk],
                      wg::desc(sV + c * (WBK * 128) + kk * 2048, WBK * 128, 1024),
                      1);
    wg::commit();
    wg::wait<0>();
#pragma unroll
    for (int c = 0; c < C::CV; ++c) wg::reg_fence(o[c]);
#pragma unroll
    for (int kk = 0; kk < WBK / 16; ++kk) wg::reg_fence(a[kk]);
  }
  wg::cp_async_wait<0>();  // no copy outlives the block

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int rho = row0 + r_lo + 8 * h;
    if (rho >= rows) continue;
    const size_t row =
        (static_cast<size_t>(b) * Sq + rho / G) * Hq + hk * G + rho % G;
    const bool any = l_run[h] > 0.f;
    const float inv = any ? 1.f / l_run[h] : 0.f;
#pragma unroll
    for (int c = 0; c < C::CV; ++c)
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        const int d = c * 64 + n * 8 + (lane % 4) * 2;
        *reinterpret_cast<uint32_t*>(out + row * DV + d) = wg::pack_bf16(
            o[c][4 * n + 2 * h] * inv, o[c][4 * n + 2 * h + 1] * inv);
      }
    if (lane % 4 == 0)
      lse[row] = any ? (m_run[h] + log2f(l_run[h])) * LN2 : NEG;
  }
}

template <int DK, int DV>
int launch_wgmma(const void* q, const void* k, const void* v, const int* q_pos,
                 const int* kv_pos, void* out, float* lse, int B, int Sq,
                 int Skv, int Hq, int Hkv, float scale, float softcap,
                 int causal, cudaStream_t stream) {
  using C = WCfg<DK, DV>;
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_wgmma<DK, DV>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(C::SMEM));
  if (err != cudaSuccess) return err;
  const int blocks = (Sq * (Hq / Hkv) + C::BM - 1) / C::BM;
  if (blocks > 65535) return cudaErrorInvalidValue;
  const bool capped = softcap != 0.f;
  dim3 grid(Hkv, blocks, B);
  flash_fwd_wgmma<DK, DV><<<grid, C::NT, C::SMEM, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), q_pos, kv_pos,
      static_cast<__nv_bfloat16*>(out), lse, Sq, Skv, Hq, Hkv,
      scale * LOG2E, capped ? softcap * LOG2E : 0.f,
      capped ? scale / softcap : 0.f, capped, causal);
  return cudaGetLastError();
}

// One 64 x N x 64 product through the helpers of wgmma_sm90.cuh: a (M x K)
// row-major read K-major, or (a_mn_major) a (K x M) row-major read MN-major
// (transpose-A bit set); b (N x K) row-major read K-major, or (mn_major) b
// (K x N) row-major read MN-major (transpose bit set).  N = 64: A from
// shared memory with b K-major, from registers with b MN-major, the two
// forms flash_fwd_wgmma uses.  N = 96, 128 or 256: A from shared memory
// (mma_ss_n), b MN-major as gmm_wgmma and xattn_out_wgmma read it, or
// K-major as xattn_logits_wgmma and xattn_bwd_sdp_wgmma do; A MN-major
// with b MN-major as xattn_bwd_grad_wgmma reads dS^T and P^T.
template <int N>
__global__ void __launch_bounds__(128)
wgmma_tile_check(const __nv_bfloat16* __restrict__ a,
                 const __nv_bfloat16* __restrict__ b, float* __restrict__ c,
                 int mn_major, int a_mn_major) {
  namespace wg = wgmma_sm90;
  __shared__ unsigned char raw[1024 + 8192 + N * 128];
  const uint32_t raw_addr = wg::smem_addr(raw);
  const uint32_t sA = (raw_addr + 1023u) & ~1023u, sB = sA + 8192;
  unsigned char* sm = raw + (sA - raw_addr);
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  for (int e = tid; e < 64 * 8; e += 128) {
    const int r = e / 8, pc = e % 8;
    *reinterpret_cast<uint4*>(sm + wg::sw128(r, pc)) =
        *reinterpret_cast<const uint4*>(a + r * 64 + pc * 8);
  }
  if (mn_major) {  // b's 64 rows of N columns: 64-column chunks 8192 B apart
    for (int e = tid; e < 64 * (N / 8); e += 128) {
      const int r = e / (N / 8), pc = e % (N / 8);
      *reinterpret_cast<uint4*>(sm + 8192 + (pc / 8) * 8192 +
                                wg::sw128(r, pc % 8)) =
          *reinterpret_cast<const uint4*>(b + r * N + pc * 8);
    }
  } else {  // b's N rows of 64 columns, 128 bytes a row
    for (int e = tid; e < N * 8; e += 128) {
      const int r = e / 8, pc = e % 8;
      *reinterpret_cast<uint4*>(sm + 8192 + wg::sw128(r, pc)) =
          *reinterpret_cast<const uint4*>(b + r * 64 + pc * 8);
    }
  }
  wg::fence_proxy_async();
  __syncthreads();
  float d[N / 2];
#pragma unroll
  for (int j = 0; j < N / 2; ++j) d[j] = 0.f;
  const int g = warp * 16 + lane / 4, t2 = (lane % 4) * 2;
  const uint32_t lbo = mn_major ? 8192 : 16;
  wg::fence();
#pragma unroll
  for (int ks = 0; ks < 4; ++ks) {
    const uint64_t db = wg::desc(sB + (mn_major ? ks * 2048 : ks * 32), lbo,
                                 1024);
    if (N == 64 && mn_major) {
      uint32_t f[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int row = g + 8 * (r % 2), col = ks * 16 + 8 * (r / 2) + t2;
        f[r] = wg::pack_bf16(__bfloat162float(a[row * 64 + col]),
                             __bfloat162float(a[row * 64 + col + 1]));
      }
      if constexpr (N == 64) wg::mma_rs<1>(d, f, db, ks > 0);
    } else {
      const uint64_t da = a_mn_major ? wg::desc(sA + ks * 2048, 8192, 1024)
                                     : wg::desc(sA + ks * 32, 16, 1024);
      if constexpr (N == 64) {
        wg::mma_ss<0>(d, da, db, ks > 0);
      } else {
        if (a_mn_major) wg::mma_ss_n<N, 1, 1>(d, da, db, ks > 0);
        else if (mn_major) wg::mma_ss_n<N, 1>(d, da, db, ks > 0);
        else wg::mma_ss_n<N, 0>(d, da, db, ks > 0);
      }
    }
  }
  wg::commit();
  wg::wait<0>();
  wg::reg_fence(d);
#pragma unroll
  for (int n = 0; n < N / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      c[(g + 8 * (e / 2)) * N + n * 8 + t2 + e % 2] = d[4 * n + e];
}

size_t smem_bytes(int D, int Dv) {
  return sizeof(float) * (static_cast<size_t>(BQ + BK) * (D + 4)
                          + static_cast<size_t>(BK) * (Dv + 4) + BQ * PS)
       + sizeof(int) * (BK + BQ);
}

int launch(const void* q, const void* k, const void* v, const int* q_pos,
           const int* kv_pos, void* out, float* lse, float* ws, int B, int Sq,
           int Skv, int Hq, int Hkv, int D, int Dv, float scale,
           float softcap, int causal, int nsplit, cudaStream_t stream) {
  const size_t smem = smem_bytes(D, Dv);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const int rows = Sq * (Hq / Hkv);
  const int out_rows = B * Sq * Hq;
  float* o_part = ws;
  float* lse_part = ws + static_cast<size_t>(nsplit) * out_rows * Dv;
  dim3 grid((rows + BQ - 1) / BQ, Hkv, B * nsplit);
  flash_fwd<<<grid, BQ * TPR, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), q_pos, kv_pos, static_cast<float*>(out),
      lse, o_part, lse_part, B, Sq, Skv, Hq, Hkv, D, Dv, scale, softcap,
      causal, nsplit, nsplit == 1 ? Skv : kv_chunk_for(Skv, nsplit));
  err = cudaGetLastError();
  if (err != cudaSuccess || nsplit == 1) return err;
  combine_splits<float><<<out_rows, combine_threads(Dv), 0, stream>>>(
      o_part, lse_part, static_cast<float*>(out), lse, out_rows, Dv, nsplit);
  return cudaGetLastError();
}

}  // namespace

// How many KV splits flash_attention_fwd takes for this problem on a card
// with `sms` multiprocessors; with n > 1 the caller passes a float32
// workspace of n * B * Sq * Hq * (Dv + 1) elements.
extern "C" int flash_attention_splits(int B, int Sq, int Skv, int Hq, int Hkv,
                                      int sms) {
  if (B <= 0 || Sq <= 0 || Skv <= 0 || Hkv <= 0 || Hq % Hkv != 0) return 1;
  return splits_for(B, Sq, Skv, Hq, Hkv, sms);
}

// dtype: 0 = float32 (D % 4 == 0, D <= 256, and Dv == D or (D, Dv) =
// (192, 128)), 1 = bfloat16 ((D, Dv) = (64, 64), (128, 128), (256, 256),
// (192, 128) or (576, 512)).  Returns a cudaError_t (0 = launched).
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v,
                                   const int* q_pos, const int* kv_pos,
                                   void* out, float* lse, float* ws, int B,
                                   int Sq, int Skv, int Hq, int Hkv, int D,
                                   int Dv, float scale, float softcap,
                                   int causal, int nsplit, int dtype,
                                   void* stream) {
  if (Hkv <= 0 || Hq % Hkv != 0 || nsplit < 1 ||
      (nsplit > 1 && ws == nullptr))
    return cudaErrorInvalidValue;
  if (B == 0 || Sq == 0) return cudaSuccess;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    if (D <= 0 || D > DMAX || D % 4 != 0 ||
        !(Dv == D || (D == 192 && Dv == 128)))
      return cudaErrorInvalidValue;
    return launch(q, k, v, q_pos, kv_pos, out, lse, ws, B, Sq, Skv, Hq, Hkv,
                  D, Dv, scale, softcap, causal, nsplit, st);
  }
  if (dtype != 1) return cudaErrorInvalidValue;
#define FLASH_TC(DK, DV)                                                    \
  if (D == DK && Dv == DV)                                                  \
    return launch_tc<DK, DV>(q, k, v, q_pos, kv_pos, out, lse, ws, B, Sq,   \
                             Skv, Hq, Hkv, scale, softcap, causal, nsplit, st);
  FLASH_TC(64, 64)
  FLASH_TC(128, 128)
  FLASH_TC(256, 256)
  FLASH_TC(192, 128)
  FLASH_TC(576, 512)
#undef FLASH_TC
  return cudaErrorInvalidValue;
}

// The wgmma variant (flash_fwd_wgmma): bfloat16, (D, Dv) = (64, 64),
// (128, 128), (256, 256) or (192, 128), Skv <= 65536, no KV split.
// Returns a cudaError_t (0 = launched).
extern "C" int flash_attention_fwd_wgmma(const void* q, const void* k,
                                         const void* v, const int* q_pos,
                                         const int* kv_pos, void* out,
                                         float* lse, int B, int Sq, int Skv,
                                         int Hq, int Hkv, int D, int Dv,
                                         float scale, float softcap,
                                         int causal, void* stream) {
  if (Hkv <= 0 || Hq % Hkv != 0 || Skv < 0 || Skv > WMAXT * WBK)
    return cudaErrorInvalidValue;
  if (B == 0 || Sq == 0) return cudaSuccess;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define FLASH_WG(DK, DV)                                                    \
  if (D == DK && Dv == DV)                                                  \
    return launch_wgmma<DK, DV>(q, k, v, q_pos, kv_pos, out, lse, B, Sq,    \
                                Skv, Hq, Hkv, scale, softcap, causal, st);
  FLASH_WG(64, 64)
  FLASH_WG(128, 128)
  FLASH_WG(256, 256)
  FLASH_WG(192, 128)
#undef FLASH_WG
  return cudaErrorInvalidValue;
}

// c (64 x n f32) = a b, or a^T b with a_mn_major, through one wgmma tile
// product (wgmma_tile_check): n = 64, 128 or 256 with b K-major or
// MN-major, n = 96 with b K-major; a MN-major at n = 128 or 256 with b
// MN-major.
extern "C" int flash_wgmma_tile_check(const void* a, const void* b, float* c,
                                      int n, int mn_major, int a_mn_major,
                                      void* stream) {
  const auto st = static_cast<cudaStream_t>(stream);
  const auto ab = static_cast<const __nv_bfloat16*>(a);
  const auto bb = static_cast<const __nv_bfloat16*>(b);
  if ((a_mn_major && (n == 64 || n == 96 || !mn_major)) ||
      (n == 96 && mn_major))
    return cudaErrorInvalidValue;
  if (n == 64)
    wgmma_tile_check<64><<<1, 128, 0, st>>>(ab, bb, c, mn_major, a_mn_major);
  else if (n == 96)
    wgmma_tile_check<96><<<1, 128, 0, st>>>(ab, bb, c, mn_major, a_mn_major);
  else if (n == 128)
    wgmma_tile_check<128><<<1, 128, 0, st>>>(ab, bb, c, mn_major, a_mn_major);
  else if (n == 256)
    wgmma_tile_check<256><<<1, 128, 0, st>>>(ab, bb, c, mn_major, a_mn_major);
  else return cudaErrorInvalidValue;
  return cudaGetLastError();
}
