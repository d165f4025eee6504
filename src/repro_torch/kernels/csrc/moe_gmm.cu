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
// bytes and operations are within 15% of each other.  At the Memory-LLM
// (C = 128) and at decode and the prompt prefill (C = 8) it is bound by
// reading the weights.
//
// Design: the TPU kernel walks (E, C, F, D) in order, accumulating over D
// in a VMEM scratch tile.  Here each output tile of one expert is summed
// over D in registers by one thread block; the tiles of one expert are
// taken together, so its weights are shared in L2.  Four kernels:
//   * gmm_wgmma ("wgmma", bf16): 64-row consumer warpgroups on wgmma
//     m64nNk16 (N = 128 or 256) with x K-major and w MN-major in 128-byte
//     swizzled shared memory; a persistent grid whose blocks stream the
//     64-deep D slabs of their tiles through a 4-stage cp.async ring, one
//     barrier a slab and one wgmma group in flight, so the next tile's
//     first slabs load while this tile's last ones multiply and its
//     outputs leave in 16-byte rows.  The tile (warpgroups x columns) is
//     picked by C (launch_wgmma_for).
//   * gmm_rows ("rows", bf16, C <= ROWS_MAX_C = 32): out^T = w^T x^T on
//     mma.sync m16n8k16, so F fills the 16 MMA rows and C the 8-wide
//     columns; four warps own 64 columns of F and stream all of D through
//     a 4-6 stage cp.async ring.  No 64-row tile computes rows of zeros,
//     and the weights are read once by enough blocks to keep the loads in
//     flight that device memory's latency asks for.
//   * gmm_bf16 ("mma_sync", bf16): four warps of 32 x 64 outputs on
//     mma.sync m16n8k16, ldmatrix from padded shared tiles, two cp.async
//     stages of 32-deep slabs; it copies element by element where a row
//     is not a multiple of 8 or a base not 16-byte aligned, so it takes
//     every shape.
//   * gmm_f32 (float32): CUDA cores (64 x 64 x 16 block tiles, 4 x 4
//     outputs per thread), so a float32 check on the card runs without
//     TF32.
// A slab's rows and columns past C, D or F are zero-filled; each output
// is the sum of one block, taken in one order (no split of D, no atomics).
//
// Dispatch (kernels/moe_gmm.py::variant_for): bf16 calls with D and F
// multiples of 8 and 16-byte aligned x and w go to "rows" for C <= 32
// and to "wgmma" above; the others to "mma_sync".
//
// Measured: PERF.md section 6 holds the device times of every variant and
// of torch.bmm at granite's shapes (E = 40, 1536 -> 512 and 512 -> 1536;
// C = 768, 128 and 8, and probes at C = 16, 32 and 64), with the card,
// its power limit and the chip_smoke.py run they come from (device time of
// 21 graph-replayed calls over three sets of x and w, 189 MB of weights,
// so that no call reads its weights from L2).  The cut at C = 32 is set
// by the 1536 -> 512 orientation, two of a MoE layer's three products:
// there rows is ahead of wgmma up to C = 32; in 512 -> 1536 the two are
// within about 1 us of each other at C = 16 and 32, either ahead.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cstdint>

#include "mma_sm80.cuh"
#include "wgmma_sm90.cuh"

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

// ---- bfloat16 on mma.sync: the "mma_sync" variant ------------------------

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

// ---- bfloat16 on wgmma: the "wgmma" variant -------------------------------
//
// gmm_wgmma<NWG, BN>: NWG consumer warpgroups own 64 rows of x
// each, so an output tile is (64 NWG) x BN of one expert.  The grid is
// persistent (as many blocks as fit the card at once); block b takes
// tiles b, b + grid, ... in the order (expert, row tile, column tile), so
// the blocks in flight share one or two experts' weights in L2.  A block
// walks the 64-deep D slabs of its tiles as one stream through the slab
// ring of wgmma_sm90.cuh (ring_prime / ring_walk: STAGES cp.async stages
// in the 128-byte swizzle, one barrier a slab, one wgmma group in flight)
// — x rows as the K-major A operand (one 64-column chunk a warpgroup), the
// slab's 64 rows of w as the MN-major B operand (BN / 64 chunks of 64
// columns), zero-filled past C, D and F — so the next tile's first slabs
// load while this tile's last ones multiply and its outputs are stored.
// A slab is 4 k-steps of wgmma m64nBNk16 per warpgroup.  Outputs leave in
// 16-byte rows (row8_bf16).

template <int NWG, int BN>
struct WgCfg {
  static constexpr int STAGES = 4;                     // of the ring
  static constexpr int NT = 128 * NWG;                 // threads
  static constexpr int BM = 64 * NWG;                  // rows of a tile
  static constexpr int A_BYTES = NWG * 8192;           // x: BM x 64
  static constexpr int B_BYTES = (BN / 64) * 8192;     // w: 64 x BN
  static constexpr int STAGE = A_BYTES + B_BYTES;
  static constexpr size_t SMEM = 1024 + STAGES * STAGE;  // + 1024-B align
  static constexpr int MINB = 2 * SMEM <= 232448 - 2048 ? 2 : 1;  // an SM
  static_assert(64 * BN % (8 * NT) == 0, "whole w pieces a thread");
};

template <int NWG, int BN>
__global__ void __launch_bounds__(WgCfg<NWG, BN>::NT, WgCfg<NWG, BN>::MINB)
gmm_wgmma(const bf16* __restrict__ x, const bf16* __restrict__ w,
          bf16* __restrict__ out, int C, int D, int F, int tiles_m,
          int tiles_n, int tiles) {
  namespace wg = wgmma_sm90;
  using K = WgCfg<NWG, BN>;
  constexpr int NT = K::NT, BM = K::BM, STAGES = K::STAGES;
  extern __shared__ unsigned char smem_gmm[];
  const uint32_t raw = wg::smem_addr(smem_gmm);
  const uint32_t base = (raw + 1023u) & ~1023u;  // swizzle atoms: 1024 B
  const int tid = threadIdx.x, lane = tid % 32, warp = (tid % 128) / 32;
  const int grp = tid / 128;  // this thread's warpgroup
  const int nk = (D + 63) / 64;
  const int mine = blockIdx.x < tiles ? (tiles - 1 - blockIdx.x) / gridDim.x + 1
                                      : 0;
  const int total = mine * nk;  // slabs of this block

  struct Tile {
    size_t e;
    int m0, n0;
  };
  auto tile_of = [&](int t) {  // this block's t-th tile
    const int T = blockIdx.x + t * gridDim.x;
    const int r = T / tiles_n;
    return Tile{static_cast<size_t>(r / tiles_m), (r % tiles_m) * BM,
                (T % tiles_n) * BN};
  };

  // This thread's share of a slab: x rows rx + i NT/8 at 16-byte piece px
  // of the slab's 64 columns; w rows rw + i WRS at piece pw of BN / 8.
  constexpr int XI = BM * 8 / NT, WPR = BN / 8, WI = 64 * WPR / NT;
  constexpr int WRS = NT / WPR;
  const int px = tid % 8, rx = tid / 8, pw = tid % WPR, rw = tid / WPR;
  const size_t x_step = static_cast<size_t>(NT / 8) * D;
  const size_t w_step = static_cast<size_t>(WRS) * F;
  // The load cursor: slab c_kt of this block's tile c_t, whose rows of x
  // start at c_x and whose columns of w at c_w.
  int c_t = 0, c_kt = 0;
  const bf16* c_x = x;
  const bf16* c_w = w;
  uint32_t c_rows = 0;  // bit i: x row rx + i NT/8 is below C
  bool c_cols = false;  // piece pw is left of F
  auto enter = [&](int t) {
    const Tile tl = tile_of(t);
    c_x = x + (tl.e * C + tl.m0 + rx) * static_cast<size_t>(D) + px * 8;
    c_w = w + (tl.e * D + rw) * static_cast<size_t>(F) + tl.n0 + pw * 8;
    c_rows = 0;
#pragma unroll
    for (int i = 0; i < XI; ++i)
      c_rows |= static_cast<uint32_t>(tl.m0 + rx + i * (NT / 8) < C) << i;
    c_cols = tl.n0 + pw * 8 < F;
  };
  // stage s <- the cursor's slab; the cursor moves on
  auto issue = [&](int s) {
    const int k0 = c_kt * 64;
    const uint32_t sA = base + s * K::STAGE, sB = sA + K::A_BYTES;
#pragma unroll
    for (int i = 0; i < XI; ++i) {
      const int r = rx + i * (NT / 8);
      const bool ok = (c_rows >> i & 1u) && k0 + px * 8 < D;
      wg::cp_async16(sA + (r / 64) * 8192 + wg::sw128(r % 64, px),
                     ok ? c_x + i * x_step + k0 : x, ok);
    }
    const bf16* wk = c_w + static_cast<size_t>(k0) * F;
#pragma unroll
    for (int i = 0; i < WI; ++i) {
      const bool ok = c_cols && k0 + rw + i * WRS < D;
      wg::cp_async16(sB + (pw / 8) * 8192 + wg::sw128(rw + i * WRS, pw % 8),
                     ok ? wk + i * w_step : w, ok);
    }
    if (++c_kt == nk) {
      c_kt = 0;
      if (++c_t < mine) enter(c_t);
    }
  };

  // accumulator fragment: acc[4n + 2h + {0,1}] = (row 16 warp + lane/4 +
  // 8h, columns 8n + 2 (lane % 4) + {0,1}) of this warpgroup's 64 rows,
  // stored 8 neighbouring columns (16 bytes) a thread
  float acc[BN / 2];
#pragma unroll
  for (int j = 0; j < BN / 2; ++j) acc[j] = 0.f;
  auto store = [&](const Tile& tl) {
    bf16* oe = out + tl.e * C * static_cast<size_t>(F);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int gm = tl.m0 + grp * 64 + warp * 16 + lane / 4 + 8 * h;
#pragma unroll
      for (int j = 0; j < BN / 32; ++j) {
        const uint4 v = wg::row8_bf16(acc, h, j, lane);
        const int gn = tl.n0 + 8 * (4 * j + lane % 4);
        if (gm < C && gn < F)  // F % 8 == 0: the 8 columns are whole
          *reinterpret_cast<uint4*>(oe + static_cast<size_t>(gm) * F + gn) = v;
      }
    }
  };

  if (mine > 0) enter(0);
  wg::ring_prime<STAGES>(total, issue);
  wg::ring_walk<STAGES>(
      mine, nk, issue, [](int, int) {},
      [&](int stage, int) {
        const uint32_t sA = base + stage * K::STAGE + grp * 8192;
        const uint32_t sB = base + stage * K::STAGE + K::A_BYTES;
#pragma unroll
        for (int ks = 0; ks < 4; ++ks)
          wg::mma_ss_n<BN, 1>(acc, wg::desc(sA + ks * 32, 16, 1024),
                              wg::desc(sB + ks * 2048, 8192, 1024), 1);
      },
      [&] { wg::reg_fence(acc); },
      [&](int t) {
        store(tile_of(t));
#pragma unroll
        for (int j = 0; j < BN / 2; ++j) acc[j] = 0.f;  // the next tile's
      });
}

template <int NWG, int BN>
int launch_wgmma(const bf16* x, const bf16* w, bf16* out, int E, int C,
                 int D, int F, cudaStream_t st) {
  using K = WgCfg<NWG, BN>;
  const auto kernel = gmm_wgmma<NWG, BN>;
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
  const long long tiles_m = (C + K::BM - 1) / K::BM;
  const long long tiles_n = (F + BN - 1) / BN;
  const long long tiles = tiles_m * tiles_n * E;
  if (tiles > (1LL << 31) - 1 || per_sm < 1) return cudaErrorInvalidValue;
  const int grid = static_cast<int>(
      tiles < static_cast<long long>(sms) * per_sm ? tiles : sms * per_sm);
  kernel<<<grid, K::NT, K::SMEM, st>>>(x, w, out, C, D, F,
                                       static_cast<int>(tiles_m),
                                       static_cast<int>(tiles_n),
                                       static_cast<int>(tiles));
  return cudaGetLastError();
}

// The wgmma variant's tile <consumer warpgroups, columns> for a
// call, from the tiles' device times at granite's shapes on an H100
// (PERF.md section 6): 256 x 128 at the 768-row source prefill, 128 x 256
// at the 128-row Memory-LLM, 64 x 128 where a 128-row tile would be half
// empty.
int launch_wgmma_for(const bf16* x, const bf16* w, bf16* out, int E, int C,
                     int D, int F, cudaStream_t st) {
  if (C >= 256) return launch_wgmma<4, 128>(x, w, out, E, C, D, F, st);
  if (C > 64) return launch_wgmma<2, 256>(x, w, out, E, C, D, F, st);
  return launch_wgmma<1, 128>(x, w, out, E, C, D, F, st);
}

// ---- bfloat16, few rows: the "rows" variant -------------------------------
//
// gmm_rows<NT8>: out[e]^T = w[e]^T x[e]^T, so F fills the MMA's 16 rows
// and C its 8-column tiles (NT8 of them: C <= 8 NT8).  A block of four
// warps owns 64 columns of F (16 a warp) of one expert and walks all of
// D in 64-deep slabs through a ring of 4-6 cp.async stages; the w
// slab (64 x 64) and the x slab (8 NT8 rows x 64) sit in the 128-byte
// swizzle, read by ldmatrix (w transposed) into mma.sync m16n8k16.  No
// split of D: each output is one block's sum, in one order.

constexpr int RWARPS = 4, RBF = 16 * RWARPS;  // F columns of a block
// The rows kernel's widest call, and the cut of the dispatch rule
// (kernels/moe_gmm.py::ROWS_MAX_C): 8 NT8, NT8 <= 4.
constexpr int ROWS_MAX_C = 32;

template <int NT8>
struct RowsCfg {
  static constexpr int STAGES = NT8 <= 2 ? 6 : 4;
  static constexpr int W_BYTES = 64 * 128;        // 64 D rows x 64 columns
  static constexpr int X_BYTES = NT8 * 8 * 128;   // 8 NT8 rows x 64 D
  static constexpr int STAGE = W_BYTES + X_BYTES;
  static constexpr size_t SMEM = 1024 + STAGES * STAGE;
};

template <int NT8>
__global__ void __launch_bounds__(32 * RWARPS)
gmm_rows(const bf16* __restrict__ x, const bf16* __restrict__ w,
         bf16* __restrict__ out, int C, int D, int F) {
  namespace wg = wgmma_sm90;
  using K = RowsCfg<NT8>;
  constexpr int NT = 32 * RWARPS, STAGES = K::STAGES;
  extern __shared__ unsigned char smem_rows[];
  const uint32_t raw = wg::smem_addr(smem_rows);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const unsigned char* sm = smem_rows + (base - raw);
  const size_t e = blockIdx.y;
  const bf16* xe = x + e * C * static_cast<size_t>(D);
  const bf16* we = w + e * D * static_cast<size_t>(F);
  out += e * C * static_cast<size_t>(F);
  const int f0 = blockIdx.x * RBF;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int nk = (D + 63) / 64;

  auto issue = [&](int s, int kt) {
    const uint32_t sW = base + s * K::STAGE, sX = sW + K::W_BYTES;
    const int k0 = kt * 64;
#pragma unroll
    for (int i = 0; i < 64 * 8 / NT; ++i) {
      const int p = tid + NT * i;
      const int r = p / 8, pc = p % 8;
      const int gk = k0 + r, gf = f0 + pc * 8;
      const bool ok = gk < D && gf < F;
      wg::cp_async16(sW + wg::sw128(r, pc),
                     ok ? we + static_cast<size_t>(gk) * F + gf : we, ok);
    }
#pragma unroll
    for (int p = tid; p < NT8 * 64; p += NT) {
      const int r = p / 8, pc = p % 8;
      const int gk = k0 + pc * 8;
      const bool ok = r < C && gk < D;
      wg::cp_async16(sX + wg::sw128(r, pc),
                     ok ? xe + static_cast<size_t>(r) * D + gk : xe, ok);
    }
  };

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nk) issue(s, s);
    wg::cp_async_commit();
  }
  float acc[NT8][4];
#pragma unroll
  for (int j = 0; j < NT8; ++j)
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[j][q] = 0.f;

  // ldmatrix rows of this lane: matrix i = lane / 8, row lane % 8
  const int li = lane / 8, lr = lane % 8;
  for (int kt = 0; kt < nk; ++kt) {
    wg::cp_async_wait<STAGES - 2>();  // slab kt has landed (this thread's part)
    __syncthreads();  // ... and every thread's; slab kt - 1 is read
    if (kt + STAGES - 1 < nk) issue((kt + STAGES - 1) % STAGES, kt + STAGES - 1);
    wg::cp_async_commit();
    const unsigned char* sW = sm + (kt % STAGES) * K::STAGE;
    const unsigned char* sX = sW + K::W_BYTES;
#pragma unroll
    for (int kk = 0; kk < 64; kk += 32) {
      // A = w^T (16 F x 16 D) for D rows kk and kk + 16: matrices (D rows
      // +0/+8) x (F columns +0/+8), transposed on the way
      uint32_t a[2][4];
#pragma unroll
      for (int h = 0; h < 2; ++h)
        ldsm_x4_t(a[h], reinterpret_cast<const bf16*>(
                            sW + wg::sw128(kk + 16 * h + lr + (li / 2) * 8,
                                           warp * 2 + li % 2)));
#pragma unroll
      for (int j = 0; j < NT8; ++j) {
        // B = x^T (16 D x 8 C): x rows 8j.., D columns kk + 8 li
        uint32_t b[4];
        ldsm_x4(b, reinterpret_cast<const bf16*>(
                       sX + wg::sw128(8 * j + lr, kk / 8 + li)));
        mma16816(acc[j], a[0], b[0], b[1]);
        mma16816(acc[j], a[1], b[2], b[3]);
      }
    }
  }
  wg::cp_async_wait<0>();  // no copy outlives the block

  // acc[j] = (F column g / g + 8, C rows 8j + 2t, 8j + 2t + 1) with
  // g = lane / 4, t = lane % 4
#pragma unroll
  for (int j = 0; j < NT8; ++j)
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int c = 8 * j + 2 * (lane % 4) + q % 2;
      const int f = f0 + warp * 16 + lane / 4 + 8 * (q / 2);
      if (c < C && f < F)
        out[static_cast<size_t>(c) * F + f] = __float2bfloat16_rn(acc[j][q]);
    }
}

template <int NT8>
int launch_rows(const bf16* x, const bf16* w, bf16* out, int E, int C, int D,
                int F, cudaStream_t st) {
  using K = RowsCfg<NT8>;
  static unsigned ready = 0;
  int dev = 0;
  const cudaError_t err =
      wgmma_sm90::with_smem(gmm_rows<NT8>, K::SMEM, ready, &dev);
  if (err != cudaSuccess) return err;
  const dim3 grid((F + RBF - 1) / RBF, E);
  gmm_rows<NT8><<<grid, 32 * RWARPS, K::SMEM, st>>>(x, w, out, C, D, F);
  return cudaGetLastError();
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

int launch_rows_for(const bf16* x, const bf16* w, bf16* out, int E, int C,
                    int D, int F, cudaStream_t st) {
  if (C <= 8) return launch_rows<1>(x, w, out, E, C, D, F, st);
  if (C <= 16) return launch_rows<2>(x, w, out, E, C, D, F, st);
  return launch_rows<4>(x, w, out, E, C, D, F, st);
}

}  // namespace

// out = per-expert x @ w: x (E,C,D), w (E,D,F), out (E,C,F), contiguous.
// dtype: 0 = float32, 1 = bfloat16.  variant (bfloat16): 0 = "mma_sync",
// 1 = "wgmma", 2 = "rows"; float32 takes 0.  "wgmma" and "rows" take D
// and F multiples of 8 and 16-byte aligned x, w and out, "rows" C <=
// ROWS_MAX_C.  Returns a cudaError_t (0 = launched).
extern "C" int moe_gmm_fwd(const void* x, const void* w, void* out, int E,
                           int C, int D, int F, int dtype, int variant,
                           void* stream) {
  if (E < 0 || C < 0 || D <= 0 || F < 0) return cudaErrorInvalidValue;
  if (E == 0 || C == 0 || F == 0) return cudaSuccess;
  if (E > 65535) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && variant == 0) {
    if ((C + TM - 1) / TM > 65535) return cudaErrorInvalidValue;
    const dim3 grid((F + TN - 1) / TN, (C + TM - 1) / TM, E);
    gmm_f32<<<grid, NT, 0, st>>>(static_cast<const float*>(x),
                                 static_cast<const float*>(w),
                                 static_cast<float*>(out), C, D, F);
    return cudaGetLastError();
  }
  if (dtype != 1) return cudaErrorInvalidValue;
  const bf16* xb = static_cast<const bf16*>(x);
  const bf16* wb = static_cast<const bf16*>(w);
  bf16* ob = static_cast<bf16*>(out);
  if (variant == 0) {
    if ((C + MB - 1) / MB > 65535) return cudaErrorInvalidValue;
    const dim3 grid((F + NB - 1) / NB, (C + MB - 1) / MB, E);
    gmm_bf16<<<grid, MNT, 0, st>>>(xb, wb, ob, C, D, F,
                                   D % 8 == 0 && aligned16(x),
                                   F % 8 == 0 && aligned16(w));
    return cudaGetLastError();
  }
  if (D % 8 || F % 8 || !aligned16(x) || !aligned16(w) || !aligned16(out))
    return cudaErrorInvalidValue;
  if (variant == 1) return launch_wgmma_for(xb, wb, ob, E, C, D, F, st);
  if (variant == 2 && C <= ROWS_MAX_C)
    return launch_rows_for(xb, wb, ob, E, C, D, F, st);
  return cudaErrorInvalidValue;
}

// ---- the backward: dX = dY Wᵀ and dW = Xᵀ dY -------------------------------
//
// Replaces the gradient JAX forms for src/repro/kernels/moe_gmm.py::gmm by
// differentiating its plain path (ref.py::gmm_ref; the JAX package defines
// no custom_vjp).  Contract: plain.gmm_bwd_ref —
//   dx[e] = dy[e] @ w[e]ᵀ   (E,C,F) x (E,D,F) -> (E,C,D), x's type
//   dw[e] = x[e]ᵀ @ dy[e]   (E,C,D) x (E,C,F) -> (E,D,F), w's type
// each summed in float32.  The wrapper launches each only for an input
// that needs a gradient (MemCom Phase 1 freezes the experts: dX alone).
//
// What bounds it on an H100: at granite-moe-3b-a800m's training shapes (E
// = 40, D 1536 <-> F 512, C = 256 rows an expert for the Memory-LLM and
// the prompt) dX does 16.1 GFLOP and moves 104.9 MB (the weights, 62.9
// MB, dY and dX once): 0.016 ms of tensor-core time against 0.031 ms of
// bytes, so it is bound by bytes, as the forward at C = 128 is; dW moves
// the same 104.9 MB (x, dY and dW once).
//
// Design ("wgmma", bf16 with D and F multiples of 8 and 16-byte aligned
// operands: kernels/moe_gmm.py::bwd_variant_for): gmm_bwd_wgmma, the
// forward's gmm_wgmma with the backward's storage orders (see the
// kernel).  Above 128 rows a tile is 256 rows (launch_bwd_wgmma_for): at
// C <= 256 one row tile covers dX's rows, so each expert's weights (1.6
// MB) are read from device memory once, where a 64-row tile reads them C
// / 64 times (four at C = 256, 252 MB a call: more than the 50 MB L2
// keeps).  The cp.async ring keeps two 64-deep slabs in flight an SM (96
// KB at 256 x 128), and outputs leave in 16-byte rows.  W is never copied
// transposed.
//
// "mma_sync" (the other bf16 calls): one kernel template,
// gmm_bwd_tc<A_T, B_T>, the
// forward's gmm_bf16 with each operand read in its storage order: A (M x
// K) is stored row-major ([m][k], ldmatrix) or as its transpose ([k][m],
// ldmatrix.trans), B (K x N) as [k][n] (ldmatrix.trans) or [n][k]
// (ldmatrix).  dX is <false, true>: dy rows are A's, w's rows (D rows of F)
// are B's columns, read in place; no transposed copy of w (63 MB a call at
// granite's width) is made.  dW is <true, false>: x's rows (C rows of D)
// are Aᵀ's rows, dy's are B's.  Four warps own 64 x 128 outputs of one
// expert and stream K through two cp.async stages of 32-deep slabs; each
// output is one block's sum in one order (no split of K, no atomics), so
// two runs are bit-identical.  float32: gmm_bwd_f32<A_T, B_T>, the
// forward's CUDA-core tile with the same two storage orders (no TF32).
// PERF.md section 6 has both variants' times beside torch.bmm's.

namespace {

// out[e] = A[e] B[e] for e = blockIdx.z, float32 on the CUDA cores.
// A(m, k) = a[A_T ? k lda + m : m lda + k], B(k, n) = b[B_T ? n ldb + k :
// k ldb + n]; out (M x N) row-major.
template <bool A_T, bool B_T>
__global__ void __launch_bounds__(NT)
gmm_bwd_f32(const float* __restrict__ a, const float* __restrict__ b,
            float* __restrict__ out, int M, int N, int K, int lda, int ldb,
            size_t a_step, size_t b_step) {
  __shared__ __align__(16) float As[TK][TM + 4];
  __shared__ __align__(16) float Bs[TK][TN + 4];
  const size_t e = blockIdx.z;
  a += e * a_step;
  b += e * b_step;
  out += e * M * static_cast<size_t>(N);
  const int m0 = blockIdx.y * TM, n0 = blockIdx.x * TN;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  float acc[4][4] = {};

  for (int k0 = 0; k0 < K; k0 += TK) {
#pragma unroll 1
    for (int i = threadIdx.x; i < TM * TK; i += NT) {
      // neighbouring threads on neighbouring addresses of the storage
      const int mm = A_T ? i % TM : i / TK, kk = A_T ? i / TM : i % TK;
      const int gm = m0 + mm, gk = k0 + kk;
      As[kk][mm] = (gm < M && gk < K)
                       ? a[A_T ? static_cast<size_t>(gk) * lda + gm
                               : static_cast<size_t>(gm) * lda + gk]
                       : 0.f;
    }
#pragma unroll 1
    for (int i = threadIdx.x; i < TN * TK; i += NT) {
      const int nn = B_T ? i / TK : i % TN, kk = B_T ? i % TK : i / TN;
      const int gn = n0 + nn, gk = k0 + kk;
      Bs[kk][nn] = (gn < N && gk < K)
                       ? b[B_T ? static_cast<size_t>(gn) * ldb + gk
                               : static_cast<size_t>(gk) * ldb + gn]
                       : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < TK; ++kk) {
      const float4 av = *reinterpret_cast<const float4*>(&As[kk][ty * 4]);
      const float4 bv = *reinterpret_cast<const float4*>(&Bs[kk][tx * 4]);
      const float ar[4] = {av.x, av.y, av.z, av.w};
      const float br[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] += ar[i] * br[j];
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
      if (gn < N) out[static_cast<size_t>(gm) * N + gn] = acc[i][j];
    }
  }
}

constexpr int SMP = MB + 8;  // padded row of a [k][m] A tile (144 bytes)

// out[e] = A[e] B[e] for e = blockIdx.z: bf16 in, float32 sums, bf16 out;
// storage orders as gmm_bwd_f32's.  vec_a / vec_b: the rows of a / b are
// whole 16-byte pieces (row length a multiple of 8, 16-byte aligned base),
// so each piece is one cp.async.
template <bool A_T, bool B_T>
__global__ void __launch_bounds__(MNT)
gmm_bwd_tc(const bf16* __restrict__ a, const bf16* __restrict__ b,
           bf16* __restrict__ out, int M, int N, int K, int lda, int ldb,
           size_t a_step, size_t b_step, bool vec_a, bool vec_b) {
  constexpr int A_ELEMS = A_T ? KB * SMP : MB * SKP;
  constexpr int B_ELEMS = B_T ? NB * SKP : KB * SNP;
  __shared__ __align__(16) bf16 As[2][A_ELEMS];
  __shared__ __align__(16) bf16 Bs[2][B_ELEMS];
  const size_t e = blockIdx.z;
  const bf16* ae = a + e * a_step;
  const bf16* be = b + e * b_step;
  out += e * M * static_cast<size_t>(N);
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

  // stage s <- the K slab starting at k0
  auto load_slab = [&](int s, int k0) {
    if (A_T) {  // KB rows of k, MB columns of m
      for (int i = threadIdx.x; i < KB * MB / 8; i += MNT) {
        const int r = i / (MB / 8), c = (i % (MB / 8)) * 8;
        const int gk = k0 + r;
        load8(&As[s][r * SMP + c], ae, ae + static_cast<size_t>(gk) * lda,
              gk < K, m0 + c, M, vec_a);
      }
    } else {  // MB rows of m, KB columns of k
      for (int i = threadIdx.x; i < MB * KB / 8; i += MNT) {
        const int r = i / (KB / 8), c = (i % (KB / 8)) * 8;
        const int gm = m0 + r;
        load8(&As[s][r * SKP + c], ae, ae + static_cast<size_t>(gm) * lda,
              gm < M, k0 + c, K, vec_a);
      }
    }
    if (B_T) {  // NB rows of n, KB columns of k
      for (int i = threadIdx.x; i < NB * KB / 8; i += MNT) {
        const int r = i / (KB / 8), c = (i % (KB / 8)) * 8;
        const int gn = n0 + r;
        load8(&Bs[s][r * SKP + c], be, be + static_cast<size_t>(gn) * ldb,
              gn < N, k0 + c, K, vec_b);
      }
    } else {  // KB rows of k, NB columns of n
      for (int i = threadIdx.x; i < KB * NB / 8; i += MNT) {
        const int r = i / (NB / 8), c = (i % (NB / 8)) * 8;
        const int gk = k0 + r;
        load8(&Bs[s][r * SNP + c], be, be + static_cast<size_t>(gk) * ldb,
              gk < K, n0 + c, N, vec_b);
      }
    }
  };

  const int nk = (K + KB - 1) / KB;
  if (nk > 0) load_slab(0, 0);
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
      // A fragments: matrices (m +0/+8) x (k +0/+8) in the mma's order
      uint32_t af[2][4];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        if (A_T)
          ldsm_x4_t(af[mi], &as[(kk + lane % 8 + (lane / 16) * 8) * SMP + wm
                                + mi * 16 + ((lane / 8) % 2) * 8]);
        else
          ldsm_x4(af[mi], &as[(wm + mi * 16 + lane % 16) * SKP + kk
                              + (lane / 16) * 8]);
      }
#pragma unroll
      for (int nj = 0; nj < 4; ++nj) {
        // B fragments: (k +0/+8) x (n +0/+8), n-tile pairs
        uint32_t bfr[4];
        if (B_T)
          ldsm_x4(bfr, &bs[(wn + nj * 16 + (lane / 16) * 8 + lane % 8) * SKP
                           + kk + ((lane / 8) % 2) * 8]);
        else
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
  cp_async_wait_one();
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 8; ++ni)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int gm = m0 + wm + mi * 16 + lane / 4 + h * 8;
        const int gn = n0 + wn + ni * 8 + (lane % 4) * 2;
        if (gm >= M) continue;
        bf16* row = out + static_cast<size_t>(gm) * N;
        if (gn < N) row[gn] = __float2bfloat16_rn(acc[mi][ni][2 * h]);
        if (gn + 1 < N) row[gn + 1] = __float2bfloat16_rn(acc[mi][ni][2 * h + 1]);
      }
}

// ---- bfloat16 on wgmma: the backward's "wgmma" variant ------------------
//
// gmm_bwd_wgmma<NWG, RB, BN, DW>: out[e] (M x N) = A[e] B[e] over K, with
// gmm_wgmma's persistent grid and tile order (expert, row tile, column
// tile), the slab ring of wgmma_sm90.cuh and its 16-byte epilogue.  A tile
// is BM = 64 NWG RB rows (NWG consumer warpgroups, RB 64-row blocks each,
// every block one wgmma m64nBNk16 a k-step) by BN columns.  Only the
// operands' storage orders differ from the forward's:
//   dX (DW = 0): A = dy[e] (C x F), K-major as the forward's x; B = w[e]
//     read in place: its D rows of F are the columns of Wᵀ, each a run of
//     K, so B is K-major (TB = 0): BN rows of 128 bytes a slab.  M = C, N
//     = D, K = F.
//   dW (DW = 1): A = x[e]ᵀ from x stored [c][d]: the slab's 64 rows are k
//     = c and its columns m = d, the MN-major A (TA = 1) of the memcom_xattn
//     backward's dK, one 64-column chunk a row block; B = dy[e] [c][f],
//     MN-major (TB = 1) as the forward reads w.  M = D, N = F, K = C.
// Rows and columns past M, N and K are zero-filled, so a ragged K (C) adds
// nothing.  Each output is one block's sum in one order.  The ring is as
// deep as an SM's shared memory holds (at most 8 stages).
template <int NWG, int RB, int BN>
struct BwdCfg {
  static constexpr int NT = 128 * NWG;                 // threads
  static constexpr int BM = 64 * NWG * RB;             // rows of a tile
  static constexpr int A_BYTES = NWG * RB * 8192;      // BM x 64
  static constexpr int B_BYTES = BN * 128;             // 64 x BN
  static constexpr int STAGE = A_BYTES + B_BYTES;
  static constexpr int FIT = (232448 - 1024) / STAGE;
  static constexpr int STAGES = FIT < 8 ? FIT : 8;
  static constexpr size_t SMEM = 1024 + STAGES * STAGE;
  static constexpr int AI = 8 * BM / NT, BI = 8 * BN / NT;  // pieces a thread
  static_assert(BN % 64 == 0 && 8 * BN % NT == 0 && STAGES >= 3,
                "whole chunks and pieces, 3 stages");
};

template <int NWG, int RB, int BN, bool DW>
__global__ void __launch_bounds__(BwdCfg<NWG, RB, BN>::NT, 1)
gmm_bwd_wgmma(const bf16* __restrict__ a, const bf16* __restrict__ b,
              bf16* __restrict__ out, int M, int N, int K, int tiles_m,
              int tiles_n, int tiles) {
  namespace wg = wgmma_sm90;
  using KC = BwdCfg<NWG, RB, BN>;
  constexpr int NT = KC::NT, BM = KC::BM, STAGES = KC::STAGES;
  extern __shared__ unsigned char smem_gbw[];
  const uint32_t raw = wg::smem_addr(smem_gbw);
  const uint32_t base = (raw + 1023u) & ~1023u;  // swizzle atoms: 1024 B
  const int tid = threadIdx.x, lane = tid % 32, warp = (tid % 128) / 32;
  const int grp = tid / 128;
  const int nk = (K + 63) / 64;
  const int mine = blockIdx.x < tiles ? (tiles - 1 - blockIdx.x) / gridDim.x + 1
                                      : 0;
  const int total = mine * nk;
  const int lda = DW ? M : K, ldb = DW ? N : K;  // row lengths of a and b
  const size_t a_step = static_cast<size_t>(M) * K;
  const size_t b_step = static_cast<size_t>(N) * K;

  struct Tile {
    size_t e;
    int m0, n0;
  };
  auto tile_of = [&](int t) {  // this block's t-th tile
    const int T = blockIdx.x + t * gridDim.x;
    const int r = T / tiles_n;
    return Tile{static_cast<size_t>(r / tiles_m), (r % tiles_m) * BM,
                (T % tiles_n) * BN};
  };

  // A slab's 16-byte pieces: piece p = tid + i NT of row p / PR at column
  // piece p % PR, where a row holds PR pieces (K-major: a row of M or N,
  // 8 pieces of k; MN-major: a row of k, BM / 8 or BN / 8 pieces).
  int c_t = 0, c_kt = 0;  // the load cursor: slab c_kt of tile c_t
  Tile c_tile{0, 0, 0};
  auto issue = [&](int s) {
    const int k0 = c_kt * 64;
    const uint32_t sA = base + s * KC::STAGE, sB = sA + KC::A_BYTES;
    const bf16* ae = a + c_tile.e * a_step;
    const bf16* be = b + c_tile.e * b_step;
#pragma unroll
    for (int i = 0; i < KC::AI; ++i) {
      const int p = tid + i * NT;
      if constexpr (DW) {  // k row k0 + r, m columns m0 + 8 c ..
        const int r = p / (BM / 8), c = p % (BM / 8), m = c_tile.m0 + 8 * c;
        const bool ok = k0 + r < K && m < M;
        wg::cp_async16(sA + (c / 8) * 8192 + wg::sw128(r, c % 8),
                       ok ? ae + static_cast<size_t>(k0 + r) * lda + m : a,
                       ok);
      } else {  // m row m0 + r, k columns k0 + 8 c ..
        const int r = p / 8, c = p % 8, m = c_tile.m0 + r, k = k0 + 8 * c;
        const bool ok = m < M && k < K;
        wg::cp_async16(sA + (r / 64) * 8192 + wg::sw128(r % 64, c),
                       ok ? ae + static_cast<size_t>(m) * lda + k : a, ok);
      }
    }
#pragma unroll
    for (int i = 0; i < KC::BI; ++i) {
      const int p = tid + i * NT;
      if constexpr (DW) {  // k row k0 + r, n columns n0 + 8 c ..
        const int r = p / (BN / 8), c = p % (BN / 8), n = c_tile.n0 + 8 * c;
        const bool ok = k0 + r < K && n < N;
        wg::cp_async16(sB + (c / 8) * 8192 + wg::sw128(r, c % 8),
                       ok ? be + static_cast<size_t>(k0 + r) * ldb + n : b,
                       ok);
      } else {  // n row n0 + r (a row of w), k columns k0 + 8 c ..
        const int r = p / 8, c = p % 8, n = c_tile.n0 + r, k = k0 + 8 * c;
        const bool ok = n < N && k < K;
        wg::cp_async16(sB + wg::sw128(r, c),
                       ok ? be + static_cast<size_t>(n) * ldb + k : b, ok);
      }
    }
    if (++c_kt == nk) {
      c_kt = 0;
      if (++c_t < mine) c_tile = tile_of(c_t);
    }
  };

  // row block r of this warpgroup: rows (grp RB + r) 64 .. of the tile
  float acc[RB][BN / 2];
#pragma unroll
  for (int r = 0; r < RB; ++r)
#pragma unroll
    for (int j = 0; j < BN / 2; ++j) acc[r][j] = 0.f;
  auto store = [&](const Tile& tl) {
    bf16* oe = out + tl.e * M * static_cast<size_t>(N);
#pragma unroll
    for (int r = 0; r < RB; ++r)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int gm = tl.m0 + (grp * RB + r) * 64 + warp * 16 + lane / 4
                       + 8 * h;
#pragma unroll
        for (int j = 0; j < BN / 32; ++j) {
          const uint4 v = wg::row8_bf16(acc[r], h, j, lane);
          const int gn = tl.n0 + 8 * (4 * j + lane % 4);
          if (gm < M && gn < N)  // N % 8 == 0: the 8 columns are whole
            *reinterpret_cast<uint4*>(oe + static_cast<size_t>(gm) * N + gn) =
                v;
        }
      }
  };

  if (mine > 0) c_tile = tile_of(0);
  wg::ring_prime<STAGES>(total, issue);
  wg::ring_walk<STAGES>(
      mine, nk, issue, [](int, int) {},
      [&](int stage, int) {
        const uint32_t sA = base + stage * KC::STAGE;
        const uint32_t sB = sA + KC::A_BYTES;
#pragma unroll
        for (int ks = 0; ks < 4; ++ks)
#pragma unroll
          for (int r = 0; r < RB; ++r) {
            const uint32_t chunk = sA + (grp * RB + r) * 8192;
            if constexpr (DW)
              wg::mma_ss_n<BN, 1, 1>(acc[r],
                                     wg::desc(chunk + ks * 2048, 8192, 1024),
                                     wg::desc(sB + ks * 2048, 8192, 1024), 1);
            else
              wg::mma_ss_n<BN, 0>(acc[r], wg::desc(chunk + ks * 32, 16, 1024),
                                  wg::desc(sB + ks * 32, 16, 1024), 1);
          }
      },
      [&] {
#pragma unroll
        for (int r = 0; r < RB; ++r) wg::reg_fence(acc[r]);
      },
      [&](int t) {
        store(tile_of(t));
#pragma unroll
        for (int r = 0; r < RB; ++r)
#pragma unroll
          for (int j = 0; j < BN / 2; ++j) acc[r][j] = 0.f;  // the next tile's
      });
}

template <int NWG, int RB, int BN, bool DW>
int launch_bwd_wgmma(const bf16* a, const bf16* b, bf16* out, int E, int M,
                     int N, int K, int sms, cudaStream_t st) {
  using KC = BwdCfg<NWG, RB, BN>;
  const auto kernel = gmm_bwd_wgmma<NWG, RB, BN, DW>;
  static unsigned ready = 0;
  int dev = 0;
  const cudaError_t err =
      wgmma_sm90::with_smem(kernel, KC::SMEM, ready, &dev);
  if (err != cudaSuccess) return err;
  const long long tiles_m = (M + KC::BM - 1) / KC::BM;
  const long long tiles_n = (N + BN - 1) / BN;
  const long long tiles = tiles_m * tiles_n * E;
  if (tiles > (1LL << 31) - 1) return cudaErrorInvalidValue;
  const int grid = static_cast<int>(tiles < sms ? tiles : sms);  // one an SM
  kernel<<<grid, KC::NT, KC::SMEM, st>>>(a, b, out, M, N, K,
                                         static_cast<int>(tiles_m),
                                         static_cast<int>(tiles_n),
                                         static_cast<int>(tiles));
  return cudaGetLastError();
}

// The tile of a product of M rows and N columns on `sms` SMs (one block an
// SM), from the tiles' device times at granite's training shapes on an
// H100 (scripts/gmm_bwd_tiles.py, PERF.md section 6): up to 128 rows, as
// many 64-row warpgroups as cover them, 128 columns wide; above, 256 rows
// (so that at C = 256 one row tile covers dX's rows and each expert's
// weights are read once) by 128 columns on four warpgroups, or, for dX
// where 192-column tiles fill the card in one wave and 128-column ones do
// not (granite's D = 512: 120 tiles against 160 on 132 SMs), 256 x 192 on
// two warpgroups of two 64-row blocks each.  Per byte the four-warpgroup
// tile is the faster one.
template <bool DW>
int launch_bwd_wgmma_for(const bf16* a, const bf16* b, bf16* out, int E,
                         int M, int N, int K, cudaStream_t st) {
  if (M == 0 || N == 0) return cudaSuccess;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess)
    return err;
  if (M <= 64)
    return launch_bwd_wgmma<1, 1, 128, DW>(a, b, out, E, M, N, K, sms, st);
  if (M <= 128)
    return launch_bwd_wgmma<2, 1, 128, DW>(a, b, out, E, M, N, K, sms, st);
  const long long rows = static_cast<long long>(E) * ((M + 255) / 256);
  if (!DW && rows * ((N + 191) / 192) <= sms && rows * ((N + 127) / 128) > sms)
    return launch_bwd_wgmma<2, 2, 192, DW>(a, b, out, E, M, N, K, sms, st);
  return launch_bwd_wgmma<4, 1, 128, DW>(a, b, out, E, M, N, K, sms, st);
}

// One product of the backward: out (E, M, N) = A B per expert.
template <bool A_T, bool B_T>
int launch_bwd(const void* a, const void* b, void* out, int E, int M, int N,
               int K, int lda, int ldb, size_t a_step, size_t b_step,
               int dtype, cudaStream_t st) {
  if (M == 0 || N == 0) return cudaSuccess;
  if (dtype == 0) {
    if ((M + TM - 1) / TM > 65535) return cudaErrorInvalidValue;
    const dim3 grid((N + TN - 1) / TN, (M + TM - 1) / TM, E);
    gmm_bwd_f32<A_T, B_T><<<grid, NT, 0, st>>>(
        static_cast<const float*>(a), static_cast<const float*>(b),
        static_cast<float*>(out), M, N, K, lda, ldb, a_step, b_step);
    return cudaGetLastError();
  }
  if (dtype != 1) return cudaErrorInvalidValue;
  if ((M + MB - 1) / MB > 65535) return cudaErrorInvalidValue;
  // a row of a holds lda elements, of b ldb; a step is a multiple of 8
  // elements when the row is
  const bool vec_a = lda % 8 == 0 && aligned16(a);
  const bool vec_b = ldb % 8 == 0 && aligned16(b);
  const dim3 grid((N + NB - 1) / NB, (M + MB - 1) / MB, E);
  gmm_bwd_tc<A_T, B_T><<<grid, MNT, 0, st>>>(
      static_cast<const bf16*>(a), static_cast<const bf16*>(b),
      static_cast<bf16*>(out), M, N, K, lda, ldb, a_step, b_step, vec_a,
      vec_b);
  return cudaGetLastError();
}

}  // namespace

// The gradient of moe_gmm_fwd: x (E,C,D), w (E,D,F), dy (E,C,F), all
// contiguous, of one dtype (0 = float32, 1 = bfloat16).  dx (E,C,D) = dy
// wᵀ is written when dx is not null, dw (E,D,F) = xᵀ dy when dw is not
// null.  variant (bfloat16): 0 = "mma_sync", 1 = "wgmma", which takes D
// and F multiples of 8 and 16-byte aligned x, w, dy, dx and dw; float32
// takes 0.  Returns a cudaError_t (0 = launched).
extern "C" int moe_gmm_bwd(const void* x, const void* w, const void* dy,
                           void* dx, void* dw, int E, int C, int D, int F,
                           int dtype, int variant, void* stream) {
  if (E < 0 || C < 0 || D < 0 || F < 0 || E > 65535)
    return cudaErrorInvalidValue;
  if (E == 0) return cudaSuccess;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (variant == 1) {
    if (dtype != 1 || D % 8 || F % 8 || !aligned16(x) || !aligned16(w) ||
        !aligned16(dy) || (dx != nullptr && !aligned16(dx)) ||
        (dw != nullptr && !aligned16(dw)))
      return cudaErrorInvalidValue;
    const bf16* xb = static_cast<const bf16*>(x);
    const bf16* wb = static_cast<const bf16*>(w);
    const bf16* db = static_cast<const bf16*>(dy);
    if (dx != nullptr) {  // M = C, N = D, K = F
      const int err = launch_bwd_wgmma_for<false>(
          db, wb, static_cast<bf16*>(dx), E, C, D, F, st);
      if (err != cudaSuccess) return err;
    }
    if (dw != nullptr)  // M = D, N = F, K = C
      return launch_bwd_wgmma_for<true>(xb, db, static_cast<bf16*>(dw), E, D,
                                        F, C, st);
    return cudaSuccess;
  }
  if (variant != 0) return cudaErrorInvalidValue;
  const size_t cd = static_cast<size_t>(C) * D, cf = static_cast<size_t>(C) * F;
  const size_t df = static_cast<size_t>(D) * F;
  if (dx != nullptr) {  // (C x F) (F x D): A = dy [c][f], B = w [d][f]
    const int err = launch_bwd<false, true>(dy, w, dx, E, C, D, F, F, F, cf,
                                            df, dtype, st);
    if (err != cudaSuccess) return err;
  }
  if (dw != nullptr)  // (D x C) (C x F): A = x [c][d], B = dy [c][f]
    return launch_bwd<true, false>(x, dy, dw, E, D, F, C, D, F, cd, cf,
                                   dtype, st);
  return cudaSuccess;
}
