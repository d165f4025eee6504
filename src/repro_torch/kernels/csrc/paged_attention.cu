// Paged decode attention for Hopper (sm_90a), CUDA C++: attention of each
// slot's last S query rows through its block table into a shared KV pool.
//
// Replaces: src/repro/kernels/paged_attention.py::paged_flash_decode (the
// Pallas TPU kernel).  Contract: jnp_impl.paged_decode_attention_lengths
// (plain twin: plain.paged_decode_attention_ref).
//
//   q (B,S,Hq,D), k_pool (N,bs,Hkv,D), v_pool (N,bs,Hkv,Dv), tables (B,nb)
//   int32, lengths (B,) int32  ->  out (B,S,Hq,Dv) in q's type.  The tile
//   widths (TD, TDv): (64,64), (128,128), (256,256), (192,128), and
//   (576,512) in bf16 (MLA's absorbed decode: one latent KV head, the key
//   [ckv | kr], the value ckv).  A call at narrower widths (D, Dv)
//   (multiples of 8, the Pallas kernel takes any) runs at the tile the
//   host names (paged_attention.py::tile_dims) with its columns past D and
//   Dv zero in shared memory: their loads are skipped (cp.async with a
//   source size of 0 fills zeros), so the zero columns add nothing to the
//   products, and output columns past Dv are never stored.  The pools are
//   read in place at their own row widths: no pool is padded or copied.
//   Query row r of slot b sits at position lengths[b] - S + r and sees the
//   positions p <= that one; position p of slot b lives in pool block
//   tables[b, p / bs] at offset p % bs.  Softcap is applied to the scaled
//   logits before the mask; a row that sees no key gives 0.
//
// What bounds it on an H100: a decode step reads every visible K/V row of
// its slot once and does 4 * D flops per (query row, key) pair, 2-4 query
// rows per KV row at the gemma2-2b / mistral-7b GQA widths: about 2 flops
// a byte, far below the 295 where the tensor cores would be the limit, so
// by the roofline it is bound by bytes.  At the main-path shape the call
// reads ~4.4 MB, ~1.3 us at 3.35 TB/s: about what the card must have in
// flight at once to cover one memory round trip (Little's law), so in
// practice it is bound by latency: how many bytes each block keeps in
// flight, and how many dependent steps (length, table, K/V, products,
// merge) stand between a block's start and its output.
//
// Design:
// * One thread block owns one (slot, KV head, split) and takes all G*S
//   query rows of that KV head together (rows ordered (s, g), q head =
//   hk*G + g), so each visible K/V row is read once per KV head.  More than
//   RMAX rows (a wide fused or speculative step, or MLA's group of 128
//   query heads on its one latent head) take several row groups on grid
//   x, each reading the slot's K/V rows again (at MLA's decode, 16 row
//   groups a slot: the repeated reads of a ~1.2 MB slot mostly hit L2).
// * Split by the slot's own length: the positions below min(lengths[b],
//   nb * bs) are cut into nsplit chunks of whole TK-position tiles, so no
//   split walks more than ceil(len / nsplit) positions rounded up to a
//   tile, however wide the table is (paged_attention.py::split_plan states
//   the same plan; the host picks nsplit from shapes alone).  Table entries
//   at or past lengths[b] are never read.
// * K/V in flight: a tile's table entries are resolved once into shared
//   memory (a refill's entries are loaded while the current tile
//   computes), then its K and V rows (D contiguous elements of one head,
//   128-1024 bytes) go as 16-byte cp.async.cg copies into a ring of
//   STAGES tiles (RING_BYTES of dynamic shared memory), one commit group a
//   tile, positions past the chunk zero-filled.  All STAGES tiles are in
//   flight before the first tile's scores start: at the main-path shapes
//   that is the whole chunk.
// * Products from shared memory.  bf16: both on the tensor cores with
//   mma.sync m16n8k16, the block's query rows on N: S^T = K Q^T (K by
//   ldmatrix from XOR-swizzled rows, each warp 16 keys by half the head
//   dim) and O^T += V^T P^T (V by ldmatrix.trans, each warp D / 4
//   columns), P rounded to bf16 as the flash kernels do.  float32 (tests)
//   on the CUDA cores: 8 threads a key with 16-byte reads and a
//   reduce-scatter of the rows' dots, then each thread one 16-byte chunk
//   of V's columns for every row.  The online softmax (scale, softcap,
//   mask, running max and sum per row, f32) is one warp per row, lane =
//   key.
// * Merge in the cluster: the nsplit blocks of one (row group, KV head,
//   slot) are one thread block cluster (at most MAX_SPLITS).  Each block
//   owns every nsplit-th float4 of the output rows; each pushes its
//   unscaled O for every float4 into the owner's shared memory, and its
//   running max and sum to every block, by remote stores (distributed
//   shared memory), then after one cluster barrier merges what it owns
//   from its own shared memory and writes out.  No workspace, no second
//   kernel, no remote load; a split that saw no key has sum 0 and weighs
//   nothing.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cstdint>
#include <type_traits>

#include "split_kv.cuh"    // NEG, store4
#include "wgmma_sm90.cuh"  // cp_async16, cp_async_commit, cp_async_wait

namespace {

namespace cg = cooperative_groups;
using mma_sm80::ldsm_x4;
using mma_sm80::ldsm_x4_t;
using mma_sm80::mma16816;
using mma_sm80::smem_addr;
using wgmma_sm90::cp_async16;
using wgmma_sm90::cp_async_commit;
using wgmma_sm90::cp_async_wait;
using split_kv::NEG;
using split_kv::store4;
using bf16 = __nv_bfloat16;

constexpr int NT = 128;    // threads per block
constexpr int NW = NT / 32;
constexpr int TK = 32;     // positions per tile (one per lane in the softmax)
constexpr int RMAX = 8;    // query rows per block (the n of m16n8k16)
constexpr int TPK = 8;     // threads per key in the float32 scores
static_assert(TPK == RMAX, "thread kj of a key keeps row kj's score");
constexpr int RING_BYTES = 65536;  // the K/V ring: STAGES tiles of K and V
constexpr int MIN_STAGES = 2;
constexpr int MAX_STAGES = 8;
constexpr int MAX_SPLITS = 16;  // blocks a cluster may hold on an H100
constexpr int SP = TK + 4;  // score row stride (floats): conflict-free mma stores
constexpr int PS = TK + 8;  // bf16 probability row stride: conflict-free B loads
constexpr unsigned FULL = 0xffffffffu;

constexpr int clampi(int x, int lo, int hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}

template <typename T, int D, int DV>
struct Cfg {
  // bf16 runs both products on the tensor cores (mma.sync m16n8k16, keys
  // or head-dim columns on M, the block's query rows on N), float32 on the
  // CUDA cores
  static constexpr bool TC = std::is_same<T, bf16>::value;
  static constexpr int EPC = 16 / static_cast<int>(sizeof(T));  // per chunk
  static constexpr int CPR = D / EPC;           // 16-byte chunks a K row
  static constexpr int CPRV = DV / EPC;         // ... a V row
  static constexpr int QS = D + (TC ? 8 : 0);   // q row stride (elements)
  static constexpr int TILE = TK * (D + DV);    // K and V elements a stage
  static constexpr int STAGES = clampi(
      RING_BYTES / (TILE * static_cast<int>(sizeof(T))), MIN_STAGES,
      MAX_STAGES);
  static constexpr int KPT = TK * TPK / NT;     // float32: keys a thread scores
  static constexpr int CPT = CPR / TPK;         // float32: chunks a thread a key
  static constexpr int NG = NT / CPRV;          // float32: P V key groups
  static constexpr int MT = DV / 16 / NW;       // bf16: P V column tiles a warp
  static constexpr size_t RING = static_cast<size_t>(STAGES) * TILE * sizeof(T);
  static constexpr size_t SMEM = RING + RMAX * QS * sizeof(T)
                                 + 2 * RMAX * SP * 4 + RMAX * PS * 2
                                 + 3 * RMAX * 4 + STAGES * TK * 4;
  static_assert(CPR % TPK == 0 && NT % CPRV == 0 && KPT >= 1, "tiling");
  static_assert(SMEM % 16 == 0, "the merge's receive area follows");
  static_assert(!TC || (TK == 32 && NW == 4 && MT >= 1), "bf16 warp tiling");
  static_assert(static_cast<size_t>(TC ? 1 : NG) * RMAX * DV * 4 <= RING,
                "the partial output reuses the ring");
};

// 16-byte chunk `ch` of ring row `row`: bf16 rows are XOR-swizzled so that
// ldmatrix's eight rows of one chunk column hit eight bank groups.
template <bool TC>
__device__ __forceinline__ int swz(int row, int ch) {
  return TC ? (ch ^ (row & 7)) : ch;
}

__device__ __forceinline__ void unpack(uint4 u, float (&f)[4]) {
  f[0] = __uint_as_float(u.x);
  f[1] = __uint_as_float(u.y);
  f[2] = __uint_as_float(u.z);
  f[3] = __uint_as_float(u.w);
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

// The cluster barrier in two halves: arrive (release: this thread's earlier
// shared-memory writes, its peers' included, become visible to the
// waiters), then wait (acquire).
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// Block (row group, hk, b * nsplit + split); the nsplit blocks of one
// (row group, hk, b) form one thread block cluster and merge their
// partials through distributed shared memory.
// D, DV: the tile widths; with PAD the call's own widths are dk <= D and
// dvo <= DV (the pools' and q's row widths, out's row width), else D, DV.
template <typename T, int D, int DV, bool PAD>
__global__ void __launch_bounds__(NT)
paged_decode(const T* __restrict__ q, const T* __restrict__ kp,
             const T* __restrict__ vp, const int* __restrict__ tables,
             const int* __restrict__ lengths, T* __restrict__ out, int S,
             int Hq, int Hkv, int bs, int nb, float scale, float softcap,
             int nsplit, int dk_arg, int dv_arg) {
  using C = Cfg<T, D, DV>;
  constexpr bool TC = C::TC;
  constexpr int EPC = C::EPC, CPR = C::CPR, CPRV = C::CPRV, QS = C::QS;
  constexpr int STAGES = C::STAGES;
  const int dk = PAD ? dk_arg : D;     // row widths in global memory
  const int dvo = PAD ? dv_arg : DV;
  extern __shared__ __align__(16) unsigned char smem[];
  T* ring = reinterpret_cast<T*>(smem);  // [STAGES][K [TK][D] | V [TK][DV]]
  T* Qs = ring + STAGES * C::TILE;                   // [RMAX][QS]
  float* Ss = reinterpret_cast<float*>(Qs + RMAX * QS);  // [2][RMAX][SP]
  bf16* Pb = reinterpret_cast<bf16*>(Ss + 2 * RMAX * SP);  // [RMAX][PS]
  float* m_s = reinterpret_cast<float*>(Pb + RMAX * PS);
  float* l_s = m_s + RMAX;
  float* corr_s = l_s + RMAX;
  int* rows_s = reinterpret_cast<int*>(corr_s + RMAX);  // [STAGES][TK]

  cluster_arrive_relaxed();  // a peer's shared memory is written only after
                             // the matching wait: every block has started
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int G = Hq / Hkv;
  const int r0 = blockIdx.x * RMAX;
  const int nr = min(RMAX, S * G - r0);
  const int hk = blockIdx.y;
  const int b = blockIdx.z / nsplit;
  const int split = blockIdx.z % nsplit;
  const int len = lengths[b];
  // this split's positions [p_lo, p_hi) (split_plan in paged_attention.py)
  const int L = min(max(len, 0), nb * bs);
  const int chunk = ((L + nsplit - 1) / nsplit + TK - 1) / TK * TK;
  const int p_lo = min(L, split * chunk);
  const int p_hi = min(L, p_lo + chunk);
  const int ntiles = (p_hi - p_lo + TK - 1) / TK;
  const int* tbl = tables + static_cast<size_t>(b) * nb;

  // pool row (block * bs + offset) of position i of tile t, -1 past p_hi
  auto row_of = [&](int t, int i) {
    const int p = p_lo + t * TK + i;
    return p < p_hi ? tbl[p / bs] * bs + p % bs : -1;
  };
  // K and V rows of the tile whose rows sit in rows_s[slot] -> ring[slot];
  // rows past the tile's keys are zero-filled (the products read them)
  auto issue = [&](int slot) {
    T* kd = ring + slot * C::TILE;
    T* vd = kd + TK * D;
    const int* rw = rows_s + slot * TK;
    for (int e = tid; e < TK * CPR; e += NT) {
      const int c = e / CPR, ch = e % CPR;
      const int row = rw[c];
      const bool ok = row >= 0 && (!PAD || ch * EPC < dk);
      const size_t off = !ok ? 0
          : (static_cast<size_t>(row) * Hkv + hk) * dk + ch * EPC;
      cp_async16(smem_addr(kd + c * D + swz<TC>(c, ch) * EPC), kp + off, ok);
    }
    for (int e = tid; e < TK * CPRV; e += NT) {
      const int c = e / CPRV, ch = e % CPRV;
      const int row = rw[c];
      const bool ok = row >= 0 && (!PAD || ch * EPC < dvo);
      const size_t off = !ok ? 0
          : (static_cast<size_t>(row) * Hkv + hk) * dvo + ch * EPC;
      cp_async16(smem_addr(vd + c * DV + swz<TC>(c, ch) * EPC), vp + off, ok);
    }
  };

  for (int i = tid; i < STAGES * TK; i += NT)
    rows_s[i] = i / TK < ntiles ? row_of(i / TK, i % TK) : -1;
  for (int e = tid; e < nr * CPR; e += NT) {  // q joins the first group
    const int r = e / CPR, ch = e % CPR;
    const int rho = r0 + r, s = rho / G, g = rho % G;
    const bool ok = !PAD || ch * EPC < dk;
    cp_async16(smem_addr(Qs + r * QS + ch * EPC),
               q + (ok ? ((static_cast<size_t>(b) * S + s) * Hq + hk * G + g)
                             * dk + ch * EPC
                       : 0),
               ok);
  }
  for (int i = tid; i < RMAX * PS / 2; i += NT)  // rows past nr stay 0
    reinterpret_cast<uint32_t*>(Pb)[i] = 0u;
  if (tid < RMAX) {
    m_s[tid] = NEG;
    l_s[tid] = 0.f;
    corr_s[tid] = 1.f;
  }
  __syncthreads();  // rows_s
#pragma unroll
  for (int t = 0; t < STAGES; ++t) {
    if (t < ntiles) issue(t);
    cp_async_commit();
  }

  // bf16: out^T fragments (columns on M, rows on N) of MT column tiles;
  // float32: RMAX rows x one chunk of columns, keys dealt round NG groups
  float acc[TC ? C::MT : RMAX][TC ? 4 : EPC];
#pragma unroll
  for (int i = 0; i < (TC ? C::MT : RMAX); ++i)
#pragma unroll
    for (int e = 0; e < (TC ? 4 : EPC); ++e) acc[i][e] = 0.f;
  const int g4 = lane >> 2, t4 = lane & 3;      // mma fragment coordinates
  const int kj = tid % TPK, key0 = tid / TPK;   // float32 scores
  const int vg = tid / CPRV, vch = tid % CPRV;  // float32 P V

  for (int t = 0; t < ntiles; ++t) {
    const int slot = t % STAGES;
    const T* Ks = ring + slot * C::TILE;
    const T* Vs = Ks + TK * D;
    const int p0 = p_lo + t * TK;
    const int nk = min(TK, p_hi - p0);
    const bool refill = t + STAGES < ntiles;
    int next_row = -1;  // loaded now, stored once this tile's softmax is done
    if (refill && tid < TK) next_row = row_of(t + STAGES, tid);
    cp_async_wait<STAGES - 1>();  // tile t has landed (this thread's part)
    __syncthreads();

    // ---- raw scores q_r . k_c into Ss ----
    if constexpr (TC) {
      // warp w: keys 16 (w & 1) .. +15, half (w >> 1) of the head dim
      constexpr int KS = D / 32;
      const int mt = warp & 1, kh = warp >> 1;
      float c4[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int s = 0; s < KS; ++s) {
        const int ks = kh * KS + s;
        const int key = mt * 16 + ((lane >> 3) & 1) * 8 + (lane & 7);
        uint32_t a[4];
        ldsm_x4(a, Ks + key * D + swz<TC>(key, ks * 2 + (lane >> 4)) * 8);
        const T* qr = Qs + g4 * QS + ks * 16 + 2 * t4;
        mma16816(c4, a, *reinterpret_cast<const uint32_t*>(qr),
                 *reinterpret_cast<const uint32_t*>(qr + 8));
      }
      float* sp = Ss + kh * RMAX * SP + mt * 16 + g4;
      sp[2 * t4 * SP] = c4[0];
      sp[(2 * t4 + 1) * SP] = c4[1];
      sp[2 * t4 * SP + 8] = c4[2];
      sp[(2 * t4 + 1) * SP + 8] = c4[3];
    } else {
      float dot[RMAX][C::KPT];
#pragma unroll
      for (int r = 0; r < RMAX; ++r)
#pragma unroll
        for (int kk = 0; kk < C::KPT; ++kk) dot[r][kk] = 0.f;
#pragma unroll
      for (int i = 0; i < C::CPT; ++i) {
        const int col = (kj + TPK * i) * EPC;
        float kf[C::KPT][EPC];
#pragma unroll
        for (int kk = 0; kk < C::KPT; ++kk)
          unpack(*reinterpret_cast<const uint4*>(
                     Ks + (key0 + kk * (NT / TPK)) * D + col), kf[kk]);
#pragma unroll
        for (int r = 0; r < RMAX; ++r) {
          if (r < nr) {
            float qf[EPC];
            unpack(*reinterpret_cast<const uint4*>(Qs + r * QS + col), qf);
#pragma unroll
            for (int kk = 0; kk < C::KPT; ++kk)
#pragma unroll
              for (int e = 0; e < EPC; ++e) dot[r][kk] += qf[e] * kf[kk][e];
          }
        }
      }
      // sum each (row, key) over the key's TPK threads, reduce-scatter:
      // thread kj ends with row kj's sums
#pragma unroll
      for (int kk = 0; kk < C::KPT; ++kk) {
#pragma unroll
        for (int h = RMAX / 2; h > 0; h /= 2) {
          const bool up = kj & h;
#pragma unroll
          for (int r = 0; r < h; ++r) {
            const float give = up ? dot[r][kk] : dot[r + h][kk];
            const float keep = up ? dot[r + h][kk] : dot[r][kk];
            dot[r][kk] = keep + __shfl_xor_sync(FULL, give, h);
          }
        }
        Ss[kj * SP + key0 + kk * (NT / TPK)] = dot[0][kk];
      }
    }
    __syncthreads();
    // ---- scale, cap, mask; online softmax: one warp per row, lane = key --
    for (int r = warp; r < nr; r += NW) {
      const int q_pos = len - S + (r0 + r) / G;
      const bool ok = lane < nk && p0 + lane <= q_pos;
      float x = Ss[r * SP + lane];
      if constexpr (TC) x += Ss[(RMAX + r) * SP + lane];
      x *= scale;
      if (softcap != 0.f) x = softcap * tanhf(x / softcap);
      x = ok ? x : NEG;
      const float m_old = m_s[r];
      const float m_new = fmaxf(m_old, warp_max(x));
      const float corr = expf(m_old - m_new);
      const float pr = ok ? expf(x - m_new) : 0.f;
      const float sum = warp_sum(pr);
      if constexpr (TC) Pb[r * PS + lane] = __float2bfloat16_rn(pr);
      else Ss[r * SP + lane] = pr;
      if (lane == 0) {
        m_s[r] = m_new;
        l_s[r] = l_s[r] * corr + sum;
        corr_s[r] = corr;
      }
    }
    if (refill && tid < TK) rows_s[slot * TK + tid] = next_row;
    __syncthreads();
    // ---- O = O * corr + P V ----
    if constexpr (TC) {
      // out^T (columns x rows) += V^T P^T: warp w takes column tiles
      // w * MT .. +MT-1, both 16-key steps of the tile
      const float lo = corr_s[2 * t4], hi = corr_s[2 * t4 + 1];
#pragma unroll
      for (int i = 0; i < C::MT; ++i) {
        acc[i][0] *= lo; acc[i][1] *= hi; acc[i][2] *= lo; acc[i][3] *= hi;
      }
#pragma unroll
      for (int ks = 0; ks < TK / 16; ++ks) {
        const bf16* pr = Pb + g4 * PS + ks * 16 + 2 * t4;
        const uint32_t b0 = *reinterpret_cast<const uint32_t*>(pr);
        const uint32_t b1 = *reinterpret_cast<const uint32_t*>(pr + 8);
        const int c = ks * 16 + (lane >> 4) * 8 + (lane & 7);
#pragma unroll
        for (int i = 0; i < C::MT; ++i) {
          uint32_t a[4];
          ldsm_x4_t(a, Vs + c * DV
                       + swz<TC>(c, (warp * C::MT + i) * 2 + ((lane >> 3) & 1))
                             * 8);
          mma16816(acc[i], a, b0, b1);
        }
      }
    } else {
#pragma unroll
      for (int r = 0; r < RMAX; ++r) {
        if (r < nr) {
          const float cr = corr_s[r];
#pragma unroll
          for (int e = 0; e < EPC; ++e) acc[r][e] *= cr;
        }
      }
#pragma unroll 4
      for (int c = vg; c < nk; c += C::NG) {
        float vf[EPC];
        unpack(*reinterpret_cast<const uint4*>(Vs + c * DV + vch * EPC), vf);
#pragma unroll
        for (int r = 0; r < RMAX; ++r) {
          if (r < nr) {
            const float pr = Ss[r * SP + c];
#pragma unroll
            for (int e = 0; e < EPC; ++e) acc[r][e] += pr * vf[e];
          }
        }
      }
    }
    __syncthreads();  // every read of this slot is done
    if (refill) issue(slot);
    cp_async_commit();
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring is free; the last tile's m_s / l_s

  // ---- this split's unscaled O into the ring: red[r][d] ----
  float* red = reinterpret_cast<float*>(smem);
  if constexpr (TC) {
    const int r = 2 * t4;
#pragma unroll
    for (int i = 0; i < C::MT; ++i) {
      const int d = (warp * C::MT + i) * 16 + g4;
      if (r < nr) {
        red[r * DV + d] = acc[i][0];
        red[r * DV + d + 8] = acc[i][2];
      }
      if (r + 1 < nr) {
        red[(r + 1) * DV + d] = acc[i][1];
        red[(r + 1) * DV + d + 8] = acc[i][3];
      }
    }
  } else {  // the key groups' sums meet in the ring, then in red[0]
#pragma unroll
    for (int r = 0; r < RMAX; ++r) {
      if (r < nr) {
        float* dst = red + (vg * RMAX + r) * DV + vch * EPC;
        store4(dst, make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]));
      }
    }
    __syncthreads();
    for (int e = tid; e < nr * (DV / 4); e += NT) {
      const int r = e / (DV / 4), d = (e % (DV / 4)) * 4;
      float4 o = *reinterpret_cast<const float4*>(red + r * DV + d);
#pragma unroll
      for (int g = 1; g < C::NG; ++g) {
        const float4 x =
            *reinterpret_cast<const float4*>(red + (g * RMAX + r) * DV + d);
        o.x += x.x; o.y += x.y; o.z += x.z; o.w += x.w;
      }
      store4(red + r * DV + d, o);
    }
  }

  // ---- merge the cluster's nsplit partials (O, m, l) and write out ----
  // out = sum_j e^(m_j - M) O_j / sum_j e^(m_j - M) l_j, M = max_j m_j; a
  // row no split saw (every l_j = 0) gives 0.  Float4 e of the rows'
  // columns belongs to block e % nsplit: each block pushes its partial of
  // every float4 into the owner's receive area and its m, l to every
  // block (remote stores, no round trip), then, after one cluster
  // barrier, merges what it owns from its own shared memory.
  __syncthreads();  // red is whole
  cg::cluster_group cluster = cg::this_cluster();
  float4* recv = reinterpret_cast<float4*>(smem + C::SMEM);
  float* m_recv = reinterpret_cast<float*>(
      recv + min(RMAX, S * G) * (DV / 4) + MAX_SPLITS);  // [MAX_SPLITS][RMAX]
  float* l_recv = m_recv + MAX_SPLITS * RMAX;
  // float4 e of the rows' first dvo columns: row e / (dvo / 4)
  const int units = nr * (dvo / 4);
  const int slots = (units + nsplit - 1) / nsplit;  // float4s a block owns
  cluster_wait();  // every block of the cluster has started
  for (int e = tid; e < units; e += NT)
    *cluster.map_shared_rank(recv + split * slots + e / nsplit, e % nsplit) =
        *reinterpret_cast<const float4*>(
            PAD ? red + (e / (dvo / 4)) * DV + (e % (dvo / 4)) * 4
                : red + e * 4);
  for (int i = tid; i < nsplit * nr; i += NT) {
    const int k = i / nr, r = i % nr;
    *cluster.map_shared_rank(m_recv + split * RMAX + r, k) = m_s[r];
    *cluster.map_shared_rank(l_recv + split * RMAX + r, k) = l_s[r];
  }
  cluster_arrive();
  cluster_wait();  // every push into this block has landed
  for (int u = tid; split + u * nsplit < units; u += NT) {
    const int e = split + u * nsplit;
    const int r = e / (dvo / 4), d = (e % (dvo / 4)) * 4;
    float mj[MAX_SPLITS], lj[MAX_SPLITS];  // unrolled: the reads overlap
    float4 x[MAX_SPLITS];
    float M = NEG;
#pragma unroll
    for (int j = 0; j < MAX_SPLITS; ++j) {
      mj[j] = j < nsplit ? m_recv[j * RMAX + r] : NEG;
      lj[j] = j < nsplit ? l_recv[j * RMAX + r] : 0.f;
      if (lj[j] > 0.f) x[j] = recv[j * slots + u];
      M = fmaxf(M, mj[j]);
    }
    float l = 0.f;
    float4 o = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int j = 0; j < MAX_SPLITS; ++j) {
      if (lj[j] > 0.f) {
        const float w = expf(mj[j] - M);
        l += w * lj[j];
        o.x += w * x[j].x; o.y += w * x[j].y;
        o.z += w * x[j].z; o.w += w * x[j].w;
      }
    }
    const float inv = l > 0.f ? 1.f / l : 0.f;
    const int rho = r0 + r, s = rho / G, h = hk * G + rho % G;
    store4(out + ((static_cast<size_t>(b) * S + s) * Hq + h) * dvo + d,
           make_float4(o.x * inv, o.y * inv, o.z * inv, o.w * inv));
  }
}

// The receive area of the merge: a float4 of every split for each float4
// of the block's rows' columns that the block owns, and every split's m
// and l for each row.
template <int DV>
constexpr size_t recv_bytes(int rows) {
  return (static_cast<size_t>(rows) * (DV / 4) + MAX_SPLITS) * 16
         + 2 * MAX_SPLITS * RMAX * 4;
}

template <typename T, int D, int DV, bool PAD>
int launch(const void* q, const void* kp, const void* vp, const int* tables,
           const int* lengths, void* out, int B, int S, int Hq, int Hkv,
           int bs, int nb, float scale, float softcap, int nsplit, int dk,
           int dv, cudaStream_t stream) {
  using C = Cfg<T, D, DV>;
  const auto kernel = paged_decode<T, D, DV, PAD>;
  const size_t smem = C::SMEM + recv_bytes<DV>(min(RMAX, S * (Hq / Hkv)));
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(C::SMEM + recv_bytes<DV>(RMAX)));
  if (err == cudaSuccess && nsplit > 8)  // past the portable cluster size
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((S * (Hq / Hkv) + RMAX - 1) / RMAX, Hkv, B * nsplit);
  cfg.blockDim = dim3(NT);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute cluster[1];
  cluster[0].id = cudaLaunchAttributeClusterDimension;
  cluster[0].val.clusterDim.x = 1;
  cluster[0].val.clusterDim.y = 1;
  cluster[0].val.clusterDim.z = nsplit;
  cfg.attrs = cluster;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, static_cast<const T*>(q),
                           static_cast<const T*>(kp),
                           static_cast<const T*>(vp), tables, lengths,
                           static_cast<T*>(out), S, Hq, Hkv, bs, nb, scale,
                           softcap, nsplit, dk, dv);
  return err != cudaSuccess ? err : cudaGetLastError();
}

// (D, Dv) the call's widths, (tD, tDv) the tile's: equal, or D <= tD and
// Dv <= tDv, both multiples of 8 (16-byte rows in either type), at one of
// the four tiles below 576 (the padded instantiations).
template <typename T>
int launch_d(int D, int Dv, int tD, int tDv, const void* q, const void* kp,
             const void* vp, const int* tables, const int* lengths, void* out,
             int B, int S, int Hq, int Hkv, int bs, int nb, float scale,
             float softcap, int nsplit, cudaStream_t st) {
  const bool pad = D != tD || Dv != tDv;
  if (pad && (D <= 0 || Dv <= 0 || D > tD || Dv > tDv || D % 8 || Dv % 8))
    return cudaErrorInvalidValue;
#define PAGED(DK, DV)                                                         \
  if (tD == DK && tDv == DV)                                                  \
    return pad ? launch<T, DK, DV, true>(q, kp, vp, tables, lengths, out, B,  \
                                         S, Hq, Hkv, bs, nb, scale, softcap,  \
                                         nsplit, D, Dv, st)                   \
               : launch<T, DK, DV, false>(q, kp, vp, tables, lengths, out, B, \
                                          S, Hq, Hkv, bs, nb, scale, softcap, \
                                          nsplit, D, Dv, st);
  PAGED(64, 64)
  PAGED(128, 128)
  PAGED(256, 256)
  PAGED(192, 128)
#undef PAGED
  if constexpr (std::is_same<T, bf16>::value) {
    if (!pad && D == 576 && Dv == 512)
      return launch<T, 576, 512, false>(q, kp, vp, tables, lengths, out, B, S,
                                        Hq, Hkv, bs, nb, scale, softcap,
                                        nsplit, D, Dv, st);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16; the tile (tD, tDv) = (64, 64), (128,
// 128), (256, 256), (192, 128), and (576, 512) in bfloat16, from
// paged_attention.py::tile_dims, and the call's widths (D, Dv) at most the
// tile's; nsplit (1 to MAX_SPLITS) from paged_attention.py::num_splits.
// Returns a cudaError_t (0 = launched).
extern "C" int paged_decode_fwd(const void* q, const void* k_pool,
                                const void* v_pool, const int* tables,
                                const int* lengths, void* out, int B, int S,
                                int Hq, int Hkv, int D, int Dv, int tD,
                                int tDv, int bs, int nb, float scale,
                                float softcap, int nsplit, int dtype,
                                void* stream) {
  if (Hkv <= 0 || Hq % Hkv != 0 || bs <= 0 || nb <= 0 || nsplit < 1 ||
      nsplit > MAX_SPLITS)
    return cudaErrorInvalidValue;
  if (B == 0 || S == 0) return cudaSuccess;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_d<float>(D, Dv, tD, tDv, q, k_pool, v_pool, tables, lengths,
                           out, B, S, Hq, Hkv, bs, nb, scale, softcap, nsplit,
                           st);
  if (dtype == 1)
    return launch_d<__nv_bfloat16>(D, Dv, tD, tDv, q, k_pool, v_pool, tables,
                                   lengths, out, B, S, Hq, Hkv, bs, nb, scale,
                                   softcap, nsplit, st);
  return cudaErrorInvalidValue;
}
