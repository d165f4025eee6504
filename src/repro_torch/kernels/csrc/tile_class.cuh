// The flash kernels' tile rule (forward: flash_attention.cu's flash_fwd_tc
// and flash_fwd_wgmma; backward: flash_attention_bwd.cu's flash_bwd_wgmma).
//
// A KV tile is judged once against a block of query rows from four
// numbers: the smallest and largest valid kv position in the tile (kv_pos
// >= 0; rows past the end count as holes), its count of holes, and the
// smallest and largest q position of the block's rows (rows past the end
// of the problem are left out).  The tile is
//   skipped    when it has no valid key, or, causal, its smallest valid
//              key lies after the block's last query: no pair is visible;
//   mask-free  when it has no hole and, causal, its largest key lies at or
//              before the block's first query: every pair is visible;
//   masked     otherwise (each pair is tested).
// kernels/flash_attention.py::tile_class states the same rule for the
// CPU tests.  The numbers come from warp reductions, not a serial scan:
// every lane of the warp calls the reductions.

#pragma once

#include <climits>

namespace flash_tiles {

enum TileClass { kSkip = 0, kMasked = 1, kFree = 2 };
struct Span { int lo, hi, holes; };
struct QRange { int lo, hi; };

__device__ __forceinline__ Span span_of(int p) {
  return p >= 0 ? Span{p, p, 0} : Span{INT_MAX, INT_MIN, 1};
}
__device__ __forceinline__ Span merge(Span a, Span b) {
  return Span{min(a.lo, b.lo), max(a.hi, b.hi), a.holes + b.holes};
}
__device__ __forceinline__ Span warp_span(Span s) {
#pragma unroll
  for (int off = 16; off > 0; off /= 2) {
    s.lo = min(s.lo, __shfl_xor_sync(0xffffffffu, s.lo, off));
    s.hi = max(s.hi, __shfl_xor_sync(0xffffffffu, s.hi, off));
    s.holes += __shfl_xor_sync(0xffffffffu, s.holes, off);
  }
  return s;
}
__device__ __forceinline__ QRange qrange_of(int p, bool valid) {
  return valid ? QRange{p, p} : QRange{INT_MAX, INT_MIN};
}
__device__ __forceinline__ QRange merge(QRange a, QRange b) {
  return QRange{min(a.lo, b.lo), max(a.hi, b.hi)};
}
__device__ __forceinline__ QRange warp_qrange(QRange r) {
#pragma unroll
  for (int off = 16; off > 0; off /= 2) {
    r.lo = min(r.lo, __shfl_xor_sync(0xffffffffu, r.lo, off));
    r.hi = max(r.hi, __shfl_xor_sync(0xffffffffu, r.hi, off));
  }
  return r;
}
__device__ __forceinline__ int tile_class(Span s, QRange q, int causal) {
  if (s.lo == INT_MAX || (causal && s.lo > q.hi)) return kSkip;
  if (s.holes == 0 && (!causal || s.hi <= q.lo)) return kFree;
  return kMasked;
}

}  // namespace flash_tiles
