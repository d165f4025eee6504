// Split-KV (flash-decoding) merge shared by the attention kernels under
// csrc/: a kernel that cuts the key axis into nsplit chunks writes each
// chunk's normalised partial output and its lse to a float32 workspace,
// and combine_splits merges the partials of every output row exactly
// through their lse (the merge of jnp_impl.combine_attention_partials).
//
// Workspace layout, for `rows` output rows of D columns:
//   o_part   (nsplit, rows, D)  float32
//   lse_part (nsplit, rows)     float32, -1e30 for a chunk that saw no key

#pragma once

#include <cuda_bf16.h>
#include <cstdint>

namespace split_kv {

constexpr float NEG = -1e30f;

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ void store4(float* p, float4 x) {
  *reinterpret_cast<float4*>(p) = x;
}

__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 x) {
  __nv_bfloat162 a = __floats2bfloat162_rn(x.x, x.y);
  __nv_bfloat162 b = __floats2bfloat162_rn(x.z, x.w);
  uint2 raw;
  raw.x = *reinterpret_cast<uint32_t*>(&a);
  raw.y = *reinterpret_cast<uint32_t*>(&b);
  *reinterpret_cast<uint2*>(p) = raw;
}

// Merge the nsplit partials of one output row (one block per row, one
// thread per 4 columns: launch with D / 4 threads or more).  A partial
// that saw no key has lse -1e30 and weighs nothing; a row no partial saw
// gets 0 and lse -1e30.  `lse` may be null when the caller needs none.
template <typename T>
__global__ void combine_splits(const float* __restrict__ o_part,
                               const float* __restrict__ lse_part,
                               T* __restrict__ out, float* __restrict__ lse,
                               int rows, int D, int nsplit) {
  const int row = blockIdx.x;
  float m = NEG;
  for (int i = 0; i < nsplit; ++i)
    m = fmaxf(m, lse_part[static_cast<size_t>(i) * rows + row]);
  float l = 0.f;
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  const int d = threadIdx.x * 4;
  for (int i = 0; i < nsplit; ++i) {
    const size_t pr = static_cast<size_t>(i) * rows + row;
    const float li = lse_part[pr];
    if (li <= NEG * 0.5f) continue;
    const float w = expf(li - m);
    l += w;
    if (d < D) {
      const float4 o = load4(o_part + pr * D + d);
      acc.x += w * o.x; acc.y += w * o.y; acc.z += w * o.z; acc.w += w * o.w;
    }
  }
  if (d < D) {
    float4 o = make_float4(0.f, 0.f, 0.f, 0.f);
    if (l > 0.f) o = make_float4(acc.x / l, acc.y / l, acc.z / l, acc.w / l);
    store4(out + static_cast<size_t>(row) * D + d, o);
  }
  if (lse != nullptr && threadIdx.x == 0) lse[row] = l > 0.f ? m + logf(l) : NEG;
}

}  // namespace split_kv
