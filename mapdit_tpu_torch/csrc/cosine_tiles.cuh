// cosine_tiles.cuh: the row staging and exponent tile of the cosine
// attention core, shared by cosine_attention.cu and dit_stack.cu (which runs
// the same core on four of its warps at a time, `tid` counting the threads
// of those four warps). The tile products themselves are those of
// attention_tiles.cuh.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

#include "attention_tiles.cuh"

namespace cosine_tiles {

using namespace attn_tiles;

// Rows [0, TILE) of one head slice of the f32 qkv, a thread's share held
// in registers between the loads (fetch) and the bf16 tile (commit), so
// that several tiles' loads are in flight at once.
template <int HD>
struct Rows {
  static constexpr int C4 = HD / 4;         // float4 chunks of a row
  static constexpr int PER = (C4 + 3) / 4;  // chunks a lane takes, four lanes a row
  static constexpr int PASSES = TILE / (THREADS / 4);
  float4 x[PASSES][PER];
};

// rows >= `rows` read as zeros; through the read-only path, or, COHERENT,
// through L2 only (for rows that an earlier stage of the same kernel wrote)
template <int HD, bool COHERENT = false>
__device__ __forceinline__ void fetch(Rows<HD>& f, const float* src, int64_t ld_src, int rows, int tid) {
  using R = Rows<HD>;
  const int sub = tid & 3;
#pragma unroll
  for (int p = 0; p < R::PASSES; ++p) {
    const int r = (tid >> 2) + p * (THREADS / 4);
    const float4* row = reinterpret_cast<const float4*>(src + (int64_t)r * ld_src);
#pragma unroll
    for (int j = 0; j < R::PER; ++j) {
      const int c = sub + 4 * j;
      f.x[p][j] = (r < rows && c < R::C4) ? (COHERENT ? __ldcg(row + c) : __ldg(row + c))
                                          : make_float4(0.f, 0.f, 0.f, 0.f);
    }
  }
}

// the bf16 rows (pad columns zero) into `tile`; scale[r] = sqrt(hd) /
// (||row|| + eps) from the f32 values, when scale is given
template <int HD>
__device__ __forceinline__ void commit(const Rows<HD>& f, __nv_bfloat16* tile, float* scale, int tid) {
  using D = Dims<HD>;
  using R = Rows<HD>;
  const int sub = tid & 3;
  const float sqrt_hd = sqrtf((float)HD);
#pragma unroll
  for (int p = 0; p < R::PASSES; ++p) {
    const int r = (tid >> 2) + p * (THREADS / 4);
    __nv_bfloat16* dst = tile + r * D::LD;
    float ss = 0.f;
#pragma unroll
    for (int j = 0; j < R::PER; ++j) {
      const int c = sub + 4 * j;
      if (c < R::C4) {
        const float4 v = f.x[p][j];
        ss += v.x * v.x + v.y * v.y + v.z * v.z + v.w * v.w;
        *reinterpret_cast<uint2*>(dst + 4 * c) = make_uint2(pack_bf16(v.x, v.y), pack_bf16(v.z, v.w));
      }
    }
    for (int c = HD + 4 * sub; c < D::KP; c += 16) *reinterpret_cast<uint2*>(dst + c) = make_uint2(0u, 0u);
    ss = quad_sum(ss);
    if (scale != nullptr && sub == 0) scale[r] = sqrt_hd / (sqrtf(ss) + NORM_EPS);
  }
}

// ex = exp(l - sqrt(hd)) for the warp's rows against one key tile, in the
// S fragment layout; keys >= `keys` give 0
template <int HD>
__device__ __forceinline__ void exp_tile(float (&s)[KEY_TILES][4], const __nv_bfloat16* sq,
                                         const __nv_bfloat16* sk, const float* qsc, const float* ksc,
                                         int keys, int warp, int lane) {
  qk_tile<HD>(s, sq, sk, warp, lane);
  const float sqrt_hd = sqrtf((float)HD);
  const float inv_hd = 1.f / sqrt_hd;
  const int g = lane >> 2, c = lane & 3;
  const float r0 = qsc[warp * 16 + g], r1 = qsc[warp * 16 + g + 8];
#pragma unroll
  for (int j = 0; j < KEY_TILES; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int col = 8 * j + 2 * c + (e & 1);
      const float l = s[j][e] * inv_hd * (e < 2 ? r0 : r1) * ksc[col];
      s[j][e] = col < keys ? exp2_approx((l - sqrt_hd) * LOG2E) : 0.f;
    }
  }
}

}  // namespace cosine_tiles
