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

// ---------------------------------------------------------------------------
// The f32 form (cosine_attention_f32 and dit_stack's float32 instance: the
// Pallas core at dtype = float32, where nothing is rounded). The rows stay
// f32 in shared memory (row stride HD + 4 floats) and both products run on
// the f32 pipes in k order: a warp's lane holds 4 query rows (warp*16 +
// lane/8 + 4i) against 8 keys (lane%8 + 8j) of a tile, and the same 4 rows
// by HD/8 output columns (lane%8 + 8j). P.V takes p from the lanes that
// hold it (shuffles inside each group of eight lanes), so p never leaves
// the registers. A warp's 16-byte loads meet four Q rows and eight K rows
// on distinct bank groups at either head width.

template <int HD>
struct DimsF32 {
  static constexpr int LD = HD + 4;   // shared row stride in floats
  static constexpr int NJ = HD / 8;   // output columns a lane
  // one group's Q, K and V rows and the two scale vectors
  static constexpr int BYTES = 3 * TILE * LD * 4 + 2 * TILE * 4;
};

// the f32 rows into `tile`; scale[r] = sqrt(hd) / (||row|| + eps), when
// scale is given
template <int HD>
__device__ __forceinline__ void commit_f32(const Rows<HD>& f, float* tile, float* scale, int tid) {
  using R = Rows<HD>;
  const int sub = tid & 3;
  const float sqrt_hd = sqrtf((float)HD);
#pragma unroll
  for (int p = 0; p < R::PASSES; ++p) {
    const int r = (tid >> 2) + p * (THREADS / 4);
    float* dst = tile + r * DimsF32<HD>::LD;
    float ss = 0.f;
#pragma unroll
    for (int j = 0; j < R::PER; ++j) {
      const int c = sub + 4 * j;
      if (c < R::C4) {
        const float4 v = f.x[p][j];
        ss += v.x * v.x + v.y * v.y + v.z * v.z + v.w * v.w;
        *reinterpret_cast<float4*>(dst + 4 * c) = v;
      }
    }
    ss = quad_sum(ss);
    if (scale != nullptr && sub == 0) scale[r] = sqrt_hd / (sqrtf(ss) + NORM_EPS);
  }
}

// sum of a row's values over the eight lanes that hold it
__device__ __forceinline__ float oct_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  v += __shfl_xor_sync(0xffffffffu, v, 2);
  return v + __shfl_xor_sync(0xffffffffu, v, 4);
}

// s[i][j] = row (warp*16 + lane/8 + 4i) of sq . row (lane%8 + 8j) of sk
// over the HD columns, FFMA in column order (the rows of a tile at the
// DimsF32 stride)
template <int HD>
__device__ __forceinline__ void qk_tile_f32(float (&s)[4][8], const float* sq, const float* sk, int warp, int lane) {
  using D = DimsF32<HD>;
  const int r = warp * 16 + (lane >> 3), kc = lane & 7;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) s[i][j] = 0.f;
#pragma unroll 2
  for (int c = 0; c < HD / 4; ++c) {
    float4 q[4], k[8];
#pragma unroll
    for (int i = 0; i < 4; ++i) q[i] = *reinterpret_cast<const float4*>(sq + (r + 4 * i) * D::LD + 4 * c);
#pragma unroll
    for (int j = 0; j < 8; ++j) k[j] = *reinterpret_cast<const float4*>(sk + (kc + 8 * j) * D::LD + 4 * c);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        s[i][j] = fmaf(q[i].x, k[j].x, s[i][j]);
        s[i][j] = fmaf(q[i].y, k[j].y, s[i][j]);
        s[i][j] = fmaf(q[i].z, k[j].z, s[i][j]);
        s[i][j] = fmaf(q[i].w, k[j].w, s[i][j]);
      }
  }
}

// ex = exp(l - sqrt(hd)) of the lane's rows against its keys of one tile,
// l = (q . k) * 1/sqrt(hd) * qs * ks in f32; keys >= `keys` give 0
template <int HD>
__device__ __forceinline__ void exp_tile_f32(float (&s)[4][8], const float* sq, const float* sk, const float* qsc,
                                             const float* ksc, int keys, int warp, int lane) {
  const int r = warp * 16 + (lane >> 3), kc = lane & 7;
  qk_tile_f32<HD>(s, sq, sk, warp, lane);
  const float sqrt_hd = sqrtf((float)HD);
  const float inv_hd = 1.f / sqrt_hd;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float rs = qsc[r + 4 * i];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = kc + 8 * j;
      const float l = s[i][j] * inv_hd * rs * ksc[col];
      s[i][j] = col < keys ? exp2_approx((l - sqrt_hd) * LOG2E) : 0.f;
    }
  }
}

// a lane's part of the sums of its four rows
__device__ __forceinline__ void add_row_sums_f32(float (&sum)[4], const float (&s)[4][8]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) sum[i] += s[i][j];
}

// o += P . (the TILE rows of sv): key c + 8j of the tile is held by lane c
// of the lane's group of eight
template <int HD>
__device__ __forceinline__ void pv_tile_f32(float (&o)[4][DimsF32<HD>::NJ], const float (&p)[4][8], const float* sv,
                                            int lane) {
  using D = DimsF32<HD>;
  const int group = lane & ~7, oc = lane & 7;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      float pk[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pk[i] = __shfl_sync(0xffffffffu, p[i][j], group + c);
      const float* vrow = sv + (c + 8 * j) * D::LD + oc;
#pragma unroll
      for (int jj = 0; jj < D::NJ; ++jj) {
        const float v = vrow[8 * jj];
#pragma unroll
        for (int i = 0; i < 4; ++i) o[i][jj] = fmaf(pk[i], v, o[i][jj]);
      }
    }
  }
}

// the lane's rows of the output, o * f[i], to dst + r * ld_dst (tile rows
// r < rows only; r counted from the tile's first query)
template <int HD>
__device__ __forceinline__ void store_rows_f32(const float (&o)[4][DimsF32<HD>::NJ], const float (&f)[4], float* dst,
                                               int64_t ld_dst, int rows, int warp, int lane) {
  const int r = warp * 16 + (lane >> 3), oc = lane & 7;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if (r + 4 * i >= rows) continue;
    float* row = dst + (int64_t)(r + 4 * i) * ld_dst + oc;
#pragma unroll
    for (int jj = 0; jj < DimsF32<HD>::NJ; ++jj) row[8 * jj] = o[i][jj] * f[i];
  }
}

}  // namespace cosine_tiles
