// Tensor-core tiles shared by cosine_attention.cu and fused_attention.cu.
//
// A block of WARPS warps takes TILE query rows, 16 a warp, and runs the keys
// through shared memory in tiles of TILE. Both products are
// mma.sync.aligned.m16n8k16 in bf16 with f32 accumulation, their operands
// read with ldmatrix from bf16 tiles whose rows are padded to LD elements
// (row addresses 16-byte aligned, the eight rows of an 8x8 matrix on eight
// distinct bank groups):
//   * S = Q.K^T: A is the warp's 16 Q rows, B the K tile read untransposed
//     (a key's row is a column of K^T); the head width is padded with zero
//     columns to KP, a multiple of 16 (72 -> 80);
//   * O += P.V: A is P, repacked in registers from the S accumulators (the
//     m16n8 C fragment of two neighbouring key tiles is the m16k16 A
//     fragment of their 16 keys), B the V tile read with ldmatrix.trans.
// Fragment layout (PTX ISA, mma.m16n8k16): lane = 4 g + c; C element e of
// n-tile j sits at row g + 8 (e / 2), column 8 j + 2 c + (e % 2).
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace attn_tiles {

constexpr int WARPS = 4;
constexpr int THREADS = 32 * WARPS;
constexpr int TILE = 16 * WARPS;  // query rows of a block, keys of a tile
constexpr int KEY_TILES = TILE / 8;
constexpr float NORM_EPS = 1e-4f;
constexpr float LOG2E = 1.4426950408889634f;

template <int HD>
struct Dims {
  static_assert(HD % 8 == 0, "head width must be a multiple of 8");
  static constexpr int KP = (HD + 15) / 16 * 16;  // Q.K^T contraction, zero padded
  static constexpr int LD = KP + 8;               // shared row stride in elements
  static constexpr int NT = HD / 8;               // n8 tiles of P.V
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm_x2_trans(uint32_t (&r)[2], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, "
      "{%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 2^x on the special-function unit (ex2.approx.ftz: ~2 ulp; a result below
// 2^-126 flushes to 0, where exp2f would take a slower path for subnormals,
// as the exponents of unbounded logits far below the row maximum do)
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// two f32 values rounded to bf16 (to nearest even), the first in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// s = (the warp's 16 rows of sq) . (the TILE rows of sk)^T, f32
template <int HD>
__device__ __forceinline__ void qk_tile(float (&s)[KEY_TILES][4], const __nv_bfloat16* sq,
                                        const __nv_bfloat16* sk, int warp, int lane) {
  using D = Dims<HD>;
#pragma unroll
  for (int j = 0; j < KEY_TILES; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
  for (int kk = 0; kk < D::KP / 16; ++kk) {
    uint32_t a[4];
    ldsm_x4(a, sq + (warp * 16 + (lane & 15)) * D::LD + kk * 16 + (lane >> 4) * 8);
#pragma unroll
    for (int jp = 0; jp < KEY_TILES / 2; ++jp) {
      uint32_t b[4];
      ldsm_x4(b, sk + (jp * 16 + (lane & 7) + (lane >> 4) * 8) * D::LD + kk * 16 + ((lane >> 3) & 1) * 8);
      mma(s[2 * jp], a, b[0], b[1]);
      mma(s[2 * jp + 1], a, b[2], b[3]);
    }
  }
}

// The A fragments of P.V: p (the S layout, already rounded where the
// caller wants it) packed to bf16, one m16k16 fragment per 16 keys.
__device__ __forceinline__ void pack_p(uint32_t (&pa)[KEY_TILES / 2][4], const float (&p)[KEY_TILES][4]) {
#pragma unroll
  for (int kk = 0; kk < KEY_TILES / 2; ++kk) {
    pa[kk][0] = pack_bf16(p[2 * kk][0], p[2 * kk][1]);
    pa[kk][1] = pack_bf16(p[2 * kk][2], p[2 * kk][3]);
    pa[kk][2] = pack_bf16(p[2 * kk + 1][0], p[2 * kk + 1][1]);
    pa[kk][3] = pack_bf16(p[2 * kk + 1][2], p[2 * kk + 1][3]);
  }
}

// o += P . (the TILE rows of sv)
template <int HD>
__device__ __forceinline__ void pv_tile(float (&o)[Dims<HD>::NT][4], const uint32_t (&pa)[KEY_TILES / 2][4],
                                        const __nv_bfloat16* sv, int lane) {
  using D = Dims<HD>;
#pragma unroll
  for (int kk = 0; kk < KEY_TILES / 2; ++kk) {
    const __nv_bfloat16* rows = sv + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * D::LD;
#pragma unroll
    for (int jp = 0; jp < D::NT / 2; ++jp) {
      uint32_t b[4];
      ldsm_x4_trans(b, rows + jp * 16 + (lane >> 4) * 8);
      mma(o[2 * jp], pa[kk], b[0], b[1]);
      mma(o[2 * jp + 1], pa[kk], b[2], b[3]);
    }
    if (D::NT % 2) {
      uint32_t b[2];
      ldsm_x2_trans(b, rows + (D::NT - 1) * 8);
      mma(o[D::NT - 1], pa[kk], b[0], b[1]);
    }
  }
}

// The warp's 16 output rows, o * (row factor) rounded to bf16, staged in its
// own rows of `stage` and written with 16-byte stores to dst + r * ld_dst
// (rows r < rows only).
template <int HD>
__device__ __forceinline__ void store_rows(const float (&o)[Dims<HD>::NT][4], float f0, float f1,
                                           __nv_bfloat16* stage, __nv_bfloat16* dst, int64_t ld_dst,
                                           int rows, int warp, int lane) {
  using D = Dims<HD>;
  const int g = lane >> 2, c = lane & 3;
  __nv_bfloat16* mine = stage + warp * 16 * D::LD;
  __syncwarp();  // every lane's ldmatrix of these rows is done
#pragma unroll
  for (int j = 0; j < D::NT; ++j) {
    *reinterpret_cast<uint32_t*>(mine + g * D::LD + 8 * j + 2 * c) = pack_bf16(o[j][0] * f0, o[j][1] * f0);
    *reinterpret_cast<uint32_t*>(mine + (g + 8) * D::LD + 8 * j + 2 * c) = pack_bf16(o[j][2] * f1, o[j][3] * f1);
  }
  __syncwarp();
  for (int i = lane; i < 16 * D::NT; i += 32) {
    const int r = i / D::NT, ch = i % D::NT;
    if (warp * 16 + r < rows)
      *reinterpret_cast<uint4*>(dst + (int64_t)(warp * 16 + r) * ld_dst + 8 * ch) =
          *reinterpret_cast<const uint4*>(mine + r * D::LD + 8 * ch);
  }
}

// a lane's part of the sums of its two rows (g and g + 8) of an S tile
__device__ __forceinline__ void add_row_sums(float& sum0, float& sum1, const float (&s)[KEY_TILES][4]) {
#pragma unroll
  for (int j = 0; j < KEY_TILES; ++j) {
    sum0 += s[j][0] + s[j][1];
    sum1 += s[j][2] + s[j][3];
  }
}

// sum of a row's values over the four lanes of a quad
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

}  // namespace attn_tiles
