// attention_bwd_f32.cuh: the attention backward of one (sample, head) at
// float32, the f32 form of attention_bwd_tiles.cuh, shared by
// csrc/attn_branch_bwd.cu (attention_bwd_f32, a block a unit) and
// csrc/attn_branch.cu (row 4's float32 instance, a unit on each group of
// four consumer warps).
//
// It is _attn_bwd_math (mapdit_tpu/ops/pallas/dit_block.py:560) at dtype =
// float32, where every .astype is a no-op: nothing is rounded. With
// qn = q*sqrt(hd)/(|q| + eps), kn likewise,
//   p = softmax(qn.kn^T / sqrt(hd)), dp = do.v^T,
//   dlog = p*(dp - rowsum(dp*p)) / sqrt(hd),
//   dv = p^T.do, dqn = dlog.kn, dkn = dlog^T.qn,
//   dq, dk = the full quotient VJP of the normalisation (its denominator is
//   a live edge): dz = c*dzn - z*(sum(z*dzn)*sqrt(hd)/(r*(r+eps)^2)),
//   c = sqrt(hd)/(r+eps), r = |z|.
// Every product is an FFMA chain on the f32 pipes in column order
// (cosine_tiles.cuh's f32 part: a lane holds 4 rows by 8 columns of a
// 64 x 64 score tile, and 4 rows by HD/8 output columns, p passing to the
// next product by shuffles inside its group of eight lanes). A TF32
// mma.sync would round every operand to 10 mantissa bits, past the 2e-4
// the f32 kernels are held to.
//
// Tiles of 64 rows: the q (normalised) and do rows of a query tile and the
// k (normalised) and v rows of a key tile lie in shared memory at once
// (four tiles of 64 x (HD + 4) f32, 68 KB at hd 64, 76 KB at hd 72), so T
// is bounded by the row sums kept (MAXT), not by the tiles:
//   * phase A, a query tile at a time: the exponent max-free, ex =
//     exp(l - sqrt(hd)) (cosine logits lie within +-sqrt(hd), as in the
//     forward kernels); past one key tile a first sweep over the key tiles
//     takes sum ex and sum ex*dp of each row, a second forms p, dlog and
//     adds dqn = dlog.kn; at T <= 64 one sweep does both. 1/sum and
//     rowsum(dp*p) = sum(ex*dp)/sum of each query row go to shared memory;
//   * phase B, a key tile at a time against each query tile: S^T and dP^T
//     again (the same FFMA chains, so the same p), p and dlog from the
//     stored row sums (queries past T take p = 0), dv = p^T.do and dkn =
//     dlog^T.qn added over the query tiles;
//   * dq, dk and dv leave in f32 from the accumulators, each element once:
//     no atomics, the same bits on every run.
// Against the plain version (attn_branch._attention_vjp at f32) the steps
// differ besides the order of the sums as the bf16 long form's do: the
// max-free exponent by ex2.approx (~2 ulp), p = ex * (1/sum), and
// rowsum(dp*p) as sum(ex*dp)/sum.
#pragma once

#include <math.h>
#include <stdint.h>

#include "cosine_tiles.cuh"

namespace attn_bwd_f32 {

using namespace cosine_tiles;

// shared memory of a unit for T <= MAXT: the four tiles, each query row's
// 1/sum and rowsum(dp*p), the staged tiles' norms
template <int HD, int MAXT>
struct Layout {
  static constexpr int TILE_FLOATS = TILE * DimsF32<HD>::LD;
  static constexpr int BYTES = (4 * TILE_FLOATS + 2 * MAXT + 2 * TILE) * 4;
};

// rows [0, rows) of a head slice (row stride ld, read through L2) into
// `tile` at the DimsF32 stride, zeros past them; with `norms` given, each
// row normalised as the plain version writes it, z * sqrt(hd) / (|z| +
// eps), and |z| kept in norms[r]
template <int HD>
__device__ __forceinline__ void stage(float* tile, float* norms, const float* src, int64_t ld, int rows, int tid) {
  using R = Rows<HD>;
  R f;
  fetch<HD, true>(f, src, ld, rows, tid);
  const int sub = tid & 3;
  const float sqrt_hd = sqrtf((float)HD);
#pragma unroll
  for (int p = 0; p < R::PASSES; ++p) {
    const int r = (tid >> 2) + p * (THREADS / 4);
    float* dst = tile + r * DimsF32<HD>::LD;
    float den = 1.f;
    if (norms != nullptr) {
      float ss = 0.f;
#pragma unroll
      for (int j = 0; j < R::PER; ++j) {
        const float4 v = f.x[p][j];
        ss += v.x * v.x + v.y * v.y + v.z * v.z + v.w * v.w;
      }
      const float nrm = sqrtf(quad_sum(ss));
      if (sub == 0) norms[r] = nrm;
      den = nrm + NORM_EPS;
    }
    // zero rows skip the division (its slow path)
    const bool scaled = norms != nullptr && r < rows;
#pragma unroll
    for (int j = 0; j < R::PER; ++j) {
      const int c = sub + 4 * j;
      if (c < R::C4) {
        float4 v = f.x[p][j];
        if (scaled) {
          v.x = v.x * sqrt_hd / den;
          v.y = v.y * sqrt_hd / den;
          v.z = v.z * sqrt_hd / den;
          v.w = v.w * sqrt_hd / den;
        }
        *reinterpret_cast<float4*>(dst + 4 * c) = v;
      }
    }
  }
}

// ex = exp(l - sqrt(hd)), l = s / sqrt(hd), of a lane's 4 x 8 scores in
// place; columns at or past `cols` give 0
template <int HD>
__device__ __forceinline__ void exp_scores(float (&s)[4][8], int cols, int lane) {
  const float sqrt_hd = sqrtf((float)HD), inv_sqrt_hd = (float)(1.0 / sqrt((double)HD));
  const int kc = lane & 7;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j)
      s[i][j] = kc + 8 * j < cols ? exp2_approx((s[i][j] * inv_sqrt_hd - sqrt_hd) * LOG2E) : 0.f;
}

// The normalisation's VJP of a lane's rows (r0 + 4i of the tile, those <
// rows) from the dzn accumulators, z the raw rows (zsrc + r * ld), norms
// their |z|; dz to dst + r * ld
template <int HD>
__device__ __forceinline__ void normalize_vjp(const float (&o)[4][DimsF32<HD>::NJ], const float* zsrc, float* dst,
                                              int64_t ld, const float* norms, int r0, int rows, int lane) {
  constexpr int NJ = DimsF32<HD>::NJ;
  const float sqrt_hd = sqrtf((float)HD);
  const int oc = lane & 7;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = r0 + 4 * i;
    float z[NJ], dot = 0.f;
#pragma unroll
    for (int jj = 0; jj < NJ; ++jj) {
      z[jj] = r < rows ? __ldcg(zsrc + (int64_t)r * ld + oc + 8 * jj) : 0.f;
      dot = fmaf(z[jj], o[i][jj], dot);
    }
    // the shuffles run on every lane; rows past `rows` skip the divisions
    dot = oct_sum(dot);
    if (r >= rows) continue;
    const float nrm = norms[r], den = nrm + NORM_EPS;
    const float c = sqrt_hd / den, k = dot * sqrt_hd / (nrm * (den * den));
#pragma unroll
    for (int jj = 0; jj < NJ; ++jj) dst[(int64_t)r * ld + oc + 8 * jj] = c * o[i][jj] - z[jj] * k;
  }
}

// a lane's rows of an f32 result (no normalisation) to dst + r * ld
template <int HD>
__device__ __forceinline__ void store_rows(const float (&o)[4][DimsF32<HD>::NJ], float* dst, int64_t ld, int r0,
                                           int rows, int lane) {
  const int oc = lane & 7;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = r0 + 4 * i;
    if (r >= rows) continue;
#pragma unroll
    for (int jj = 0; jj < DimsF32<HD>::NJ; ++jj) dst[(int64_t)r * ld + oc + 8 * jj] = o[i][jj];
  }
}

// One (sample, head) unit on four warps (tid 0-127; sync() is their
// barrier) with Layout<HD, MAXT>::BYTES of shared memory at smem (16-byte
// aligned): dqkv's f32 head slice of the sample from the f32 qkv (N*T, 3D)
// and dattn (N*T, D), both read through L2 (rows an earlier stage of the
// same launch may have written). T <= MAXT.
template <int HD, int MAXT, class Sync>
__device__ __forceinline__ void attention_bwd_unit(const float* qkv, const float* dattn, float* dqkv, int t,
                                                   int heads, int sample, int head, float* smem, int tid,
                                                   const Sync& sync) {
  using D = DimsF32<HD>;
  using L = Layout<HD, MAXT>;
  float* sq = smem;                   // qn of a query tile
  float* sdo = sq + L::TILE_FLOATS;   // do of a query tile
  float* sk = sdo + L::TILE_FLOATS;   // kn of a key tile
  float* sv = sk + L::TILE_FLOATS;    // v of a key tile
  float* inv_sum = sv + L::TILE_FLOATS;  // each query row's 1/sum ex
  float* row_dp = inv_sum + MAXT;        // and rowsum(dp*p)
  float* nq = row_dp + MAXT;             // the staged tiles' norms
  float* nk = nq + TILE;

  const int warp = tid / 32, lane = tid % 32;
  const int d = heads * HD;
  const int64_t ld = 3 * (int64_t)d;
  const float* base = qkv + (int64_t)sample * t * ld + head * HD;
  const float* dbase = dattn + (int64_t)sample * t * d + head * HD;
  float* obase = dqkv + (int64_t)sample * t * ld + head * HD;
  const int tiles = (t + TILE - 1) / TILE, rl = warp * 16 + (lane >> 3), kc = lane & 7;
  const float inv_sqrt_hd = (float)(1.0 / sqrt((double)HD));

  const auto stage_keys = [&](int k0, int rows) {
    stage<HD>(sk, nk, base + d + (int64_t)k0 * ld, ld, rows, tid);
    stage<HD>(sv, nullptr, base + 2 * d + (int64_t)k0 * ld, ld, rows, tid);
  };
  const auto stage_queries = [&](int q0, int rows) {
    stage<HD>(sq, nq, base + (int64_t)q0 * ld, ld, rows, tid);
    stage<HD>(sdo, nullptr, dbase + (int64_t)q0 * d, d, rows, tid);
  };

  // phase A: the query tiles' p rows, dlog and dq
  for (int qt = 0; qt < tiles; ++qt) {
    const int q0 = qt * TILE, qrows = min(TILE, t - q0);
    const bool active = warp * 16 < qrows;
    sync();  // the tiles' last readers are through
    stage_queries(q0, qrows);
    float sum[4] = {0.f, 0.f, 0.f, 0.f}, sdp[4] = {0.f, 0.f, 0.f, 0.f};
    if (tiles > 1) {
      // first sweep: the row sums over every key tile
      for (int kt = 0; kt < tiles; ++kt) {
        const int krows = min(TILE, t - kt * TILE);
        sync();
        stage_keys(kt * TILE, krows);
        sync();
        if (!active) continue;
        float s[4][8], dp[4][8];
        qk_tile_f32<HD>(s, sq, sk, warp, lane);
        qk_tile_f32<HD>(dp, sdo, sv, warp, lane);
        exp_scores<HD>(s, krows, lane);
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            sum[i] += s[i][j];
            sdp[i] = fmaf(s[i][j], dp[i][j], sdp[i]);
          }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        sum[i] = oct_sum(sum[i]);
        sdp[i] = oct_sum(sdp[i]);
      }
    }
    float inv[4], rs[4];
    float o[4][D::NJ];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int jj = 0; jj < D::NJ; ++jj) o[i][jj] = 0.f;
    for (int kt = 0; kt < tiles; ++kt) {
      const int krows = min(TILE, t - kt * TILE);
      sync();
      stage_keys(kt * TILE, krows);
      sync();
      if (!active) continue;
      float s[4][8], dp[4][8];
      qk_tile_f32<HD>(s, sq, sk, warp, lane);
      qk_tile_f32<HD>(dp, sdo, sv, warp, lane);
      exp_scores<HD>(s, krows, lane);
      if (tiles == 1) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            sum[i] += s[i][j];
            sdp[i] = fmaf(s[i][j], dp[i][j], sdp[i]);
          }
          sum[i] = oct_sum(sum[i]);
          sdp[i] = oct_sum(sdp[i]);
        }
      }
      if (kt == 0) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          inv[i] = 1.f / sum[i];
          rs[i] = sdp[i] * inv[i];
        }
      }
      // p = ex/sum, dlog = p*(dp - rowsum)/sqrt(hd), in place of s
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) s[i][j] = s[i][j] * inv[i] * (dp[i][j] - rs[i]) * inv_sqrt_hd;
      pv_tile_f32<HD>(o, s, sk, lane);
    }
    if (active) {
      if (kc == 0) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          if (rl + 4 * i < qrows) {
            inv_sum[q0 + rl + 4 * i] = inv[i];
            row_dp[q0 + rl + 4 * i] = rs[i];
          }
        }
      }
      normalize_vjp<HD>(o, base + (int64_t)q0 * ld, obase + (int64_t)q0 * ld, ld, nq, rl, qrows, lane);
    }
  }

  // phase B: the key tiles' dk and dv against every query tile
  for (int kt = 0; kt < tiles; ++kt) {
    const int k0 = kt * TILE, krows = min(TILE, t - k0);
    const bool active = warp * 16 < krows;
    sync();  // the row sums are whole, the tiles' last readers through
    if (tiles > 1) {
      stage_keys(k0, krows);
    }
    float dv[4][D::NJ], dk[4][D::NJ];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int jj = 0; jj < D::NJ; ++jj) dv[i][jj] = dk[i][jj] = 0.f;
    for (int qt = 0; qt < tiles; ++qt) {
      const int q0 = qt * TILE, qrows = min(TILE, t - q0);
      if (tiles > 1) {
        if (qt > 0) sync();
        stage_queries(q0, qrows);
        sync();
      }
      if (!active) continue;
      float s[4][8], dp[4][8];
      qk_tile_f32<HD>(s, sk, sq, warp, lane);
      qk_tile_f32<HD>(dp, sv, sdo, warp, lane);
      exp_scores<HD>(s, qrows, lane);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int q = q0 + kc + 8 * j;
        const float iq = q < t ? inv_sum[q] : 0.f, rq = q < t ? row_dp[q] : 0.f;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float p = s[i][j] * iq;
          s[i][j] = p;
          dp[i][j] = p * (dp[i][j] - rq) * inv_sqrt_hd;
        }
      }
      pv_tile_f32<HD>(dv, s, sdo, lane);
      pv_tile_f32<HD>(dk, dp, sq, lane);
    }
    if (active) {
      normalize_vjp<HD>(dk, base + d + (int64_t)k0 * ld, obase + d + (int64_t)k0 * ld, ld, nk, rl, krows, lane);
      store_rows<HD>(dv, obase + 2 * d + (int64_t)k0 * ld, ld, rl, krows, lane);
    }
  }
}

}  // namespace attn_bwd_f32
