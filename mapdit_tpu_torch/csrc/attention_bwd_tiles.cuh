// attention_bwd_tiles.cuh: the attention backward of one (sample, head)
// on the tensor cores, shared by csrc/attn_branch_bwd.cu (attention_bwd, a
// block a unit) and csrc/attn_branch.cu (the attention half-block's
// backward, a unit on each group of four consumer warps). The design and
// its measurements are attn_branch_bwd.cu's notes on (b).
#pragma once

#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include "attention_tiles.cuh"

namespace attn_bwd_tiles {

namespace tiles = attn_tiles;

template <int HD, int KT>
struct BwdLayout {
  using D = tiles::Dims<HD>;
  static constexpr int ROWS = tiles::TILE * KT;  // rows of every tile, zero past T
  static constexpr int WARPS = ROWS / 16;        // one warp a 16 query (and key) rows
  static constexpr int THREADS = 32 * WARPS;
  static constexpr int LDP = ROWS + 8;           // row stride of p and dlog
  static constexpr int TILE_ELEMS = ROWS * D::LD;
  static constexpr int P_ELEMS = ROWS * LDP;
  static constexpr size_t BYTES = (4 * (size_t)TILE_ELEMS + 2 * (size_t)P_ELEMS) * 2 + 2 * ROWS * sizeof(float);
  // blocks an SM the registers are capped for (the shared memory allows
  // four at hd 64, three at hd 72)
  static constexpr int MIN_BLOCKS = KT > 1 ? 1 : (HD == 64 ? 4 : 3);
};

// One thread's share of ROWS rows of a head slice (four lanes a row, two
// passes), held in registers between the loads and the bf16 tile.
template <int HD, int KT>
struct Slice {
  static constexpr int C4 = HD / 4;         // float4 chunks of a row
  static constexpr int PER = (C4 + 3) / 4;  // chunks a lane takes
  static constexpr int STEP = BwdLayout<HD, KT>::THREADS / 4;
  float4 x[2][PER];
};

// rows >= `rows` read as zeros; through the read-only path, or, COHERENT,
// through L2 only (rows an earlier stage of the same launch wrote)
template <int HD, int KT, bool COHERENT>
__device__ __forceinline__ void fetch(Slice<HD, KT>& f, const float* src, int64_t ld, int rows, int tid) {
  using S = Slice<HD, KT>;
  const int sub = tid & 3;
#pragma unroll
  for (int p = 0; p < 2; ++p) {
    const int r = (tid >> 2) + p * S::STEP;
    const float4* row = reinterpret_cast<const float4*>(src + (int64_t)r * ld);
#pragma unroll
    for (int j = 0; j < S::PER; ++j) {
      const int c = sub + 4 * j;
      f.x[p][j] = (r < rows && c < S::C4) ? (COHERENT ? __ldcg(row + c) : __ldg(row + c))
                                          : make_float4(0.f, 0.f, 0.f, 0.f);
    }
  }
}

// The rows as bf16 into `tile` (pad columns zero). With `norms` given, the
// rows are normalised first, z*sqrt(hd)/(||z|| + eps) in f32 as the plain
// version writes it, and ||z|| goes to norms[r]. Rows >= `rows` are zeros
// and skip the division (an IEEE division of 0 takes its slow path: zero
// rows made a T=16 block ~1.7x slower than a T=64 one).
template <int HD, int KT>
__device__ __forceinline__ void commit(const Slice<HD, KT>& f, __nv_bfloat16* tile, float* norms, int rows,
                                       int tid) {
  using D = tiles::Dims<HD>;
  using S = Slice<HD, KT>;
  const int sub = tid & 3;
  const float sqrt_hd = sqrtf((float)HD);
#pragma unroll
  for (int p = 0; p < 2; ++p) {
    const int r = (tid >> 2) + p * S::STEP;
    __nv_bfloat16* dst = tile + r * D::LD;
    float mul = 1.f, den = 1.f;
    if (norms != nullptr) {
      float ss = 0.f;
#pragma unroll
      for (int j = 0; j < S::PER; ++j) {
        const float4 v = f.x[p][j];
        ss += v.x * v.x + v.y * v.y + v.z * v.z + v.w * v.w;
      }
      const float nrm = sqrtf(tiles::quad_sum(ss));
      if (sub == 0) norms[r] = nrm;
      mul = sqrt_hd;
      den = nrm + tiles::NORM_EPS;
    }
    const bool scaled = norms != nullptr && r < rows;
#pragma unroll
    for (int j = 0; j < S::PER; ++j) {
      const int c = sub + 4 * j;
      if (c < S::C4) {
        float4 v = f.x[p][j];
        if (scaled) {
          v.x = v.x * mul / den;
          v.y = v.y * mul / den;
          v.z = v.z * mul / den;
          v.w = v.w * mul / den;
        }
        *reinterpret_cast<uint2*>(dst + 4 * c) = make_uint2(tiles::pack_bf16(v.x, v.y), tiles::pack_bf16(v.z, v.w));
      }
    }
    for (int c = HD + 4 * sub; c < D::KP; c += 16) *reinterpret_cast<uint2*>(dst + c) = make_uint2(0u, 0u);
  }
}

// The normalize VJP of the warp's 16 rows r0.. from the dzn accumulators o:
// dz = c*dzn - z*(Sum(z*dzn)*sqrt(hd)/(r*(r+eps)^2)), c = sqrt(hd)/(r+eps),
// z the raw f32 rows (zrows + r*ld, read in the fragment layout), r their
// norms; packed to bf16, rows g and g+8 of each n8 tile.
template <int HD, bool COHERENT>
__device__ __forceinline__ void normalize_vjp(const float (&o)[tiles::Dims<HD>::NT][4],
                                              uint32_t (&out)[tiles::Dims<HD>::NT][2], const float* zrows,
                                              int64_t ld, const float* norms, int r0, int t, int lane) {
  constexpr int NT = tiles::Dims<HD>::NT;
  const int g = lane >> 2, c = lane & 3;
  const int ra = r0 + g, rb = ra + 8;
  float2 za[NT], zb[NT];
  float dot_a = 0.f, dot_b = 0.f;
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    const int col = 8 * j + 2 * c;
    const float2* pa = reinterpret_cast<const float2*>(zrows + (int64_t)ra * ld + col);
    const float2* pb = reinterpret_cast<const float2*>(zrows + (int64_t)rb * ld + col);
    za[j] = ra < t ? (COHERENT ? __ldcg(pa) : __ldg(pa)) : make_float2(0.f, 0.f);
    zb[j] = rb < t ? (COHERENT ? __ldcg(pb) : __ldg(pb)) : make_float2(0.f, 0.f);
  }
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    dot_a += za[j].x * o[j][0] + za[j].y * o[j][1];
    dot_b += zb[j].x * o[j][2] + zb[j].y * o[j][3];
  }
  dot_a = tiles::quad_sum(dot_a);
  dot_b = tiles::quad_sum(dot_b);
  const float sqrt_hd = sqrtf((float)HD);
  const float na = norms[ra], nb = norms[rb];
  // rows past T are not stored: they skip the divisions (0 / 0 there)
  float ca = 0.f, cb = 0.f, ka = 0.f, kb = 0.f;
  if (ra < t) {
    ca = sqrt_hd / (na + tiles::NORM_EPS);
    ka = dot_a * sqrt_hd / (na * ((na + tiles::NORM_EPS) * (na + tiles::NORM_EPS)));
  }
  if (rb < t) {
    cb = sqrt_hd / (nb + tiles::NORM_EPS);
    kb = dot_b * sqrt_hd / (nb * ((nb + tiles::NORM_EPS) * (nb + tiles::NORM_EPS)));
  }
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    out[j][0] = tiles::pack_bf16(ca * o[j][0] - za[j].x * ka, ca * o[j][1] - za[j].y * ka);
    out[j][1] = tiles::pack_bf16(cb * o[j][2] - zb[j].x * kb, cb * o[j][3] - zb[j].y * kb);
  }
}

template <int HD>
__device__ __forceinline__ void pack_rows(const float (&o)[tiles::Dims<HD>::NT][4],
                                          uint32_t (&out)[tiles::Dims<HD>::NT][2]) {
#pragma unroll
  for (int j = 0; j < tiles::Dims<HD>::NT; ++j) {
    out[j][0] = tiles::pack_bf16(o[j][0], o[j][1]);
    out[j][1] = tiles::pack_bf16(o[j][2], o[j][3]);
  }
}

// The warp's 16 rows of one bf16 result (packed fragments) into its own
// rows of `stage`.
template <int HD>
__device__ __forceinline__ void stage_rows(const uint32_t (&v)[tiles::Dims<HD>::NT][2], __nv_bfloat16* stage,
                                           int r0, int lane) {
  using D = tiles::Dims<HD>;
  const int g = lane >> 2, c = lane & 3;
#pragma unroll
  for (int j = 0; j < D::NT; ++j) {
    *reinterpret_cast<uint32_t*>(stage + (r0 + g) * D::LD + 8 * j + 2 * c) = v[j][0];
    *reinterpret_cast<uint32_t*>(stage + (r0 + g + 8) * D::LD + 8 * j + 2 * c) = v[j][1];
  }
}

// rows r0 .. r0+15 (those < t) of a staged tile to dst + r * ld, 16-byte stores
template <int HD>
__device__ __forceinline__ void store_rows(const __nv_bfloat16* stage, __nv_bfloat16* dst, int64_t ld, int r0,
                                           int t, int lane) {
  using D = tiles::Dims<HD>;
  for (int i = lane; i < 16 * D::NT; i += 32) {
    const int r = r0 + i / D::NT, ch = i % D::NT;
    if (r < t)
      *reinterpret_cast<uint4*>(dst + (int64_t)r * ld + 8 * ch) =
          *reinterpret_cast<const uint4*>(stage + r * D::LD + 8 * ch);
  }
}

// One (sample, head) unit on L::THREADS threads (tid counts them from 0;
// sync() is their barrier) with L::BYTES of shared memory at smem (16-byte
// aligned): dqkv's head slice of the sample from qkv and dattn (COHERENT:
// read through L2, as rows written earlier in the same launch).
template <int HD, int KT, bool COHERENT, class Sync>
__device__ __forceinline__ void attention_bwd_unit(const float* __restrict__ qkv, const float* __restrict__ dattn,
                                                   __nv_bfloat16* __restrict__ dqkv, int t, int heads, int sample,
                                                   int head, unsigned char* smem, int tid, const Sync& sync) {
  using D = tiles::Dims<HD>;
  using L = BwdLayout<HD, KT>;
  constexpr int KEYS = tiles::KEY_TILES;
  __nv_bfloat16* sq = reinterpret_cast<__nv_bfloat16*>(smem);  // qn
  __nv_bfloat16* sk = sq + L::TILE_ELEMS;                       // kn
  __nv_bfloat16* sv = sk + L::TILE_ELEMS;                       // v
  __nv_bfloat16* sd = sv + L::TILE_ELEMS;                       // do
  __nv_bfloat16* sp = sd + L::TILE_ELEMS;                       // bf16(p), (query, key)
  __nv_bfloat16* sl = sp + L::P_ELEMS;                          // bf16(dlog), (query, key)
  float* rq = reinterpret_cast<float*>(sl + L::P_ELEMS);
  float* rk = rq + L::ROWS;

  const int warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, c = lane & 3;
  const int d = heads * HD;
  const int64_t ld = 3 * (int64_t)d;
  const float* base = qkv + (int64_t)sample * t * ld + head * HD;
  const float* dbase = dattn + (int64_t)sample * t * d + head * HD;
  const int r0 = warp * 16;  // the warp's query rows in phase A, key rows in phase B
  const bool active = r0 < t;
  const float inv_sqrt_hd = (float)(1.0 / sqrt((double)HD));

  {
    Slice<HD, KT> fa, fb;
    fetch<HD, KT, COHERENT>(fa, base, ld, t, tid);
    fetch<HD, KT, COHERENT>(fb, base + d, ld, t, tid);
    commit<HD, KT>(fa, sq, rq, t, tid);
    commit<HD, KT>(fb, sk, rk, t, tid);
    fetch<HD, KT, COHERENT>(fa, base + 2 * d, ld, t, tid);
    fetch<HD, KT, COHERENT>(fb, dbase, d, t, tid);
    commit<HD, KT>(fa, sv, nullptr, t, tid);
    commit<HD, KT>(fb, sd, nullptr, t, tid);
  }
  sync();

  // phase A, the warp's query rows: S, dP, softmax, dlog, dqn
  uint32_t dq[D::NT][2];
  if (active) {
    float s[KT][KEYS][4], dp[KT][KEYS][4];
#pragma unroll
    for (int kt = 0; kt < KT; ++kt) {
      tiles::qk_tile<HD>(s[kt], sq, sk + kt * tiles::TILE * D::LD, warp, lane);
      tiles::qk_tile<HD>(dp[kt], sd, sv + kt * tiles::TILE * D::LD, warp, lane);
    }
    float m0 = -INFINITY, m1 = -INFINITY;
#pragma unroll
    for (int kt = 0; kt < KT; ++kt)
#pragma unroll
      for (int j = 0; j < KEYS; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = kt * tiles::TILE + 8 * j + 2 * c + (e & 1);
          const float l = col < t ? s[kt][j][e] * inv_sqrt_hd : -INFINITY;
          s[kt][j][e] = l;
          if (e < 2) m0 = fmaxf(m0, l);
          else m1 = fmaxf(m1, l);
        }
    m0 = tiles::quad_max(m0);
    m1 = tiles::quad_max(m1);
    float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
    for (int kt = 0; kt < KT; ++kt)
#pragma unroll
      for (int j = 0; j < KEYS; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float x = tiles::exp2_approx((s[kt][j][e] - (e < 2 ? m0 : m1)) * tiles::LOG2E);
          s[kt][j][e] = x;
          if (e < 2) sum0 += x;
          else sum1 += x;
        }
    // query rows past T take p = 0, so dlog = 0 there too (the shuffles
    // run on every lane)
    sum0 = tiles::quad_sum(sum0);
    sum1 = tiles::quad_sum(sum1);
    const float inv0 = r0 + g < t ? 1.f / sum0 : 0.f;
    const float inv1 = r0 + g + 8 < t ? 1.f / sum1 : 0.f;
    float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
    for (int kt = 0; kt < KT; ++kt)
#pragma unroll
      for (int j = 0; j < KEYS; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p = s[kt][j][e] * (e < 2 ? inv0 : inv1);
          s[kt][j][e] = p;
          if (e < 2) rs0 += dp[kt][j][e] * p;
          else rs1 += dp[kt][j][e] * p;
        }
    rs0 = tiles::quad_sum(rs0);
    rs1 = tiles::quad_sum(rs1);
    uint32_t la[KT][KEYS / 2][4];
#pragma unroll
    for (int kt = 0; kt < KT; ++kt) {
#pragma unroll
      for (int j = 0; j < KEYS; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          // dlog = p*(dp - rowsum(dp*p)) / sqrt(hd), in place of dp
          dp[kt][j][e] = s[kt][j][e] * (dp[kt][j][e] - (e < 2 ? rs0 : rs1)) * inv_sqrt_hd;
        }
#pragma unroll
      for (int j = 0; j < KEYS; ++j) {
        const int col = kt * tiles::TILE + 8 * j + 2 * c;
        const int ra = (r0 + g) * L::LDP + col, rb = (r0 + g + 8) * L::LDP + col;
        *reinterpret_cast<uint32_t*>(sp + ra) = tiles::pack_bf16(s[kt][j][0], s[kt][j][1]);
        *reinterpret_cast<uint32_t*>(sp + rb) = tiles::pack_bf16(s[kt][j][2], s[kt][j][3]);
        *reinterpret_cast<uint32_t*>(sl + ra) = tiles::pack_bf16(dp[kt][j][0], dp[kt][j][1]);
        *reinterpret_cast<uint32_t*>(sl + rb) = tiles::pack_bf16(dp[kt][j][2], dp[kt][j][3]);
      }
      tiles::pack_p(la[kt], dp[kt]);
    }
    float o[D::NT][4];
#pragma unroll
    for (int j = 0; j < D::NT; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
#pragma unroll
    for (int kt = 0; kt < KT; ++kt) tiles::pv_tile<HD>(o, la[kt], sk + kt * tiles::TILE * D::LD, lane);
    normalize_vjp<HD, COHERENT>(o, dq, base, ld, rq, r0, t, lane);
  } else {
    // query rows all past T: p = dlog = 0, which phase B reads as zero
    // rows of its contraction
    for (int i = lane; i < 16 * (L::ROWS / 8); i += 32) {
      const int off = (r0 + i / (L::ROWS / 8)) * L::LDP + 8 * (i % (L::ROWS / 8));
      *reinterpret_cast<uint4*>(sp + off) = make_uint4(0u, 0u, 0u, 0u);
      *reinterpret_cast<uint4*>(sl + off) = make_uint4(0u, 0u, 0u, 0u);
    }
  }
  sync();

  // phase B, the warp's key rows: dv = p^T.do, dkn = dlog^T.qn, the A
  // operand read transposed from p and dlog
  uint32_t dk[D::NT][2], dv[D::NT][2];
  if (active) {
    const int a_row = (lane & 7) + ((lane >> 4) << 3), a_col = r0 + ((lane >> 3) & 1) * 8;
    float o[D::NT][4];
#pragma unroll
    for (int pass = 0; pass < 2; ++pass) {
      const __nv_bfloat16* src = pass == 0 ? sp : sl;
      const __nv_bfloat16* b = pass == 0 ? sd : sq;
#pragma unroll
      for (int j = 0; j < D::NT; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
#pragma unroll
      for (int qt = 0; qt < KT; ++qt) {
        uint32_t a[KEYS / 2][4];
#pragma unroll
        for (int kk = 0; kk < KEYS / 2; ++kk)
          tiles::ldsm_x4_trans(a[kk], src + (qt * tiles::TILE + kk * 16 + a_row) * L::LDP + a_col);
        tiles::pv_tile<HD>(o, a, b + qt * tiles::TILE * D::LD, lane);
      }
      if (pass == 0) pack_rows<HD>(o, dv);
      else normalize_vjp<HD, COHERENT>(o, dk, base + d, ld, rk, r0, t, lane);
    }
  }
  sync();

  // every tile is free: stage the warp's rows of dq, dk, dv and store them
  if (active) {
    stage_rows<HD>(dq, sq, r0, lane);
    stage_rows<HD>(dk, sk, r0, lane);
    stage_rows<HD>(dv, sv, r0, lane);
    __syncwarp();
    __nv_bfloat16* out = dqkv + (int64_t)sample * t * ld + head * HD;
    store_rows<HD>(sq, out, ld, r0, t, lane);
    store_rows<HD>(sk, out + d, ld, r0, t, lane);
    store_rows<HD>(sv, out + 2 * d, ld, r0, t, lane);
  }
}

}  // namespace attn_bwd_tiles
