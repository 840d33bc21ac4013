// fused_attention: standalone multi-head attention over (B, H, T, D')
// operands, softmax(norm(q) . norm(k)^T * scale) . v, with the row
// normalisation only under `cosine`.
//
// Replaces mapdit_tpu/ops/pallas/attention.py:125 _fused_attention_fwd_impl
// (fused_attention; its two pallas_calls, :145 the v2 kernel
// _attention_kernel :32 and :168 the head-pair-packed v3 kernel
// _attention_kernel_packed :65, compute the same function; the pairing is a
// 128x128 matrix-unit tile shape and is not carried over). It differs from
// cosine_attention.cu, the core of the block kernels, in four ways:
//   * operands are separate q, k, v of shape (B, H, T, D') addressed by
//     their batch, head and token strides (last dimension contiguous), so
//     the transposed views of a fused qkv product are read in place and no
//     head relayout copy is made; the output is written by strides too;
//   * `cosine` is a switch, and without it logits are unbounded, so the
//     softmax subtracts the row maximum (no max-free exp here);
//   * p is normalised before P.V;
//   * inputs are f32 or bf16.
// Roundings, those of the v3 Pallas kernel: under `cosine` the rows
// q * sqrt(D') / (||q|| + 1e-4) (norm and product in f32) are rounded to the
// input type, likewise k; logits are f32 sums of the products of those
// values, times `scale`; p = exp(l - max) / sum in f32 is rounded to v's
// type; the output is the f32 sum of p . v rounded to the input type. For
// f32 inputs nothing is rounded, which is the v2 kernel's arithmetic.
//
// Bound on the H100: bytes. At B/2 (T = 64, D' = 64) a head moves 4*T*D'
// bf16 elements for 4*T*T*D' flops, 32 flops a byte against the ~295 the
// tensor cores need.
//
// bf16 (every model path): one block of 4 warps per (query tile of 64, head,
// batch), 16 query rows a warp, both products on the tensor cores
// (mma.sync m16n8k16, attention_tiles.cuh). Rows are read with 16-byte
// loads, four lanes a row, into registers (fetch); the Q tile's and the
// first K and V tiles' loads are all in flight before any is used. Under
// `cosine` the pass that stores a row in shared memory (commit) takes its
// f32 norm (quad shuffles) and stores the normalised row rounded to bf16,
// so Q is normalised once and each K tile in the pass that brings it to
// shared memory. Keys run in tiles of 64, so T is not limited by shared
// memory (34 KB at D' = 72, whose Q.K^T contraction is padded to 80 with
// zero columns):
//   * T <= 64 (every main-path shape): one key tile; row max and sum by
//     quad shuffles over the fragments in registers, p = e * (1 / sum)
//     rounded to bf16 and repacked as the A operand of P.V;
//   * T > 64: a first sweep takes the row maximum and the row sum online
//     (the sum rescaled when the maximum grows), a second recomputes the
//     logits, forms p = exp(l - max) * (1 / sum), rounds it and multiplies:
//     the roundings of the one-tile case at every T. (The single-sweep
//     FlashAttention form would round exp(l - running max) instead of p.)
// exp is ex2.approx with log2(e) folded into the argument (exp2_approx),
// and p is e times the row's reciprocal: exp2f's accurate sequence and an
// IEEE division per element slowed every row, most those without cosine at
// large logits, where most p underflow to 0 (0.0369 ms with both, 0.0268
// with ex2.approx, 0.0102 with the reciprocal, at (64,12,64,64)).
// The output is staged in the warp's own Q rows and written with 16-byte
// stores, so the base and every stride of q, k, v and out must be 16-byte
// aligned (the wrapper checks). D' is 64 or 72, every registry head width.
// Forms measured beside this one, each in one call with it
// (tools/bench_attention.py on a copy of the tree; the variants are not
// kept; PERF.md; NVIDIA H100 80GB HBM3, 700 W; ms at (64,12,64,64) /
// (256,12,64,64) / XL head (64,16,64,72)):
//   * the f32-pipe first form (below, then also for bf16): 0.1394 / 0.5375
//     / 0.2254;
//   * Q committed before the K and V loads are issued, exp2f: 0.0139 /
//     0.0500 / 0.0215; with the loads overlapped: 0.0130 / 0.0466 / 0.0244
//     (166 registers at D' = 72, three blocks an SM);
//   * the same capped at 128 registers (spills): 0.0134 / 0.0468 / 0.0257;
//   * with ex2.approx: 0.0122 / 0.0458 / 0.0241;
//   * this form (and the reciprocal): 0.0110 / 0.0421 / 0.0211.
// wgmma (m64nNk16, one warpgroup a 64-row tile) is not built or measured.
//
// f32 (attention_impl="pallas" under compute_dtype="float32", off the main
// path): the f32 pipes, as the first form. Its rows are held to 1e-5 / 1e-4
// against the plain version, which neither bf16 nor TF32 products meet. K
// and V of the head, the query tile and a qt x T tile of logits live in
// shared memory as f32 (rows padded by one element against bank
// conflicts); the host picks the largest qt that fits 227 KB (T = 256,
// D' = 72 takes qt = 32, 191,616 bytes), which limits T.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <math_constants.h>
#include <stdint.h>

#include "attention_tiles.cuh"

namespace {

using namespace attn_tiles;

struct Strides {
  long long b, h, t;
};

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* out;
  int t, hd, qt;
  Strides sq, sk, sv, so;
  float scale;
  int cosine;
};

// ---------------------------------------------------------------------------
// bf16 on the tensor cores

// Rows [0, TILE) of a bf16 operand, a thread's share held in registers
// between the loads (fetch) and the tile (commit), so that several tiles'
// loads are in flight at once.
template <int HD>
struct Rows {
  static constexpr int C8 = HD / 8;         // 16-byte chunks of a row
  static constexpr int PER = (C8 + 3) / 4;  // chunks a lane takes, four lanes a row
  static constexpr int PASSES = TILE / (THREADS / 4);
  uint4 x[PASSES][PER];
};

// rows >= `rows` read as zeros
template <int HD>
__device__ __forceinline__ void fetch(Rows<HD>& f, const __nv_bfloat16* src, long long ld_src, int rows) {
  using R = Rows<HD>;
  const int sub = threadIdx.x & 3;
#pragma unroll
  for (int p = 0; p < R::PASSES; ++p) {
    const int r = (threadIdx.x >> 2) + p * (THREADS / 4);
    const uint4* row = reinterpret_cast<const uint4*>(src + r * ld_src);
#pragma unroll
    for (int j = 0; j < R::PER; ++j) {
      const int c = sub + 4 * j;
      f.x[p][j] = (r < rows && c < R::C8) ? __ldg(row + c) : make_uint4(0u, 0u, 0u, 0u);
    }
  }
}

// the rows (pad columns zero) into `tile`; under `cosine` each row is
// normalised in f32 and rounded back to bf16 first
template <int HD>
__device__ __forceinline__ void commit(Rows<HD>& f, __nv_bfloat16* tile, int cosine) {
  using D = Dims<HD>;
  using R = Rows<HD>;
  const int sub = threadIdx.x & 3;
  const float sqrt_hd = sqrtf((float)HD);
#pragma unroll
  for (int p = 0; p < R::PASSES; ++p) {
    const int r = (threadIdx.x >> 2) + p * (THREADS / 4);
    __nv_bfloat16* dst = tile + r * D::LD;
    if (cosine) {
      float ss = 0.f;
#pragma unroll
      for (int j = 0; j < R::PER; ++j) {
        const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&f.x[p][j]);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float2 v = __bfloat1622float2(h[i]);
          ss += v.x * v.x + v.y * v.y;
        }
      }
      const float scale = sqrt_hd / (sqrtf(quad_sum(ss)) + NORM_EPS);
#pragma unroll
      for (int j = 0; j < R::PER; ++j) {
        uint32_t* w = reinterpret_cast<uint32_t*>(&f.x[p][j]);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float2 v = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[i]));
          w[i] = pack_bf16(v.x * scale, v.y * scale);
        }
      }
    }
#pragma unroll
    for (int j = 0; j < R::PER; ++j) {
      const int c = sub + 4 * j;
      if (c < R::C8) *reinterpret_cast<uint4*>(dst + 8 * c) = f.x[p][j];
    }
    for (int c = HD + 8 * sub; c < D::KP; c += 32) *reinterpret_cast<uint4*>(dst + c) = make_uint4(0u, 0u, 0u, 0u);
  }
}

// l = scale * q.k for the warp's rows against one key tile (S fragment
// layout); keys >= `keys` give -inf
template <int HD>
__device__ __forceinline__ void logit_tile(float (&s)[KEY_TILES][4], const __nv_bfloat16* sq,
                                           const __nv_bfloat16* sk, float scale, int keys, int warp, int lane) {
  qk_tile<HD>(s, sq, sk, warp, lane);
  const int c = lane & 3;
#pragma unroll
  for (int j = 0; j < KEY_TILES; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] = 8 * j + 2 * c + (e & 1) < keys ? s[j][e] * scale : -CUDART_INF_F;
}

__device__ __forceinline__ void row_max(float& m0, float& m1, const float (&s)[KEY_TILES][4]) {
#pragma unroll
  for (int j = 0; j < KEY_TILES; ++j) {
    m0 = fmaxf(m0, fmaxf(s[j][0], s[j][1]));
    m1 = fmaxf(m1, fmaxf(s[j][2], s[j][3]));
  }
  m0 = quad_max(m0);
  m1 = quad_max(m1);
}

// s = exp(l - m) in place, m the row maximum
__device__ __forceinline__ void exp_rows(float (&s)[KEY_TILES][4], float m0, float m1) {
#pragma unroll
  for (int j = 0; j < KEY_TILES; ++j) {
    s[j][0] = exp2_approx((s[j][0] - m0) * LOG2E);
    s[j][1] = exp2_approx((s[j][1] - m0) * LOG2E);
    s[j][2] = exp2_approx((s[j][2] - m1) * LOG2E);
    s[j][3] = exp2_approx((s[j][3] - m1) * LOG2E);
  }
}

template <int HD>
__global__ void __launch_bounds__(THREADS) fused_attention_mma(Params p) {
  using D = Dims<HD>;
  __shared__ __align__(16) __nv_bfloat16 sq[TILE * D::LD];
  __shared__ __align__(16) __nv_bfloat16 sk[TILE * D::LD];
  __shared__ __align__(16) __nv_bfloat16 sv[TILE * D::LD];

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const long long b = blockIdx.z, h = blockIdx.y;
  const int t = p.t, q0 = blockIdx.x * TILE;
  const int rows = min(TILE, t - q0);
  const bool active = warp * 16 < rows;
  const int tiles = (t + TILE - 1) / TILE;
  const __nv_bfloat16* qg = static_cast<const __nv_bfloat16*>(p.q) + b * p.sq.b + h * p.sq.h + q0 * p.sq.t;
  const __nv_bfloat16* kg = static_cast<const __nv_bfloat16*>(p.k) + b * p.sk.b + h * p.sk.h;
  const __nv_bfloat16* vg = static_cast<const __nv_bfloat16*>(p.v) + b * p.sv.b + h * p.sv.h;
  __nv_bfloat16* og = static_cast<__nv_bfloat16*>(p.out) + b * p.so.b + h * p.so.h + q0 * p.so.t;

  Rows<HD> fq, fk, fv;
  fetch<HD>(fq, qg, p.sq.t, rows);

  float s[KEY_TILES][4];
  uint32_t pa[KEY_TILES / 2][4];
  float o[D::NT][4];
#pragma unroll
  for (int j = 0; j < D::NT; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
  float m0 = -CUDART_INF_F, m1 = -CUDART_INF_F, sum0 = 0.f, sum1 = 0.f;

  if (tiles > 1) {  // first sweep: row maximum and sum, online
    for (int kt = 0; kt < tiles; ++kt) {
      fetch<HD>(fk, kg + kt * TILE * p.sk.t, p.sk.t, min(TILE, t - kt * TILE));
      __syncthreads();
      if (kt == 0) commit<HD>(fq, sq, p.cosine);
      commit<HD>(fk, sk, p.cosine);
      __syncthreads();
      if (!active) continue;
      logit_tile<HD>(s, sq, sk, p.scale, t - kt * TILE, warp, lane);
      float n0 = m0, n1 = m1;
      row_max(n0, n1, s);
      sum0 *= exp2_approx((m0 - n0) * LOG2E);
      sum1 *= exp2_approx((m1 - n1) * LOG2E);
      m0 = n0;
      m1 = n1;
      exp_rows(s, m0, m1);
      add_row_sums(sum0, sum1, s);
    }
    sum0 = quad_sum(sum0);
    sum1 = quad_sum(sum1);
  }

  for (int kt = 0; kt < tiles; ++kt) {
    const int keys = t - kt * TILE;
    fetch<HD>(fk, kg + kt * TILE * p.sk.t, p.sk.t, min(TILE, keys));
    fetch<HD>(fv, vg + kt * TILE * p.sv.t, p.sv.t, min(TILE, keys));
    __syncthreads();
    if (kt == 0 && tiles == 1) commit<HD>(fq, sq, p.cosine);
    commit<HD>(fk, sk, p.cosine);
    commit<HD>(fv, sv, 0);
    __syncthreads();
    if (!active) continue;
    logit_tile<HD>(s, sq, sk, p.scale, keys, warp, lane);
    if (tiles == 1) row_max(m0, m1, s);
    exp_rows(s, m0, m1);
    if (tiles == 1) {
      add_row_sums(sum0, sum1, s);
      sum0 = quad_sum(sum0);
      sum1 = quad_sum(sum1);
    }
    const float inv0 = 1.f / sum0, inv1 = 1.f / sum1;
#pragma unroll
    for (int j = 0; j < KEY_TILES; ++j) {
      s[j][0] *= inv0;
      s[j][1] *= inv0;
      s[j][2] *= inv1;
      s[j][3] *= inv1;
    }
    pack_p(pa, s);
    pv_tile<HD>(o, pa, sv, lane);
  }
  if (active) store_rows<HD>(o, 1.f, 1.f, sq, og, p.so.t, rows, warp, lane);
}

// ---------------------------------------------------------------------------
// f32 on the f32 pipes

constexpr int F32_THREADS = 256;

__host__ __device__ inline int row_stride(int hd) { return hd + 1; }

__host__ inline size_t smem_bytes(int t, int hd, int qt) {
  return ((size_t)(2 * t + qt) * row_stride(hd) + (size_t)qt * t) * sizeof(float);
}

__global__ void __launch_bounds__(F32_THREADS) fused_attention_f32(Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int t = p.t, hd = p.hd;
  const int ld = row_stride(hd);
  float* ks = reinterpret_cast<float*>(smem);
  float* vs = ks + t * ld;
  float* qs = vs + t * ld;
  float* lg = qs + p.qt * ld;

  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;
  const int nwarps = F32_THREADS / 32;
  const long long b = blockIdx.z, h = blockIdx.y;
  const int q0 = blockIdx.x * p.qt;
  const int rows = min(p.qt, t - q0);

  const float* qg = static_cast<const float*>(p.q) + b * p.sq.b + h * p.sq.h + (long long)q0 * p.sq.t;
  const float* kg = static_cast<const float*>(p.k) + b * p.sk.b + h * p.sk.h;
  const float* vg = static_cast<const float*>(p.v) + b * p.sv.b + h * p.sv.h;
  float* og = static_cast<float*>(p.out) + b * p.so.b + h * p.so.h + (long long)q0 * p.so.t;

  for (int i = tid; i < t * hd; i += F32_THREADS) {
    const int r = i / hd, c = i % hd;
    ks[r * ld + c] = kg[r * p.sk.t + c];
    vs[r * ld + c] = vg[r * p.sv.t + c];
  }
  for (int i = tid; i < rows * hd; i += F32_THREADS) {
    const int r = i / hd, c = i % hd;
    qs[r * ld + c] = qg[r * p.sq.t + c];
  }
  __syncthreads();

  if (p.cosine) {
    // one warp per k or q row: norm, then the scaled row
    const float sqrt_hd = sqrtf((float)hd);
    for (int r = warp; r < t + rows; r += nwarps) {
      float* row = r < t ? ks + r * ld : qs + (r - t) * ld;
      float s = 0.f;
      for (int c = lane; c < hd; c += 32) s += row[c] * row[c];
      for (int off = 16; off > 0; off /= 2) s += __shfl_xor_sync(0xffffffffu, s, off);
      const float f = sqrt_hd / (sqrtf(s) + NORM_EPS);
      for (int c = lane; c < hd; c += 32) row[c] *= f;
    }
    __syncthreads();
  }

  for (int i = tid; i < rows * t; i += F32_THREADS) {
    const int r = i / t, c = i % t;
    const float* qr = qs + r * ld;
    const float* kc = ks + c * ld;
    float acc = 0.f;
    for (int j = 0; j < hd; ++j) acc += qr[j] * kc[j];
    lg[i] = acc * p.scale;
  }
  __syncthreads();

  // one warp per query row: max, exp and sum, then p
  for (int r = warp; r < rows; r += nwarps) {
    float* row = lg + r * t;
    float m = -CUDART_INF_F;
    for (int c = lane; c < t; c += 32) m = fmaxf(m, row[c]);
    for (int off = 16; off > 0; off /= 2) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
    float s = 0.f;
    for (int c = lane; c < t; c += 32) {
      const float e = expf(row[c] - m);
      row[c] = e;
      s += e;
    }
    for (int off = 16; off > 0; off /= 2) s += __shfl_xor_sync(0xffffffffu, s, off);
    for (int c = lane; c < t; c += 32) row[c] /= s;
  }
  __syncthreads();

  for (int i = tid; i < rows * hd; i += F32_THREADS) {
    const int r = i / hd, c = i % hd;
    const float* pr = lg + r * t;
    float acc = 0.f;
    for (int j = 0; j < t; ++j) acc += pr[j] * vs[j * ld + c];
    og[r * p.so.t + c] = acc;
  }
}

int launch_f32(const Params& p, int b, int h, cudaStream_t stream) {
  const size_t smem = smem_bytes(p.t, p.hd, p.qt);
  cudaError_t err =
      cudaFuncSetAttribute(fused_attention_f32, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((p.t + p.qt - 1) / p.qt, h, b);
  fused_attention_f32<<<grid, F32_THREADS, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <int HD>
int launch_mma(const Params& p, int b, int h, cudaStream_t stream) {
  dim3 grid((p.t + TILE - 1) / TILE, h, b);
  fused_attention_mma<HD><<<grid, THREADS, 0, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" size_t fused_attention_smem_bytes(int t, int hd, int qt) {
  return smem_bytes(t, hd, qt);
}

// dtype: 0 = f32, 1 = bf16 (q, k, v and out alike). Strides are in elements:
// batch, head, token for each of q, k, v, out; the last dimension is
// contiguous. f32: qt is the query tile, chosen by the caller so that
// fused_attention_smem_bytes(t, hd, qt) fits the card's limit. bf16: hd is
// 64 or 72, every base and stride 16-byte aligned; qt is not read.
extern "C" int fused_attention(const void* q, const void* k, const void* v, void* out, int dtype,
                               int b, int h, int t, int hd, const long long* strides, float scale,
                               int cosine, int qt, void* stream) {
  Params p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.out = out;
  p.t = t;
  p.hd = hd;
  p.qt = qt;
  p.sq = {strides[0], strides[1], strides[2]};
  p.sk = {strides[3], strides[4], strides[5]};
  p.sv = {strides[6], strides[7], strides[8]};
  p.so = {strides[9], strides[10], strides[11]};
  p.scale = scale;
  p.cosine = cosine;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_f32(p, b, h, s);
  switch (hd) {
    case 64:
      return launch_mma<64>(p, b, h, s);
    case 72:
      return launch_mma<72>(p, b, h, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" const char* fused_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
