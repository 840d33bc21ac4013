// cosine_attention: the attention core of the DiT block on the tensor cores.
//
// Replaces mapdit_tpu/ops/pallas/dit_block.py:129 _attention_core with
// _cosine_scales (:49), the body shared by the whole-block, whole-stack and
// attention half-block Pallas kernels, and, in residual mode, the attention
// of _attn_res_kernel (:1083-1124, under _attn_res_fwd_impl :1152). Input is
// the flat f32 qkv product (N*T, 3D) with heads as contiguous column slices
// (no head relayout); output is the pre-projection attention (N*T, D) in
// bf16. Roundings, those of the Pallas bodies:
//   * per-row cosine scales qs, ks = sqrt(hd) / (||row|| + 1e-4), from the
//     f32 rows;
//   * logits = (bf16(q) . bf16(k)) summed in f32, * 1/sqrt(hd) * qs_i * ks_j;
//   * max-free softmax ex = exp(l - sqrt(hd)): cosine logits are bounded by
//     sqrt(hd), so no row max is needed and no exponent overflows; exp is
//     ex2.approx with log2(e) folded into the argument (exp2_approx);
//   * normal mode: o = (bf16(ex) . bf16(v)) * (1 / sum ex), the division
//     after P.V;
//   * residual mode (normalize_first = 1): p = ex * (1 / sum ex) in f32,
//     written as (N, heads, T, T) when p_out is given, then
//     o = bf16(p) . bf16(v).
// The two modes round at different places, as the two Pallas kernels do.
// There is no f32 output: the products are bf16 on the tensor cores, so the
// wrapper refuses out_dtype=float32 on the card (the plain version takes it
// on the CPU, where nothing is rounded).
//
// Bound on the H100: bytes. At T = 64, hd = 64 a (sample, head) reads
// 3*T*hd f32 and writes T*hd bf16 for 4*T*T*hd flops, ~10 flops a byte
// against the ~295 the tensor cores need; residual mode adds T*T f32 of p.
//
// Design. One block of 4 warps per (head, sample, tile of 64 query rows);
// each warp owns 16 query rows (attention_tiles.cuh). Every byte of qkv a
// block needs is read once with 16-byte loads, four lanes a row, into
// registers (fetch); the Q tile's and the first K and V tiles' loads are
// all in flight before any is used. The pass that stores a row in shared
// memory as bf16 (commit) also takes its f32 sum of squares (quad
// shuffles), so the norms cost no second read. Keys run in tiles of 64, so
// T is not limited by shared memory (34 KB at hd = 72):
//   * normal mode adds O and sum ex over the key tiles (max-free: nothing
//     is rescaled, the roundings stay);
//   * residual mode needs the row sums before p, so for T > 64 a first
//     sweep takes them and a second recomputes the logits, forms p, writes
//     it and multiplies; at T <= 64 one sweep does both.
// Logits and p stay in registers (16 rows x 64 keys a warp); p is repacked
// from the accumulator fragments as the A operand of P.V; ragged 16-row
// and 64-key tiles are masked (zero rows, ex = 0). The output is staged in
// the warp's own Q rows and written with 16-byte stores; p is written from
// the fragments as 8-byte stores, each quad filling a 32-byte sector.
// Grid: (heads, N, ceil(T / 64)); at S/2 that is 384 blocks of 128 threads,
// several resident on each SM, whose loads overlap each other's products.
// Forms measured beside this one, each in one call with it
// (tools/bench_attention.py on a copy of the tree; the variants are not
// kept; PERF.md; NVIDIA H100 80GB HBM3, 700 W; ms at S/2 sampling /
// residual N=256 / XL head):
//   * the f32-pipe first form (one block per (sample, head), T x T
//     exponentials in shared memory): 0.0822 / 0.3005 / 0.0520 ms;
//   * Q committed before the K and V loads are issued, exp2f: 0.0075 /
//     0.0443 / 0.0064; with the loads overlapped: 0.0077 / 0.0440 / 0.0058;
//   * the same capped at 128 registers (4 blocks an SM; spills): 0.0082 /
//     0.0466 / 0.0075;
//   * p staged in shared memory for 16-byte stores: residual 0.0448 against
//     0.0443 for 8-byte stores from the fragments;
//   * this form (loads overlapped, ex2.approx): 0.0069 / 0.0417 / 0.0048.
// wgmma (m64nNk16, one warpgroup a 64-row tile) is not built: at S/2 this
// form takes 0.0069 ms against a byte bound of 0.0066, so faster products
// have at most 5% to win there.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "attention_tiles.cuh"
#include "cosine_tiles.cuh"

namespace {

using namespace attn_tiles;
using namespace cosine_tiles;

template <int HD, bool RESIDUAL>
__global__ void __launch_bounds__(THREADS)
    cosine_attention_kernel(const float* __restrict__ qkv, __nv_bfloat16* __restrict__ out,
                            float* __restrict__ p_out, int t, int heads) {
  using D = Dims<HD>;
  __shared__ __align__(16) __nv_bfloat16 sq[TILE * D::LD];
  __shared__ __align__(16) __nv_bfloat16 sk[TILE * D::LD];
  __shared__ __align__(16) __nv_bfloat16 sv[TILE * D::LD];
  __shared__ float qsc[TILE], ksc[TILE];

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, c = lane & 3;
  const int head = blockIdx.x, sample = blockIdx.y, q0 = blockIdx.z * TILE;
  const int d = heads * HD;
  const int64_t ld = 3 * (int64_t)d;
  const float* base = qkv + (int64_t)sample * t * ld + head * HD;
  const int rows = min(TILE, t - q0);
  const bool active = warp * 16 < rows;
  const int tiles = (t + TILE - 1) / TILE;

  Rows<HD> fq, fk, fv;
  fetch<HD>(fq, base + q0 * ld, ld, rows, threadIdx.x);

  float s[KEY_TILES][4];
  uint32_t pa[KEY_TILES / 2][4];
  float o[D::NT][4];
#pragma unroll
  for (int j = 0; j < D::NT; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
  float sum0 = 0.f, sum1 = 0.f;

  if (RESIDUAL && tiles > 1) {  // first sweep: the row sums
    for (int kt = 0; kt < tiles; ++kt) {
      fetch<HD>(fk, base + d + kt * TILE * ld, ld, min(TILE, t - kt * TILE), threadIdx.x);
      __syncthreads();
      if (kt == 0) commit<HD>(fq, sq, qsc, threadIdx.x);
      commit<HD>(fk, sk, ksc, threadIdx.x);
      __syncthreads();
      if (active) {
        exp_tile<HD>(s, sq, sk, qsc, ksc, t - kt * TILE, warp, lane);
        add_row_sums(sum0, sum1, s);
      }
    }
    sum0 = quad_sum(sum0);
    sum1 = quad_sum(sum1);
  }

  float* p_rows = nullptr;
  if (RESIDUAL && p_out != nullptr)
    p_rows = p_out + ((int64_t)sample * heads + head) * t * t + (int64_t)(q0 + warp * 16 + g) * t;
  for (int kt = 0; kt < tiles; ++kt) {
    const int keys = t - kt * TILE;
    fetch<HD>(fk, base + d + kt * TILE * ld, ld, min(TILE, keys), threadIdx.x);
    fetch<HD>(fv, base + 2 * d + kt * TILE * ld, ld, min(TILE, keys), threadIdx.x);
    __syncthreads();
    if (kt == 0 && !(RESIDUAL && tiles > 1)) commit<HD>(fq, sq, qsc, threadIdx.x);
    commit<HD>(fk, sk, ksc, threadIdx.x);
    commit<HD>(fv, sv, nullptr, threadIdx.x);
    __syncthreads();
    if (!active) continue;
    exp_tile<HD>(s, sq, sk, qsc, ksc, keys, warp, lane);
    if (!RESIDUAL) {
      add_row_sums(sum0, sum1, s);
    } else {
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
      if (p_rows != nullptr) {
        const int r0 = q0 + warp * 16 + g;
#pragma unroll
        for (int j = 0; j < KEY_TILES; ++j) {
          const int col = kt * TILE + 8 * j + 2 * c;
          if (col < t) {
            if (r0 < t) *reinterpret_cast<float2*>(p_rows + col) = make_float2(s[j][0], s[j][1]);
            if (r0 + 8 < t) *reinterpret_cast<float2*>(p_rows + 8 * (int64_t)t + col) = make_float2(s[j][2], s[j][3]);
          }
        }
      }
    }
    pack_p(pa, s);
    pv_tile<HD>(o, pa, sv, lane);
  }
  if (!active) return;
  float f0 = 1.f, f1 = 1.f;
  if (!RESIDUAL) {
    f0 = 1.f / quad_sum(sum0);
    f1 = 1.f / quad_sum(sum1);
  }
  store_rows<HD>(o, f0, f1, sq, out + ((int64_t)sample * t + q0) * d + head * HD, d, rows, warp, lane);
}

template <int HD>
int launch(const float* qkv, __nv_bfloat16* out, float* p_out, int normalize_first, int n, int t, int heads,
           cudaStream_t stream) {
  dim3 grid(heads, n, (t + TILE - 1) / TILE);
  if (normalize_first)
    cosine_attention_kernel<HD, true><<<grid, THREADS, 0, stream>>>(qkv, out, p_out, t, heads);
  else
    cosine_attention_kernel<HD, false><<<grid, THREADS, 0, stream>>>(qkv, out, p_out, t, heads);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// qkv: f32 (n*t, 3*heads*hd), 16-byte aligned; out: bf16 (n*t, heads*hd);
// p_out: f32 (n, heads, t, t) or null (residual mode only). hd is 64 or 72
// (every registry head width) and t is even.
extern "C" int cosine_attention(const void* qkv, void* out, void* p_out, int normalize_first, int n, int t,
                                int heads, int hd, void* stream) {
  const float* q = static_cast<const float*>(qkv);
  __nv_bfloat16* o = static_cast<__nv_bfloat16*>(out);
  float* p = static_cast<float*>(p_out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 64:
      return launch<64>(q, o, p, normalize_first, n, t, heads, s);
    case 72:
      return launch<72>(q, o, p, normalize_first, n, t, heads, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" const char* cosine_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
