// attn_branch_bwd: the non-GEMM kernels of the attention half-block's fused
// backward.
//
// Replaces mapdit_tpu/ops/pallas/dit_block.py:_attn_bwd_kernel with its
// body _attn_bwd_math (reached from _attn_bwd_impl, the attn_bwd="pallas"
// VJP of fused_attn_branch). The Pallas kernel holds a group of samples in
// VMEM and runs the whole recompute + hand VJP there; on Hopper the four
// products of width D or 3D go to csrc/mp_gemm.cu (qkv, out, dattn = dout .
// Wout, dh = dqkv . Wqkv) and the stages between them are these kernels.
// The residual backward (a), db = dy*0.3/rd, dgate_rows = sum_t db*out,
// dout = bf16(db*gate), is the out product's epilogue in mp_gemm.cu
// (mp_gemm_gate_residual_bwd), so out is never stored; the direct path
// dx0 = dy*0.7/rd is formed by (c).
//
//   (b) attention_bwd       one block per (sample, head): recompute the q/k
//         norms and the exact softmax p of the pre-normalised, bf16-rounded
//         q/k, then dv = bf16(p)^T bf16(do), dp = bf16(do) bf16(v)^T,
//         dlog = p*(dp - rowsum(dp*p))/sqrt(hd), dqn = bf16(dlog) bf16(kn),
//         dkn = bf16(dlog)^T bf16(qn), and the FULL quotient VJP of
//         normalize (its denominator is a live edge in the reference):
//         dz = c*dzn - z*(sum(z*dzn)*sqrt(hd)/(r*(r+eps)^2)), c = sqrt(hd)/(r+eps)
//   (c) modulate_fwd / modulate_bwd   h = (u + (shift-u)*g)/den, u = x*scale,
//         den = sqrt((1-g)^2 + g^2) constant in g: h in bf16 for the qkv
//         GEMM and dW_qkv; du = dh*(1-g)/den, dx = dy*0.7/rd + du*scale,
//         dshift_rows = sum_t dh * g/den, dscale_rows = sum_t du*x,
//         dgain = sum(dh*(shift-u))/den over the whole batch.
//
// No float atomics anywhere: every sum runs in a fixed order, so the bits do
// not change from run to run (the Pallas grid accumulated the same sums
// sequentially, l.768-780).
//
// The f32 forms (a float32 model: _attn_bwd_math at dtype = float32, where
// nothing is rounded): attention_bwd_f32 (f32 dqkv; one block of four warps
// a (sample, head) on attention_bwd_f32.cuh, the products on the f32 pipes,
// T up to 256 in tiles of 64) and modulate_fwd_f32 (f32 h); modulate_bwd
// takes f32 x, dy and dh as it stands. Bound of attention_bwd_f32 at the S/2
// shape: its 10*T*T*hd flops a (sample, head) on the f32 pipes (67
// TFLOP/s), 0.0601 ms, above its bytes' 0.0526 (f32 qkv and dattn read,
// f32 dqkv written).
//
// Bound on the H100 at the DiT-S/2 training shapes (N = 256, T = 64,
// D = 384, 6 heads): (c) are elementwise passes over a few (N, T, D)
// arrays, memory-bound: modulate_fwd reads x and writes h (bf16),
// 25.95 MB, 0.0077 ms; modulate_bwd reads dh (f32), x and dy (bf16) and
// writes dx (bf16), 64.5 MB, 0.0193 ms. (b) reads 4*T*hd f32 (q, k, v, do) and writes
// 3*T*hd bf16 per (sample, head) and does 10*T*T*hd flops, ~20 flops a
// byte against the ~295 of the tensor cores: bound by bytes, 0.0413 ms for
// the 100.7 MB read and 37.7 MB written at that shape.
//
// (b)'s design. One block per (sample, head) and one warp per 16 query
// rows (four warps: T <= 64, one key tile; the form past 64 below), on
// the tensor cores through
// attention_tiles.cuh (mma.sync m16n8k16 bf16 products, f32 sums, operands
// read with ldmatrix from bf16 tiles with padded rows):
//   * q, k, v and do are read once, 16 bytes a lane and four lanes a row,
//     and stored as bf16 tiles (qn and kn already normalised, head width
//     72 padded with zero columns to 80); the pass that normalises q and k
//     takes each row's f32 norm with quad shuffles and keeps it;
//   * each warp keeps its 16 rows of S = qn.kn^T and dP = do.v^T (one
//     key tile of 64) in registers and takes the exact softmax
//     (row maximum, exponentials, row sum), rowsum(dp*p) and dlog there,
//     a row lying on the four lanes of a quad; keys past T are masked, and
//     query rows past T get p = dlog = 0, so they add nothing to dv or dkn;
//   * dqn = bf16(dlog).kn from the accumulators repacked as A fragments,
//     as P.V is done in the forward;
//   * bf16(p) and bf16(dlog) go to shared memory, where each warp takes
//     its 16 key rows of dv = p^T.do and dkn = dlog^T.qn, reading the A
//     operand with ldmatrix.trans (a key is a row there);
//   * the normalize VJP works on the accumulator fragments: Sum z*dzn is a
//     quad reduction, with the raw f32 rows of q and k read again (from
//     L2) in the fragment layout and the norms from the load pass;
//   * dq, dk and dv are staged as bf16 in the warp's own rows of the
//     tiles and written with 16-byte stores, each element once: no
//     atomics, the same bits on every run.
// Shared memory: four bf16 tiles and p, dlog, 55.8 KB at T = 64 and hd 64
// (four blocks an SM), 63.5 KB at hd 72. This form is also row 4's
// persistent kernel's attention stage (attention_bwd_tiles.cuh).
// Past T = 64 (up to 256, 32 x 32 latents at patch 2) a second form keeps
// no T x T array (p and dlog would take 270 KB at T = 256): one block of
// eight warps per (sample, head) holds the T rows of qn, kn, v and do as
// bf16, rounded up to 128 rows (74 KB at T = 128 and hd 64, 148 KB at
// T = 256, 180 KB at hd 72: one block an SM there) and recomputes S and dP
// from them:
//   * phase A, 16 query rows a warp: a first sweep over the key tiles of
//     64 takes sum ex and sum dp*ex of each row, the exponent max-free,
//     ex = exp(l - sqrt(hd)) (cosine logits are bounded by sqrt(hd), as in
//     the forward kernels), so 1/sum and rowsum(dp*p) = sum(dp*ex)/sum go
//     to shared memory; a second sweep forms p and dlog tile by tile and
//     adds dqn = bf16(dlog).kn over the key tiles;
//   * phase B, 16 key rows a warp: S^T = kn.qn^T and dP^T = v.do^T against
//     each tile of 64 queries, p and dlog from the stored row sums, and
//     dv = bf16(p)^T.do, dkn = bf16(dlog)^T.qn added over the query tiles;
//   * dq, dk and dv are written once each from the fragments (after the
//     normalize VJP): every sum runs in a fixed order, no atomics.
// Its roundings are the first form's (bf16 operands of every product, p
// and dlog in f32 between them) but for the max-free exponent and
// rowsum(dp*p) taken as sum(dp*ex)/sum. The bf16 roundings are the plain version's
// (attn_branch._attention_vjp): bf16 operands of every product, p and dlog
// in f32 between them. Two f32 steps differ from it besides the order of
// the sums, as in the forward kernels: the exponent is ex2.approx.ftz of
// (l - max) * log2(e) (~2 ulp; torch.softmax takes expf, also ~2 ulp, and
// an IEEE division; the flush below 2^-126 never acts, as cosine logits
// lie within +-sqrt(hd)), and p = e * (1 / sum), one rounding more. Taking expf
// and dividing each element held the same checks and cost 0.0869 ms
// against 0.0779 at the S/2 shape (PERF.md).
// The first form of (b) (one 256-thread block per (sample, head) with
// 117 KB of shared memory, the five T x T x hd products as scalar f32 loops
// over bf16 values) took 1.1460 ms at the S/2 shape (PERF.md).
//
// (c)'s design. Both passes take eight consecutive columns a thread with
// 16-byte accesses (D % 8 == 0 and 16-byte aligned bases; the wrapper
// raises otherwise) and the modulate arithmetic of modulate.cuh, the one
// mp_gemm's prologue runs:
//   * modulate_fwd: grid (token blocks, N), block (D/8 chunks, RY rows); a
//     thread reads its eight shift and scale values once and takes
//     FWD_ROWS token rows of one sample, their loads issued together. The
//     sample is blockIdx.y: no integer division per element (the first
//     form took two 64-bit divisions an element).
//   * modulate_bwd: grid (D/128 column blocks, N or N/2), block (16
//     chunks, 8 row groups); a thread takes the rows rg, rg + 8, ... of
//     its sample, BWD_ROWS of them in flight (dh 32, x 16, dy 16 bytes
//     each, read through the streaming path), and forms the residual's
//     direct path dx0 = dy*0.7/rd itself (one f32 product, as an
//     earlier residual pass stored it; that f32 array is gone). The row
//     groups' dshift / dscale sums meet in shared memory in row-group
//     order; where the grid fills the card four times over, a block takes
//     two samples, paying its row loads, reductions and ticket half as
//     often. dgain's per-block partials are summed in block order by the
//     last block to finish (a ticket counter it resets), in the same
//     launch. The first form (one thread a column, a serial loop over the
//     sample's rows with 4- and 2-byte accesses, a second launch for dgain)
//     was latency-bound.
//   At S/2 (tools/bench_attention.py --part backward, graph-timed, NVIDIA
//   H100 80GB HBM3, 700 W; PERF.md): modulate_fwd 0.0083 ms against a byte
//   bound of 0.0077 (first form 0.0259); modulate_bwd 0.0236 against 0.0192
//   (first form 0.0488). Forms of modulate_bwd built for the comparison in
//   one call and not kept: 64-column blocks, loads through the read-only
//   path and one sample a block were each slower than this form; eight
//   rows in flight a thread (more registers), 256-thread blocks and four
//   samples a block were slower still.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <initializer_list>

#include "attention_bwd_f32.cuh"
#include "attention_bwd_tiles.cuh"
#include "attention_tiles.cuh"
#include "modulate.cuh"

namespace {

enum { DT_F32 = 0, DT_BF16 = 1 };

// ---------------------------------------------------------------------------
// (b) attention backward on the tensor cores (attention_bwd_tiles.cuh);
// grid (heads, N), one block per (sample, head), for T <= 64 (KT = 1, one
// key tile)

using attn_bwd_tiles::BwdLayout;

struct BlockSync {
  __device__ __forceinline__ void operator()() const { __syncthreads(); }
};

template <int HD, int KT>
__global__ void __launch_bounds__(BwdLayout<HD, KT>::THREADS, BwdLayout<HD, KT>::MIN_BLOCKS)
    attention_bwd_kernel(const float* __restrict__ qkv, const float* __restrict__ dattn,
                         __nv_bfloat16* __restrict__ dqkv, int t, int heads) {
  extern __shared__ __align__(16) unsigned char smem[];
  attn_bwd_tiles::attention_bwd_unit<HD, KT, false>(qkv, dattn, dqkv, t, heads, blockIdx.y, blockIdx.x, smem,
                                                     threadIdx.x, BlockSync{});
}

template <int HD, int KT>
int launch_attention_bwd(const float* qkv, const float* dattn, __nv_bfloat16* dqkv, int n, int t, int heads,
                         cudaStream_t stream) {
  using L = BwdLayout<HD, KT>;
  static bool configured = false;
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(attention_bwd_kernel<HD, KT>,
                                                 cudaFuncAttributeMaxDynamicSharedMemorySize, (int)L::BYTES);
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = true;
  }
  attention_bwd_kernel<HD, KT><<<dim3(heads, n), L::THREADS, L::BYTES, stream>>>(qkv, dattn, dqkv, t, heads);
  return static_cast<int>(cudaGetLastError());
}

// (b) past T = 64: one block of LONG_THREADS per (sample, head) holding the
// head's T rows of qn, kn, v and do as bf16 tiles (rows rounded up to 128,
// zero past T) and no T x T array; the notes at the top
constexpr int LONG_WARPS = 8;
constexpr int LONG_THREADS = 32 * LONG_WARPS;
constexpr int LONG_MAX_T = 256;
constexpr int LONG_ROWS = 128;  // rows a load pass takes (attn_bwd_tiles::Slice<HD, 2>)
static_assert(BwdLayout<64, 2>::THREADS == LONG_THREADS, "the load passes take the long form's threads");

template <int HD>
size_t long_bytes(int t) {
  const size_t rows = (t + LONG_ROWS - 1) / LONG_ROWS * LONG_ROWS;
  return 4 * rows * attn_tiles::Dims<HD>::LD * 2 + 4 * rows * sizeof(float);
}

// a warp's 16 rows of one bf16 result (packed fragments) straight to dst +
// r * ld, rows r0 + g and r0 + g + 8 below t
template <int HD>
__device__ __forceinline__ void store_fragments(const uint32_t (&v)[attn_tiles::Dims<HD>::NT][2], __nv_bfloat16* dst,
                                                int64_t ld, int r0, int t, int lane) {
  const int g = lane >> 2, c = lane & 3;
#pragma unroll
  for (int j = 0; j < attn_tiles::Dims<HD>::NT; ++j) {
    if (r0 + g < t) *reinterpret_cast<uint32_t*>(dst + (int64_t)(r0 + g) * ld + 8 * j + 2 * c) = v[j][0];
    if (r0 + g + 8 < t) *reinterpret_cast<uint32_t*>(dst + (int64_t)(r0 + g + 8) * ld + 8 * j + 2 * c) = v[j][1];
  }
}

// ex = exp(l - sqrt(hd)), l = s / sqrt(hd): the max-free exponent of a
// cosine logit (|l| <= sqrt(hd), so ex lies in [e^-2sqrt(hd), 1])
__device__ __forceinline__ float cosine_exp(float s, float inv_sqrt_hd, float sqrt_hd) {
  return attn_tiles::exp2_approx((s * inv_sqrt_hd - sqrt_hd) * attn_tiles::LOG2E);
}

template <int HD>
__global__ void __launch_bounds__(LONG_THREADS, 1)
    attention_bwd_long_kernel(const float* __restrict__ qkv, const float* __restrict__ dattn,
                              __nv_bfloat16* __restrict__ dqkv, int t, int heads) {
  namespace tiles = attn_tiles;
  using D = tiles::Dims<HD>;
  using S = attn_bwd_tiles::Slice<HD, 2>;
  constexpr int KEYS = tiles::KEY_TILES, TILE = tiles::TILE;
  extern __shared__ __align__(16) unsigned char smem[];
  const int rows = (t + LONG_ROWS - 1) / LONG_ROWS * LONG_ROWS;
  __nv_bfloat16* sq = reinterpret_cast<__nv_bfloat16*>(smem);  // qn
  __nv_bfloat16* sk = sq + rows * D::LD;                        // kn
  __nv_bfloat16* sv = sk + rows * D::LD;                        // v
  __nv_bfloat16* sd = sv + rows * D::LD;                        // do
  float* rq = reinterpret_cast<float*>(sd + rows * D::LD);      // ||q||, ||k||
  float* rk = rq + rows;
  float* pinv = rk + rows;  // 1 / sum ex of each query row, 0 past T
  float* prs = pinv + rows; // rowsum(dp * p) of each query row

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, c = lane & 3;
  const int sample = blockIdx.y, head = blockIdx.x;
  const int d = heads * HD;
  const int64_t ld = 3 * (int64_t)d;
  const float* base = qkv + (int64_t)sample * t * ld + head * HD;
  const float* dbase = dattn + (int64_t)sample * t * d + head * HD;
  __nv_bfloat16* out = dqkv + (int64_t)sample * t * ld + head * HD;
  const float sqrt_hd = sqrtf((float)HD), inv_sqrt_hd = (float)(1.0 / sqrt((double)HD));

  for (int r = tid; r < rows; r += LONG_THREADS) pinv[r] = prs[r] = 0.f;
  for (int r0 = 0; r0 < rows; r0 += LONG_ROWS) {
    S fa, fb;
    attn_bwd_tiles::fetch<HD, 2, false>(fa, base + r0 * ld, ld, t - r0, tid);
    attn_bwd_tiles::fetch<HD, 2, false>(fb, base + d + r0 * ld, ld, t - r0, tid);
    attn_bwd_tiles::commit<HD, 2>(fa, sq + r0 * D::LD, rq + r0, t - r0, tid);
    attn_bwd_tiles::commit<HD, 2>(fb, sk + r0 * D::LD, rk + r0, t - r0, tid);
    attn_bwd_tiles::fetch<HD, 2, false>(fa, base + 2 * d + r0 * ld, ld, t - r0, tid);
    attn_bwd_tiles::fetch<HD, 2, false>(fb, dbase + r0 * d, d, t - r0, tid);
    attn_bwd_tiles::commit<HD, 2>(fa, sv + r0 * D::LD, nullptr, t - r0, tid);
    attn_bwd_tiles::commit<HD, 2>(fb, sd + r0 * D::LD, nullptr, t - r0, tid);
  }
  __syncthreads();

  // phase A, 16 query rows a warp at a time: a first sweep over the key
  // tiles takes sum ex and sum dp*ex, a second forms p and dlog and adds
  // dqn = dlog . kn over the key tiles
  for (int q0 = 16 * warp; q0 < t; q0 += 16 * LONG_WARPS) {
    float s[KEYS][4], dp[KEYS][4];
    float sum0 = 0.f, sum1 = 0.f, rs0 = 0.f, rs1 = 0.f;
    for (int k0 = 0; k0 < t; k0 += TILE) {
      tiles::qk_tile<HD>(s, sq + q0 * D::LD, sk + k0 * D::LD, 0, lane);
      tiles::qk_tile<HD>(dp, sd + q0 * D::LD, sv + k0 * D::LD, 0, lane);
#pragma unroll
      for (int j = 0; j < KEYS; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = k0 + 8 * j + 2 * c + (e & 1);
          const float x = col < t ? cosine_exp(s[j][e], inv_sqrt_hd, sqrt_hd) : 0.f;
          if (e < 2) sum0 += x, rs0 += dp[j][e] * x;
          else sum1 += x, rs1 += dp[j][e] * x;
        }
    }
    const float inv0 = q0 + g < t ? 1.f / tiles::quad_sum(sum0) : 0.f;
    const float inv1 = q0 + g + 8 < t ? 1.f / tiles::quad_sum(sum1) : 0.f;
    rs0 = tiles::quad_sum(rs0) * inv0;
    rs1 = tiles::quad_sum(rs1) * inv1;
    if (c == 0) {
      pinv[q0 + g] = inv0;
      pinv[q0 + g + 8] = inv1;
      prs[q0 + g] = rs0;
      prs[q0 + g + 8] = rs1;
    }
    float o[D::NT][4];
#pragma unroll
    for (int j = 0; j < D::NT; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
    for (int k0 = 0; k0 < t; k0 += TILE) {
      tiles::qk_tile<HD>(s, sq + q0 * D::LD, sk + k0 * D::LD, 0, lane);
      tiles::qk_tile<HD>(dp, sd + q0 * D::LD, sv + k0 * D::LD, 0, lane);
#pragma unroll
      for (int j = 0; j < KEYS; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = k0 + 8 * j + 2 * c + (e & 1);
          const float p = col < t ? cosine_exp(s[j][e], inv_sqrt_hd, sqrt_hd) * (e < 2 ? inv0 : inv1) : 0.f;
          // dlog = p*(dp - rowsum(dp*p)) / sqrt(hd)
          dp[j][e] = p * (dp[j][e] - (e < 2 ? rs0 : rs1)) * inv_sqrt_hd;
        }
      uint32_t la[KEYS / 2][4];
      tiles::pack_p(la, dp);
      tiles::pv_tile<HD>(o, la, sk + k0 * D::LD, lane);
    }
    uint32_t dq[D::NT][2];
    attn_bwd_tiles::normalize_vjp<HD, false>(o, dq, base, ld, rq, q0, t, lane);
    store_fragments<HD>(dq, out, ld, q0, t, lane);
  }
  __syncthreads();

  // phase B, 16 key rows a warp at a time: S^T = kn . qn^T and dP^T = v .
  // do^T against each tile of 64 queries, p and dlog from the query rows'
  // sums, dv = p^T . do and dkn = dlog^T . qn added over the query tiles
  for (int k0 = 16 * warp; k0 < t; k0 += 16 * LONG_WARPS) {
    float ov[D::NT][4], ok[D::NT][4];
#pragma unroll
    for (int j = 0; j < D::NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) ov[j][e] = ok[j][e] = 0.f;
    for (int q0 = 0; q0 < t; q0 += TILE) {
      float s[KEYS][4], dp[KEYS][4];
      tiles::qk_tile<HD>(s, sk + k0 * D::LD, sq + q0 * D::LD, 0, lane);
      tiles::qk_tile<HD>(dp, sv + k0 * D::LD, sd + q0 * D::LD, 0, lane);
#pragma unroll
      for (int j = 0; j < KEYS; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int q = q0 + 8 * j + 2 * c + (e & 1);
          const float p = cosine_exp(s[j][e], inv_sqrt_hd, sqrt_hd) * pinv[q];
          s[j][e] = p;
          dp[j][e] = p * (dp[j][e] - prs[q]) * inv_sqrt_hd;
        }
      uint32_t pa[KEYS / 2][4], la[KEYS / 2][4];
      tiles::pack_p(pa, s);
      tiles::pack_p(la, dp);
      tiles::pv_tile<HD>(ov, pa, sd + q0 * D::LD, lane);
      tiles::pv_tile<HD>(ok, la, sq + q0 * D::LD, lane);
    }
    uint32_t dk[D::NT][2], dv[D::NT][2];
    attn_bwd_tiles::pack_rows<HD>(ov, dv);
    attn_bwd_tiles::normalize_vjp<HD, false>(ok, dk, base + d, ld, rk, k0, t, lane);
    store_fragments<HD>(dk, out + d, ld, k0, t, lane);
    store_fragments<HD>(dv, out + 2 * d, ld, k0, t, lane);
  }
}

template <int HD>
int launch_attention_bwd_long(const float* qkv, const float* dattn, __nv_bfloat16* dqkv, int n, int t, int heads,
                              cudaStream_t stream) {
  static bool configured = false;
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(attention_bwd_long_kernel<HD>,
                                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                 (int)long_bytes<HD>(LONG_MAX_T));
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = true;
  }
  attention_bwd_long_kernel<HD><<<dim3(heads, n), LONG_THREADS, long_bytes<HD>(t), stream>>>(qkv, dattn, dqkv, t,
                                                                                           heads);
  return static_cast<int>(cudaGetLastError());
}

template <int HD>
size_t attention_bwd_bytes(int t) {
  return t <= attn_tiles::TILE ? BwdLayout<HD, 1>::BYTES : long_bytes<HD>(t);
}

// (b) in f32 (attention_bwd_f32.cuh): one block of four warps per (sample,
// head), any 1 <= T <= LONG_MAX_T, the rows' sums for up to LONG_MAX_T
// queries beside the four tiles (70 KB at hd 64, 78 KB at hd 72: two
// blocks an SM)
template <int HD>
__global__ void __launch_bounds__(attn_tiles::THREADS)
    attention_bwd_f32_kernel(const float* __restrict__ qkv, const float* __restrict__ dattn,
                             float* __restrict__ dqkv, int t, int heads) {
  extern __shared__ __align__(16) float smem_f32[];
  attn_bwd_f32::attention_bwd_unit<HD, LONG_MAX_T>(qkv, dattn, dqkv, t, heads, blockIdx.y, blockIdx.x, smem_f32,
                                                   threadIdx.x, BlockSync{});
}

template <int HD>
int launch_attention_bwd_f32(const float* qkv, const float* dattn, float* dqkv, int n, int t, int heads,
                             cudaStream_t stream) {
  constexpr int bytes = attn_bwd_f32::Layout<HD, LONG_MAX_T>::BYTES;
  static bool configured = false;
  if (!configured) {
    const cudaError_t err =
        cudaFuncSetAttribute(attention_bwd_f32_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = true;
  }
  attention_bwd_f32_kernel<HD><<<dim3(heads, n), attn_tiles::THREADS, bytes, stream>>>(qkv, dattn, dqkv, t, heads);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// (c) modulate forward and backward

constexpr int FWD_THREADS = 256;  // most threads of a modulate_fwd block
constexpr int FWD_ROWS = 2;       // token rows a modulate_fwd thread takes
constexpr int BWD_CHUNKS = 16;    // 8-column chunks of a modulate_bwd block: 128 columns
constexpr int BWD_GROUPS = 8;     // its row groups
constexpr int BWD_THREADS = BWD_CHUNKS * BWD_GROUPS;
constexpr int BWD_ROWS = 4;       // rows a modulate_bwd thread has in flight
constexpr int FOLD_BLOCKS = 4 * 132;  // blocks that fill the H100's SMs four times

// modulate_bwd's blocks that have added their dgain partial; the last one
// sums the partials and sets it back to 0 (one launch at a time per device:
// the port launches on one stream)
__device__ unsigned int modulate_bwd_ticket = 0;

// grid (ceil(t / (RY * FWD_ROWS)), n), block (bx, RY): chunk threadIdx.x
// (and + bx, ...) of rows threadIdx.y + i * RY of the block's token rows
template <typename XT, typename HT = __nv_bfloat16>
__global__ void __launch_bounds__(FWD_THREADS)
    modulate_fwd_kernel(const XT* __restrict__ x, const float* __restrict__ rows, int rows_ld, int shift_off,
                        int scale_off, const float* __restrict__ gain, HT* __restrict__ h, int t, int d) {
  const int sample = blockIdx.y;
  const int r0 = blockIdx.x * blockDim.y * FWD_ROWS + threadIdx.y;
  const float g = *gain;
  const float den = modulate::denominator(g);
  const float* mrow = rows + (int64_t)sample * rows_ld;
  const int64_t base = (int64_t)sample * t * d;
  for (int c = 8 * threadIdx.x; c < d; c += 8 * blockDim.x) {
    float v[FWD_ROWS][8], sh[8], sc[8];
#pragma unroll
    for (int i = 0; i < FWD_ROWS; ++i) {
      const int r = r0 + i * blockDim.y;
      if (r < t) modulate::load8(x + base + (int64_t)r * d + c, v[i]);
    }
    modulate::load8(mrow + shift_off + c, sh);
    modulate::load8(mrow + scale_off + c, sc);
#pragma unroll
    for (int i = 0; i < FWD_ROWS; ++i) {
      const int r = r0 + i * blockDim.y;
      if (r < t) {
        modulate::modulate8(v[i], sh, sc, g, den);
        modulate::store8(h + base + (int64_t)r * d + c, v[i]);
      }
    }
  }
}

// grid (ceil(d / (8 * BWD_CHUNKS)), samples), block (BWD_CHUNKS,
// BWD_GROUPS); block row y takes the samples y, y + gridDim.y, ...
template <typename XT, typename YT>
__global__ void __launch_bounds__(BWD_THREADS)
    modulate_bwd_kernel(const float* __restrict__ dh, const XT* __restrict__ x, const YT* __restrict__ dy,
                        const float* __restrict__ rows, int rows_ld, int shift_off, int scale_off,
                        const float* __restrict__ gain, XT* __restrict__ dx, float* __restrict__ dshift,
                        float* __restrict__ dscale, float* __restrict__ partial, float* __restrict__ dgain, int n,
                        int t, int d, float dx_fac) {
  constexpr int BCOLS = 8 * BWD_CHUNKS;
  __shared__ __align__(16) float red_dh[BWD_GROUPS][BCOLS];
  __shared__ __align__(16) float red_sc[BWD_GROUPS][BCOLS];
  __shared__ float red_gain[BWD_THREADS];
  __shared__ bool last;
  const int tid = threadIdx.y * BWD_CHUNKS + threadIdx.x;
  const int col = blockIdx.x * BCOLS + 8 * threadIdx.x;
  const float g = *gain;
  const float den = modulate::denominator(g);
  const float du_fac = (1.f - g) / den;
  float acc_gain = 0.f;
  for (int sample = blockIdx.y; sample < n; sample += gridDim.y) {
    float acc_dh[8], acc_sc[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) acc_dh[e] = acc_sc[e] = 0.f;
    if (col < d) {
      const float* mrow = rows + (int64_t)sample * rows_ld;
      float sh[8], sc[8];
      modulate::load8(mrow + shift_off + col, sh);
      modulate::load8(mrow + scale_off + col, sc);
      const int64_t base = (int64_t)sample * t * d + col;
      for (int r0 = threadIdx.y; r0 < t; r0 += BWD_GROUPS * BWD_ROWS) {
        float gh[BWD_ROWS][8], xv[BWD_ROWS][8], yv[BWD_ROWS][8];
#pragma unroll
        for (int i = 0; i < BWD_ROWS; ++i) {
          const int r = r0 + i * BWD_GROUPS;
          if (r < t) {
            const int64_t o = base + (int64_t)r * d;
            modulate::load8_stream(dh + o, gh[i]);
            modulate::load8_stream(x + o, xv[i]);
            modulate::load8_stream(dy + o, yv[i]);
          }
        }
#pragma unroll
        for (int i = 0; i < BWD_ROWS; ++i) {
          const int r = r0 + i * BWD_GROUPS;
          if (r < t) {
            float out[8];
#pragma unroll
            for (int e = 0; e < 8; ++e) {
              const float u = xv[i][e] * sc[e];
              const float du = gh[i][e] * du_fac;
              acc_dh[e] += gh[i][e];
              acc_gain += gh[i][e] * (sh[e] - u);
              // dx0 rounded on its own, as the plain version rounds it
              out[e] = __fmul_rn(yv[i][e], dx_fac) + du * sc[e];
              acc_sc[e] += du * xv[i][e];
            }
            modulate::store8(dx + base + (int64_t)r * d, out);
          }
        }
      }
    }
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      red_dh[threadIdx.y][8 * threadIdx.x + e] = acc_dh[e];
      red_sc[threadIdx.y][8 * threadIdx.x + e] = acc_sc[e];
    }
    __syncthreads();
    // the row groups' column sums, in row-group order
    for (int c = tid; c < BCOLS; c += BWD_THREADS) {
      float s = 0.f, q = 0.f;
#pragma unroll
      for (int i = 0; i < BWD_GROUPS; ++i) {
        s += red_dh[i][c];
        q += red_sc[i][c];
      }
      const int cc = blockIdx.x * BCOLS + c;
      if (cc < d) {
        dshift[(int64_t)sample * d + cc] = s * (g / den);
        dscale[(int64_t)sample * d + cc] = q;
      }
    }
    __syncthreads();
  }
  red_gain[tid] = acc_gain;
  __syncthreads();
  for (int stride = BWD_THREADS / 2; stride > 0; stride /= 2) {
    if (tid < stride) red_gain[tid] += red_gain[tid + stride];
    __syncthreads();
  }
  const unsigned int blocks = gridDim.x * gridDim.y;
  if (tid == 0) {
    partial[blockIdx.y * gridDim.x + blockIdx.x] = red_gain[0];
    __threadfence();
    last = atomicAdd(&modulate_bwd_ticket, 1u) == blocks - 1;
  }
  __syncthreads();
  if (!last) return;
  // the last block: dgain = (sum of the partials in block order) / den
  float acc = 0.f;
  for (unsigned int i = tid; i < blocks; i += BWD_THREADS) acc += __ldcg(partial + i);
  red_gain[tid] = acc;
  __syncthreads();
  for (int stride = BWD_THREADS / 2; stride > 0; stride /= 2) {
    if (tid < stride) red_gain[tid] += red_gain[tid + stride];
    __syncthreads();
  }
  if (tid == 0) {
    dgain[0] = red_gain[0] / den;
    modulate_bwd_ticket = 0;
  }
}

// 16-byte accesses: eight columns a thread, every base at a multiple of 16
// bytes (the rows' stride and offsets too: multiples of 4 floats)
bool modulate_domain(int d, int rows_ld, int shift_off, int scale_off, std::initializer_list<const void*> ptrs) {
  if (d < 8 || d % 8 || rows_ld % 4 || shift_off % 4 || scale_off % 4) return false;
  for (const void* p : ptrs)
    if (reinterpret_cast<uintptr_t>(p) % 16) return false;
  return true;
}

}  // namespace

// Shared memory of one attention_bwd block, 0 where the kernel does not
// take (t, hd): head widths 64 and 72, 1 <= t <= 256.
extern "C" size_t attention_bwd_smem_bytes(int t, int hd) {
  if (t < 1 || t > LONG_MAX_T) return 0;
  return hd == 64 ? attention_bwd_bytes<64>(t) : hd == 72 ? attention_bwd_bytes<72>(t) : 0;
}

extern "C" int attention_bwd(const void* qkv, const void* dattn, void* dqkv, int n, int t,
                             int heads, int hd, void* stream) {
  if (n < 1 || heads < 1 || attention_bwd_smem_bytes(t, hd) == 0) return static_cast<int>(cudaErrorInvalidValue);
  const float* q = static_cast<const float*>(qkv);
  const float* da = static_cast<const float*>(dattn);
  __nv_bfloat16* out = static_cast<__nv_bfloat16*>(dqkv);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (t > attn_tiles::TILE)
    return hd == 64 ? launch_attention_bwd_long<64>(q, da, out, n, t, heads, s)
                    : launch_attention_bwd_long<72>(q, da, out, n, t, heads, s);
  return hd == 64 ? launch_attention_bwd<64, 1>(q, da, out, n, t, heads, s)
                  : launch_attention_bwd<72, 1>(q, da, out, n, t, heads, s);
}

// The f32 form: f32 qkv (n*t, 3*heads*hd) and dattn (n*t, heads*hd) in,
// f32 dqkv out, 16-byte aligned; head widths 64 and 72, 1 <= t <= 256.
extern "C" int attention_bwd_f32(const void* qkv, const void* dattn, void* dqkv, int n, int t, int heads, int hd,
                                 void* stream) {
  if (n < 1 || heads < 1 || t < 1 || t > LONG_MAX_T || (hd != 64 && hd != 72) ||
      (reinterpret_cast<uintptr_t>(qkv) | reinterpret_cast<uintptr_t>(dattn) | reinterpret_cast<uintptr_t>(dqkv)) % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  const float* q = static_cast<const float*>(qkv);
  const float* da = static_cast<const float*>(dattn);
  float* out = static_cast<float*>(dqkv);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return hd == 64 ? launch_attention_bwd_f32<64>(q, da, out, n, t, heads, s)
                  : launch_attention_bwd_f32<72>(q, da, out, n, t, heads, s);
}

namespace {

// modulate_fwd's launch: h in bf16 (rounded once, as the plain version
// rounds it for the qkv product) or f32 (the f32 form: nothing rounded)
template <typename HT>
int launch_modulate_fwd(const void* x, int x_dtype, const void* rows, int rows_ld, int shift_off, int scale_off,
                        const void* gain, void* h, int n, int t, int d, void* stream) {
  if (n < 1 || t < 1 || !modulate_domain(d, rows_ld, shift_off, scale_off, {x, rows, h}))
    return static_cast<int>(cudaErrorInvalidValue);
  const int chunks = d / 8;
  const int bx = chunks < FWD_THREADS ? chunks : FWD_THREADS;
  // rows a block: a power of two (T = 64 splits evenly), no more than T needs
  int ry = 1;
  while (2 * ry * bx <= FWD_THREADS && 2 * ry <= (t + FWD_ROWS - 1) / FWD_ROWS) ry *= 2;
  const dim3 grid((t + ry * FWD_ROWS - 1) / (ry * FWD_ROWS), n), block(bx, ry);
  const float* r = static_cast<const float*>(rows);
  const float* g = static_cast<const float*>(gain);
  HT* out = static_cast<HT*>(h);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_dtype == DT_F32)
    modulate_fwd_kernel<float, HT><<<grid, block, 0, s>>>(static_cast<const float*>(x), r, rows_ld, shift_off,
                                                          scale_off, g, out, t, d);
  else
    modulate_fwd_kernel<__nv_bfloat16, HT><<<grid, block, 0, s>>>(static_cast<const __nv_bfloat16*>(x), r, rows_ld,
                                                                  shift_off, scale_off, g, out, t, d);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int modulate_fwd(const void* x, int x_dtype, const void* rows, int rows_ld,
                            int shift_off, int scale_off, const void* gain, void* h, int n, int t,
                            int d, void* stream) {
  return launch_modulate_fwd<__nv_bfloat16>(x, x_dtype, rows, rows_ld, shift_off, scale_off, gain, h, n, t, d,
                                            stream);
}

// modulate_fwd writing f32 h (a float32 model's backward: h is the qkv
// product's f32 operand and the dW pair's)
extern "C" int modulate_fwd_f32(const void* x, int x_dtype, const void* rows, int rows_ld, int shift_off,
                                int scale_off, const void* gain, void* h, int n, int t, int d, void* stream) {
  return launch_modulate_fwd<float>(x, x_dtype, rows, rows_ld, shift_off, scale_off, gain, h, n, t, d, stream);
}

// modulate_bwd's grid: column blocks x rows of blocks; where one sample a
// block would fill the card four times over, a block takes two samples
dim3 modulate_bwd_grid(int n, int d) {
  const int cols = (d + 8 * BWD_CHUNKS - 1) / (8 * BWD_CHUNKS);
  return dim3(cols, n * cols >= FOLD_BLOCKS ? (n + 1) / 2 : n);
}

extern "C" int modulate_bwd_partials(int n, int d) {
  const dim3 grid = modulate_bwd_grid(n, d);
  return grid.x * grid.y;
}

template <typename XT, typename YT>
int launch_modulate_bwd(const void* dh, const void* x, const void* dy, const void* rows, int rows_ld, int shift_off,
                        int scale_off, const void* gain, void* dx, void* dshift, void* dscale, void* partial,
                        void* dgain, int n, int t, int d, float dx_fac, cudaStream_t stream) {
  const dim3 grid = modulate_bwd_grid(n, d), block(BWD_CHUNKS, BWD_GROUPS);
  modulate_bwd_kernel<XT, YT><<<grid, block, 0, stream>>>(
      static_cast<const float*>(dh), static_cast<const XT*>(x), static_cast<const YT*>(dy),
      static_cast<const float*>(rows), rows_ld, shift_off, scale_off, static_cast<const float*>(gain),
      static_cast<XT*>(dx), static_cast<float*>(dshift), static_cast<float*>(dscale), static_cast<float*>(partial),
      static_cast<float*>(dgain), n, t, d, dx_fac);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int modulate_bwd(const void* dh, const void* x, int x_dtype, const void* dy, int dy_dtype,
                            const void* rows, int rows_ld, int shift_off, int scale_off, const void* gain,
                            void* dx, void* dshift, void* dscale, void* partial, void* dgain, int n, int t,
                            int d, void* stream) {
  if (n < 1 || t < 1 || !modulate_domain(d, rows_ld, shift_off, scale_off, {dh, x, dy, rows, dx}))
    return static_cast<int>(cudaErrorInvalidValue);
  const double t_res = 0.3, rd = sqrt((1.0 - t_res) * (1.0 - t_res) + t_res * t_res);
  const float dx_fac = (float)((1.0 - t_res) / rd);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  using bf = __nv_bfloat16;
  if (x_dtype == DT_F32)
    return dy_dtype == DT_F32
               ? launch_modulate_bwd<float, float>(dh, x, dy, rows, rows_ld, shift_off, scale_off, gain, dx, dshift,
                                                   dscale, partial, dgain, n, t, d, dx_fac, s)
               : launch_modulate_bwd<float, bf>(dh, x, dy, rows, rows_ld, shift_off, scale_off, gain, dx, dshift,
                                                dscale, partial, dgain, n, t, d, dx_fac, s);
  return dy_dtype == DT_F32
             ? launch_modulate_bwd<bf, float>(dh, x, dy, rows, rows_ld, shift_off, scale_off, gain, dx, dshift,
                                              dscale, partial, dgain, n, t, d, dx_fac, s)
             : launch_modulate_bwd<bf, bf>(dh, x, dy, rows, rows_ld, shift_off, scale_off, gain, dx, dshift, dscale,
                                           partial, dgain, n, t, d, dx_fac, s);
}

extern "C" const char* attn_branch_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
