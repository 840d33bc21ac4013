// mp_gemm: C = epilogue(prologue(A) . op(W) * alpha), bf16 operands, f32 sums,
// op(W) = W^T for W stored (N, K) or W itself for W stored (K, N).
//
// Replaces the five matrix products inside the Pallas whole-block body
// (mapdit_tpu/ops/pallas/dit_block.py:_block_body, reached from
// _fwd_impl and _stack_fwd_impl) together with the elementwise stages the
// Pallas kernel kept in VMEM around them:
//   prologue  MODULATE: per-sample modulate of A before it is rounded to
//             bf16, (a*scale + (shift - a*scale)*g) / sqrt((1-g)^2 + g^2),
//             sample = row / tokens, shift/scale read from an f32 (N, 6D)
//             modulation buffer at column offsets, g read from device memory
//             (no host sync);
//   epilogue  SILU: silu(c) / 0.596 (MP-SiLU);
//             RESIDUAL: (x + (gate*c - x)*0.3) / sqrt(0.58), the gated MP
//             residual, with x read from the stream (f32 or bf16).
// W is stored (out, in), as the port stores every weight: the forward
// products read it as (N, K) and take W^T; the attention half-block's
// backward (mapdit_tpu/ops/pallas/dit_block.py:_attn_bwd_math, dattn =
// dout . Wout and dh = dqkv . Wqkv) reads the same array as (K, N) and takes
// W itself, so no transposed weight copy is ever made. Only the tile load
// differs between the two layouts; the shared-memory tile is (n, k) in both.
//
// Bound on the H100: at the DiT-S/2 sampling shapes (M = 4096 rows, K = 384
// or 1536) every product does 2*M*N*K flops on ~(M*K + N*K + M*N) elements,
// i.e. a few hundred flops per byte: compute-bound on the tensor cores.
// This first form stages 64x64x32 tiles in shared memory and multiplies with
// WMMA bf16 16x16x16 fragments (4 warps, 32x32 per warp). It is correct and
// simple, not fast: TMA + wgmma pipelining is the later step (ROADMAP B.2).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;

namespace {

constexpr int BM = 64;
constexpr int BN = 64;
constexpr int BK = 32;
constexpr int LDA = BK + 8;  // bf16 elements: a multiple of 8, as wmma needs
constexpr int LDC = BN + 4;  // f32 elements: a multiple of 4
constexpr int THREADS = 128;
constexpr float RES_T = 0.3f;
constexpr float SILU_DIV = 0.596f;

enum { DT_F32 = 0, DT_BF16 = 1 };
enum { PRO_NONE = 0, PRO_MODULATE = 1 };
enum { EPI_NONE = 0, EPI_SILU = 1, EPI_RESIDUAL = 2 };

struct Params {
  const void* a;
  int a_dtype;
  const __nv_bfloat16* w;
  void* c;
  int c_dtype;
  int m, n, k;
  float alpha;
  int prologue;
  const float* mods;
  int mods_ld, shift_off, scale_off, gate_off;
  const float* gain;
  int tokens;
  int epilogue;
  const void* x;
  int x_dtype;
};

__device__ __forceinline__ float load_f32(const void* p, int dtype, int64_t i) {
  return dtype == DT_F32 ? static_cast<const float*>(p)[i]
                         : __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i]);
}

__device__ __forceinline__ void store_f32(void* p, int dtype, int64_t i, float v) {
  if (dtype == DT_F32) {
    static_cast<float*>(p)[i] = v;
  } else {
    static_cast<__nv_bfloat16*>(p)[i] = __float2bfloat16(v);
  }
}

// W_KN: W stored (K, N) and C = A . W; otherwise W stored (N, K) and
// C = A . W^T. A template parameter, so the forward products compile to the
// same code as without the second layout.
template <bool W_KN>
__global__ void __launch_bounds__(THREADS) mp_gemm_kernel(Params p) {
  __shared__ __align__(32) __nv_bfloat16 As[BM * LDA];
  __shared__ __align__(32) __nv_bfloat16 Ws[BN * LDA];
  __shared__ __align__(32) float Cs[BM * LDC];

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int wm = (warp / 2) * 32;
  const int wn = (warp % 2) * 32;
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;

  float g = 0.f, den = 1.f;
  if (p.prologue == PRO_MODULATE) {
    g = *p.gain;
    den = sqrtf((1.f - g) * (1.f - g) + g * g);
  }

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  for (int k0 = 0; k0 < p.k; k0 += BK) {
    for (int i = tid; i < BM * BK; i += THREADS) {
      const int r = i / BK, kk = i % BK;
      const int row = m0 + r, col = k0 + kk;
      float v = 0.f;
      if (row < p.m && col < p.k) {
        v = load_f32(p.a, p.a_dtype, (int64_t)row * p.k + col);
        if (p.prologue == PRO_MODULATE) {
          const float* mrow = p.mods + (int64_t)(row / p.tokens) * p.mods_ld;
          const float xs = v * mrow[p.scale_off + col];
          v = (xs + (mrow[p.shift_off + col] - xs) * g) / den;
        }
      }
      As[r * LDA + kk] = __float2bfloat16(v);
    }
    if constexpr (W_KN) {
      // neighbouring threads read neighbouring n of one k row of W
      for (int i = tid; i < BN * BK; i += THREADS) {
        const int r = i % BN, kk = i / BN;
        const int row = n0 + r, col = k0 + kk;
        Ws[r * LDA + kk] = (row < p.n && col < p.k) ? p.w[(int64_t)col * p.n + row]
                                                   : __float2bfloat16(0.f);
      }
    } else {
      for (int i = tid; i < BN * BK; i += THREADS) {
        const int r = i / BK, kk = i % BK;
        const int row = n0 + r, col = k0 + kk;
        Ws[r * LDA + kk] = (row < p.n && col < p.k) ? p.w[(int64_t)row * p.k + col]
                                                   : __float2bfloat16(0.f);
      }
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> fa[2];
      // Ws holds W's rows (n, k): read as the col-major (k, n) operand W^T
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major> fb[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) wmma::load_matrix_sync(fa[i], As + (wm + 16 * i) * LDA + kk, LDA);
#pragma unroll
      for (int j = 0; j < 2; ++j) wmma::load_matrix_sync(fb[j], Ws + (wn + 16 * j) * LDA + kk, LDA);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(Cs + (wm + 16 * i) * LDC + wn + 16 * j, acc[i][j], LDC,
                              wmma::mem_row_major);
  __syncthreads();

  const float res_denom = sqrtf((1.f - RES_T) * (1.f - RES_T) + RES_T * RES_T);
  for (int i = tid; i < BM * BN; i += THREADS) {
    const int r = i / BN, cc = i % BN;
    const int row = m0 + r, col = n0 + cc;
    if (row >= p.m || col >= p.n) continue;
    const int64_t idx = (int64_t)row * p.n + col;
    float v = Cs[r * LDC + cc] * p.alpha;
    if (p.epilogue == EPI_SILU) {
      v = v / (1.f + expf(-v)) / SILU_DIV;
    } else if (p.epilogue == EPI_RESIDUAL) {
      const float xv = load_f32(p.x, p.x_dtype, idx);
      const float gate = p.mods[(int64_t)(row / p.tokens) * p.mods_ld + p.gate_off + col];
      v = (xv + (gate * v - xv) * RES_T) / res_denom;
    }
    store_f32(p.c, p.c_dtype, idx, v);
  }
}

}  // namespace

extern "C" int mp_gemm(const void* a, int a_dtype, const void* w, void* c, int c_dtype, int m,
                       int n, int k, float alpha, int prologue, const void* mods, int mods_ld,
                       int shift_off, int scale_off, int gate_off, const void* gain, int tokens,
                       int epilogue, const void* x, int x_dtype, int w_kn, void* stream) {
  Params p;
  p.a = a;
  p.a_dtype = a_dtype;
  p.w = static_cast<const __nv_bfloat16*>(w);
  p.c = c;
  p.c_dtype = c_dtype;
  p.m = m;
  p.n = n;
  p.k = k;
  p.alpha = alpha;
  p.prologue = prologue;
  p.mods = static_cast<const float*>(mods);
  p.mods_ld = mods_ld;
  p.shift_off = shift_off;
  p.scale_off = scale_off;
  p.gate_off = gate_off;
  p.gain = static_cast<const float*>(gain);
  p.tokens = tokens;
  p.epilogue = epilogue;
  p.x = x;
  p.x_dtype = x_dtype;
  dim3 grid((n + BN - 1) / BN, (m + BM - 1) / BM);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (w_kn) {
    mp_gemm_kernel<true><<<grid, THREADS, 0, s>>>(p);
  } else {
    mp_gemm_kernel<false><<<grid, THREADS, 0, s>>>(p);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* mp_gemm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
