// dw_gemm: C (P, Q) f32 = alpha * A^T . B for bf16 A (M, P) and B (M, Q), f32
// sums, contracting over the M rows.
//
// Replaces the two weight-gradient products that the in-kernel-dW variant of
// the Pallas attention backward computes in its own body
// (mapdit_tpu/ops/pallas/dit_block.py:_attn_bwd_dw_kernel): dW_qkv =
// dqkv^T . h and dW_out = dout^T . attn, operands in the weights' type, f32
// accumulation over all N*T rows, 1/sqrt(D) applied once to the finished sum.
//
// Bound on the H100: at the DiT-S/2 training shapes (M = 16,384; P x Q =
// 1152 x 384 and 384 x 384) the products do 2*M*P*Q flops on (M*(P+Q)) bf16
// elements read and P*Q f32 written, ~280 and ~190 flops per byte: just under
// the ridge of the tensor cores (295), so bound by bytes, narrowly. The
// output is small (108 and 36 tiles of 64 x 64) and the contraction deep, so
// one block per tile would leave most of the 132 SMs idle: the contraction is split across blockIdx.z, every split writes its
// own f32 partial tile, and a second kernel sums the partials in a fixed
// order (no atomics: two runs give the same bits). Both operands are read
// along their fast axis (P or Q), 16 bytes a thread; the tile of A lies in
// shared memory as (k, p), which WMMA reads as the col-major operand A^T, so
// nothing is transposed. The tail of M is masked with zeros.
// This first form stages 32 x 64 tiles and multiplies with WMMA bf16
// 16x16x16 fragments (4 warps, 32x32 per warp), like mp_gemm.cu.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;

namespace {

constexpr int BP = 64;
constexpr int BQ = 64;
constexpr int BK = 32;
constexpr int LDS = 64 + 8;  // bf16 elements: a multiple of 8, as wmma needs
constexpr int THREADS = 128;
constexpr int TARGET_BLOCKS = 132 * 8;  // eight resident blocks on each SM
constexpr int MIN_ROWS_PER_SPLIT = 4 * BK;
constexpr int REDUCE_THREADS = 256;

__host__ __device__ inline int ceil_div(int a, int b) { return (a + b - 1) / b; }

// rows of M that one split contracts: a multiple of BK
__host__ __device__ inline int rows_per_split(int m, int splits) {
  return ceil_div(ceil_div(m, splits), BK) * BK;
}

inline int pick_splits(int m, int p, int q) {
  const int tiles = ceil_div(p, BP) * ceil_div(q, BQ);
  int splits = ceil_div(TARGET_BLOCKS, tiles);
  const int most = m / MIN_ROWS_PER_SPLIT;
  if (splits > most) splits = most;
  if (splits < 1) splits = 1;
  // drop splits that would start past the end of M
  return ceil_div(m, rows_per_split(m, splits));
}

// one (k, 64) tile: rows k0.. of src (m, ld) at columns c0.., 8 bf16 a thread
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst, const __nv_bfloat16* src, int ld,
                                          int k0, int k_end, int c0, int tid) {
  for (int i = tid; i < BK * (64 / 8); i += THREADS) {
    const int kk = i / 8, c = (i % 8) * 8;
    const int row = k0 + kk, col = c0 + c;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (row < k_end && col < ld) v = *reinterpret_cast<const uint4*>(src + (int64_t)row * ld + col);
    *reinterpret_cast<uint4*>(dst + kk * LDS + c) = v;
  }
}

// partial[z] (P, Q) = A[rows of split z]^T . B[rows of split z]
__global__ void __launch_bounds__(THREADS)
dw_gemm_partial_kernel(const __nv_bfloat16* a, const __nv_bfloat16* b, float* partial, int m, int p,
                       int q, int rows) {
  __shared__ __align__(32) __nv_bfloat16 As[BK * LDS];
  __shared__ __align__(32) __nv_bfloat16 Bs[BK * LDS];
  __shared__ __align__(32) float Cs[16 * 16 * 4];

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int wp = (warp / 2) * 32;
  const int wq = (warp % 2) * 32;
  const int p0 = blockIdx.y * BP;
  const int q0 = blockIdx.x * BQ;
  const int k_begin = blockIdx.z * rows;
  const int k_end = min(m, k_begin + rows);

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  for (int k0 = k_begin; k0 < k_end; k0 += BK) {
    load_tile(As, a, p, k0, k_end, p0, tid);
    load_tile(Bs, b, q, k0, k_end, q0, tid);
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      // As holds A's rows (k, p): read as the col-major (p, k) operand A^T
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::col_major> fa[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> fb[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) wmma::load_matrix_sync(fa[i], As + kk * LDS + wp + 16 * i, LDS);
#pragma unroll
      for (int j = 0; j < 2; ++j) wmma::load_matrix_sync(fb[j], Bs + kk * LDS + wq + 16 * j, LDS);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
    }
    __syncthreads();
  }

  // each warp stages one 16 x 16 fragment at a time and writes its rows out
  float* stage = Cs + warp * 256;
  float* out = partial + (int64_t)blockIdx.z * p * q;
  const int lane = tid % 32;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      wmma::store_matrix_sync(stage, acc[i][j], 16, wmma::mem_row_major);
      __syncwarp();
      for (int e = lane; e < 256; e += 32) {
        const int row = p0 + wp + 16 * i + e / 16, col = q0 + wq + 16 * j + e % 16;
        if (row < p && col < q) out[(int64_t)row * q + col] = stage[e];
      }
      __syncwarp();
    }
}

// c = alpha * (partial[0] + partial[1] + ... ), summed in that order
__global__ void __launch_bounds__(REDUCE_THREADS)
dw_gemm_reduce_kernel(const float* partial, float* c, int64_t count, int splits, float alpha) {
  const int64_t i = (int64_t)blockIdx.x * REDUCE_THREADS + threadIdx.x;
  if (i >= count) return;
  float sum = 0.f;
  for (int s = 0; s < splits; ++s) sum += partial[(int64_t)s * count + i];
  c[i] = sum * alpha;
}

}  // namespace

// how many partial (P, Q) f32 tiles dw_gemm needs as scratch
extern "C" int dw_gemm_splits(int m, int p, int q) { return pick_splits(m, p, q); }

extern "C" int dw_gemm(const void* a, const void* b, void* partial, void* c, int m, int p, int q,
                       float alpha, void* stream) {
  if (m < 1 || p % 8 || q % 8) return static_cast<int>(cudaErrorInvalidValue);
  const int splits = pick_splits(m, p, q);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  dim3 grid(ceil_div(q, BQ), ceil_div(p, BP), splits);
  dw_gemm_partial_kernel<<<grid, THREADS, 0, s>>>(
      static_cast<const __nv_bfloat16*>(a), static_cast<const __nv_bfloat16*>(b),
      static_cast<float*>(partial), m, p, q, rows_per_split(m, splits));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t count = (int64_t)p * q;
  dw_gemm_reduce_kernel<<<static_cast<unsigned>((count + REDUCE_THREADS - 1) / REDUCE_THREADS),
                          REDUCE_THREADS, 0, s>>>(static_cast<const float*>(partial),
                                                  static_cast<float*>(c), count, splits, alpha);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* dw_gemm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
