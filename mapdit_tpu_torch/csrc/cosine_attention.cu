// cosine_attention: the attention core of the DiT block, one block of
// threads per (sample, head).
//
// Replaces mapdit_tpu/ops/pallas/dit_block.py:_attention_core with
// _cosine_scales, the body shared by the whole-block, whole-stack and
// attention half-block Pallas kernels. Input is the flat f32 qkv product
// (N*T, 3D) with heads as contiguous column slices (no head relayout);
// output is the pre-projection attention (N*T, D), bf16 or f32.
//   * per-row cosine scales sqrt(hd) / (||row|| + 1e-4), from the f32 rows;
//   * logits = (bf16(q) . bf16(k)) / sqrt(hd) * qs_i * ks_j (f32 sums);
//   * max-free softmax exp(l - sqrt(hd)): cosine logits are bounded by
//     sqrt(hd), so no row max is needed and no exponent overflows;
//   * o = (bf16(exp) . bf16(v)) * (1 / row sum), the division after P.V.
// Products of bf16 values are exact in f32, so the scalar f32 FMAs here give
// the bf16-operand, f32-accumulate products of the Pallas kernel up to the
// order of the sums.
//
// Bound on the H100: at T = 64, hd = 64 a block moves 3*T*hd f32 in and
// T*hd out and does 4*T*T*hd flops, ~10 flops per byte: memory-bound. q, k,
// v (bf16, rows padded by 2 elements against bank conflicts) and the f32
// T x T exponentials all stay in shared memory, so qkv is read once and the
// output written once. The products run on the f32 pipes, not the tensor
// cores; that is the simple first form (ROADMAP B.1).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr float NORM_EPS = 1e-4f;

__host__ __device__ inline int row_stride(int hd) { return hd + 2; }

__host__ inline size_t smem_bytes(int t, int hd) {
  return 3 * (size_t)t * row_stride(hd) * sizeof(__nv_bfloat16) +
         ((size_t)t * t + 3 * (size_t)t) * sizeof(float);
}

__global__ void __launch_bounds__(THREADS)
    cosine_attention_kernel(const float* __restrict__ qkv, void* __restrict__ out, int out_bf16,
                            int t, int heads, int hd) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int ld = row_stride(hd);
  __nv_bfloat16* q = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* k = q + t * ld;
  __nv_bfloat16* v = k + t * ld;
  float* ex = reinterpret_cast<float*>(v + t * ld);
  float* qs = ex + t * t;
  float* ks = qs + t;
  float* inv_sum = ks + t;

  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;
  const int nwarps = THREADS / 32;
  const int sample = blockIdx.y;
  const int head = blockIdx.x;
  const int d = heads * hd;
  const float* base = qkv + (int64_t)sample * t * 3 * d + head * hd;

  for (int i = tid; i < t * hd; i += THREADS) {
    const int r = i / hd, c = i % hd;
    const float* row = base + (int64_t)r * 3 * d;
    q[r * ld + c] = __float2bfloat16(row[c]);
    k[r * ld + c] = __float2bfloat16(row[d + c]);
    v[r * ld + c] = __float2bfloat16(row[2 * d + c]);
  }
  // one warp per q or k row: the norm is taken on the f32 values
  const float sqrt_hd = sqrtf((float)hd);
  for (int r = warp; r < 2 * t; r += nwarps) {
    const float* row = base + (int64_t)(r % t) * 3 * d + (r < t ? 0 : d);
    float s = 0.f;
    for (int c = lane; c < hd; c += 32) s += row[c] * row[c];
    for (int off = 16; off > 0; off /= 2) s += __shfl_xor_sync(0xffffffffu, s, off);
    if (lane == 0) (r < t ? qs : ks)[r % t] = sqrt_hd / (sqrtf(s) + NORM_EPS);
  }
  __syncthreads();

  const float inv_hd = 1.f / sqrt_hd;
  for (int i = tid; i < t * t; i += THREADS) {
    const int r = i / t, c = i % t;
    const __nv_bfloat16* qr = q + r * ld;
    const __nv_bfloat16* kc = k + c * ld;
    float acc = 0.f;
    for (int j = 0; j < hd; ++j) acc += __bfloat162float(qr[j]) * __bfloat162float(kc[j]);
    const float logit = acc * inv_hd * qs[r] * ks[c];
    ex[i] = expf(logit - sqrt_hd);
  }
  __syncthreads();

  for (int r = warp; r < t; r += nwarps) {
    float s = 0.f;
    for (int c = lane; c < t; c += 32) s += ex[r * t + c];
    for (int off = 16; off > 0; off /= 2) s += __shfl_xor_sync(0xffffffffu, s, off);
    if (lane == 0) inv_sum[r] = 1.f / s;
  }
  __syncthreads();

  for (int i = tid; i < t * hd; i += THREADS) {
    const int r = i / hd, c = i % hd;
    const float* er = ex + r * t;
    float acc = 0.f;
    for (int j = 0; j < t; ++j)
      acc += __bfloat162float(__float2bfloat16(er[j])) * __bfloat162float(v[j * ld + c]);
    const float o = acc * inv_sum[r];
    const int64_t idx = ((int64_t)sample * t + r) * d + head * hd + c;
    if (out_bf16) {
      static_cast<__nv_bfloat16*>(out)[idx] = __float2bfloat16(o);
    } else {
      static_cast<float*>(out)[idx] = o;
    }
  }
}

}  // namespace

extern "C" size_t cosine_attention_smem_bytes(int t, int hd) { return smem_bytes(t, hd); }

extern "C" int cosine_attention(const void* qkv, void* out, int out_bf16, int n, int t, int heads,
                                int hd, void* stream) {
  const size_t smem = smem_bytes(t, hd);
  cudaError_t err = cudaFuncSetAttribute(
      cosine_attention_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid(heads, n);
  cosine_attention_kernel<<<grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(qkv), out, out_bf16, t, heads, hd);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* cosine_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
