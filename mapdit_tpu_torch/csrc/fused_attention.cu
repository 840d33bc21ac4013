// fused_attention: standalone multi-head attention over (B, H, T, D')
// operands, softmax(norm(q) . norm(k)^T * scale) . v, with the row
// normalisation only under `cosine`.
//
// Replaces mapdit_tpu/ops/pallas/attention.py:_fused_attention_fwd_impl
// (fused_attention; its two pallas_calls, the v2 kernel _attention_kernel
// and the head-pair-packed v3 kernel _attention_kernel_packed, compute the
// same function; the pairing is a 128x128 matrix-unit tile shape and is not
// carried over). It differs from cosine_attention.cu, the core of the block
// kernels, in four ways:
//   * operands are separate q, k, v of shape (B, H, T, D') addressed by
//     their batch, head and token strides (last dimension contiguous), so
//     the transposed views of a fused qkv product are read in place and no
//     head relayout copy is made; the output is written by strides too;
//   * `cosine` is a switch, and without it logits are unbounded, so the
//     softmax subtracts the row maximum (no max-free exp here);
//   * p is normalised before P.V;
//   * inputs are f32 or bf16 (one template parameter).
// Roundings, those of the v3 Pallas kernel: under `cosine` the rows
// q * sqrt(D') / (||q|| + 1e-4) (norm and product in f32) are rounded to the
// input type, likewise k; logits are f32 sums of the products of those
// values, times `scale`; p = exp(l - max) / sum in f32 is rounded to v's
// type; the output is the f32 sum of p . v rounded to the input type. For
// f32 inputs nothing is rounded, which is the v2 kernel's arithmetic.
// Products of bf16 values are exact in f32, so scalar f32 FMAs give the
// bf16-operand, f32-accumulate products up to the order of the sums.
//
// One block per (batch, head, tile of `qt` query rows). K and V of the head,
// the query tile and a qt x T tile of logits live in shared memory as f32
// (rows padded by one element against bank conflicts), so every operand is
// read from device memory once per query tile and D' = 72 needs no special
// case. The host picks the largest qt that fits 227 KB: T = 256, D' = 72
// takes qt = 32 (191,616 bytes). A loop over key tiles with a running
// maximum, which would lift the limit on T, is later work.
//
// Bound on the H100: at B/2 (T = 64, D' = 64) a head moves 4*T*D' elements
// and does 4*T*T*D' flops, 32 flops per bf16 byte: memory-bound. The
// products run on the f32 pipes, not the tensor cores; that is the simple
// first form.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr float NORM_EPS = 1e-4f;

__host__ __device__ inline int row_stride(int hd) { return hd + 1; }

__host__ inline size_t smem_bytes(int t, int hd, int qt) {
  return ((size_t)(2 * t + qt) * row_stride(hd) + (size_t)qt * t) * sizeof(float);
}

__device__ __forceinline__ float load(const float* p) { return *p; }
__device__ __forceinline__ float load(const __nv_bfloat16* p) { return __bfloat162float(*p); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

template <typename T>
__device__ __forceinline__ float round_to(float v);
template <>
__device__ __forceinline__ float round_to<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ float round_to<__nv_bfloat16>(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

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

template <typename T>
__global__ void __launch_bounds__(THREADS) fused_attention_kernel(Params p) {
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
  const int nwarps = THREADS / 32;
  const long long b = blockIdx.z, h = blockIdx.y;
  const int q0 = blockIdx.x * p.qt;
  const int rows = min(p.qt, t - q0);

  const T* qg = static_cast<const T*>(p.q) + b * p.sq.b + h * p.sq.h + (long long)q0 * p.sq.t;
  const T* kg = static_cast<const T*>(p.k) + b * p.sk.b + h * p.sk.h;
  const T* vg = static_cast<const T*>(p.v) + b * p.sv.b + h * p.sv.h;
  T* og = static_cast<T*>(p.out) + b * p.so.b + h * p.so.h + (long long)q0 * p.so.t;

  for (int i = tid; i < t * hd; i += THREADS) {
    const int r = i / hd, c = i % hd;
    ks[r * ld + c] = load(kg + r * p.sk.t + c);
    vs[r * ld + c] = load(vg + r * p.sv.t + c);
  }
  for (int i = tid; i < rows * hd; i += THREADS) {
    const int r = i / hd, c = i % hd;
    qs[r * ld + c] = load(qg + r * p.sq.t + c);
  }
  __syncthreads();

  if (p.cosine) {
    // one warp per k or q row: norm of the f32 values, then the scaled row
    // rounded to the input type
    const float sqrt_hd = sqrtf((float)hd);
    for (int r = warp; r < t + rows; r += nwarps) {
      float* row = r < t ? ks + r * ld : qs + (r - t) * ld;
      float s = 0.f;
      for (int c = lane; c < hd; c += 32) s += row[c] * row[c];
      for (int off = 16; off > 0; off /= 2) s += __shfl_xor_sync(0xffffffffu, s, off);
      const float f = sqrt_hd / (sqrtf(s) + NORM_EPS);
      for (int c = lane; c < hd; c += 32) row[c] = round_to<T>(row[c] * f);
    }
    __syncthreads();
  }

  for (int i = tid; i < rows * t; i += THREADS) {
    const int r = i / t, c = i % t;
    const float* qr = qs + r * ld;
    const float* kc = ks + c * ld;
    float acc = 0.f;
    for (int j = 0; j < hd; ++j) acc += qr[j] * kc[j];
    lg[i] = acc * p.scale;
  }
  __syncthreads();

  // one warp per query row: max, exp and sum, then p rounded to v's type
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
    for (int c = lane; c < t; c += 32) row[c] = round_to<T>(row[c] / s);
  }
  __syncthreads();

  for (int i = tid; i < rows * hd; i += THREADS) {
    const int r = i / hd, c = i % hd;
    const float* pr = lg + r * t;
    float acc = 0.f;
    for (int j = 0; j < t; ++j) acc += pr[j] * vs[j * ld + c];
    store(og + r * p.so.t + c, acc);
  }
}

template <typename T>
int launch(const Params& p, int b, int h, cudaStream_t stream) {
  const size_t smem = smem_bytes(p.t, p.hd, p.qt);
  cudaError_t err = cudaFuncSetAttribute(fused_attention_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((p.t + p.qt - 1) / p.qt, h, b);
  fused_attention_kernel<T><<<grid, THREADS, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" size_t fused_attention_smem_bytes(int t, int hd, int qt) {
  return smem_bytes(t, hd, qt);
}

// dtype: 0 = f32, 1 = bf16 (q, k, v and out alike). Strides are in elements:
// batch, head, token for each of q, k, v, out; the last dimension is
// contiguous. qt is the query tile, chosen by the caller so that
// fused_attention_smem_bytes(t, hd, qt) fits the card's limit.
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
  return dtype == 1 ? launch<__nv_bfloat16>(p, b, h, s) : launch<float>(p, b, h, s);
}

extern "C" const char* fused_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
