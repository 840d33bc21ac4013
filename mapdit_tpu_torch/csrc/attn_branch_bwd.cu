// attn_branch_bwd: the three non-GEMM kernels of the attention half-block's
// fused backward.
//
// Replaces mapdit_tpu/ops/pallas/dit_block.py:_attn_bwd_kernel with its
// body _attn_bwd_math (reached from _attn_bwd_impl, the attn_bwd="pallas"
// VJP of fused_attn_branch). The Pallas kernel holds a group of samples in
// VMEM and runs the whole recompute + hand VJP there; on Hopper the four
// products of width D or 3D go to csrc/mp_gemm.cu (qkv, out, dattn = dout .
// Wout, dh = dqkv . Wqkv) and the stages between them are these kernels:
//
//   (a) gate_residual_bwd   y = (x + (gate*out - x)*0.3) / sqrt(0.58):
//         dx0 = dy*0.7/rd, db = dy*0.3/rd, dgate_rows = sum_t db*out,
//         dout = bf16(db*gate)
//   (b) attention_bwd       one block per (sample, head): recompute the q/k
//         norms and the exact softmax p of the pre-normalised, bf16-rounded
//         q/k, then dv = bf16(p)^T bf16(do), dp = bf16(do) bf16(v)^T,
//         dlog = p*(dp - rowsum(dp*p))/sqrt(hd), dqn = bf16(dlog) bf16(kn),
//         dkn = bf16(dlog)^T bf16(qn), and the FULL quotient VJP of
//         normalize (its denominator is a live edge in the reference):
//         dz = c*dzn - z*(sum(z*dzn)*sqrt(hd)/(r*(r+eps)^2)), c = sqrt(hd)/(r+eps)
//   (c) modulate_fwd / modulate_bwd   h = (u + (shift-u)*g)/den, u = x*scale,
//         den = sqrt((1-g)^2 + g^2) constant in g: h in bf16 for the qkv
//         GEMM and dW_qkv; du = dh*(1-g)/den, dx = dx0 + du*scale,
//         dshift_rows = sum_t dh * g/den, dscale_rows = sum_t du*x,
//         dgain = sum(dh*(shift-u))/den over the whole batch.
//
// Sums across the sequence run in a fixed order inside one thread (a column
// of one sample), and dgain's cross-block sum is a second one-block pass
// over per-block partials in a fixed order: no float atomics, so the bits do
// not change from run to run (the Pallas grid accumulated the same sums
// sequentially, l.768-780).
//
// Bound on the H100 at the DiT-S/2 training shapes (N = 256, T = 64,
// D = 384, 6 heads): (a) and (c) are elementwise passes over a few (N, T, D)
// arrays, memory-bound. (b) reads 4*T*hd f32 and writes 3*T*hd bf16 per
// (sample, head) and does 10*T*T*hd flops (~20 flops per byte), still
// memory-bound against the tensor cores. Its operands (q, k raw in f32;
// qn, kn, v, do rounded to bf16; p and dp/dlog T x T in f32; one T x hd f32
// work buffer) stay in ~117 KB of shared memory at T = hd = 64, so every
// input is read once and every output written once. The products run on the
// f32 pipes over bf16-rounded operands (exact products, f32 sums), the
// simple first form; tensor cores are later work (ROADMAP B.5).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int COLS = 128;  // threads of the column kernels
constexpr int THREADS = 256;
constexpr float NORM_EPS = 1e-4f;

enum { DT_F32 = 0, DT_BF16 = 1 };

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

__device__ __forceinline__ float bf(float v) { return __bfloat162float(__float2bfloat16(v)); }

// ---------------------------------------------------------------------------
// (a) gated MP residual backward; grid (ceil(D / COLS), N)

__global__ void __launch_bounds__(COLS)
    gate_residual_bwd_kernel(const void* __restrict__ dy, int dy_dtype, const float* __restrict__ out,
                             const float* __restrict__ rows, int rows_ld, int gate_off,
                             float* __restrict__ dx0, __nv_bfloat16* __restrict__ dout,
                             float* __restrict__ dgate, int t, int d, float dx_fac, float db_fac) {
  const int col = blockIdx.x * COLS + threadIdx.x;
  const int sample = blockIdx.y;
  if (col >= d) return;
  const float gate = rows[(int64_t)sample * rows_ld + gate_off + col];
  float acc = 0.f;
  for (int r = 0; r < t; ++r) {
    const int64_t idx = ((int64_t)sample * t + r) * d + col;
    const float g = load_f32(dy, dy_dtype, idx);
    dx0[idx] = g * dx_fac;
    const float db = g * db_fac;
    acc += db * out[idx];
    dout[idx] = __float2bfloat16(db * gate);
  }
  dgate[(int64_t)sample * d + col] = acc;
}

// ---------------------------------------------------------------------------
// (b) attention backward; grid (heads, N), one block per (sample, head)

struct AttnSmem {
  int ldf, ldb;
  float *qf, *kf, *dz, *p, *ds, *rq, *rk;
  __nv_bfloat16 *qn, *kn, *vb, *dob;
};

__host__ __device__ inline size_t attn_bwd_smem_bytes(int t, int hd) {
  const size_t ldf = hd + 1, ldb = hd + 2;
  return (3 * (size_t)t * ldf + 2 * (size_t)t * t + 2 * (size_t)t) * sizeof(float) +
         4 * (size_t)t * ldb * sizeof(__nv_bfloat16);
}

__device__ inline AttnSmem attn_smem(unsigned char* base, int t, int hd) {
  AttnSmem s;
  s.ldf = hd + 1;
  s.ldb = hd + 2;
  float* f = reinterpret_cast<float*>(base);
  s.qf = f;
  s.kf = s.qf + t * s.ldf;
  s.dz = s.kf + t * s.ldf;
  s.p = s.dz + t * s.ldf;
  s.ds = s.p + t * t;
  s.rq = s.ds + t * t;
  s.rk = s.rq + t;
  __nv_bfloat16* b = reinterpret_cast<__nv_bfloat16*>(s.rk + t);
  s.qn = b;
  s.kn = s.qn + t * s.ldb;
  s.vb = s.kn + t * s.ldb;
  s.dob = s.vb + t * s.ldb;
  return s;
}

// dz holds dzn (T x hd); z is the raw f32 row block, r its row norms. One
// warp per row: dz_row = c*dzn - z*(sum(z*dzn)*sqrt_hd/(r*(r+eps)^2)),
// written as bf16 into dqkv's column block starting at col0.
__device__ void normalize_vjp_rows(const AttnSmem& s, const float* z, const float* r,
                                   __nv_bfloat16* dqkv, int64_t row0, int ld_out, int col0, int t,
                                   int hd, float sqrt_hd) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32, nwarps = THREADS / 32;
  for (int row = warp; row < t; row += nwarps) {
    float dot = 0.f;
    for (int c = lane; c < hd; c += 32) dot += z[row * s.ldf + c] * s.dz[row * s.ldf + c];
    for (int off = 16; off > 0; off /= 2) dot += __shfl_xor_sync(0xffffffffu, dot, off);
    const float rr = r[row];
    const float cc = sqrt_hd / (rr + NORM_EPS);
    const float k = dot * sqrt_hd / (rr * ((rr + NORM_EPS) * (rr + NORM_EPS)));
    for (int c = lane; c < hd; c += 32) {
      const float v = cc * s.dz[row * s.ldf + c] - z[row * s.ldf + c] * k;
      dqkv[(row0 + row) * ld_out + col0 + c] = __float2bfloat16(v);
    }
  }
}

__global__ void __launch_bounds__(THREADS)
    attention_bwd_kernel(const float* __restrict__ qkv, const float* __restrict__ dattn,
                         __nv_bfloat16* __restrict__ dqkv, int t, int heads, int hd) {
  extern __shared__ __align__(16) unsigned char smem[];
  const AttnSmem s = attn_smem(smem, t, hd);
  const int tid = threadIdx.x;
  const int lane = tid % 32, warp = tid / 32, nwarps = THREADS / 32;
  const int head = blockIdx.x, sample = blockIdx.y;
  const int d = heads * hd;
  const int64_t row0 = (int64_t)sample * t;
  const float* base = qkv + row0 * 3 * d + head * hd;
  const float* dbase = dattn + row0 * d + head * hd;
  const float sqrt_hd = sqrtf((float)hd);
  const float inv_sqrt_hd = 1.f / sqrt_hd;

  for (int i = tid; i < t * hd; i += THREADS) {
    const int r = i / hd, c = i % hd;
    const float* row = base + (int64_t)r * 3 * d;
    s.qf[r * s.ldf + c] = row[c];
    s.kf[r * s.ldf + c] = row[d + c];
    s.vb[r * s.ldb + c] = __float2bfloat16(row[2 * d + c]);
    s.dob[r * s.ldb + c] = __float2bfloat16(dbase[(int64_t)r * d + c]);
  }
  __syncthreads();
  for (int r = warp; r < 2 * t; r += nwarps) {
    const float* row = (r < t ? s.qf : s.kf) + (r % t) * s.ldf;
    float acc = 0.f;
    for (int c = lane; c < hd; c += 32) acc += row[c] * row[c];
    for (int off = 16; off > 0; off /= 2) acc += __shfl_xor_sync(0xffffffffu, acc, off);
    if (lane == 0) (r < t ? s.rq : s.rk)[r % t] = sqrtf(acc);
  }
  __syncthreads();
  // qn = q*sqrt_hd/(r+eps), rounded to bf16 for the products
  for (int i = tid; i < t * hd; i += THREADS) {
    const int r = i / hd, c = i % hd;
    s.qn[r * s.ldb + c] = __float2bfloat16(s.qf[r * s.ldf + c] * sqrt_hd / (s.rq[r] + NORM_EPS));
    s.kn[r * s.ldb + c] = __float2bfloat16(s.kf[r * s.ldf + c] * sqrt_hd / (s.rk[r] + NORM_EPS));
  }
  __syncthreads();
  // logits, then dp = do . v^T (both T x T)
  for (int i = tid; i < t * t; i += THREADS) {
    const int r = i / t, c = i % t;
    float acc = 0.f, dacc = 0.f;
    for (int j = 0; j < hd; ++j) {
      acc += __bfloat162float(s.qn[r * s.ldb + j]) * __bfloat162float(s.kn[c * s.ldb + j]);
      dacc += __bfloat162float(s.dob[r * s.ldb + j]) * __bfloat162float(s.vb[c * s.ldb + j]);
    }
    s.p[i] = acc * inv_sqrt_hd;
    s.ds[i] = dacc;
  }
  __syncthreads();
  // exact softmax, one warp per row: exp(l - max) / sum
  for (int r = warp; r < t; r += nwarps) {
    float m = -INFINITY;
    for (int c = lane; c < t; c += 32) m = fmaxf(m, s.p[r * t + c]);
    for (int off = 16; off > 0; off /= 2) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
    float sum = 0.f;
    for (int c = lane; c < t; c += 32) {
      const float e = expf(s.p[r * t + c] - m);
      s.p[r * t + c] = e;
      sum += e;
    }
    for (int off = 16; off > 0; off /= 2) sum += __shfl_xor_sync(0xffffffffu, sum, off);
    float dot = 0.f;
    for (int c = lane; c < t; c += 32) {
      const float p = s.p[r * t + c] / sum;
      s.p[r * t + c] = p;
      dot += s.ds[r * t + c] * p;
    }
    for (int off = 16; off > 0; off /= 2) dot += __shfl_xor_sync(0xffffffffu, dot, off);
    // dlog = p*(dp - rowsum(dp*p)) / sqrt(hd), in place of dp
    for (int c = lane; c < t; c += 32)
      s.ds[r * t + c] = s.p[r * t + c] * (s.ds[r * t + c] - dot) * inv_sqrt_hd;
  }
  __syncthreads();
  // dv = bf16(p)^T . do, straight to dqkv's v columns; dqn = bf16(dlog) . kn
  for (int i = tid; i < t * hd; i += THREADS) {
    const int r = i / hd, c = i % hd;
    float dv = 0.f, dq = 0.f;
    for (int j = 0; j < t; ++j) {
      dv += bf(s.p[j * t + r]) * __bfloat162float(s.dob[j * s.ldb + c]);
      dq += bf(s.ds[r * t + j]) * __bfloat162float(s.kn[j * s.ldb + c]);
    }
    dqkv[(row0 + r) * 3 * d + 2 * d + head * hd + c] = __float2bfloat16(dv);
    s.dz[r * s.ldf + c] = dq;
  }
  __syncthreads();
  normalize_vjp_rows(s, s.qf, s.rq, dqkv, row0, 3 * d, head * hd, t, hd, sqrt_hd);
  __syncthreads();
  // dkn = bf16(dlog)^T . qn
  for (int i = tid; i < t * hd; i += THREADS) {
    const int r = i / hd, c = i % hd;
    float dk = 0.f;
    for (int j = 0; j < t; ++j) dk += bf(s.ds[j * t + r]) * __bfloat162float(s.qn[j * s.ldb + c]);
    s.dz[r * s.ldf + c] = dk;
  }
  __syncthreads();
  normalize_vjp_rows(s, s.kf, s.rk, dqkv, row0, 3 * d, d + head * hd, t, hd, sqrt_hd);
}

// ---------------------------------------------------------------------------
// (c) modulate forward (elementwise) and backward (grid (ceil(D / COLS), N))

__global__ void modulate_fwd_kernel(const void* __restrict__ x, int x_dtype,
                                    const float* __restrict__ rows, int rows_ld, int shift_off,
                                    int scale_off, const float* __restrict__ gain,
                                    __nv_bfloat16* __restrict__ h, int64_t total, int t, int d) {
  const float g = *gain;
  const float den = sqrtf((1.f - g) * (1.f - g) + g * g);
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < total;
       i += (int64_t)gridDim.x * blockDim.x) {
    const int col = (int)(i % d);
    const float* mrow = rows + (i / ((int64_t)t * d)) * rows_ld;
    const float u = load_f32(x, x_dtype, i) * mrow[scale_off + col];
    h[i] = __float2bfloat16((u + (mrow[shift_off + col] - u) * g) / den);
  }
}

__global__ void __launch_bounds__(COLS)
    modulate_bwd_kernel(const float* __restrict__ dh, const void* __restrict__ x, int x_dtype,
                        const float* __restrict__ rows, int rows_ld, int shift_off, int scale_off,
                        const float* __restrict__ gain, const float* __restrict__ dx0,
                        void* __restrict__ dx, float* __restrict__ dshift,
                        float* __restrict__ dscale, float* __restrict__ partial, int t, int d) {
  __shared__ float red[COLS];
  const int col = blockIdx.x * COLS + threadIdx.x;
  const int sample = blockIdx.y;
  const float g = *gain;
  const float den = sqrtf((1.f - g) * (1.f - g) + g * g);
  const float du_fac = (1.f - g) / den;
  float acc_gain = 0.f;
  if (col < d) {
    const float* mrow = rows + (int64_t)sample * rows_ld;
    const float shift = mrow[shift_off + col], scale = mrow[scale_off + col];
    float acc_dh = 0.f, acc_scale = 0.f;
    for (int r = 0; r < t; ++r) {
      const int64_t idx = ((int64_t)sample * t + r) * d + col;
      const float g_h = dh[idx];
      const float xv = load_f32(x, x_dtype, idx);
      const float u = xv * scale;
      const float du = g_h * du_fac;
      acc_dh += g_h;
      acc_gain += g_h * (shift - u);
      store_f32(dx, x_dtype, idx, dx0[idx] + du * scale);
      acc_scale += du * xv;
    }
    dshift[(int64_t)sample * d + col] = acc_dh * (g / den);
    dscale[(int64_t)sample * d + col] = acc_scale;
  }
  red[threadIdx.x] = acc_gain;
  __syncthreads();
  for (int stride = COLS / 2; stride > 0; stride /= 2) {
    if (threadIdx.x < stride) red[threadIdx.x] += red[threadIdx.x + stride];
    __syncthreads();
  }
  if (threadIdx.x == 0) partial[(int64_t)blockIdx.y * gridDim.x + blockIdx.x] = red[0];
}

// dgain = (sum of the per-block partials) / den, in a fixed order
__global__ void __launch_bounds__(THREADS)
    gain_reduce_kernel(const float* __restrict__ partial, int count, const float* __restrict__ gain,
                       float* __restrict__ dgain) {
  __shared__ float red[THREADS];
  float acc = 0.f;
  for (int i = threadIdx.x; i < count; i += THREADS) acc += partial[i];
  red[threadIdx.x] = acc;
  __syncthreads();
  for (int stride = THREADS / 2; stride > 0; stride /= 2) {
    if (threadIdx.x < stride) red[threadIdx.x] += red[threadIdx.x + stride];
    __syncthreads();
  }
  if (threadIdx.x == 0) {
    const float g = *gain;
    dgain[0] = red[0] / sqrtf((1.f - g) * (1.f - g) + g * g);
  }
}

}  // namespace

extern "C" int gate_residual_bwd(const void* dy, int dy_dtype, const void* out, const void* rows,
                                 int rows_ld, int gate_off, void* dx0, void* dout, void* dgate,
                                 int n, int t, int d, void* stream) {
  const double t_res = 0.3, rd = sqrt((1.0 - t_res) * (1.0 - t_res) + t_res * t_res);
  dim3 grid((d + COLS - 1) / COLS, n);
  gate_residual_bwd_kernel<<<grid, COLS, 0, static_cast<cudaStream_t>(stream)>>>(
      dy, dy_dtype, static_cast<const float*>(out), static_cast<const float*>(rows), rows_ld,
      gate_off, static_cast<float*>(dx0), static_cast<__nv_bfloat16*>(dout),
      static_cast<float*>(dgate), t, d, (float)((1.0 - t_res) / rd), (float)(t_res / rd));
  return static_cast<int>(cudaGetLastError());
}

extern "C" size_t attention_bwd_smem_bytes(int t, int hd) { return attn_bwd_smem_bytes(t, hd); }

extern "C" int attention_bwd(const void* qkv, const void* dattn, void* dqkv, int n, int t,
                             int heads, int hd, void* stream) {
  const size_t smem = attn_bwd_smem_bytes(t, hd);
  cudaError_t err = cudaFuncSetAttribute(
      attention_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid(heads, n);
  attention_bwd_kernel<<<grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(qkv), static_cast<const float*>(dattn),
      static_cast<__nv_bfloat16*>(dqkv), t, heads, hd);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int modulate_fwd(const void* x, int x_dtype, const void* rows, int rows_ld,
                            int shift_off, int scale_off, const void* gain, void* h, int n, int t,
                            int d, void* stream) {
  const int64_t total = (int64_t)n * t * d;
  const int blocks = (int)((total + 255) / 256 < 4096 ? (total + 255) / 256 : 4096);
  modulate_fwd_kernel<<<blocks, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      x, x_dtype, static_cast<const float*>(rows), rows_ld, shift_off, scale_off,
      static_cast<const float*>(gain), static_cast<__nv_bfloat16*>(h), total, t, d);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int modulate_bwd_partials(int n, int d) { return n * ((d + COLS - 1) / COLS); }

extern "C" int modulate_bwd(const void* dh, const void* x, int x_dtype, const void* rows,
                            int rows_ld, int shift_off, int scale_off, const void* gain,
                            const void* dx0, void* dx, void* dshift, void* dscale, void* partial,
                            void* dgain, int n, int t, int d, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  dim3 grid((d + COLS - 1) / COLS, n);
  modulate_bwd_kernel<<<grid, COLS, 0, s>>>(
      static_cast<const float*>(dh), x, x_dtype, static_cast<const float*>(rows), rows_ld,
      shift_off, scale_off, static_cast<const float*>(gain), static_cast<const float*>(dx0), dx,
      static_cast<float*>(dshift), static_cast<float*>(dscale), static_cast<float*>(partial), t, d);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  gain_reduce_kernel<<<1, THREADS, 0, s>>>(static_cast<const float*>(partial), grid.x * grid.y,
                                           static_cast<const float*>(gain),
                                           static_cast<float*>(dgain));
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* attn_branch_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
