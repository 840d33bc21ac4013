// gemm_pipeline.cuh: the TMA + wgmma tile pipeline of mp_gemm.cu, shared
// with dit_stack.cu.
//
// One CTA tile is BM x BN, k depth BK: two consumer warpgroups of 64 rows
// each issue wgmma.mma_async m64n128k16 (bf16 -> f32, both operands from
// shared memory, 64 f32 accumulators a thread); one producer warp keeps TMA
// loads (cp.async.bulk.tensor, 128-byte swizzle, full/empty mbarrier pairs)
// in flight through a ring of STAGES stages of 32 KB. mp_gemm.cu's notes
// hold the measurements behind this shape.
//
// The pipeline position is a running count of k steps, `it`, that the
// producer and the consumers advance alike: stage it % STAGES, phase
// (it / STAGES) & 1. A kernel that runs one tile starts it at 0; a
// persistent kernel carries it from tile to tile, and every stage is
// released after its tile (consume_tile releases the last one too), so the
// phases stay paired across tiles.
//
// The epilogue goes through shared memory: stage_tile writes the
// accumulators into a padded f32 tile, then epilogue_tile hands eight
// consecutive columns to the caller's functor, which moves x, the gate and
// C in 16-byte accesses. The arithmetic of the epilogues (alpha, MP-SiLU,
// the gated MP residual) is here once.
//
// The f32 form (the float32 instances of mp_gemm.cu and dit_stack.cu, the
// Pallas kernels at dtype = float32): f32 A and W, k depth BK_F32 = 32, so
// a stage's tiles are 128-byte rows as in bf16 and the ring, its swizzle
// and its barriers stay byte for byte the same; consume_tile_f32 runs the
// products on the f32 pipes (FFMA, k in order) into accumulators laid out
// as wgmma's, so stage_tile, store_partial and the epilogues take them
// unchanged. The products must be f32-accurate (the Pallas f32 kernel is
// held to its f32 reference at 2e-4): a single TF32 wgmma rounds each
// operand to 10 mantissa bits (~3e-4 a product), and 3xTF32 would need the
// hi / lo split of every A and W tile in shared memory beside the ring, so
// the first form is the f32 pipes' (bound: 67 TFLOP/s, not 989). What bounds
// it now: shared-memory loads. A thread's fragment (2 rows by 32 columns)
// takes 34 16-byte loads for 256 FMAs a 4-k chunk; S/2 qkv runs at 19.4
// TFLOP/s, f32 cuBLAS at 37 (mapdit_tpu_torch/tools/bench_f32.py; NVIDIA H100
// 80GB HBM3, 700.00 W). An 8 x 8 register tile (16 loads) with a staging of
// its own is the next step.
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <dlfcn.h>
#include <stdint.h>

namespace gemm_pipeline {

constexpr int BM = 128;
constexpr int BN = 128;
constexpr int BK = 64;
constexpr int CONSUMER_THREADS = 256;             // two warpgroups
constexpr int THREADS = CONSUMER_THREADS + 32;    // and one producer warp
constexpr int PRODUCER_WARP = CONSUMER_THREADS / 32;
constexpr float RES_T = 0.3f;
constexpr float SILU_DIV = 0.596f;

enum { DT_F32 = 0, DT_BF16 = 1 };

constexpr int A_BYTES = BM * BK * 2;
constexpr int W_BYTES = BN * BK * 2;
constexpr int STAGE_BYTES = A_BYTES + W_BYTES;
// the f32 form's k depth: 128-byte rows, the bf16 stage's bytes
constexpr int BK_F32 = 32;
static_assert(BM * BK_F32 * 4 == A_BYTES && BN * BK_F32 * 4 == W_BYTES, "an f32 stage holds the bf16 stage's bytes");
// the f32 epilogue tile, rows padded by 4 floats so the fragments' 8-byte
// writes are free of bank conflicts
constexpr int LDT = BN + 4;
constexpr int TILE_BYTES = BM * LDT * 4;
// named barrier of the consumer warpgroups (0 is __syncthreads)
constexpr int CONSUMER_BAR = 3;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// spins on try_wait; a wait of ~10 s (a lost TMA transaction, a barrier
// count that cannot complete) traps, so a fault ends the launch with an
// error instead of holding the card
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  const long long start = clock64();
  while (!done) {
    if (clock64() - start > (1ll << 34)) __trap();
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map, uint32_t bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(
          dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

// wgmma shared-memory matrix descriptor, 128-byte swizzle
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo_bytes, uint32_t sbo_bytes) {
  uint64_t d = 0;
  d |= static_cast<uint64_t>((addr & 0x3FFFF) >> 4);
  d |= static_cast<uint64_t>((lbo_bytes >> 4) & 0x3FFF) << 16;
  d |= static_cast<uint64_t>((sbo_bytes >> 4) & 0x3FFF) << 32;
  d |= 1ull << 62;
  return d;
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// keeps the compiler from moving accumulator reads across a wgmma wait
__device__ __forceinline__ void fence_acc(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// D(64x128, f32) += A(64x16, smem) . B(16x128, smem); TRANS_B = 1 reads B
// MN-major (W stored (K, N)), 0 K-major (W stored (N, K))
template <int TRANS_B>
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, %67;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1), "n"(TRANS_B));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float bf16_lo(uint32_t u) { return __uint_as_float(u << 16); }
__device__ __forceinline__ float bf16_hi(uint32_t u) { return __uint_as_float(u & 0xFFFF0000u); }

// The ring: STAGES stages of an A tile and a W tile, 1024-byte aligned for
// the swizzle, then the full and empty barriers.
template <int STAGES>
struct Ring {
  static constexpr int N_STAGES = STAGES;
  uint32_t base;
  __device__ __forceinline__ uint32_t stage(int s) const { return base + s * STAGE_BYTES; }
  __device__ __forceinline__ uint32_t full(int s) const { return base + STAGES * STAGE_BYTES + 8 * s; }
  __device__ __forceinline__ uint32_t empty(int s) const { return base + STAGES * STAGE_BYTES + 8 * (STAGES + s); }
  static constexpr int BYTES = STAGES * STAGE_BYTES + 2 * STAGES * 8;

  // one thread, before the CTA's first __syncthreads
  __device__ __forceinline__ void init() const {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), CONSUMER_THREADS / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
};

// The producer (one thread): the nk k steps from k step kb of the tile at
// rows m0 of A and rows (or, W_KN, columns) n0 of W; KSTEP elements a k
// step (BK, or BK_F32 for f32 operands).
template <int STAGES, bool W_KN, int KSTEP = BK>
__device__ __forceinline__ void produce_tile(const Ring<STAGES>& ring, const CUtensorMap* tm_a,
                                             const CUtensorMap* tm_w, int m0, int n0, int kb, int nk,
                                             uint32_t& it) {
  static_assert(!W_KN || KSTEP == BK, "the MN-major W tiles are bf16");
  for (int i = 0; i < nk; ++i, ++it) {
    const int s = it % STAGES;
    mbar_wait(ring.empty(s), ((it / STAGES) & 1) ^ 1);
    const uint32_t a_s = ring.stage(s), w_s = a_s + A_BYTES;
    const int k0 = (kb + i) * KSTEP;
    mbar_expect_tx(ring.full(s), STAGE_BYTES);
    tma_load_2d(a_s, tm_a, ring.full(s), k0, m0);
    if constexpr (W_KN) {
      tma_load_2d(w_s, tm_w, ring.full(s), n0, k0);
      tma_load_2d(w_s + BK * 128, tm_w, ring.full(s), n0 + 64, k0);
    } else {
      tma_load_2d(w_s, tm_w, ring.full(s), k0, n0);
    }
  }
}

// A consumer warpgroup (wg owns rows 64*wg .. 64*wg + 63 of the tile): the
// nk k steps into acc. The wgmma of k step i overlaps the loads of step
// i + 1 (wgmma.wait_group 1), so a stage is released one step late; the
// last is released once the tile's products are done.
template <int STAGES, bool W_KN>
__device__ __forceinline__ void consume_tile(const Ring<STAGES>& ring, float (&acc)[64], int wg, int lane,
                                             bool active, int nk, uint32_t& it) {
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;
  for (int i = 0; i < nk; ++i, ++it) {
    const int s = it % STAGES;
    mbar_wait(ring.full(s), (it / STAGES) & 1);
    const uint32_t a_s = ring.stage(s), w_s = a_s + A_BYTES;
    if (active) {
      const uint32_t a_wg = a_s + wg * (64 * 128);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        const uint64_t da = smem_desc(a_wg + kk * 32, 16, 1024);
        if constexpr (W_KN) {
          // MN-major: 64-column boxes 8 KB apart (LBO), 8-k groups 1 KB apart (SBO)
          wgmma_m64n128k16<1>(acc, da, smem_desc(w_s + kk * 16 * 128, BK * 128, 1024));
        } else {
          wgmma_m64n128k16<0>(acc, da, smem_desc(w_s + kk * 32, 16, 1024));
        }
      }
      wgmma_commit();
      wgmma_wait<1>();
    }
    if (i > 0) {
      __syncwarp();
      if (lane == 0) mbar_arrive(ring.empty((it - 1) % STAGES));
    }
  }
  wgmma_wait<0>();
  fence_acc(acc);
  if (nk > 0) {
    __syncwarp();
    if (lane == 0) mbar_arrive(ring.empty((it - 1) % STAGES));
  }
}

// accumulator layout of m64nNk16: warp w of the warpgroup holds rows
// 16w + lane/4 (+8), columns 8j + 2(lane%4) (+1); for consumer thread tid
__device__ __forceinline__ int acc_row(int tid) { return 64 * (tid >> 7) + 16 * ((tid >> 5) & 3) + ((tid & 31) >> 2); }
__device__ __forceinline__ int acc_col(int tid) { return 2 * (tid & 3); }

// 16 bytes of shared memory at a shared-window address
__device__ __forceinline__ float4 lds_float4(uint32_t addr) {
  float4 v;
  asm volatile("ld.shared.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "r"(addr)
               : "memory");
  return v;
}

// byte offset of 16-byte chunk c of row r in a 1024-byte aligned tile of
// 128-byte rows that TMA wrote with the 128-byte swizzle (the chunk index
// XOR the row's place in its group of eight)
__device__ __forceinline__ uint32_t swizzle_offset(int r, int c) { return r * 128 + ((c ^ (r & 7)) << 4); }

// acc += a . w over four consecutive k, in k order
__device__ __forceinline__ void fma_k4(float& acc, const float4& a, const float4& w) {
  acc = fmaf(a.x, w.x, acc);
  acc = fmaf(a.y, w.y, acc);
  acc = fmaf(a.z, w.z, acc);
  acc = fmaf(a.w, w.w, acc);
}

// consume_tile for f32 operands on the f32 pipes: consumer thread tid
// (0-255) sums the 64 elements of its wgmma fragment (rows rt, rt + 8,
// columns ct + 8j, ct + 8j + 1) over each stage's 32 k, 16-byte loads of A
// and W rows from the swizzled tiles (a warp's loads meet eight rows of A
// and four of W at distinct chunks: no bank conflicts), every product an
// FFMA in k order. A stage is released as soon as the warp is through it.
template <int STAGES>
__device__ __forceinline__ void consume_tile_f32(const Ring<STAGES>& ring, float (&acc)[64], int tid, bool active,
                                                 int nk, uint32_t& it) {
  const int lane = tid & 31, rt = acc_row(tid), ct = acc_col(tid);
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;
  for (int i = 0; i < nk; ++i, ++it) {
    const int s = it % STAGES;
    mbar_wait(ring.full(s), (it / STAGES) & 1);
    if (active) {
      const uint32_t a_s = ring.stage(s), w_s = a_s + A_BYTES;
#pragma unroll 2
      for (int c = 0; c < BK_F32 / 4; ++c) {
        const float4 a0 = lds_float4(a_s + swizzle_offset(rt, c)), a1 = lds_float4(a_s + swizzle_offset(rt + 8, c));
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          const float4 w0 = lds_float4(w_s + swizzle_offset(ct + 8 * j, c));
          const float4 w1 = lds_float4(w_s + swizzle_offset(ct + 8 * j + 1, c));
          fma_k4(acc[4 * j], a0, w0);
          fma_k4(acc[4 * j + 1], a0, w1);
          fma_k4(acc[4 * j + 2], a1, w0);
          fma_k4(acc[4 * j + 3], a1, w1);
        }
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(ring.empty(s));
  }
}

// The f32 partial sums of split z of a split-K product at (z, row, col) of
// (splits, m, n), straight from the fragments (8-byte stores).
__device__ __forceinline__ void store_partial(float* partial, const float (&acc)[64], int z, int m, int n, int m0,
                                              int n0, int tid) {
  const int rt = acc_row(tid), ct = acc_col(tid);
#pragma unroll
  for (int j = 0; j < 16; ++j) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = m0 + rt + 8 * h, col = n0 + ct + 8 * j;
      if (row < m && col < n) {
        const int64_t idx = (static_cast<int64_t>(z) * m + row) * n + col;
        *reinterpret_cast<float2*>(partial + idx) = make_float2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
      }
    }
  }
}

// The accumulators into the f32 tile (the consumers only): the named
// barrier before keeps the previous tile's readers out, the one after
// makes the tile whole.
__device__ __forceinline__ void stage_tile(float* tile, const float (&acc)[64], bool active, int tid) {
  asm volatile("bar.sync %0, %1;\n" ::"n"(CONSUMER_BAR), "n"(CONSUMER_THREADS) : "memory");
  if (active) {
    const int rt = acc_row(tid), ct = acc_col(tid);
#pragma unroll
    for (int j = 0; j < 16; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        *reinterpret_cast<float2*>(tile + (rt + 8 * h) * LDT + ct + 8 * j) =
            make_float2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
      }
  }
  asm volatile("bar.sync %0, %1;\n" ::"n"(CONSUMER_BAR), "n"(CONSUMER_THREADS) : "memory");
}

// Eight consecutive columns of the staged tile a consumer thread and step,
// handed to finish(row, col, v) inside the (m, n) bounds.
template <class Finish>
__device__ __forceinline__ void epilogue_tile(const float* tile, int m, int n, int m0, int n0, int tid,
                                              const Finish& finish) {
#pragma unroll 2
  for (int q = tid; q < BM * BN / 8; q += CONSUMER_THREADS) {
    const int r = q / (BN / 8), c = 8 * (q % (BN / 8));
    const int row = m0 + r, col = n0 + c;
    if (row < m && col < n) {
      const float4 lo = *reinterpret_cast<const float4*>(tile + r * LDT + c);
      const float4 hi = *reinterpret_cast<const float4*>(tile + r * LDT + c + 4);
      float v[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
      finish(row, col, v);
    }
  }
}

// The epilogues' arithmetic on eight f32 sums v.
__device__ __forceinline__ void scale8(float (&v)[8], float alpha) {
#pragma unroll
  for (int e = 0; e < 8; ++e) v[e] *= alpha;
}

// the fast exponential and reciprocals: IEEE division and expf made the
// SiLU epilogue outlast a K = 384 tile's products; the f32 result moves by
// a few ulps, far inside a bf16 ulp
__device__ __forceinline__ void silu8(float (&v)[8], float alpha) {
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    const float c = v[e] * alpha;
    v[e] = c * __frcp_rn(1.f + __expf(-c)) * (1.f / SILU_DIV);
  }
}

// the gated MP residual (x + (gate*c - x)*0.3) / sqrt(0.58), c = v*alpha
__device__ __forceinline__ void residual8(float (&v)[8], const float (&x)[8], const float (&gate)[8], float alpha) {
  const float inv_denom = rsqrtf((1.f - RES_T) * (1.f - RES_T) + RES_T * RES_T);
#pragma unroll
  for (int e = 0; e < 8; ++e) v[e] = (x[e] + (gate[e] * (v[e] * alpha) - x[e]) * RES_T) * inv_denom;
}

// The tensor maps are encoded on the host with cuTensorMapEncodeTiled, taken
// from the libcuda.so.1 the process has loaded (dlopen/dlsym), so a library
// links no libcuda and builds with plain nvcc.
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
                                const cuuint64_t*, const cuuint32_t*, const cuuint32_t*, CUtensorMapInterleave,
                                CUtensorMapSwizzle, CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

inline EncodeTiled encode_fn() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* h = dlopen("libcuda.so.1", RTLD_LAZY | RTLD_NOLOAD);
    if (h == nullptr) h = dlopen("libcuda.so.1", RTLD_LAZY);
    if (h != nullptr) fn = reinterpret_cast<EncodeTiled>(dlsym(h, "cuTensorMapEncodeTiled"));
  }
  return fn;
}

// a row-major (rows, cols) matrix of elem_bytes elements read in
// (box_rows, box_cols) tiles, 128-byte swizzle, zeros outside
inline bool encode_typed(CUtensorMap* map, CUtensorMapDataType type, int elem_bytes, const void* ptr, int rows,
                         int cols, int box_rows, int box_cols) {
  EncodeTiled fn = encode_fn();
  if (fn == nullptr) return false;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(cols) * elem_bytes};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(box_cols), static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t elem[2] = {1, 1};
  return fn(map, type, 2, const_cast<void*>(ptr), dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// a row-major bf16 matrix
inline bool encode(CUtensorMap* map, const void* ptr, int rows, int cols, int box_rows, int box_cols) {
  return encode_typed(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, ptr, rows, cols, box_rows, box_cols);
}

// a row-major f32 matrix (box_cols of at most 32: 128-byte rows)
inline bool encode_f32_swizzled(CUtensorMap* map, const void* ptr, int rows, int cols, int box_rows, int box_cols) {
  return encode_typed(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, ptr, rows, cols, box_rows, box_cols);
}

}  // namespace gemm_pipeline
