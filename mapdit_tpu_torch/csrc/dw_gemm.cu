// dw_gemm: C (P, Q) f32 = alpha * A^T . B for bf16 A (M, P) and B (M, Q), f32
// sums, contracting over the M rows.
//
// Replaces the two weight-gradient products that the in-kernel-dW variant of
// the Pallas attention backward computes in its own body
// (mapdit_tpu/ops/pallas/dit_block.py:783 _attn_bwd_dw_kernel, under
// _attn_bwd_impl l.861, pallas_call l.918): dW_qkv = dqkv^T . h and
// dW_out = dout^T . attn, operands in the weights' type, f32 accumulation
// over all N*T rows, 1/sqrt(D) applied once to the finished sum.
//
// Bound on the H100: at the DiT-S/2 training shapes (M = 16,384; P x Q =
// 1152 x 384 and 384 x 384) the products do 2*M*P*Q flops on M*(P+Q) bf16
// elements read and P*Q f32 written, ~280 and ~190 flops per byte: just under
// the ridge of the tensor cores (295), so bound by bytes, narrowly: 0.0232 ms
// for the pair (75.5 MB at 3.35 TB/s).
//
// Design (sm_90a), mp_gemm.cu's machinery with both operands MN-major:
//   * CTA tile 192 x 192 of C, k depth 64: three consumer warpgroups of 64
//     rows of P each issue wgmma.mma_async m64n192k16 (bf16 -> f32, 96 f32
//     accumulators a thread); one producer warp keeps TMA loads
//     (cp.async.bulk.tensor, 128-byte swizzle, full/empty mbarrier pairs)
//     in flight through a ring of four 48 KB stages (one CTA an SM).
//   * A and B are both stored with the contraction M as their slow axis, so
//     A^T enters wgmma as a transposed (M-major) A operand and B as a
//     transposed (N-major) B operand, both from shared memory: each stage
//     holds (64 rows of M) x (64 columns) boxes, three of A and three of B;
//     nothing is copied or transposed in device memory.
//   * The tile is wide so that each byte staged from L2 feeds more
//     products: a 192 x 192 x 64 step moves 48 KB for 4.7 MFLOP, 98 FLOP a
//     byte, against 64 for mp_gemm's 128 x 128 (the first form's WMMA
//     tiles staged 32 FLOP a byte and never overlapped copies with products).
//   * The output is small (12 tiles at the S/2 qkv shape, 4 at out) and the
//     contraction deep (256 k steps), so M is split across blockIdx.z, each
//     split a deep main loop that the ring hides. The splits of one tile
//     form a thread-block cluster of CS = 1, 2, 4 or 8 CTAs along z: each
//     CTA parks its f32 tile in its own shared memory (the drained ring),
//     and CTA r of the cluster sums rows r*192/CS .. of all CS tiles through
//     distributed shared memory in rank order, then writes them with 16-byte
//     stores. With G clusters on one tile (splits = CS*G), each writes an f32
//     partial tile and dw_gemm_reduce sums the G partials in group order and
//     applies alpha once; with G = 1 the cluster writes alpha * C itself. No
//     atomics: two runs give the same bits, which exact resume needs.
//     (CS, G) keeps every cluster resident at once (cudaOccupancy-
//     MaxActiveClusters) and takes G = 1 where that leaves most SMs busy,
//     then more groups where a split would run deeper than 32 k steps,
//     which the f32 sums of the tensor cores do not stand (plan() below):
//     at S/2 qkv 8 x 1 (96 CTAs), out 2 x 16 (128), B/2 qkv 2 x 4.
//   * What bounds it now: L2. At S/2 qkv the 96 CTAs stage 151 MB from L2
//     in ~0.034 ms (~4.5 TB/s); a multicast form (two CTAs of one p tile
//     and split, a cluster along q, each loading half of every A box for
//     both, their empty barriers released by both CTAs' consumers) was
//     built and measured in one call against this one and not kept: S/2
//     qkv 0.0623 ms (2 x 4 x 2) against 0.0349, out 0.0349 against 0.0225,
//     B/2 qkv 0.2113 against 0.0950 (graph-timed; NVIDIA H100 80GB HBM3,
//     700 W). cuBLAS takes 0.0300 and 0.0230 for the S/2 pair.
//   * wgmma of k step i overlaps the loads of step i+1 (wgmma.wait_group 1;
//     a stage is released one step late). The tail of M, and columns past
//     P or Q, are TMA's out-of-bounds zeros.
//   * TMA needs 16-byte aligned rows and pointers: P and Q multiples of 8
//     (the wrapper raises otherwise). The tensor maps are encoded on the
//     host with cuTensorMapEncodeTiled, taken from the driver library the
//     process has loaded (dlopen of libcuda.so.1), as mp_gemm.cu does.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <dlfcn.h>
#include <stdint.h>

namespace {

constexpr int BP = 192;
constexpr int BQ = 192;
constexpr int BK = 64;
constexpr int BOX = 64;  // columns of a TMA box: 128 bytes, the swizzle's row
constexpr int WARPGROUPS = BP / 64;
constexpr int CONSUMER_THREADS = 128 * WARPGROUPS;
constexpr int THREADS = CONSUMER_THREADS + 32;  // and one producer warp
constexpr int BOX_BYTES = BK * BOX * 2;
constexpr int A_BYTES = BK * BP * 2;
constexpr int B_BYTES = BK * BQ * 2;
constexpr int STAGE_BYTES = A_BYTES + B_BYTES;
constexpr int STAGES = 4;
// 1 KB of slack to align the ring to the 1024 bytes the swizzle needs, then
// the barriers
constexpr int SMEM_BYTES = STAGES * STAGE_BYTES + 1024 + 2 * STAGES * 8;
constexpr int MIN_STEPS = 4;   // k steps a split takes at least
constexpr int MAX_STEPS = 32;  // and at most (plan())
constexpr int REDUCE_THREADS = 256;
constexpr int LDT = BQ + 8;  // f32 row stride of the parked tile (8-byte stores free of bank conflicts)
static_assert(BP * LDT * 4 <= STAGES * STAGE_BYTES, "the parked tile must fit in the ring");

__host__ __device__ inline int cdiv(int a, int b) { return (a + b - 1) / b; }

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
__device__ __forceinline__ void fence_acc(float (&d)[96]) {
#pragma unroll
  for (int i = 0; i < 96; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

// every thread of every CTA of the cluster: writes to shared memory before
// it are visible to the cluster after it
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release.aligned;\nbarrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// four floats at a shared::cta address of this CTA, read from CTA `rank` of
// the cluster
__device__ __forceinline__ float4 ld_cluster_f4(uint32_t addr, uint32_t rank) {
  uint32_t remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(remote) : "r"(addr), "r"(rank));
  float4 v;
  asm volatile("ld.shared::cluster.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "r"(remote)
               : "memory");
  return v;
}

// D(64x192, f32) += A(64x16, smem, M-major) . B(16x192, smem, N-major):
// both operands transposed (imm-trans-a = imm-trans-b = 1)
__device__ __forceinline__ void wgmma_m64n192k16_tt(float (&d)[96], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %98, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95}, "
      "%96, %97, p, 1, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95])
      : "l"(da), "l"(db), "r"(1));
}

// One split of M per CTA, CS splits (a cluster along z) per group: the
// group's sum of A^T . B over its k steps, times f, into out (P, Q) + group
// * P * Q (C itself when there is one group, else its partial tile).
__global__ void __launch_bounds__(THREADS, 1)
    dw_gemm_kernel(const __grid_constant__ CUtensorMap tm_a, const __grid_constant__ CUtensorMap tm_b, float* out,
                   int p, int q, int kt, int cs, float f) {
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  const uint32_t ring = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t bars = ring + STAGES * STAGE_BYTES;
  auto full_bar = [&](int s) { return bars + 8 * s; };
  auto empty_bar = [&](int s) { return bars + 8 * (STAGES + s); };

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int p0 = blockIdx.y * BP, q0 = blockIdx.x * BQ;
  const int splits = gridDim.z;
  const int kb = blockIdx.z * kt / splits, ke = (blockIdx.z + 1) * kt / splits;
  const int nk = ke - kb;

  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full_bar(s), 1);
      mbar_init(empty_bar(s), CONSUMER_THREADS / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // the parked f32 tile, over the ring once every stage is consumed
  float* tile = reinterpret_cast<float*>(smem_raw + (ring - smem_u32(smem_raw)));
  if (warp == CONSUMER_THREADS / 32) {
    // producer: one thread keeps the ring full
    if (lane == 0) {
      asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(&tm_a)) : "memory");
      asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(&tm_b)) : "memory");
      for (int i = 0; i < nk; ++i) {
        const int s = i % STAGES;
        mbar_wait(empty_bar(s), ((i / STAGES) & 1) ^ 1);
        const uint32_t a_s = ring + s * STAGE_BYTES, b_s = a_s + A_BYTES;
        const int k0 = (kb + i) * BK;
        mbar_expect_tx(full_bar(s), STAGE_BYTES);
#pragma unroll
        for (int j = 0; j < BP / BOX; ++j) tma_load_2d(a_s + j * BOX_BYTES, &tm_a, full_bar(s), p0 + j * BOX, k0);
#pragma unroll
        for (int j = 0; j < BQ / BOX; ++j) tma_load_2d(b_s + j * BOX_BYTES, &tm_b, full_bar(s), q0 + j * BOX, k0);
      }
    }
    __syncwarp();
  } else {
    // consumers: warpgroup wg owns rows 64*wg .. 64*wg + 63 of the tile
    // (the A box wg)
    const int wg = warp >> 2;
    const bool active = p0 + 64 * wg < p;
    float acc[96];
#pragma unroll
    for (int i = 0; i < 96; ++i) acc[i] = 0.f;

    for (int i = 0; i < nk; ++i) {
      const int s = i % STAGES;
      mbar_wait(full_bar(s), (i / STAGES) & 1);
      const uint32_t a_s = ring + s * STAGE_BYTES, b_s = a_s + A_BYTES;
      if (active) {
        const uint32_t a_wg = a_s + wg * BOX_BYTES;
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk) {
          // MN-major: 64-column boxes BOX_BYTES apart (LBO), 8-k groups 1 KB
          // apart (SBO); a k16 step is 16 rows of 128 bytes
          wgmma_m64n192k16_tt(acc, smem_desc(a_wg + kk * 16 * 128, BOX_BYTES, 1024),
                              smem_desc(b_s + kk * 16 * 128, BOX_BYTES, 1024));
        }
        wgmma_commit();
        wgmma_wait<1>();
      }
      if (i > 0) {
        __syncwarp();
        if (lane == 0) mbar_arrive(empty_bar((i - 1) % STAGES));
      }
    }
    wgmma_wait<0>();
    fence_acc(acc);
    // every warpgroup is past its last wgmma before the ring is overwritten
    asm volatile("bar.sync 1, %0;\n" ::"n"(CONSUMER_THREADS) : "memory");
    if (active) {
      // accumulator layout of m64nNk16: warp w of the warpgroup holds rows
      // 16w + lane/4 (+8), columns 8j + 2(lane%4) (+1)
      const int rt = 64 * wg + 16 * (warp & 3) + (lane >> 2), ct = 2 * (lane & 3);
#pragma unroll
      for (int j = 0; j < BQ / 8; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          *reinterpret_cast<float2*>(tile + (rt + 8 * h) * LDT + ct + 8 * j) =
              make_float2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
    }
  }
  cluster_sync();

  // CTA r of the cluster sums rows r*BP/cs .. of the cluster's tiles in rank
  // order and stores them, four columns a thread
  const int rows = BP / cs, r0 = static_cast<int>(cluster_rank()) * rows;
  float* dst = out + static_cast<int64_t>(blockIdx.z / cs) * p * q;
  for (int i = tid; i < rows * (BQ / 4); i += THREADS) {
    const int r = r0 + i / (BQ / 4), c = 4 * (i % (BQ / 4));
    const int row = p0 + r, col = q0 + c;
    if (row < p && col < q) {
      const uint32_t addr = smem_u32(tile + r * LDT + c);
      float4 v = ld_cluster_f4(addr, 0);
      for (int src = 1; src < cs; ++src) {
        const float4 u = ld_cluster_f4(addr, src);
        v.x += u.x;
        v.y += u.y;
        v.z += u.z;
        v.w += u.w;
      }
      *reinterpret_cast<float4*>(dst + static_cast<int64_t>(row) * q + col) =
          make_float4(v.x * f, v.y * f, v.z * f, v.w * f);
    }
  }
  // no CTA leaves while another still reads its tile
  cluster_sync();
}

// c = alpha * (partial[0] + partial[1] + ... ), the groups' sums added in
// group order; four elements a thread
__global__ void __launch_bounds__(REDUCE_THREADS)
    dw_gemm_reduce(const float4* __restrict__ partial, float4* __restrict__ c, int64_t count4, int groups,
                   float alpha) {
  for (int64_t i = blockIdx.x * static_cast<int64_t>(REDUCE_THREADS) + threadIdx.x; i < count4;
       i += static_cast<int64_t>(gridDim.x) * REDUCE_THREADS) {
    float4 v = partial[i];
    for (int z = 1; z < groups; ++z) {
      const float4 u = partial[z * count4 + i];
      v.x += u.x;
      v.y += u.y;
      v.z += u.z;
      v.w += u.w;
    }
    c[i] = make_float4(v.x * alpha, v.y * alpha, v.z * alpha, v.w * alpha);
  }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
                                const cuuint64_t*, const cuuint32_t*, const cuuint32_t*, CUtensorMapInterleave,
                                CUtensorMapSwizzle, CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_fn() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* h = dlopen("libcuda.so.1", RTLD_LAZY | RTLD_NOLOAD);
    if (h == nullptr) h = dlopen("libcuda.so.1", RTLD_LAZY);
    if (h != nullptr) fn = reinterpret_cast<EncodeTiled>(dlsym(h, "cuTensorMapEncodeTiled"));
  }
  return fn;
}

// a row-major bf16 (rows, cols) matrix read in (BK, BOX) boxes, 128-byte
// swizzle, zeros outside
bool encode(CUtensorMap* map, const void* ptr, int rows, int cols) {
  EncodeTiled fn = encode_fn();
  if (fn == nullptr) return false;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(cols) * 2};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(BOX), static_cast<cuuint32_t>(BK)};
  const cuuint32_t elem[2] = {1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(ptr), dims, strides, box, elem,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The kernel's launch attributes, set once: its shared memory
cudaError_t configure() {
  static cudaError_t state = cudaErrorNotReady;
  if (state == cudaErrorNotReady)
    state = cudaFuncSetAttribute(dw_gemm_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  return state;
}

cudaLaunchConfig_t launch_config(dim3 grid, int cs, cudaStream_t stream, cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = SMEM_BYTES;
  cfg.stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = 1;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = cs;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// how many clusters of cs CTAs the card holds at once (cached by cs)
int active_clusters(int cs) {
  static int cached[9] = {0};
  if (cached[cs] == 0) {
    cudaLaunchAttribute attr;
    const cudaLaunchConfig_t cfg = launch_config(dim3(1, 1, cs), cs, nullptr, &attr);
    int n = 0;
    if (configure() != cudaSuccess || cudaOccupancyMaxActiveClusters(&n, dw_gemm_kernel, &cfg) != cudaSuccess || n < 1)
      n = 1;
    cached[cs] = n;
  }
  return cached[cs];
}

struct Plan {
  int cs, groups;
};

// The splits of M, CS * G, every split at least MIN_STEPS k steps deep and
// every cluster resident at once: one group (no partial tiles) with the
// largest cluster that keeps at least 70% as many CTAs busy as the best plan
// could; else, within 10% of the most CTAs, the largest cluster. Then no
// split deeper than MAX_STEPS: the tensor cores' f32 sums lose accuracy in
// step with a split's depth (max abs error at the S/2 qkv product 6.7e-5 at
// 32 steps, 1.4e-4 at 64, 6.8e-4 at 256, against 1e-4 + 1e-4 relative), so
// a deeper plan takes more groups. tools/bench_attention.py --part backward
// times and checks every plan beside this one (PERF.md).
Plan best_resident(int m, int p, int q) {
  const int tiles = cdiv(p, BP) * cdiv(q, BQ), most = cdiv(m, BK) / MIN_STEPS;
  auto groups_for = [&](int cs) {
    const int g = active_clusters(cs) / tiles, deep = most / cs;
    return g < deep ? g : deep;
  };
  int best = 0;
  for (int cs = 1; cs <= 8; cs *= 2) {
    const int ctas = tiles * cs * groups_for(cs);
    if (ctas > best) best = ctas;
  }
  for (int cs = 8; cs >= 1; cs /= 2)
    if (cs <= most && tiles <= active_clusters(cs) && 10 * tiles * cs >= 7 * best) return {cs, 1};
  for (int cs = 8; cs >= 1; cs /= 2) {
    const int g = groups_for(cs);
    if (g >= 1 && 10 * tiles * cs * g >= 9 * best) return {cs, g};
  }
  return {1, 1};
}

Plan plan(int m, int p, int q) {
  const Plan pl = best_resident(m, p, q);
  const int need = cdiv(cdiv(m, BK), MAX_STEPS);
  return pl.cs * pl.groups >= need ? pl : Plan{pl.cs, cdiv(need, pl.cs)};
}

}  // namespace

// how many partial (P, Q) f32 tiles dw_gemm needs as scratch: the number of
// groups G (1: none, C is written directly)
extern "C" int dw_gemm_splits(int m, int p, int q) { return plan(m, p, q).groups; }

// dw_gemm under a given plan: CS in {1, 2, 4, 8} CTAs a cluster, G groups
// (CS * G splits, at most one a k step); CS = 0 takes plan()'s. Other plans
// are there to be timed against plan()'s (tools/bench_attention.py).
// partial: (G, p, q) f32, unused with one group
extern "C" int dw_gemm_planned(const void* a, const void* b, void* partial, void* c, int m, int p, int q,
                               float alpha, int cs, int groups, void* stream) {
  if (m < 1 || p % 8 || q % 8 || (reinterpret_cast<uintptr_t>(a) | reinterpret_cast<uintptr_t>(b)) % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = configure();
  if (err != cudaSuccess) return static_cast<int>(err);
  const Plan pl = cs == 0 ? plan(m, p, q) : Plan{cs, groups};
  if (pl.cs < 1 || pl.cs > 8 || (pl.cs & (pl.cs - 1)) || pl.groups < 1 || pl.cs * pl.groups > cdiv(m, BK) ||
      (pl.groups > 1 && partial == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap ta, tb;
  if (!encode(&ta, a, m, p) || !encode(&tb, b, m, q)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = launch_config(dim3(cdiv(q, BQ), cdiv(p, BP), pl.cs * pl.groups), pl.cs, s, &attr);
  const bool direct = pl.groups == 1;
  err = cudaLaunchKernelEx(&cfg, dw_gemm_kernel, ta, tb, static_cast<float*>(direct ? c : partial), p, q,
                           cdiv(m, BK), pl.cs, direct ? alpha : 1.f);
  if (err == cudaSuccess) err = cudaGetLastError();
  if (err != cudaSuccess || direct) return static_cast<int>(err);
  const int64_t count4 = static_cast<int64_t>(p) * q / 4;
  const int blocks = static_cast<int>(count4 / REDUCE_THREADS + 1 < 1024 ? count4 / REDUCE_THREADS + 1 : 1024);
  dw_gemm_reduce<<<blocks, REDUCE_THREADS, 0, s>>>(static_cast<const float4*>(partial), static_cast<float4*>(c),
                                                  count4, pl.groups, alpha);
  return static_cast<int>(cudaGetLastError());
}

// partial: (dw_gemm_splits(m, p, q), p, q) f32, unused with one group
extern "C" int dw_gemm(const void* a, const void* b, void* partial, void* c, int m, int p, int q,
                       float alpha, void* stream) {
  return dw_gemm_planned(a, b, partial, c, m, p, q, alpha, 0, 0, stream);
}

extern "C" const char* dw_gemm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
