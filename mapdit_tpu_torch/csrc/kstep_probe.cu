// kstep_probe: one SM's k step of a product tile, timed three ways with
// clock64 stamps (mapdit_tpu_torch/tools/bench_mlp_branch.py --kstep).
//
// Replaces no TPU kernel: it measures the tile pipelines the kernels run,
// to tell whether L2's bytes or each SM's own pipeline bound a k step
// (PERF.md §7). Every CTA (one an SM, all at once, as in a persistent
// kernel) walks the tiles c, c + ctas, ... of C (m, n) = A (m, k) . W^T with
// the kernels' ring, producer warpgroup (setmaxnreg 40) and two consumer
// warpgroups (232):
//   * NB = 128, four 32 KB stages: gemm_pipeline.cuh's 128 x 128 ring, as
//     mp_gemm, dit_stack and dit_block_tp's rows 6-8 run it;
//   * NB = 256, three 48 KB stages: wide_tile.cuh's 128 x 256 ring, as row
//     9 runs it, alone or with W multicast across a 2-CTA cluster.
// MODE 0 runs loads and wgmma as the kernels do; MODE 1 loads only (the
// consumers wait for each stage and release it at once); MODE 2 wgmma only
// (the ring filled once, then every k step's wgmma on the stage it would
// use, with no wait or release). Consumer thread 0 stamps clock64 and
// %globaltimer around its k steps; a CTA writes (cycles, ns, k steps, 0).
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "wide_tile.cuh"

namespace {

using namespace gemm_pipeline;

constexpr int KSTEP_THREADS = CONSUMER_THREADS + 128;

__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(t));
  return t;
}

template <int NB, int STAGES, int STAGE, int C, int MODE>
__global__ void __launch_bounds__(KSTEP_THREADS, 1)
    kstep_kernel(const __grid_constant__ CUtensorMap tm_a, const __grid_constant__ CUtensorMap tm_w, int m, int n,
                 int k, unsigned long long* out) {
  using Ring = wide_tile::WideRing<STAGES, C, STAGE>;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  const Ring ring{(smem_u32(smem_raw) + 1023u) & ~1023u};
  const uint32_t rank = C > 1 ? wide_tile::cluster_rank() : 0;
  const int mt = (m + BM - 1) / BM, nt = (n + NB - 1) / NB, kt = (k + BK - 1) / BK;
  const int items = (mt + C - 1) / C * C * nt;
  if (threadIdx.x == 0) ring.init();
  __syncthreads();
  if constexpr (C > 1) wide_tile::cluster_sync();
  const int tid = threadIdx.x;
  if (tid >= CONSUMER_THREADS) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (tid == CONSUMER_THREADS) {
      uint32_t it = 0;
      for (int j = blockIdx.x; j < items; j += gridDim.x) {
        const int q = j / C, r = q / nt * C + j % C, n0 = q % nt * NB;
        for (int i = 0; i < kt && (MODE != 2 || it < STAGES); ++i, ++it) {
          wide_tile::produce_w(ring, &tm_w, it, i * BK, n0, NB, rank);
          wide_tile::produce_a(ring, &tm_a, it, i * BK, r * BM);
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
    const int lane = tid & 31, wg = tid >> 7;
    uint32_t it = 0;
    float acc[128];
    const long long c0 = clock64();
    const unsigned long long t0 = global_ns();
    if constexpr (MODE == 2) {
      const int mine = (items - static_cast<int>(blockIdx.x) + static_cast<int>(gridDim.x) - 1) / gridDim.x;
      const int steps = mine * kt;
      for (int s = 0; s < STAGES && s < steps; ++s) mbar_wait(ring.full(s), 0);
#pragma unroll
      for (int i = 0; i < NB / 2; ++i) acc[i] = 0.f;
      for (int i = 0; i < steps; ++i, ++it) {
        const uint32_t st = ring.stage(i % STAGES);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk) {
          const uint64_t da = smem_desc(st + wg * (64 * 128) + kk * 32, 16, 1024);
          const uint64_t db = smem_desc(st + A_BYTES + kk * 32, 16, 1024);
          if constexpr (NB == wide_tile::WN) wide_tile::wgmma_m64n256k16(acc, da, db);
          else wgmma_m64n128k16<0>(wide_tile::first64(acc), da, db);
        }
        wgmma_commit();
        wgmma_wait<1>();
      }
      wgmma_wait<0>();
      wide_tile::fence_acc128(acc);
    } else {
      for (int j = blockIdx.x; j < items; j += gridDim.x) {
        if constexpr (MODE == 0) {
          wide_tile::consume_k<NB>(ring, acc, wg, lane, true, kt, it, rank);
        } else {
          for (int i = 0; i < kt; ++i, ++it) {
            mbar_wait(ring.full(it % STAGES), (it / STAGES) & 1);
            __syncwarp();
            if (lane == 0) ring.release(it % STAGES, rank);
          }
        }
      }
    }
    if (tid == 0) {
      out[4 * blockIdx.x] = clock64() - c0;
      out[4 * blockIdx.x + 1] = global_ns() - t0;
      out[4 * blockIdx.x + 2] = it;
      out[4 * blockIdx.x + 3] = 0;
    }
    // keep the sums live
    if constexpr (MODE != 1) {
      if (acc[0] == 1.2345e-30f) out[4 * blockIdx.x + 3] = 1;
    }
  }
  __syncthreads();
  if constexpr (C > 1) wide_tile::cluster_sync();
}

template <int NB, int STAGES, int STAGE, int C, int MODE>
int launch(const void* a, const void* w, int m, int n, int k, int ctas, void* out, void* stream) {
  CUtensorMap tm_a, tm_w;
  if (!encode(&tm_a, a, m, k, BM, BK) || !encode(&tm_w, w, n, k, NB / C, BK) || ctas % C)
    return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = kstep_kernel<NB, STAGES, STAGE, C, MODE>;
  const int smem = 1024 + wide_tile::WideRing<STAGES, C, STAGE>::BYTES;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(ctas);
  cfg.blockDim = dim3(KSTEP_THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, kernel, tm_a, tm_w, m, n, k, static_cast<unsigned long long*>(out));
  return static_cast<int>(e != cudaSuccess ? e : cudaGetLastError());
}

template <int MODE>
int launch_form(int nb, int cluster, const void* a, const void* w, int m, int n, int k, int ctas, void* out,
                void* stream) {
  if (nb == 128 && cluster == 1) return launch<128, 4, STAGE_BYTES, 1, MODE>(a, w, m, n, k, ctas, out, stream);
  if (nb == 256 && cluster == 1)
    return launch<256, 3, wide_tile::STAGE_BYTES_WIDE, 1, MODE>(a, w, m, n, k, ctas, out, stream);
  if (nb == 256 && cluster == 2)
    return launch<256, 3, wide_tile::STAGE_BYTES_WIDE, 2, MODE>(a, w, m, n, k, ctas, out, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// One launch of the probe: mode 0 (loads and wgmma), 1 (loads only) or 2
// (wgmma only) on the form (nb, cluster): (128, 1) the 128 x 128 ring,
// (256, 1) and (256, 2) row 9's. a: bf16 (m, k), w: bf16 (n, k), m, n, k
// multiples of 8; out: 4 uint64 a CTA.
extern "C" int kstep_probe(int mode, int nb, int cluster, const void* a, const void* w, int m, int n, int k, int ctas,
                           void* out, void* stream) {
  switch (mode) {
    case 0:
      return launch_form<0>(nb, cluster, a, w, m, n, k, ctas, out, stream);
    case 1:
      return launch_form<1>(nb, cluster, a, w, m, n, k, ctas, out, stream);
    case 2:
      return launch_form<2>(nb, cluster, a, w, m, n, k, ctas, out, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" const char* kstep_probe_error_string(int code) { return cudaGetErrorString(static_cast<cudaError_t>(code)); }
