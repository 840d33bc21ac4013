// wide_tile.cuh: product tiles of 128 rows by 128 or 256 columns on
// gemm_pipeline.cuh's TMA + wgmma pieces, in a ring whose stages hold the
// widest W tile, W optionally multicast across a cluster of CTAs (row 9's
// kernel, csrc/dit_block_tp.cu mlp_branch, runs one CTA a cluster; the
// k-step probe, csrc/kstep_probe.cu, runs both).
//
// A 128 x 256 x 64 k step: two consumer warpgroups of 64 rows each issue
// wgmma.mma_async m64n256k16 (bf16 -> f32, both operands from shared
// memory, 128 f32 accumulators a thread) on a 16 KB A tile and a 32 KB W
// tile: 4.2 MFLOP for 48 KB, twice the FLOPs a byte of gemm_pipeline.cuh's
// 128 x 128 step. A 128-column item runs m64n128k16 on the first half of
// the stage's W room and of the accumulators.
//
// Multicast (CLUSTER = 2): the two CTAs of a cluster run items on two row
// tiles with the same W tile, in lockstep through the ring; each loads its
// own A tile and one half of the W rows, which TMA writes into the same
// stage of both CTAs (.multicast::cluster), so each CTA reads 16 KB of A and
// half of W from L2 a step. A stage's full barrier expects the A tile and
// the whole W tile; its empty barrier takes an arrival from every consumer
// warp of both CTAs (the partner's through mapa), since the next fill
// writes into both. The ring's position `it` advances as in
// gemm_pipeline.cuh, alike in both CTAs of a cluster.
#pragma once

#include "gemm_pipeline.cuh"

namespace wide_tile {

using namespace gemm_pipeline;

constexpr int WN = 256;                             // columns of a wide tile
constexpr int STAGE_BYTES_WIDE = A_BYTES + WN * BK * 2;  // 48 KB

__device__ __forceinline__ void wgmma_m64n256k16(float (&d)[128], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, "
      "%128, %129, p, 1, 1, 0, 0;\n"
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
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(db), "r"(1));
}

// keeps the compiler from moving accumulator reads across a wgmma wait
__device__ __forceinline__ void fence_acc128(float (&d)[128]) {
#pragma unroll
  for (int i = 0; i < 128; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// the first 64 accumulators, for a 128-column item
__device__ __forceinline__ float (&first64(float (&d)[128]))[64] { return *reinterpret_cast<float(*)[64]>(d); }

__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

// every thread of every CTA of the cluster
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release.aligned;\nbarrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// a TMA load into the same shared offset (and barrier) of every CTA in mask
__device__ __forceinline__ void tma_load_2d_multicast(uint32_t dst, const CUtensorMap* map, uint32_t bar, int c0,
                                                      int c1, uint16_t mask) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes.multicast::cluster"
      " [%0], [%1, {%3, %4}], [%2], %5;\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "h"(mask)
      : "memory");
}

// an arrival on the barrier at this CTA's shared offset `bar` in CTA `rank`
// of the cluster
__device__ __forceinline__ void mbar_arrive_cluster(uint32_t bar, uint32_t rank) {
  asm volatile(
      "{\n"
      ".reg .b32 remote;\n"
      "mapa.shared::cluster.u32 remote, %0, %1;\n"
      "mbarrier.arrive.shared::cluster.b64 _, [remote];\n"
      "}\n" ::"r"(bar),
      "r"(rank)
      : "memory");
}

// The ring: STAGES stages of an A tile and room for a WN-row W tile,
// 1024-byte aligned for the swizzle, then the full and empty barriers.
// (STAGE = gemm_pipeline's STAGE_BYTES gives its 128 x 128 ring's layout.)
template <int STAGES, int CLUSTER, int STAGE = STAGE_BYTES_WIDE>
struct WideRing {
  uint32_t base;
  __device__ __forceinline__ uint32_t stage(int s) const { return base + s * STAGE; }
  __device__ __forceinline__ uint32_t full(int s) const { return base + STAGES * STAGE + 8 * s; }
  __device__ __forceinline__ uint32_t empty(int s) const { return base + STAGES * STAGE + 8 * (STAGES + s); }
  static constexpr int BYTES = STAGES * STAGE + 2 * STAGES * 8;
  static constexpr int N_STAGES = STAGES, N_CLUSTER = CLUSTER;

  // one thread, before the CTA's first __syncthreads (and, CLUSTER > 1,
  // before a cluster_sync ahead of any load or remote arrival)
  __device__ __forceinline__ void init() const {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), CLUSTER * CONSUMER_THREADS / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }

  // a consumer warp's lane 0: stage s is free again in every CTA of the
  // cluster
  __device__ __forceinline__ void release(int s, uint32_t rank) const {
    if constexpr (CLUSTER == 1) {
      mbar_arrive(empty(s));
    } else {
#pragma unroll
      for (uint32_t r = 0; r < CLUSTER; ++r) {
        if (r == rank) mbar_arrive(empty(s));
        else mbar_arrive_cluster(empty(s), r);
      }
    }
  }
};

// The producer (one thread): k step `at` of an item of nb columns, W part:
// the stage's barrier expects the A tile and the whole W tile; this CTA
// loads its share, rows n0 + rank * nb / CLUSTER .. of W (the tensor map's
// box), into its own stage and, multicast, the partner's.
template <class Ring>
__device__ __forceinline__ void produce_w(const Ring& ring, const CUtensorMap* tm_w, uint32_t at, int k0, int n0,
                                          int nb, uint32_t rank) {
  constexpr int STAGES = Ring::N_STAGES, CLUSTER = Ring::N_CLUSTER;
  const int s = at % STAGES;
  mbar_wait(ring.empty(s), ((at / STAGES) & 1) ^ 1);
  mbar_expect_tx(ring.full(s), A_BYTES + nb * BK * 2);
  const int rows = nb / CLUSTER;
  const uint32_t dst = ring.stage(s) + A_BYTES + rank * rows * BK * 2;
  if constexpr (CLUSTER == 1) {
    tma_load_2d(dst, tm_w, ring.full(s), k0, n0);
  } else {
    tma_load_2d_multicast(dst, tm_w, ring.full(s), k0, n0 + static_cast<int>(rank) * rows, (1u << CLUSTER) - 1);
  }
}

// ... and its A part: this CTA's own rows m0 .. m0 + 127 (zeros past M)
template <class Ring>
__device__ __forceinline__ void produce_a(const Ring& ring, const CUtensorMap* tm_a, uint32_t at, int k0, int m0) {
  const int s = at % Ring::N_STAGES;
  tma_load_2d(ring.stage(s), tm_a, ring.full(s), k0, m0);
}

// A consumer warpgroup (wg owns rows 64 wg .. 64 wg + 63 of the tile): nk k
// steps of an NB-column item into acc. The wgmma of k step i overlaps the
// loads of step i + 1; a stage is released one step late, the last once
// the products are done. An inactive warpgroup (its rows past M) still
// waits for and releases every stage: the partner CTA's loads land in it.
template <int NB, class Ring>
__device__ __forceinline__ void consume_k(const Ring& ring, float (&acc)[128], int wg, int lane, bool active, int nk,
                                          uint32_t& it, uint32_t rank) {
  constexpr int STAGES = Ring::N_STAGES;
#pragma unroll
  for (int i = 0; i < NB / 2; ++i) acc[i] = 0.f;
  for (int i = 0; i < nk; ++i, ++it) {
    const int s = it % STAGES;
    mbar_wait(ring.full(s), (it / STAGES) & 1);
    if (active) {
      const uint32_t a_wg = ring.stage(s) + wg * (64 * 128), w_s = ring.stage(s) + A_BYTES;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        const uint64_t da = smem_desc(a_wg + kk * 32, 16, 1024), db = smem_desc(w_s + kk * 32, 16, 1024);
        if constexpr (NB == WN) wgmma_m64n256k16(acc, da, db);
        else wgmma_m64n128k16<0>(first64(acc), da, db);
      }
      wgmma_commit();
      wgmma_wait<1>();
    }
    if (i > 0) {
      __syncwarp();
      if (lane == 0) ring.release((it - 1) % STAGES, rank);
    }
  }
  wgmma_wait<0>();
  fence_acc128(acc);
  if (nk > 0) {
    __syncwarp();
    if (lane == 0) ring.release((it - 1) % STAGES, rank);
  }
}

// The f32 partial sums of split z of an NB-column item at (z, row, col) of
// (splits, m, n), straight from the fragments (8-byte stores).
template <int NB>
__device__ __forceinline__ void store_partial_w(float* partial, const float (&acc)[128], int z, int m, int n, int m0,
                                                int n0, int tid) {
  const int rt = acc_row(tid), ct = acc_col(tid);
#pragma unroll
  for (int j = 0; j < NB / 8; ++j) {
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

}  // namespace wide_tile
