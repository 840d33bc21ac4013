// work_list.cuh: the persistent work-list machinery of the port's one-launch
// kernels, shared by csrc/dit_block_tp.cu (the TP partials, row 9) and
// csrc/attn_branch.cu (the attention half-block, rows 3, 4 and 5).
//
// A launch runs one list of stages laid out by a host plan (the plan's
// words: each stage's kind, items, K splits, counter word, ticket word and
// target offset, ops/cuda/dit_block_tp.py TpPlan.words), one cooperative
// launch of one CTA an SM, CTA c taking items c, c + ctas, ... An item
// waits only on the previous stage's counter of its own row tile (a release
// add by the item that finishes, an acquire load by the one that waits),
// and every wait points backwards in the list, so the earliest unfinished
// item can always run. The sync words (counters, tickets, barrier) lie in
// one buffer a plan keeps on the card: the last CTA to leave a launch zeroes
// them again (leave_launch), so a call is one device launch and no memset.
// Tickets count the finished parts of a sum whose last part is added by
// whoever takes the last ticket (take_ticket): no float atomics, the same
// bits on every run. Also here: the pre items (the modulate into a bf16
// amod), the cosine attention's (sample, head) units on four consumer warps,
// a product item's producer side on gemm_pipeline.cuh's ring, and the host's
// plan reading and tensor-map cache. dit_block_tp.cu's notes hold the
// measurements behind the design.
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <initializer_list>
#include <mutex>

#include "attention_tiles.cuh"
#include "cosine_tiles.cuh"
#include "gemm_pipeline.cuh"
#include "modulate.cuh"

namespace work_list {

using namespace gemm_pipeline;

constexpr int STAGES = 4;
constexpr int PRODUCER_REGS = 40, CONSUMER_REGS = 232;
constexpr int KERNEL_THREADS = CONSUMER_THREADS + 128;
// the sync words: [0] a grid barrier (row 7's), [SYNC_EXIT] the CTAs that
// have left; from SYNC_DONE the plan's counters and tickets
constexpr int SYNC_EXIT = 8, SYNC_DONE = 32;
// stages a list holds at most (the attention half-block's backward has seven)
constexpr int MAX_STAGES = 8;
// the plan's words (ops/cuda/dit_block_tp.py TpPlan.words): a header, then one group a
// stage (kind, items, K splits, counter word, ticket word, target offset)
enum { P_STAGES = 0, P_SYNC_WORDS, P_BUFFER_WORDS, P_CTAS, P_MODS_SPLITS, P_MODS_TICKET, P_STAGE = 8 };
enum { PS_KIND = 0, PS_ITEMS, PS_SPLITS, PS_COUNTER, PS_TICKET, PS_TARGET, PS_WORDS };
// how the pre items read shift and scale: f32 as they are (row 7's mods),
// f32 rounded to bf16 (rows 6 and 8), bf16, all three through L2; or, as
// they are, inputs of the launch through the read-only path (f32, bf16)
enum { ROWS_F32 = 0, ROWS_F32_ROUNDED = 1, ROWS_BF16 = 2, ROWS_IN_F32 = 3, ROWS_IN_BF16 = 4 };
constexpr int PRE_ROWS = 4;    // token rows of a TP pre item (a plan's pre_rows)
constexpr int PRE_UNROLL = 3;  // its loads in flight a thread
constexpr int MAX_SPLITS = 8;
// kinds of stage: the modulate, a product, the cosine attention's (sample,
// head) units, and the attention backward's (csrc/attn_branch.cu)
enum { S_PRE = 0, S_GEMM = 1, S_ATTN = 2, S_ATTN_BWD = 3 };

template <int HD>
struct AttnSmem {
  static constexpr int LD = attn_tiles::Dims<HD>::LD;
  static constexpr int BYTES = 3 * attn_tiles::TILE * LD * 2 + 2 * attn_tiles::TILE * 4;
};
static_assert(2 * AttnSmem<72>::BYTES <= STAGES * STAGE_BYTES, "attention buffers must fit in the ring");

// one product: C (m, n) = A (m, k) . W^T (w_kn: A . W, W stored (k, n)),
// 128 x 128 tiles, K split `splits` ways; epi: the kernel's epilogue
struct Prod {
  int m, n, nt, kt, splits, a_map, w_map, epi, w_kn;
  float alpha;
  void* c;         // the epilogue's output, row stride n
  float* partial;  // (splits, m, n) f32 when split
  int ticket_off;  // words from the sync base: one ticket a tile
};

__device__ __forceinline__ int cdiv_d(int a, int b) { return (a + b - 1) / b; }

__device__ __forceinline__ void load8_cg(const float* p, float (&v)[8]) {
  const float4 lo = __ldcg(reinterpret_cast<const float4*>(p));
  const float4 hi = __ldcg(reinterpret_cast<const float4*>(p) + 1);
  v[0] = lo.x; v[1] = lo.y; v[2] = lo.z; v[3] = lo.w;
  v[4] = hi.x; v[5] = hi.y; v[6] = hi.z; v[7] = hi.w;
}

__device__ __forceinline__ unsigned ld_acquire(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];\n" : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(t));
  return t;
}

// spins until *p >= target; a wait of ~10 s traps
__device__ __forceinline__ void spin_until(const unsigned* p, unsigned target) {
  const long long start = clock64();
  while (ld_acquire(p) < target) {
    if (clock64() - start > (1ll << 34)) __trap();
  }
}

// every CTA waits until all have arrived; stores before it are visible to
// loads and TMA loads after it
__device__ __forceinline__ void grid_sync(unsigned* bar, unsigned target) {
  asm volatile("fence.proxy.async;\n" ::: "memory");
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    atomicAdd(bar, 1u);
    spin_until(bar, target);
    __threadfence();
  }
  __syncthreads();
  asm volatile("fence.proxy.async;\n" ::: "memory");
}

__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync %0, %1;\n" ::"n"(CONSUMER_BAR), "n"(CONSUMER_THREADS) : "memory");
}

// One part of a ticketed sum is in (its stores issued by every consumer
// thread before the named barrier): thread 0 takes a ticket of `word`;
// returns, to every consumer thread, whether it was the last of `parts`,
// after which the other parts' stores are visible to it. `flag`: one int of
// shared memory.
__device__ __forceinline__ bool take_ticket(unsigned* word, unsigned parts, volatile int* flag) {
  __threadfence();
  consumer_sync();
  if (threadIdx.x == 0) {
    const bool is_last = atomicAdd(word, 1u) == parts - 1;
    if (is_last) __threadfence();
    *flag = is_last;
  }
  consumer_sync();
  return *flag;
}


// The plain epilogue, on eight f32 sums v of C[row, col..col+7] (alpha not
// applied): C * alpha in f32.
struct ScaleEpi {
  float* c;
  int ld;
  float alpha;
  __device__ __forceinline__ void operator()(int row, int col, float (&v)[8]) const {
    scale8(v, alpha);
    modulate::store8(c + static_cast<int64_t>(row) * ld + col, v);
  }
};

// Chunks of a 128 x 128 tile (chunk q: row q / 16, eight columns from
// 8 (q % 16)) on the consumer threads: sums(r, c, v), then the epilogue.
template <class Epi, class Sums>
__device__ __forceinline__ void finish_tile(const Epi& epi, const Sums& sums, int m, int n, int m0, int n0, int tid) {
  for (int q = tid; q < BM * BN / 8; q += CONSUMER_THREADS) {
    const int r = q / (BN / 8), c = 8 * (q % (BN / 8));
    if (m0 + r < m && n0 + c < n) {
      float v[8];
      sums(r, c, v);
      epi(m0 + r, n0 + c, v);
    }
  }
}

// item j of a product (StackProduct.item): row tile, column offset, split,
// k steps; tiles of nb columns (BN, or row 9's wide_tile::WN)
struct Tile {
  int r, m0, n0, z, kb, nk, tile_i;
  __device__ __forceinline__ Tile(const Prod& p, int j, int nb = BN) {
    const int tiles = cdiv_d(p.m, BM) * p.nt;
    tile_i = j % tiles;
    z = j / tiles;
    r = tile_i / p.nt;
    m0 = r * BM;
    n0 = tile_i % p.nt * nb;
    kb = z * p.kt / p.splits;
    nk = (z + 1) * p.kt / p.splits - kb;
  }
};

// The list's shape, as every thread derives it from the plan's items (kept
// in shared memory: the consumers' registers go to the tiles).
struct Work {
  int total, start[MAX_STAGES + 1];
  template <class Args>
  __device__ __forceinline__ void init(const Args& A) {
    start[0] = 0;
    for (int s = 0; s < A.stages; ++s) start[s + 1] = start[s] + A.items[s];
    total = start[A.stages];
  }
  __device__ __forceinline__ void locate(int g, int& s, int& j) const {
    s = 0;
    while (g >= start[s + 1]) ++s;
    j = g - start[s];
  }
};

template <class Args>
__device__ __forceinline__ unsigned* counter(const Args& A, int s, int r) { return A.sync + A.counter_off[s] + 8 * r; }

// What stage s's counter of row tile r reaches once the stage is done
// there: the plan's target (TpPlan.per_row), read from its table.
template <class Args>
__device__ __forceinline__ unsigned per_row(const Args& A, int s, int r) { return __ldg(A.sync + A.target_off[s] + r); }

// The sums of chunk (r, c) from the staged f32 tile.
struct TileSums {
  const float* tile;
  __device__ __forceinline__ void operator()(int r, int c, float (&v)[8]) const {
    const float4 lo = *reinterpret_cast<const float4*>(tile + r * LDT + c);
    const float4 hi = *reinterpret_cast<const float4*>(tile + r * LDT + c + 4);
    v[0] = lo.x; v[1] = lo.y; v[2] = lo.z; v[3] = lo.w;
    v[4] = hi.x; v[5] = hi.y; v[6] = hi.z; v[7] = hi.w;
  }
};


// Eight of a sample's shift or scale values at column col, as the pre items
// read them: through L2 (row 7 wrote its mods in this launch), rounded to
// bf16 where the plain version rounds them; inputs of the launch through the
// read-only path, where a sample's row stays in L1 for its other tokens.
template <class Args>
__device__ __forceinline__ void load_row8(const Args& A, const void* rows, int ld, int64_t sample, int col,
                                          float (&v)[8]) {
  if (A.rows_kind == ROWS_IN_BF16) {
    modulate::load8(static_cast<const __nv_bfloat16*>(rows) + sample * ld + col, v);
    return;
  }
  if (A.rows_kind == ROWS_IN_F32) {
    modulate::load8(static_cast<const float*>(rows) + sample * ld + col, v);
    return;
  }
  if (A.rows_kind == ROWS_BF16) {
    const uint4 u = __ldcg(reinterpret_cast<const uint4*>(static_cast<const __nv_bfloat16*>(rows) + sample * ld + col));
    const __nv_bfloat16* b = reinterpret_cast<const __nv_bfloat16*>(&u);
#pragma unroll
    for (int e = 0; e < 8; ++e) v[e] = __bfloat162float(b[e]);
    return;
  }
  load8_cg(static_cast<const float*>(rows) + sample * ld + col, v);
  if (A.rows_kind == ROWS_F32_ROUNDED) {
#pragma unroll
    for (int e = 0; e < 8; ++e) v[e] = __bfloat162float(__float2bfloat16_rn(v[e]));
  }
}

// Pre item j: amod = bf16(modulate(x; shift, scale, gain)) on token rows
// pre_rows j .. pre_rows (j + 1) - 1, eight columns a thread and step, the
// loads of PRE_UNROLL steps in flight at once, the modulate's division
// without its slow path (modulate8_branchless: the same quotient); then the
// row tile's pre counter.
template <class Args>
__device__ __forceinline__ void pre_item(const Args& A, int s, int j, unsigned long long* body_ns) {
  const unsigned long long t0 = global_ns();
  const int tid = threadIdx.x, chunks = A.d / 8;
  const int r0 = j * A.pre_rows, total = min(A.pre_rows, A.m - r0) * chunks;
  const float g = __ldg(A.gain);
  const float den = modulate::denominator(g), rcp = modulate::reciprocal(den);
  for (int q0 = tid; q0 < total; q0 += PRE_UNROLL * CONSUMER_THREADS) {
    float v[PRE_UNROLL][8], shift[PRE_UNROLL][8], scale[PRE_UNROLL][8];
#pragma unroll
    for (int u = 0; u < PRE_UNROLL; ++u) {
      const int q = q0 + u * CONSUMER_THREADS;
      if (q < total) {
        const int64_t row = r0 + q / chunks;
        const int col = 8 * (q % chunks);
        modulate::load8(A.x + row * A.d + col, v[u]);
        load_row8(A, A.shift, A.shift_ld, row / A.t, col, shift[u]);
        load_row8(A, A.scale, A.scale_ld, row / A.t, col, scale[u]);
      }
    }
#pragma unroll
    for (int u = 0; u < PRE_UNROLL; ++u) {
      const int q = q0 + u * CONSUMER_THREADS;
      if (q < total) {
        const int64_t row = r0 + q / chunks;
        modulate::modulate8_branchless(v[u], shift[u], scale[u], g, den, rcp);
        modulate::store8(A.amod + row * A.d + 8 * (q % chunks), v[u]);
      }
    }
  }
  if (tid == 0) *body_ns += global_ns() - t0;
  // the product's TMA loads (other CTAs) read these rows
  asm volatile("fence.proxy.async;\n" ::: "memory");
  consumer_sync();
  if (tid == 0) {
    __threadfence();
    atomicAdd(counter(A, s, r0 / BM), 1u);
  }
}

// ---------------------------------------------------------------------------
// Pre items through the ring (row 9's and the attention half-block's): the
// TMA thread loads a pre item's rows of x into one ring stage, the
// consumers modulate them from there.

__device__ __forceinline__ uint4 lds128(uint32_t addr) {
  uint4 v;
  asm volatile("ld.shared.v4.u32 {%0, %1, %2, %3}, [%4];\n" : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w) : "r"(addr));
  return v;
}

// eight bf16 values from a ring stage holding 64-column boxes of `rows`
// rows (128-byte swizzle: 16-byte unit u of row r lies at u ^ (r % 8)),
// row r, columns c .. c + 7
__device__ __forceinline__ void stage_load8(uint32_t stage, int rows, int r, int c, float (&v)[8]) {
  const uint4 x = lds128(stage + (c / 64) * rows * 128 + r * 128 + ((((c % 64) / 8) ^ (r & 7)) << 4));
  v[0] = modulate::bf16_lo(x.x); v[1] = modulate::bf16_hi(x.x);
  v[2] = modulate::bf16_lo(x.y); v[3] = modulate::bf16_hi(x.y);
  v[4] = modulate::bf16_lo(x.z); v[5] = modulate::bf16_hi(x.z);
  v[6] = modulate::bf16_lo(x.w); v[7] = modulate::bf16_hi(x.w);
}

// The TMA thread's side of pre item j: the item's rows of x, ceil(D / 64)
// boxes of pre_rows rows by 64 columns (zeros past M and D), into one stage.
template <class Ring, class Args>
__device__ __forceinline__ void produce_pre(const Args& A, const Ring& ring, const CUtensorMap* tm_x, int j,
                                            uint32_t at) {
  const int s = at % Ring::N_STAGES, boxes = (A.d + 63) / 64;
  mbar_wait(ring.empty(s), ((at / Ring::N_STAGES) & 1) ^ 1);
  mbar_expect_tx(ring.full(s), boxes * A.pre_rows * 128);
  for (int b = 0; b < boxes; ++b)
    tma_load_2d(ring.stage(s) + b * A.pre_rows * 128, tm_x, ring.full(s), 64 * b, j * A.pre_rows);
}

// The consumers' side of pre item j: amod = bf16(modulate(x; shift, scale,
// gain)) on its rows, x read from the stage, eight columns a thread and
// step, two steps' loads in flight (three spilled them); then the stage is
// released and the row tile's pre counter raised.
template <class Ring, class Args>
__device__ __forceinline__ void consume_pre(const Args& A, const Ring& ring, int s_list, int j, uint32_t& it,
                                            unsigned long long* body_ns) {
  const int tid = threadIdx.x, lane = tid & 31, rows = A.pre_rows, chunks = A.d / 8;
  const int r0 = j * rows, st = it % Ring::N_STAGES;
  mbar_wait(ring.full(st), (it / Ring::N_STAGES) & 1);
  const unsigned long long t0 = global_ns();
  const int total = min(rows, A.m - r0) * chunks;
  const float g = __ldg(A.gain);
  const float den = modulate::denominator(g);
  const float rcp = modulate::reciprocal(den);
  constexpr int UNROLL = 2;
  for (int q0 = tid; q0 < total; q0 += UNROLL * CONSUMER_THREADS) {
    float v[UNROLL][8], shift[UNROLL][8], scale[UNROLL][8];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int q = q0 + u * CONSUMER_THREADS;
      if (q < total) {
        const int r = q / chunks, c = 8 * (q % chunks);
        stage_load8(ring.stage(st), rows, r, c, v[u]);
        // inputs of the launch: the read-only path, so a sample's row stays
        // in L1 for its other tokens' chunks
        const int64_t sample = (r0 + r) / A.t;
        if (A.rows_kind == ROWS_BF16 || A.rows_kind == ROWS_IN_BF16) {
          modulate::load8(static_cast<const __nv_bfloat16*>(A.shift) + sample * A.shift_ld + c, shift[u]);
          modulate::load8(static_cast<const __nv_bfloat16*>(A.scale) + sample * A.scale_ld + c, scale[u]);
        } else {
          modulate::load8(static_cast<const float*>(A.shift) + sample * A.shift_ld + c, shift[u]);
          modulate::load8(static_cast<const float*>(A.scale) + sample * A.scale_ld + c, scale[u]);
        }
      }
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int q = q0 + u * CONSUMER_THREADS;
      if (q < total) {
        modulate::modulate8_branchless(v[u], shift[u], scale[u], g, den, rcp);
        modulate::store8(A.amod + static_cast<int64_t>(r0 + q / chunks) * A.d + 8 * (q % chunks), v[u]);
      }
    }
  }
  if (tid == 0) *body_ns += global_ns() - t0;
  __syncwarp();
  if (lane == 0) mbar_arrive(ring.empty(st));
  ++it;
  // the product's TMA loads (other CTAs) read these rows
  asm volatile("fence.proxy.async;\n" ::: "memory");
  consumer_sync();
  if (tid == 0) {
    __threadfence();
    atomicAdd(counter(A, s_list, r0 / BM), 1u);
  }
}


// The f32 probabilities of a warp's 16 query rows, from the accumulator
// fragments, to the unit's (T, T) row-major block p: a thread holds rows g
// and g + 8, two adjacent keys a key tile, so a quad fills 32 contiguous
// bytes of a row (cosine_attention.cu's residual-mode store).
__device__ __forceinline__ void store_probs(float* p, const float (&sc)[attn_tiles::KEY_TILES][4], int t,
                                            int warp, int lane) {
  const int r = warp * 16 + (lane >> 2), c = 2 * (lane & 3);
  float* row = p + r * t;
#pragma unroll
  for (int jj = 0; jj < attn_tiles::KEY_TILES; ++jj) {
    const int col = 8 * jj + c;
    if (col < t) {
      if (r < t) *reinterpret_cast<float2*>(row + col) = make_float2(sc[jj][0], sc[jj][1]);
      if (r + 8 < t) *reinterpret_cast<float2*>(row + 8 * t + col) = make_float2(sc[jj][2], sc[jj][3]);
    }
  }
}

// The cosine attention of one (sample, head) unit on a group of four warps
// once its q, k and v tiles (and the q and k scales) are staged: a warp's 16
// query rows against the T keys, the output rows (bf16) to out + r * ld.
// NORM_FIRST: p = ex * (1 / sum ex) rounded to bf16 before P.V, and, where
// probs is given, p in f32 to the unit's (T, T) block probs first (the
// residual forward's saved softmax); else P.V on the unnormalised
// exponentials divided after.
template <int HD, bool NORM_FIRST>
__device__ __forceinline__ void attention_core(__nv_bfloat16* sq, const __nv_bfloat16* sk, const __nv_bfloat16* sv,
                                               const float* qsc, const float* ksc, __nv_bfloat16* out, int64_t ld,
                                               int t, int warp, int lane, float* probs = nullptr) {
  using namespace cosine_tiles;
  using D = Dims<HD>;
  if (warp * 16 >= t) return;
  float sc[KEY_TILES][4];
  exp_tile<HD>(sc, sq, sk, qsc, ksc, t, warp, lane);
  float sum0 = 0.f, sum1 = 0.f;
  add_row_sums(sum0, sum1, sc);
  float f0 = 1.f / quad_sum(sum0), f1 = 1.f / quad_sum(sum1);
  if (NORM_FIRST) {
#pragma unroll
    for (int jj = 0; jj < KEY_TILES; ++jj) {
      sc[jj][0] *= f0;
      sc[jj][1] *= f0;
      sc[jj][2] *= f1;
      sc[jj][3] *= f1;
    }
    f0 = f1 = 1.f;
    if (probs != nullptr) store_probs(probs, sc, t, warp, lane);
  }
  uint32_t pa[KEY_TILES / 2][4];
  pack_p(pa, sc);
  float o[D::NT][4];
#pragma unroll
  for (int j = 0; j < D::NT; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
  pv_tile<HD>(o, pa, sv, lane);
  store_rows<HD>(o, f0, f1, sq, out, ld, t, warp, lane);
}

// One (sample, head) unit of the cosine attention core on a group of four
// consumer warps (tid 0-127 of the group): wait for the qkv rows of the
// sample's row tiles, stage q, k and v, run attention_core, then count the
// unit done for them.
template <int HD, class Args>
__device__ __forceinline__ void attention_unit(const Args& A, int s, int unit, uint8_t* buf, int group) {
  using namespace cosine_tiles;
  using D = Dims<HD>;
  const int tid = threadIdx.x % attn_tiles::THREADS, warp = tid >> 5, lane = tid & 31;
  const int sample = unit / A.heads, head = unit % A.heads, t = A.t, d_l = A.d_l;
  const int r0 = sample * t / BM, r1 = (sample * t + t - 1) / BM;
  if (tid == 0) {
    for (int r = r0; r <= r1; ++r) spin_until(counter(A, s - 1, r), per_row(A, s - 1, r));
    __threadfence();
  }
  __nv_bfloat16* sq = reinterpret_cast<__nv_bfloat16*>(buf + group * AttnSmem<HD>::BYTES);
  __nv_bfloat16* sk = sq + TILE * D::LD;
  __nv_bfloat16* sv = sk + TILE * D::LD;
  float* qsc = reinterpret_cast<float*>(sv + TILE * D::LD);
  float* ksc = qsc + TILE;
  const int64_t ld = 3ll * d_l;
  asm volatile("bar.sync %0, %1;\n" ::"r"(1 + group), "n"(attn_tiles::THREADS) : "memory");
  const float* base = A.qkv + static_cast<int64_t>(sample) * t * ld + head * HD;
  Rows<HD> fq, fk, fv;
  fetch<HD, true>(fq, base, ld, t, tid);
  fetch<HD, true>(fk, base + d_l, ld, t, tid);
  fetch<HD, true>(fv, base + 2 * d_l, ld, t, tid);
  commit<HD>(fq, sq, qsc, tid);
  commit<HD>(fk, sk, ksc, tid);
  commit<HD>(fv, sv, nullptr, tid);
  asm volatile("bar.sync %0, %1;\n" ::"r"(1 + group), "n"(attn_tiles::THREADS) : "memory");
  attention_core<HD, false>(sq, sk, sv, qsc, ksc, A.attn + static_cast<int64_t>(sample) * t * d_l + head * HD,
                                 d_l, t, warp, lane);
  // the out product's TMA loads read these rows
  asm volatile("fence.proxy.async;\n" ::: "memory");
  asm volatile("bar.sync %0, %1;\n" ::"r"(1 + group), "n"(attn_tiles::THREADS) : "memory");
  if (tid == 0) {
    __threadfence();
    for (int r = r0; r <= r1; ++r) atomicAdd(counter(A, s, r), 1u);
  }
}

// The producer's side of one product item: the W tiles of its first k
// steps (they depend on no earlier item) go out before it waits for the
// rows of A it reads (`wait`), then the A tiles, then the rest as
// produce_tile issues them. W_KN: W stored (K, N), boxes of 128-byte rows
// side by side (gemm_pipeline.cuh load_w_step); KSTEP: k a step (BK, or
// BK_F32 for f32 operands).
template <bool W_KN, int KSTEP = BK, class Wait>
__device__ __forceinline__ void produce_item(const Ring<STAGES>& ring, const CUtensorMap* tm_a,
                                             const CUtensorMap* tm_w, const Tile& tl, uint32_t& it,
                                             const Wait& wait) {
  const int early = min(tl.nk, STAGES);
  for (int i = 0; i < early; ++i) {
    const uint32_t at = it + i;
    const int s = at % STAGES;
    mbar_wait(ring.empty(s), ((at / STAGES) & 1) ^ 1);
    mbar_expect_tx(ring.full(s), STAGE_BYTES);
    load_w_step<W_KN, KSTEP>(tm_w, ring.stage(s) + A_BYTES, ring.full(s), tl.n0, (tl.kb + i) * KSTEP);
  }
  wait();
  for (int i = 0; i < early; ++i) {
    const int s = (it + i) % STAGES;
    tma_load_2d(ring.stage(s), tm_a, ring.full(s), (tl.kb + i) * KSTEP, tl.m0);
  }
  it += early;
  produce_tile<STAGES, W_KN, KSTEP>(ring, tm_a, tm_w, tl.m0, tl.n0, tl.kb + early, tl.nk - early, it);
}

// The consumers hand each finished product item to the signalling thread
// through two mbarriers (`done`: the eight consumer warps have issued the
// item's stores; `ack`: the thread has counted it); `attn_done` counts the
// attention items the consumers are through (their buffers lie in the ring).
struct Handoff {
  uint32_t done, ack;
  volatile unsigned* attn_done;
};

// Every CTA is through with the sync words once it gets here: the last to
// leave zeroes them for the plan's next launch.
template <class Args>
__device__ __forceinline__ void leave_launch(const Args& A) {
  __shared__ int last_out;
  if (threadIdx.x == 0) {
    __threadfence();
    last_out = atomicAdd(A.sync + SYNC_EXIT, 1u) == gridDim.x - 1;
    if (last_out) __threadfence();
  }
  __syncthreads();
  if (last_out) {
    for (int i = threadIdx.x; i < A.sync_words; i += KERNEL_THREADS) A.sync[i] = 0;
  }
}

// ---------------------------------------------------------------------------
// the host side

// Tensor maps by pointer and shape, encoded once (a weight set, a scratch
// buffer the allocator hands back).
struct MapEntry {
  const void* ptr;
  int rows, cols, box_rows, f32;
  CUtensorMap map;
};
constexpr int MAP_CACHE = 64;
inline MapEntry map_cache[MAP_CACHE];
inline int map_next = 0;
inline std::mutex map_lock;

// A bf16 matrix in boxes of box_rows x BK, or (f32) an f32 one in boxes of
// box_rows x BK_F32 (128-byte rows either way).
inline bool cached_map(CUtensorMap* out, const void* ptr, int rows, int cols, int box_rows, bool f32 = false) {
  std::lock_guard<std::mutex> guard(map_lock);
  for (const MapEntry& e : map_cache) {
    if (e.ptr == ptr && e.rows == rows && e.cols == cols && e.box_rows == box_rows && e.f32 == f32) {
      *out = e.map;
      return true;
    }
  }
  MapEntry& e = map_cache[map_next];
  if (!(f32 ? encode_f32_swizzled(&e.map, ptr, rows, cols, box_rows, BK_F32)
            : encode(&e.map, ptr, rows, cols, box_rows, BK))) {
    e.ptr = nullptr;
    return false;
  }
  e.ptr = ptr;
  e.rows = rows;
  e.cols = cols;
  e.box_rows = box_rows;
  e.f32 = f32;
  map_next = (map_next + 1) % MAP_CACHE;
  *out = e.map;
  return true;
}

// A product stage's description; false where the plan's splits or ticket
// words do not fit it. (tp_plan splits only as far as one wave takes; the
// kernel does not need it, since no split waits on another.)
inline bool make_prod(Prod& p, int m, int n, int k, int splits, int ticket_off, int sync_words, int a_map,
                      int w_map, int epi, float alpha, void* c, void* partial, int nb = BN, int w_kn = 0,
                      int kstep = BK) {
  p.m = m;
  p.n = n;
  p.nt = (n + nb - 1) / nb;
  p.kt = (k + kstep - 1) / kstep;
  p.splits = splits;
  p.a_map = a_map;
  p.w_map = w_map;
  p.epi = epi;
  p.w_kn = w_kn;
  p.alpha = alpha;
  p.c = c;
  p.partial = static_cast<float*>(partial);
  p.ticket_off = ticket_off;
  const int tiles = (m + BM - 1) / BM * p.nt;
  if (splits < 1 || splits > MAX_SPLITS || splits > p.kt) return false;
  return splits == 1 || (partial != nullptr && ticket_off >= SYNC_DONE && ticket_off + tiles <= sync_words);
}

// The stages of the plan's words into args, checked against what the
// kernel runs: the kinds in order, each stage's items (the token rows in
// pre items, the units two an item, a product's tiles times its splits),
// counters and targets inside the buffer. prods: for each S_GEMM stage in
// order, its (n, k, a map, w map, epilogue, alpha, C, partials, W read as
// (K, N), k a step).
struct ProdShape {
  int n, k, a_map, w_map, epi;
  float alpha;
  void* c;
  void* partial;
  int w_kn = 0;
  int kstep = BK;
};

template <class Args>
bool read_plan(const int* plan, Args& args, int ctas, std::initializer_list<int> kinds,
               std::initializer_list<ProdShape> prods, int nb = BN, int pre_rows = PRE_ROWS) {
  args.pre_rows = pre_rows;
  if (plan == nullptr || plan[P_STAGES] != static_cast<int>(kinds.size()) || plan[P_CTAS] != ctas ||
      plan[P_SYNC_WORDS] <= SYNC_DONE || plan[P_BUFFER_WORDS] < plan[P_SYNC_WORDS])
    return false;
  const int mt = (args.m + BM - 1) / BM, sync_words = plan[P_SYNC_WORDS];
  args.stages = plan[P_STAGES];
  args.sync_words = sync_words;
  const ProdShape* prod = prods.begin();
  int s = 0;
  for (int kind : kinds) {
    const int* w = plan + P_STAGE + PS_WORDS * s;
    args.kind[s] = w[PS_KIND];
    args.items[s] = w[PS_ITEMS];
    args.counter_off[s] = w[PS_COUNTER];
    args.target_off[s] = w[PS_TARGET];
    if (w[PS_KIND] != kind || w[PS_COUNTER] < SYNC_DONE || w[PS_COUNTER] + 8 * (mt - 1) >= sync_words ||
        w[PS_TARGET] < sync_words || w[PS_TARGET] + mt > plan[P_BUFFER_WORDS])
      return false;
    int items = 0;
    if (kind == S_PRE) {
      items = (args.m + pre_rows - 1) / pre_rows;
    } else if (kind == S_ATTN || kind == S_ATTN_BWD) {
      items = (args.samples * args.heads + 1) / 2;
    } else {
      Prod& p = args.prod[s];
      if (!make_prod(p, args.m, prod->n, prod->k, w[PS_SPLITS], w[PS_TICKET], sync_words, prod->a_map, prod->w_map,
                     prod->epi, prod->alpha, prod->c, prod->partial, nb, prod->w_kn, prod->kstep))
        return false;
      items = mt * p.nt * p.splits;
      ++prod;
    }
    if (w[PS_ITEMS] != items) return false;
    ++s;
  }
  return true;
}

inline bool aligned16(std::initializer_list<const void*> ptrs) {
  uintptr_t bits = 0;
  for (const void* p : ptrs) bits |= reinterpret_cast<uintptr_t>(p);
  return bits % 16 == 0;
}

}  // namespace work_list
