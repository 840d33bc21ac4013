// dit_stack: every block of the DiT stack in one persistent launch.
//
// Replaces the Pallas whole-stack and whole-block kernels
// (mapdit_tpu/ops/pallas/dit_block.py:1912 _stack_fwd_impl over
// _stack_kernel, l.1857, pallas_call l.1980; and :443 _fwd_impl, pallas_call
// l.476, which is this kernel at depth 1), both running _block_body (l.279)
// with the cosine attention core _attention_core (l.129). The TPU kernel
// keeps a group of samples' stream in VMEM across all blocks on a grid of
// (depth, n // g); here the stream lives in L2-sized scratch, and the whole
// card works through one list of tiles:
//
//   mods (N, depth*6D) f32 = a . w_mod^T / sqrt(D), every block's at once
//   pre  amod = bf16(modulate(x; shift_msa, scale_msa, gain_msa of block 0))
//   then, per block b and 128-row tile of the N*T token rows:
//   qkv  qkv (N*T, 3D) f32   = amod . w_qkv[b]^T / sqrt(D)
//   attn attn (N*T, D) bf16  = cosine_attention(qkv), per (sample, head)
//   out  x1 (N*T, D) f32     = mp_sum(x, gate_msa * attn . w_out[b]^T / sqrt(D), 0.3)
//        amod                = bf16(modulate(x1; shift_mlp, scale_mlp, gain_mlp))
//   fc1  h (N*T, H) bf16     = mp_silu(amod . w1[b]^T / sqrt(D))
//   fc2  x (N*T, D) bf16     = mp_sum(x1, gate_mlp * h . w2[b]^T / sqrt(H), 0.3)
//        amod                = bf16(modulate(x; the msa rows of block b + 1))
//
// with the rounding points of the launch sequence it replaces
// (ops/cuda/dit_block.py _block_sequence): mods, qkv and x1 in f32, attn,
// h, the modulated products' A and the stream in bf16. The modulate that
// mp_gemm ran as a prologue pass over its A is folded into the epilogue
// that writes that A (modulate.cuh's arithmetic on the same f32 values, so
// the same bits), which removes a pass per product.
//
// Bound on the H100 (max of bytes / 3.35 TB/s and FLOPs / 989 TFLOP/s, as
// chip_smoke.py counts them: inputs read once, output written once):
// DiT-S/2 sampling (64 rows x 64 tokens, depth 12) 0.1821 ms, B/2 (64 x 64,
// depth 12) 0.7188 ms, XL/2 (8 x 64, depth 28) 0.4696 ms, all by operations
// (XL/2's weights, 1.34 GB, alone take 0.40 ms); at 32 x 32 latents S/2 (64
// x 256, depth 12) 0.7831 ms by operations (773 GFLOP).
//
// Design (sm_90a):
//   * One cooperative launch of one CTA an SM (cudaLaunchKernelEx with the
//     cooperative attribute: every CTA is resident, so a CTA may wait on
//     another). Three warpgroups: two consumers and a producer warpgroup
//     that gives up most of its registers (setmaxnreg 40 / 232) and runs a
//     TMA thread and a signalling thread.
//   * The products run gemm_pipeline.cuh, mp_gemm's TMA + wgmma tile
//     pipeline (128 x 128 tiles, k depth 64), as a persistent loop: the
//     ring's k-step count and mbarrier phases carry from tile to tile.
//     Four 32 KB stages and an f32 epilogue tile of its own, so the
//     producer loads the next tile while the consumers run the epilogue;
//     195 KB of shared memory.
//   * After the modulation rows and the pre stage (a grid barrier each),
//     the blocks are one list of items (qkv, attention, out, fc1, fc2 of
//     block 0, then block 1, ...; within a product's split, row tile
//     major), CTA c
//     taking items c, c + ctas, ... Rows never meet across samples, so a
//     product item waits only on its own row tile's earlier stage, and an
//     attention unit only on its sample's row tiles: one counter a row
//     tile and stage, which the signalling thread raises (a release
//     add, after the consumers hand the item over through shared-memory
//     mbarriers) and the TMA thread or an attention group awaits (acquire
//     loads) before it reads. fence.proxy.async orders the ordinary stores
//     before the TMA loads that read them. Stages overlap: one row tile's
//     fc2 runs while the next's qkv does, and no SM idles at a stage's tail.
//   * Products with fewer tiles than CTAs (XL/2's qkv, out and fc2 at 8
//     rows) split K (ops/cuda/dit_block.py stack_plan: only as many splits
//     as run at once): each split writes f32 partials and takes a ticket;
//     once all have, split z sums rows z/splits .. (z+1)/splits of the tile
//     in split order and runs their epilogue. The bits repeat, and the plan
//     depends on a block's shapes, never on depth, so the stack equals a
//     chain of depth-1 calls bit for bit.
//   * The attention runs attention_tiles.cuh's mma.sync tiles with
//     cosine_tiles.cuh's row staging on two groups of four consumer warps,
//     one (sample, head, tile of 64 queries) unit each, in the ring's memory
//     (the TMA thread loads nothing meanwhile); at T > 64 the keys stream
//     through the group's buffers in tiles of 64 (cosine_attention.cu's
//     normal mode), so T is not bounded by shared memory. A unit waits for
//     the qkv rows of its whole sample and, since it read them all, counts
//     itself done for every row tile of its sample (at T = 256 a sample
//     spans two): the out product of row tile r waits for every unit of
//     every sample with a row in r, so the next block's qkv items, which
//     wait on r's fc2, never overwrite rows a unit still streams. Rows
//     this launch wrote are read through L2
//     (ld.global.cg), never the read-only path.
//   * T <= 64 and T > 64 are kernel instances of their own (LONG): the key
//     tile loop's registers pushed the one-tile instance into spills when
//     both shared one (XL/2 at T = 64 took 2.88 ms against 2.67).
//   * The work list's shape and the trace sums live in shared memory, not
//     in registers: with them in registers the attention and the epilogues
//     spilled, and S/2 took 1.2724-1.2945 ms where it takes 1.1425 now.
//   * The host: one launch and a memset of the sync words; the tensor maps
//     are encoded once per pointer and shape and kept in a small cache.
// Forms built and measured in one call each beside the launch sequence
// (graph-timed device ms at S/2 / B/2 / XL/2, the sequence's in brackets;
// NVIDIA H100 80GB HBM3, 700.00 W; not kept, so these numbers cannot be
// re-run from the repo):
//   * a grid barrier between stages (61 a call at S/2), 1 CTA an SM, an own
//     epilogue tile, split sums by the last split: 1.2809 / 3.0801 / 3.4836
//     [1.2270 / 2.5375 / 2.9408]; the barriers took 0.06 ms, the stages'
//     tails (96 tiles on 132 SMs at S/2 out and fc2) and the serial split
//     sums the rest;
//   * the same at 2 CTAs an SM (3 stages, the epilogue tile in the ring):
//     1.9670 / 3.2238 / 4.9199 - 96 registers a thread, and it spilled;
//   * with each split summing its share of the tile's rows and the
//     producer warpgroup's registers handed over (both kept): 1.2735 /
//     3.0594 / 2.9976 [1.2149 / 2.5449 / 2.9379];
//   * epilogue loads of 2 or 4 chunks in flight a thread: 1.3425 and
//     1.9035 against 1.3013 for one (spills);
//   * six ring stages with the epilogue through a half tile (64 rows at a
//     time): 1.3371 against 1.2669 for four in the same call; four with the
//     half tile 1.1384-1.1462 against 1.1129-1.1297 with the whole tile;
//   * two warps of the producer warpgroup finishing the qkv and fc1
//     epilogues: 1.8353 / 3.841 / 3.7022 - 64 threads drain a tile slower
//     than the consumers load the next;
//   * 256 x 128 tiles (two m64 halves a consumer warpgroup, three 48 KB
//     stages, the epilogue tile passed twice): 1.7068 / 3.5177 / 4.1909
//     against 1.1268 / 2.8009 / 2.6341 for 128 x 128 in the same call; the
//     second accumulator pushed the consumers past 168 registers and they
//     spilled (360 bytes of stores), the attention with them;
//   * the dataflow form without its row waits (wrong results; a bound on
//     what the waits cost): 1.2406 / 3.1440 / 2.3861 against 1.2510 /
//     3.0778 / 3.0232 with them (the register-held form).
// What bounds it now: the tile pipeline itself, mp_gemm's: a 128 x 128 x 64
// k step takes ~1.6 us of an SM against 0.28 us of tensor-core time (the
// time scales with 1/SMs, so it is each SM's pipeline, not L2 as a whole).
// Wider tiles need registers a 384-thread CTA's 168 a thread do not leave
// (the 256-row form above); TMA multicast of W across a cluster is untried.
// At T = 256 (S/2, 64 rows) the launch takes 5.04-5.05 ms against its launch
// sequence's 4.15-4.24 (NVIDIA H100 80GB HBM3, 700.00 W): a CTA spends
// ~1.44 ms on attention units, two at a time, each streaming K and V four
// times (the standalone kernel keeps several blocks an SM), and ~3.4 ms on
// the products. The next key tile's loads put in flight during this one's
// products (a form built and measured in one call, not kept) pushed the
// consumers into spills (420 / 760 bytes at hd 72 against 188 / 456) and
// took S/2 at T = 256 to 5.52-5.55 ms.
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

namespace {

using namespace gemm_pipeline;

constexpr int STAGES = 4;
// registers a thread after setmaxnreg: the producer warpgroup's, the
// consumers' (the 64 K of the SM between them)
constexpr int PRODUCER_REGS = 40, CONSUMER_REGS = 232;
constexpr int STACK_THREADS = CONSUMER_THREADS + 128;  // two consumer warpgroups, a producer warpgroup
// the sync words: [0] the grid barrier; from SYNC_DONE, one counter a row
// tile for each of the five stages of a block (eight words apart), counting
// the stage's finished items of that row tile over all blocks; then the
// tile tickets of every split product of every block
constexpr int SYNC_DONE = 32;
enum { K_QKV = 0, K_ATTN = 1, K_OUT = 2, K_FC1 = 3, K_FC2 = 4 };

// one group of four warps' attention buffers, in the ring (the producer
// loads nothing while the consumers run an attention item)
template <int HD>
struct AttnSmem {
  static constexpr int LD = attn_tiles::Dims<HD>::LD;
  static constexpr int BYTES = 3 * attn_tiles::TILE * LD * 2 + 2 * attn_tiles::TILE * 4;
};
static_assert(2 * AttnSmem<72>::BYTES <= STAGES * STAGE_BYTES, "attention buffers must fit in the ring");
// the ring (and its barriers), the hand-off mbarriers and the attention
// count, the f32 epilogue tile, and 1 KB of slack to align the ring to the
// 1024 bytes the swizzle needs
constexpr int SMEM_BYTES = 1024 + Ring<STAGES>::BYTES + 32 + TILE_BYTES;
// the trace: ns of each CTA in the modulation and pre stages, qkv, attention,
// out, fc1, fc2, then its start and end
constexpr int TRACE_WORDS = 8;

struct Maps {
  CUtensorMap a, amod, attn, h, w_mod, w_qkv, w_out, w1, w2;
};

struct Args {
  int n, t, d, hidden, heads, depth;
  int splits_qkv, splits_out, splits_fc1, splits_fc2;
  float alpha_d, alpha_h;
  const __nv_bfloat16* x;  // the input stream (N*T, D), never written
  __nv_bfloat16* out;      // the stream from block 1 on, and the output
  const float* gains;      // (depth, 2)
  float* mods;             // (N, depth*6D)
  float* qkv;
  float* x1;
  float* partial;
  __nv_bfloat16* attn;
  __nv_bfloat16* h;
  __nv_bfloat16* amod;
  unsigned* sync;             // the sync words (above), zero at launch
  unsigned long long* trace;  // null, or TRACE_WORDS a CTA: ns by kind of work, then its start and end
};

__device__ __forceinline__ int cdiv_d(int a, int b) { return (a + b - 1) / b; }

// eight values written earlier in this launch, read through L2
__device__ __forceinline__ void load8_cg(const float* p, float (&v)[8]) {
  const float4 lo = __ldcg(reinterpret_cast<const float4*>(p));
  const float4 hi = __ldcg(reinterpret_cast<const float4*>(p) + 1);
  v[0] = lo.x; v[1] = lo.y; v[2] = lo.z; v[3] = lo.w;
  v[4] = hi.x; v[5] = hi.y; v[6] = hi.z; v[7] = hi.w;
}

__device__ __forceinline__ void load8_cg(const __nv_bfloat16* p, float (&v)[8]) {
  const uint4 u = __ldcg(reinterpret_cast<const uint4*>(p));
  v[0] = bf16_lo(u.x); v[1] = bf16_hi(u.x); v[2] = bf16_lo(u.y); v[3] = bf16_hi(u.y);
  v[4] = bf16_lo(u.z); v[5] = bf16_hi(u.z); v[6] = bf16_lo(u.w); v[7] = bf16_hi(u.w);
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

// spins until *p >= target; a wait of ~10 s traps (as mbar_wait does)
__device__ __forceinline__ void spin_until(const unsigned* p, unsigned target) {
  const long long start = clock64();
  while (ld_acquire(p) < target) {
    if (clock64() - start > (1ll << 34)) __trap();
  }
}

// Every CTA waits until all have arrived (the modulation rows and the pre
// stage end so). Ordinary stores before it are visible to ordinary loads
// and to TMA loads after it, in every CTA.
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

// The epilogues. Each takes the eight f32 sums v of C[row, col..col+7]
// (alpha not applied): load(row, col, in) reads what it needs, apply(row,
// col, v, in) computes and stores.
struct NoLoads {};

// mods, qkv: C * alpha in f32
struct ScaleEpi {
  float* c;
  int64_t ld;
  float alpha;
  using In = NoLoads;
  __device__ __forceinline__ void load(int, int, In&) const {}
  __device__ __forceinline__ void apply(int row, int col, float (&v)[8], const In&) const {
    scale8(v, alpha);
    modulate::store8(c + row * ld + col, v);
  }
};

struct RowsIn {
  float x[8], gate[8], shift[8], scale[8];
};

// out: x1 = mp_sum(x, gate_msa * C * alpha) in f32, and fc1's A,
// amod = modulate(x1; shift_mlp, scale_mlp, gain_mlp) in bf16
struct OutEpi {
  const __nv_bfloat16* stream;
  const float* mods_b;  // block b's six rows of sample 0
  int64_t mods_ld;
  int t, d;
  float alpha, g;
  float* x1;
  __nv_bfloat16* amod;
  using In = RowsIn;
  __device__ __forceinline__ void load(int row, int col, In& in) const {
    const float* mrow = mods_b + (row / t) * mods_ld;
    load8_cg(stream + static_cast<int64_t>(row) * d + col, in.x);
    load8_cg(mrow + 2 * d + col, in.gate);
    load8_cg(mrow + 3 * d + col, in.shift);
    load8_cg(mrow + 4 * d + col, in.scale);
  }
  __device__ __forceinline__ void apply(int row, int col, float (&v)[8], const In& in) const {
    const int64_t idx = static_cast<int64_t>(row) * d + col;
    residual8(v, in.x, in.gate, alpha);
    modulate::store8(x1 + idx, v);
    modulate::modulate8(v, in.shift, in.scale, g, modulate::denominator(g));
    modulate::store8(amod + idx, v);
  }
};

// fc1: h = mp_silu(C * alpha) in bf16
struct SiluEpi {
  __nv_bfloat16* h;
  int hidden;
  float alpha;
  using In = NoLoads;
  __device__ __forceinline__ void load(int, int, In&) const {}
  __device__ __forceinline__ void apply(int row, int col, float (&v)[8], const In&) const {
    silu8(v, alpha);
    modulate::store8(h + static_cast<int64_t>(row) * hidden + col, v);
  }
};

// fc2: the stream x = mp_sum(x1, gate_mlp * C * alpha) in bf16, and, before
// another block, its qkv's A, amod = modulate(x; that block's msa rows)
struct Fc2Epi {
  const float* x1;
  const float* mods_b;
  int64_t mods_ld;
  int t, d;
  float alpha, g_next;
  bool next;
  __nv_bfloat16* out;
  __nv_bfloat16* amod;
  using In = RowsIn;
  __device__ __forceinline__ void load(int row, int col, In& in) const {
    const float* mrow = mods_b + (row / t) * mods_ld;
    load8_cg(x1 + static_cast<int64_t>(row) * d + col, in.x);
    load8_cg(mrow + 5 * d + col, in.gate);
    if (next) {
      load8_cg(mrow + 6 * d + col, in.shift);
      load8_cg(mrow + 7 * d + col, in.scale);
    }
  }
  __device__ __forceinline__ void apply(int row, int col, float (&v)[8], const In& in) const {
    const int64_t idx = static_cast<int64_t>(row) * d + col;
    residual8(v, in.x, in.gate, alpha);
    modulate::store8(out + idx, v);
    if (next) {
      // the next block's qkv reads the stream as stored, in bf16
#pragma unroll
      for (int e = 0; e < 8; ++e) v[e] = __bfloat162float(__float2bfloat16_rn(v[e]));
      modulate::modulate8(v, in.shift, in.scale, g_next, modulate::denominator(g_next));
      modulate::store8(amod + idx, v);
    }
  }
};

// Chunks q_begin .. q_end of a 128 x 128 tile (chunk q: row q / 16, eight
// columns from 8 (q % 16)) on the consumer threads: the sums (sums(r, c,
// v): from the staged tile or the split partials) and the epilogue's loads
// of a chunk, then its stores.
template <class Epi, class Sums>
__device__ __forceinline__ void finish_chunks(const Epi& epi, const Sums& sums, int m, int n, int m0, int n0,
                                              int q_begin, int q_end, int tid) {
  for (int q = q_begin + tid; q < q_end; q += CONSUMER_THREADS) {
    const int r = q / (BN / 8), c = 8 * (q % (BN / 8));
    if (m0 + r < m && n0 + c < n) {
      typename Epi::In in;
      float v[8];
      epi.load(m0 + r, n0 + c, in);
      sums(r, c, v);
      epi.apply(m0 + r, n0 + c, v, in);
    }
  }
}

// The shape of one call's work, as every thread derives it from the
// arguments. After the modulation rows and the pre stage (each ended by a
// grid barrier), the blocks' work is one list of items, block by block and
// within a block stage by stage: the qkv, out, fc1 and fc2 products' tiles
// (K split major, then row tile, then column tile) and the attention's
// pairs of (sample, head, query tile) units. CTA c takes items c, c + ctas, ... in
// order. An item waits only on items earlier in the list, of its own row
// tile (the counters of the sync words), and every CTA is resident, so the
// earliest unfinished item can always run.
struct Work {
  int m, mt, depth, heads, t, n;
  int qt, units;  // query tiles of 64 a sample; attention units (sample, head, query tile) a block
  int nt[4], splits[4], kt[4], items[5];  // per stage: qkv, attention, out, fc1, fc2 (nt, kt, splits: products)
  int block_items;
  int64_t partial_off[4];  // floats: each split product's own partials
  int ticket_off[4], tickets_per_block;

  Work() = default;
  __device__ __forceinline__ explicit Work(const Args& A) {
    m = A.n * A.t;
    mt = cdiv_d(m, BM);
    depth = A.depth;
    heads = A.heads;
    t = A.t;
    n = A.n;
    qt = cdiv_d(A.t, attn_tiles::TILE);
    units = A.n * A.heads * qt;
    const int cols[4] = {3 * A.d, A.d, A.hidden, A.d}, ks[4] = {A.d, A.d, A.d, A.hidden};
    const int sp[4] = {A.splits_qkv, A.splits_out, A.splits_fc1, A.splits_fc2};
    int64_t off = 0;
    int tk = 0;
    for (int i = 0; i < 4; ++i) {
      nt[i] = cdiv_d(cols[i], BN);
      kt[i] = cdiv_d(ks[i], BK);
      splits[i] = sp[i];
      partial_off[i] = off;
      ticket_off[i] = tk;
      if (sp[i] > 1) {
        off += static_cast<int64_t>(sp[i]) * m * cols[i];
        tk += mt * nt[i];
      }
    }
    tickets_per_block = tk;
    items[0] = mt * nt[0] * splits[0];
    items[1] = (units + 1) / 2;
    items[2] = mt * nt[1] * splits[1];
    items[3] = mt * nt[2] * splits[2];
    items[4] = mt * nt[3] * splits[3];
    block_items = items[0] + items[1] + items[2] + items[3] + items[4];
  }
  // stage kind (K_*) and index within the stage of item i of a block
  __device__ __forceinline__ void locate(int i, int& kind, int& j) const {
    kind = 0;
    while (i >= items[kind]) i -= items[kind++];
    j = i;
  }
  // the product (0-3: qkv, out, fc1, fc2) of stage kind
  __device__ __forceinline__ static int product(int kind) { return kind == K_QKV ? 0 : kind - 1; }
  // the attention units that read row tile r: each (sample, head, query
  // tile) unit reads the keys of its whole sample, so every unit of every
  // sample with a row in r
  __device__ __forceinline__ int units_of(int r) const {
    const int first = r * BM / t, last = min(n, (r * BM + BM + t - 1) / t) - 1;
    return (last - first + 1) * heads * qt;
  }
  // items of a product stage a row tile has, per block
  __device__ __forceinline__ int per_row(int p) const { return nt[p] * splits[p]; }
};

// The modulation rows' tiles: (n, depth*6d), unsplit.
struct Items {
  int nt, kt, tiles;
  __device__ __forceinline__ Items(int m, int n, int k)
      : nt(cdiv_d(n, BN)), kt(cdiv_d(k, BK)), tiles(cdiv_d(m, BM) * cdiv_d(n, BN)) {}
  __device__ __forceinline__ int m0(int item) const { return item / nt * BM; }
  __device__ __forceinline__ int n0(int item) const { return item % nt * BN; }
};

__device__ __forceinline__ unsigned* done(const Args& A, const Work& W, int kind, int r) {
  return A.sync + SYNC_DONE + 8 * (kind * W.mt + r);
}

// What item (kind, j) of block b must wait for: the counter and the count
// it must reach (none for block 0's qkv, which the pre stage's grid
// barrier orders).
__device__ __forceinline__ void dependency(const Args& A, const Work& W, int b, int kind, int r, unsigned*& ctr,
                                           unsigned& target) {
  ctr = nullptr;
  target = 0;
  switch (kind) {
    case K_QKV:
      if (b > 0) ctr = done(A, W, K_FC2, r), target = b * W.per_row(3);
      break;
    case K_OUT:
      ctr = done(A, W, K_ATTN, r), target = (b + 1) * W.units_of(r);
      break;
    case K_FC1:
      ctr = done(A, W, K_OUT, r), target = (b + 1) * W.per_row(1);
      break;
    case K_FC2:
      ctr = done(A, W, K_FC1, r), target = (b + 1) * W.per_row(2);
      break;
  }
}

// product item j of product p: row tile, column offset, split, k steps
struct Tile {
  int r, m0, n0, z, kb, nk, tile_i;
  __device__ __forceinline__ Tile(const Work& W, int p, int j) {
    const int tiles = W.mt * W.nt[p];
    tile_i = j % tiles;
    z = j / tiles;
    r = tile_i / W.nt[p];
    m0 = r * BM;
    n0 = tile_i % W.nt[p] * BN;
    kb = z * W.kt[p] / W.splits[p];
    nk = (z + 1) * W.kt[p] / W.splits[p] - kb;
  }
};

// the sums of chunk (r, c) from the staged f32 tile
struct TileSums {
  const float* tile;
  __device__ __forceinline__ void operator()(int r, int c, float (&v)[8]) const {
    const float4 lo = *reinterpret_cast<const float4*>(tile + r * LDT + c);
    const float4 hi = *reinterpret_cast<const float4*>(tile + r * LDT + c + 4);
    v[0] = lo.x; v[1] = lo.y; v[2] = lo.z; v[3] = lo.w;
    v[4] = hi.x; v[5] = hi.y; v[6] = hi.z; v[7] = hi.w;
  }
};

// The consumers' side of one product tile (the producer has loaded its k
// steps), then the epilogue `epi`. Unsplit, the tile's sums go through the
// epilogue tile. Split (the plan splits only where tiles x splits fit the
// grid, so every split of a tile runs at once, on its own CTA), each split
// writes its f32 partials and takes a ticket of its tile; once the tile's
// tickets are all taken, split z sums the partials of rows z/splits ..
// (z+1)/splits of the tile in split order and runs their epilogue: the
// same bits on every run. `tickets` and `partial` are the product's own.
template <class Epi>
__device__ __forceinline__ void consume_item(const Ring<STAGES>& ring, float* tile, int m, int n, const Tile& tl,
                                             int splits, float* partial, unsigned* tickets, uint32_t& it,
                                             const Epi& epi) {
  const int tid = threadIdx.x, lane = tid & 31, wg = tid >> 7;
  const int m0 = tl.m0, n0 = tl.n0;
  const bool active = m0 + 64 * wg < m;
  float acc[64];
  consume_tile<STAGES, false>(ring, acc, wg, lane, active, tl.nk, it);
  if (splits == 1) {
    stage_tile(tile, acc, active, tid);
    finish_chunks(epi, TileSums{tile}, m, n, m0, n0, 0, BM * BN / 8, tid);
    return;
  }
  store_partial(partial, acc, tl.z, m, n, m0, n0, tid);
  __threadfence();
  asm volatile("bar.sync %0, %1;\n" ::"n"(CONSUMER_BAR), "n"(CONSUMER_THREADS) : "memory");
  if (tid == 0) {
    atomicAdd(tickets + tl.tile_i, 1u);
    spin_until(tickets + tl.tile_i, splits);
    __threadfence();
  }
  asm volatile("bar.sync %0, %1;\n" ::"n"(CONSUMER_BAR), "n"(CONSUMER_THREADS) : "memory");
  const int64_t mn = static_cast<int64_t>(m) * n;
  finish_chunks(epi, [&](int r, int c, float (&v)[8]) {
    const float* p = partial + static_cast<int64_t>(m0 + r) * n + n0 + c;
    load8_cg(p, v);
    for (int s = 1; s < splits; ++s) {
      float u[8];
      load8_cg(p + s * mn, u);
#pragma unroll
      for (int e = 0; e < 8; ++e) v[e] += u[e];
    }
  }, m, n, m0, n0, (BM * BN / 8) * tl.z / splits, (BM * BN / 8) * (tl.z + 1) / splits, tid);
}

// amod = bf16(modulate(x; block 0's msa rows)), eight columns a thread
__device__ __forceinline__ void pre_stage(const Args& A) {
  const int chunks = A.d / 8;
  const int64_t total = static_cast<int64_t>(A.n) * A.t * chunks, mods_ld = 6ll * A.d * A.depth;
  const float g = __ldg(A.gains);
  for (int64_t q = blockIdx.x * static_cast<int64_t>(CONSUMER_THREADS) + threadIdx.x; q < total;
       q += static_cast<int64_t>(gridDim.x) * CONSUMER_THREADS) {
    const int64_t row = q / chunks;
    const int col = 8 * static_cast<int>(q % chunks);
    const float* mrow = A.mods + (row / A.t) * mods_ld;
    float v[8], shift[8], scale[8];
    modulate::load8(A.x + row * A.d + col, v);
    load8_cg(mrow + col, shift);
    load8_cg(mrow + A.d + col, scale);
    modulate::modulate8(v, shift, scale, g, modulate::denominator(g));
    modulate::store8(A.amod + row * A.d + col, v);
  }
}

// One (sample, head, query tile) unit of the cosine attention core over the
// qkv product of block b, on a group of four consumer warps (group's threads
// tid 0-127): wait for the qkv tiles of the sample's row tiles (its keys
// span the sample), then, as cosine_attention's normal mode,
//   * T <= 64 (one tile of queries and keys): the q, k and v loads in
//     flight at once, one pass;
//   * T > 64: the query tile's rows loaded once, K and V streamed through
//     the group's buffers in tiles of 64, O and sum ex added over the key
//     tiles (max-free: cosine logits are bounded by sqrt(hd), so nothing is
//     rescaled) and divided after P.V;
// then count the unit done for every row tile of its sample: it read them
// all, and the next block's qkv items overwrite them once the out product
// of their row tile has run.
template <int HD, bool LONG>
__device__ __forceinline__ void attention_unit(const Args& A, const Work& W, int b, int unit, uint8_t* buf,
                                               int group) {
  using namespace cosine_tiles;
  using D = Dims<HD>;
  const int tid = threadIdx.x % attn_tiles::THREADS, warp = tid >> 5, lane = tid & 31;
  const int t = A.t, d = A.d;
  int sample = unit / A.heads, head = unit % A.heads, q0 = 0, rows = t;
  if constexpr (LONG) {
    sample = unit / W.qt / A.heads;
    head = unit / W.qt % A.heads;
    q0 = unit % W.qt * TILE;
    rows = min(TILE, t - q0);
  }
  const int r0 = sample * t / BM, r1 = (sample * t + t - 1) / BM;
  if (tid == 0) {
    for (int r = r0; r <= r1; ++r) spin_until(done(A, W, K_QKV, r), (b + 1) * W.per_row(0));
    __threadfence();
  }
  __nv_bfloat16* sq = reinterpret_cast<__nv_bfloat16*>(buf + group * AttnSmem<HD>::BYTES);
  __nv_bfloat16* sk = sq + TILE * D::LD;
  __nv_bfloat16* sv = sk + TILE * D::LD;
  float* qsc = reinterpret_cast<float*>(sv + TILE * D::LD);
  float* ksc = qsc + TILE;
  const int64_t ld = 3ll * d;
  // the group's previous unit is done with the buffers, and tid 0 has seen
  // this one's qkv rows done
  asm volatile("bar.sync %0, %1;\n" ::"r"(1 + group), "n"(attn_tiles::THREADS) : "memory");
  const float* base = A.qkv + static_cast<int64_t>(sample) * t * ld + head * HD;
  __nv_bfloat16* dst = A.attn + (static_cast<int64_t>(sample) * t + q0) * d + head * HD;
  Rows<HD> fq, fk, fv;
  if constexpr (!LONG) {
    fetch<HD, true>(fq, base, ld, t, tid);
    fetch<HD, true>(fk, base + d, ld, t, tid);
    fetch<HD, true>(fv, base + 2 * d, ld, t, tid);
    commit<HD>(fq, sq, qsc, tid);
    commit<HD>(fk, sk, ksc, tid);
    commit<HD>(fv, sv, nullptr, tid);
    asm volatile("bar.sync %0, %1;\n" ::"r"(1 + group), "n"(attn_tiles::THREADS) : "memory");
    if (warp * 16 < t) {
      float s[KEY_TILES][4];
      exp_tile<HD>(s, sq, sk, qsc, ksc, t, warp, lane);
      float sum0 = 0.f, sum1 = 0.f;
      add_row_sums(sum0, sum1, s);
      uint32_t pa[KEY_TILES / 2][4];
      pack_p(pa, s);
      float o[D::NT][4];
#pragma unroll
      for (int j = 0; j < D::NT; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
      pv_tile<HD>(o, pa, sv, lane);
      store_rows<HD>(o, 1.f / quad_sum(sum0), 1.f / quad_sum(sum1), sq, dst, d, t, warp, lane);
    }
  } else {
    const bool active = warp * 16 < rows;
    fetch<HD, true>(fq, base + q0 * ld, ld, rows, tid);
    float o[D::NT][4];
#pragma unroll
    for (int j = 0; j < D::NT; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
    float sum0 = 0.f, sum1 = 0.f;
    for (int kt = 0; kt * TILE < t; ++kt) {
      const int keys = t - kt * TILE;
      fetch<HD, true>(fk, base + d + kt * TILE * ld, ld, min(TILE, keys), tid);
      fetch<HD, true>(fv, base + 2 * d + kt * TILE * ld, ld, min(TILE, keys), tid);
      // every warp is done with the previous key tile
      asm volatile("bar.sync %0, %1;\n" ::"r"(1 + group), "n"(attn_tiles::THREADS) : "memory");
      if (kt == 0) commit<HD>(fq, sq, qsc, tid);
      commit<HD>(fk, sk, ksc, tid);
      commit<HD>(fv, sv, nullptr, tid);
      asm volatile("bar.sync %0, %1;\n" ::"r"(1 + group), "n"(attn_tiles::THREADS) : "memory");
      if (!active) continue;
      float s[KEY_TILES][4];
      exp_tile<HD>(s, sq, sk, qsc, ksc, keys, warp, lane);
      add_row_sums(sum0, sum1, s);
      uint32_t pa[KEY_TILES / 2][4];
      pack_p(pa, s);
      pv_tile<HD>(o, pa, sv, lane);
    }
    if (active) store_rows<HD>(o, 1.f / quad_sum(sum0), 1.f / quad_sum(sum1), sq, dst, d, rows, warp, lane);
  }
  // the out product's TMA loads read these rows
  asm volatile("fence.proxy.async;\n" ::: "memory");
  asm volatile("bar.sync %0, %1;\n" ::"r"(1 + group), "n"(attn_tiles::THREADS) : "memory");
  if (tid == 0) {
    __threadfence();
    for (int r = r0; r <= r1; ++r) atomicAdd(done(A, W, K_ATTN, r), 1u);
  }
}

// The consumers hand each finished product item to the signalling thread
// through two mbarriers in shared memory: `done` (the eight consumer warps
// arrive once the item's stores are issued) and `ack` (the signalling
// thread arrives once it has counted the item), one phase an item; the
// consumers wait for the previous item's ack only when they finish the
// next, so they never wait on the count's release and are never two phases
// ahead. `attn_done` counts the attention items the consumers have
// finished: their buffers lie in the ring, which the TMA thread loads into
// again only after.
struct Handoff {
  uint32_t done, ack;
  volatile unsigned* attn_done;  // attention items the consumers have finished
};

// The producer warpgroup. Its first warp's lane 0 issues every product
// tile's loads once the tile's row is ready (and none while the consumers
// run an attention item in the ring); its second warp's lane 0 counts each
// product item done (a release add to the row's counter) once the
// consumers hand it over. All of it meets the two grid barriers.
__device__ __forceinline__ void producer_main(const Maps& maps, const Args& A, const Ring<STAGES>& ring,
                                              const Handoff& hand, const Work& W) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int d = A.d, hid = A.hidden;
  const CUtensorMap* a_maps[4] = {&maps.amod, &maps.attn, &maps.amod, &maps.h};
  const CUtensorMap* w_maps[4] = {&maps.w_qkv, &maps.w_out, &maps.w1, &maps.w2};
  const int w_rows[4] = {3 * d, d, hid, d};
  uint32_t it = 0;
  if (warp == PRODUCER_WARP && lane == 0) {
    for (const CUtensorMap* map : {&maps.a, &maps.amod, &maps.attn, &maps.h, &maps.w_mod, &maps.w_qkv, &maps.w_out,
                                   &maps.w1, &maps.w2})
      asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(map)) : "memory");
    const Items mods(A.n, 6 * d * A.depth, d);
    for (int item = blockIdx.x; item < mods.tiles; item += gridDim.x)
      produce_tile<STAGES, false>(ring, &maps.a, &maps.w_mod, mods.m0(item), mods.n0(item), 0, mods.kt, it);
  }
  grid_sync(A.sync, gridDim.x);
  grid_sync(A.sync, 2 * gridDim.x);  // the pre stage
  if (lane != 0 || (warp != PRODUCER_WARP && warp != PRODUCER_WARP + 1)) return;
  const bool loads = warp == PRODUCER_WARP;
  uint32_t handed = 0;
  unsigned attn_seen = 0;
  for (int g = blockIdx.x; g < W.depth * W.block_items; g += gridDim.x) {
    const int b = g / W.block_items;
    int kind, j;
    W.locate(g % W.block_items, kind, j);
    if (kind == K_ATTN) {
      // the attention buffers lie in the ring: load nothing more until the
      // consumers are through this item
      if (loads) {
        ++attn_seen;
        const long long start = clock64();
        while (*hand.attn_done < attn_seen) {
          if (clock64() - start > (1ll << 34)) __trap();
        }
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      }
      continue;
    }
    const int p = Work::product(kind);
    const Tile tl(W, p, j);
    if (loads) {
      unsigned* ctr;
      unsigned target;
      dependency(A, W, b, kind, tl.r, ctr, target);
      if (ctr != nullptr) spin_until(ctr, target);
      asm volatile("fence.proxy.async;\n" ::: "memory");
      produce_tile<STAGES, false>(ring, a_maps[p], w_maps[p], tl.m0, w_rows[p] * b + tl.n0, tl.kb, tl.nk, it);
    } else {
      mbar_wait(hand.done, handed & 1);
      __threadfence();
      atomicAdd(done(A, W, kind, tl.r), 1u);
      mbar_arrive(hand.ack);
      ++handed;
    }
  }
}

// The two consumer warpgroups: the modulation rows, the pre stage, then
// their share of the item list (the products' mainloops and epilogues, the
// attention units on two groups of four warps). spent: the ns each kind of
// work took on this CTA (thread 0 adds them up).
template <int HD, bool LONG>
__device__ __forceinline__ void consumer_main(const Args& A, const Ring<STAGES>& ring, uint8_t* ring_mem,
                                              float* tile, const Handoff& hand, const Work& W,
                                              unsigned long long* spent) {
  const int tid = threadIdx.x, lane = tid & 31;
  const int d = A.d, hid = A.hidden;
  const int64_t mods_ld = 6ll * d * A.depth;
  uint32_t it = 0, handed = 0;
  unsigned long long t0 = global_ns();
  const Items mods(A.n, 6 * d * A.depth, d);
  for (int item = blockIdx.x; item < mods.tiles; item += gridDim.x) {
    const int m0 = mods.m0(item), n0 = mods.n0(item), wg = tid >> 7;
    float acc[64];
    const bool active = m0 + 64 * wg < A.n;
    consume_tile<STAGES, false>(ring, acc, wg, lane, active, mods.kt, it);
    stage_tile(tile, acc, active, tid);
    finish_chunks(ScaleEpi{A.mods, mods_ld, A.alpha_d}, TileSums{tile}, A.n, 6 * d * A.depth, m0, n0, 0, BM * BN / 8,
                  tid);
  }
  grid_sync(A.sync, gridDim.x);
  pre_stage(A);
  grid_sync(A.sync, 2 * gridDim.x);
  if (tid == 0) spent[0] = global_ns() - t0;
  for (int g = blockIdx.x; g < W.depth * W.block_items; g += gridDim.x) {
    const int b = g / W.block_items;
    int kind, j;
    W.locate(g % W.block_items, kind, j);
    t0 = global_ns();
    if (kind == K_ATTN) {
      // units 2j (the first group) and 2j + 1 (the second)
      const int group = tid / attn_tiles::THREADS, unit = 2 * j + group;
      if (unit < W.units) attention_unit<HD, LONG>(A, W, b, unit, ring_mem, group);
      // the producer may load into the ring again
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      asm volatile("bar.sync %0, %1;\n" ::"n"(CONSUMER_BAR), "n"(CONSUMER_THREADS) : "memory");
      if (tid == 0) *hand.attn_done = *hand.attn_done + 1;
      if (tid == 0) spent[1 + kind] += global_ns() - t0;
      continue;
    }
    const int p = Work::product(kind);
    const Tile tl(W, p, j);
    unsigned* tickets = A.sync + SYNC_DONE + 8 * 5 * W.mt + b * W.tickets_per_block + W.ticket_off[p];
    const float* mods_b = A.mods + 6ll * d * b;
    const bool next = b + 1 < A.depth;
    switch (kind) {
      case K_QKV:
        consume_item(ring, tile, W.m, 3 * d, tl, W.splits[p], A.partial + W.partial_off[p], tickets, it,
                     ScaleEpi{A.qkv, 3ll * d, A.alpha_d});
        break;
      case K_OUT:
        consume_item(ring, tile, W.m, d, tl, W.splits[p], A.partial + W.partial_off[p], tickets, it,
                     OutEpi{b == 0 ? A.x : A.out, mods_b, mods_ld, A.t, d, A.alpha_d, __ldg(A.gains + 2 * b + 1), A.x1,
                            A.amod});
        break;
      case K_FC1:
        consume_item(ring, tile, W.m, hid, tl, W.splits[p], A.partial + W.partial_off[p], tickets, it,
                     SiluEpi{A.h, hid, A.alpha_d});
        break;
      default:
        consume_item(ring, tile, W.m, d, tl, W.splits[p], A.partial + W.partial_off[p], tickets, it,
                     Fc2Epi{A.x1, mods_b, mods_ld, A.t, d, A.alpha_h, next ? __ldg(A.gains + 2 * (b + 1)) : 0.f, next,
                            A.out, A.amod});
    }
    // later items (other CTAs' TMA loads among them) read these stores
    asm volatile("fence.proxy.async;\n" ::: "memory");
    __syncwarp();
    if (lane == 0) {
      if (handed > 0) mbar_wait(hand.ack, (handed - 1) & 1);
      mbar_arrive(hand.done);
    }
    ++handed;
    if (tid == 0) spent[1 + kind] += global_ns() - t0;
  }
}

template <int HD, bool LONG>
__global__ void __launch_bounds__(STACK_THREADS, 1)
    dit_stack_kernel(const __grid_constant__ Maps maps, const __grid_constant__ Args A) {
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  uint8_t* smem = smem_raw + (base - smem_u32(smem_raw));
  const Ring<STAGES> ring{base};
  const Handoff hand{base + Ring<STAGES>::BYTES, base + Ring<STAGES>::BYTES + 8,
                     reinterpret_cast<volatile unsigned*>(smem + Ring<STAGES>::BYTES + 16)};
  float* tile = reinterpret_cast<float*>(smem + Ring<STAGES>::BYTES + 32);
  // the work list's shape and the trace's sums, in shared memory rather
  // than in every thread's registers
  __shared__ Work W;
  __shared__ unsigned long long spent[6];
  if (threadIdx.x == 0) {
    W = Work(A);
    for (int i = 0; i < 6; ++i) spent[i] = 0;
    ring.init();
    mbar_init(hand.done, CONSUMER_THREADS / 32);
    mbar_init(hand.ack, 1);
    *hand.attn_done = 0;
  }
  __syncthreads();
  const unsigned long long start = global_ns();
  // the producer warpgroup hands most of its registers to the consumers
  // (setmaxnreg: 40 a producer thread, 232 a consumer thread, the 64 K of
  // the SM)
  if (threadIdx.x >= CONSUMER_THREADS) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS) : "memory");
    producer_main(maps, A, ring, hand, W);
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS) : "memory");
    consumer_main<HD, LONG>(A, ring, smem, tile, hand, W, spent);
  }
  if (A.trace != nullptr) {
    // every thread is through its items when thread 0 reads the clock
    __syncthreads();
    if (threadIdx.x == 0) {
      unsigned long long* trace = A.trace + TRACE_WORDS * blockIdx.x;
      for (int i = 0; i < 6; ++i) trace[i] = spent[i];
      trace[6] = start;
      trace[7] = global_ns();
    }
  }
}
// Tensor maps by pointer and shape: encoded once, reused while the pointer
// and shape repeat (a weight set, a scratch buffer the allocator hands back).
struct MapEntry {
  const void* ptr;
  int rows, cols, box_rows;
  CUtensorMap map;
};
constexpr int MAP_CACHE = 64;
MapEntry map_cache[MAP_CACHE];
int map_next = 0;
std::mutex map_lock;

bool cached_map(CUtensorMap* out, const void* ptr, int rows, int cols, int box_rows) {
  std::lock_guard<std::mutex> guard(map_lock);
  for (const MapEntry& e : map_cache) {
    if (e.ptr == ptr && e.rows == rows && e.cols == cols && e.box_rows == box_rows) {
      *out = e.map;
      return true;
    }
  }
  MapEntry& e = map_cache[map_next];
  if (!encode(&e.map, ptr, rows, cols, box_rows, BK)) {
    e.ptr = nullptr;
    return false;
  }
  e.ptr = ptr;
  e.rows = rows;
  e.cols = cols;
  e.box_rows = box_rows;
  map_next = (map_next + 1) % MAP_CACHE;
  *out = e.map;
  return true;
}

template <int HD, bool LONG>
cudaError_t configure() {
  static bool configured = false;
  if (!configured) {
    cudaError_t e =
        cudaFuncSetAttribute(dit_stack_kernel<HD, LONG>, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
    if (e == cudaSuccess) {
      e = cudaFuncSetAttribute(dit_stack_kernel<HD, LONG>, cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
    }
    if (e != cudaSuccess) return e;
    configured = true;
  }
  return cudaSuccess;
}

// CTAs of dit_stack_kernel<HD, *> that are resident at once on the current
// device (both instances: one an SM), or a negative CUDA error
template <int HD>
int resident_ctas() {
  cudaError_t e = configure<HD, false>();
  if (e == cudaSuccess) e = configure<HD, true>();
  int dev = 0, sms = 0, per_sm = 0;
  if (e == cudaSuccess) e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, dit_stack_kernel<HD, false>, STACK_THREADS, SMEM_BYTES);
  int per_sm_long = 0;
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm_long, dit_stack_kernel<HD, true>, STACK_THREADS,
                                                      SMEM_BYTES);
  if (per_sm_long < per_sm) per_sm = per_sm_long;
  return e == cudaSuccess ? sms * per_sm : -static_cast<int>(e);
}

template <int HD, bool LONG>
cudaError_t launch(const Maps& maps, const Args& args, int ctas, cudaStream_t s) {
  cudaError_t e = configure<HD, LONG>();
  if (e != cudaSuccess) return e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(ctas);
  cfg.blockDim = dim3(STACK_THREADS);
  cfg.dynamicSmemBytes = SMEM_BYTES;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeCooperative;
  attr[0].val.cooperative = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, dit_stack_kernel<HD, LONG>, maps, args);
  return e != cudaSuccess ? e : cudaGetLastError();
}

}  // namespace

extern "C" int dit_stack_smem_bytes() { return SMEM_BYTES; }

// CTAs resident at once for head width hd on the current device (the
// cooperative grid), or a negative CUDA error code.
extern "C" int dit_stack_resident_ctas(int hd) {
  switch (hd) {
    case 64:
      return resident_ctas<64>();
    case 72:
      return resident_ctas<72>();
    default:
      return -static_cast<int>(cudaErrorInvalidValue);
  }
}

// x, out: bf16 (n*t, d); a: bf16 (n, d); gains: f32 (depth, 2); the
// weights bf16, depth-stacked: w_mod (depth*6d, d), w_qkv (depth*3d, d),
// w_out (depth*d, d), w1 (depth*hidden, d), w2 (depth*d, hidden). The
// scratch pointers come from one workspace the wrapper lays out
// (ops/cuda/dit_block.py stack_plan); sync (sync_bytes) is zeroed here.
// trace: null, or TRACE_WORDS int64 a CTA (stack_plan's trace words): the
// ns it spent on the modulation rows and the pre stage, on qkv, attention,
// out, fc1 and fc2 items, then its start and end globaltimer.
extern "C" int dit_stack(const void* x, const void* a, const void* gains, const void* w_mod, const void* w_qkv,
                         const void* w_out, const void* w1, const void* w2, void* out, void* mods, void* qkv,
                         void* x1, void* partial, void* attn, void* h, void* amod, void* sync, int sync_bytes, int n,
                         int t, int d, int hidden, int heads, int depth, int splits_qkv, int splits_out,
                         int splits_fc1, int splits_fc2, int ctas, float alpha_d, float alpha_h, void* stream,
                         void* trace) {
  const int hd = heads > 0 ? d / heads : 0;
  const void* aligned[] = {x, a, w_mod, w_qkv, w_out, w1, w2, out, mods, qkv, x1, attn, h, amod};
  uintptr_t bits = 0;
  for (const void* p : aligned) bits |= reinterpret_cast<uintptr_t>(p);
  if (n < 1 || t < 2 || t % 2 || depth < 1 || hd * heads != d || (hd != 64 && hd != 72) ||
      d % 8 || hidden % 8 || bits % 16 || ctas < 1 || splits_qkv < 1 || splits_out < 1 || splits_fc1 < 1 ||
      splits_fc2 < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int m = n * t;
  // every split of a tile must run at once (the splits wait on each other's
  // tickets), and the tickets of every split product of every block fit
  // the sync words
  const int cols[4] = {3 * d, d, hidden, d}, splits[4] = {splits_qkv, splits_out, splits_fc1, splits_fc2};
  int64_t tickets = 0;
  for (int i = 0; i < 4; ++i) {
    const int tiles = (m + BM - 1) / BM * ((cols[i] + BN - 1) / BN);
    if (splits[i] > 1) {
      if (tiles * splits[i] > ctas) return static_cast<int>(cudaErrorInvalidValue);
      tickets += tiles;
    }
  }
  const int64_t words = SYNC_DONE + 5 * 8 * ((m + BM - 1) / BM) + tickets * depth;
  if (4 * words > sync_bytes) return static_cast<int>(cudaErrorInvalidValue);
  Maps maps;
  const bool maps_ok = cached_map(&maps.a, a, n, d, BM) && cached_map(&maps.amod, amod, m, d, BM) &&
                       cached_map(&maps.attn, attn, m, d, BM) && cached_map(&maps.h, h, m, hidden, BM) &&
                       cached_map(&maps.w_mod, w_mod, depth * 6 * d, d, BN) &&
                       cached_map(&maps.w_qkv, w_qkv, depth * 3 * d, d, BN) &&
                       cached_map(&maps.w_out, w_out, depth * d, d, BN) &&
                       cached_map(&maps.w1, w1, depth * hidden, d, BN) &&
                       cached_map(&maps.w2, w2, depth * d, hidden, BN);
  if (!maps_ok) return static_cast<int>(cudaErrorInvalidValue);
  Args args;
  args.n = n;
  args.t = t;
  args.d = d;
  args.hidden = hidden;
  args.heads = heads;
  args.depth = depth;
  args.splits_qkv = splits_qkv;
  args.splits_out = splits_out;
  args.splits_fc1 = splits_fc1;
  args.splits_fc2 = splits_fc2;
  args.alpha_d = alpha_d;
  args.alpha_h = alpha_h;
  args.x = static_cast<const __nv_bfloat16*>(x);
  args.out = static_cast<__nv_bfloat16*>(out);
  args.gains = static_cast<const float*>(gains);
  args.mods = static_cast<float*>(mods);
  args.qkv = static_cast<float*>(qkv);
  args.x1 = static_cast<float*>(x1);
  args.partial = static_cast<float*>(partial);
  args.attn = static_cast<__nv_bfloat16*>(attn);
  args.h = static_cast<__nv_bfloat16*>(h);
  args.amod = static_cast<__nv_bfloat16*>(amod);
  args.sync = static_cast<unsigned*>(sync);
  args.trace = static_cast<unsigned long long*>(trace);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e = cudaMemsetAsync(sync, 0, sync_bytes, s);
  if (e != cudaSuccess) return static_cast<int>(e);
  // T <= 64 and past it are instances of their own: the key-tile loop's
  // registers would push the one-tile instance into spills (at hd 72 188 /
  // 456 bytes against 20 / 232, XL/2 at T = 64 2.88 ms against 2.67)
  const bool long_t = t > attn_tiles::TILE;
  if (hd == 64)
    e = long_t ? launch<64, true>(maps, args, ctas, s) : launch<64, false>(maps, args, ctas, s);
  else
    e = long_t ? launch<72, true>(maps, args, ctas, s) : launch<72, false>(maps, args, ctas, s);
  return static_cast<int>(e);
}

extern "C" const char* dit_stack_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
