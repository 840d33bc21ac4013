// attn_branch: the attention half-block's training kernels, one persistent
// launch a call each.
//
// Replaces, in mapdit_tpu/ops/pallas/dit_block.py:
//   * row 3, attn_branch_fwd: _attn_fwd_impl (l.994; pallas_call l.1007,
//     body _attn_kernel l.512);
//   * row 4, attn_branch_bwd: _attn_bwd_impl (l.861; pallas_call l.918,
//     body _attn_bwd_kernel l.715 over _attn_bwd_math l.560), less the two
//     weight-gradient products, which the Pallas package leaves to XLA
//     outside its kernel (l.948-970) and the port to one bf16 product each
//     (ops/cuda/attn_branch.py);
//   * row 5, attn_branch_res_fwd: _attn_res_fwd_impl (l.1136; pallas_call
//     l.1152, body _attn_res_kernel l.1038), row 3's list whose attention
//     normalises p first (row 4's recompute) and writes the residuals of
//     the plain backward: p in f32 (N, heads, T, T), JAX's values
//     (l.1114-1115) before their rounding to bf16 for P.V, and attn to the
//     caller's tensor;
// and in the port the launch sequences of other rows' kernels those rows
// ran before (ops/cuda/attn_branch.py fwd_launch_sequence and
// res_fwd_launch_sequence: 3 launches, bwd_launch_sequence: 8), kept as the
// yardstick and as the route outside this kernel's domain.
//
// The half-block is y = mp_sum(x, gate * out_proj(attn(qkv(modulate(x)))),
// 0.3). M = N*T token rows; the lists, stage by stage, each item a 128-row
// tile (or a (sample, head) unit) of the stage:
//
//   fwd (and res_fwd)                       bwd
//   pre  h (M, D) bf16 = modulate(x; shift, scale, gain)
//   qkv  (M, 3D) f32 = h . Wqkv^T / sqrt(D)
//   attention (M, D) bf16, a (sample, head) unit at a time:
//        P.V on the exponentials,           p normalised first, rounded to
//        divided after (res_fwd: as bwd,    bf16, then P.V (the residual mode)
//        p stored in f32 first)
//   out  y = mp_sum(x, gate * attn . Wout^T / sqrt(D), 0.3), in x's type
//                                           out: dout = bf16(dy*0.3/rd * gate),
//                                           dgate = sum_t dy*0.3/rd * out
//                                           (out never stored)
//                                           dattn (M, D) f32 = dout . Wout / sqrt(D)
//                                           attention_bwd: dqkv (M, 3D) bf16
//                                           dh = dqkv . Wqkv / sqrt(D), never
//                                           stored: its epilogue is modulate's
//                                           backward, dx = dy*0.7/rd + du*scale
//                                           (x's type), dshift = g/den sum_t dh,
//                                           dscale = sum_t du*x, and dgain's
//                                           tile partial sum(dh*(shift - x*scale))
//
// with the rounding points of the launch sequences: the modulate in f32
// (modulate.cuh, an IEEE division) rounded once to bf16; products on bf16
// operands with f32 sums; qkv and dattn in f32; attn, dout and dqkv in bf16
// (h, attn, dout and dqkv are also the operands of the dW products the
// wrapper runs after the launch). shift, scale and gate are read in place
// (bf16 or f32, their own row strides), the gain from device memory: a call
// is one device operation.
//
// Bound on the H100 (the larger of the bytes over 3.35 TB/s and the
// products' FLOPs over 989 TFLOP/s; mapdit_tpu_torch/tools/
// bench_attn_branch.py bounds): DiT-S/2 at 256 x 64 tokens, row 3 0.0212 ms,
// row 4 without its dW products 0.0440, row 5 0.0212 (its 64.7 MB, p 25.2
// of them, take 0.0193; all by operations); DiT-XL/2 at 256 0.1808, 0.3664
// and 0.1808 (row 5's 192.7 MB: 0.0575). The f32 instances, on the f32
// pipes' 67 TFLOP/s: S/2 0.3125, 0.6491 and 0.3125 ms (operations).
//
// Design: the TP kernels' (dit_block_tp.cu), on work_list.cuh's machinery:
//   * One cooperative launch of one CTA an SM; a producer warpgroup (a TMA
//     thread, a signalling thread and a store warp) and two consumer
//     warpgroups on gemm_pipeline.cuh's TMA + wgmma ring (128 x 128 tiles,
//     k depth 64, four 32 KB stages, the f32 epilogue tile of its own).
//   * The list is laid out by the host's plan (ops/cuda/attn_branch.py
//     branch_plan, a dit_block_tp.py TpPlan the CPU tests walk): the launch
//     reads each stage's kind, items, counter word and target offset from
//     the plan's words and checks them against the shapes. CTA c takes items
//     c, c + ctas, ...; an item waits only on the previous stage's counter
//     of its own row tile (an attention unit: of its sample's), so every
//     wait points backwards and the earliest unfinished item can always run.
//     The last CTA to leave zeroes the sync words: no memset, no second
//     launch. Calls of one plan must not overlap in time (one stream).
//   * No K splits: at the training shapes every product has more tiles
//     than the card has SMs (S/2 at N = 256: 384 tiles of the smallest).
//   * Pre items through the ring (work_list.cuh produce_pre / consume_pre,
//     row 9's): the TMA thread loads an item's rows of x (32, 16 or 8 of
//     them, whatever fills a stage), the consumers modulate them with the
//     division's fast path written out (the same quotient).
//   * The f32 products (qkv, dattn) are staged times alpha and stored by
//     the store warp, one bulk copy a row, while the consumers go on to the
//     next item's k steps; the other epilogues run on the consumers, their
//     global loads FLIGHT rows at a time.
//   * dattn and dh read W as (K, N): two 64-column TMA boxes a ring stage,
//     wgmma with B MN-major (gemm_pipeline.cuh's W_KN form).
//   * The attention units run on each group of four consumer warps, one
//     (sample, head) at a time. The forward (both lists) on cosine_tiles.cuh's
//     core (work_list.cuh attention_core), its tiles in the f32 tile's
//     memory: while a group computes a unit, its unit of the CTA's next item
//     is already on its way into the ring (a TMA box of 64 rows of q, k and
//     v each, where those rows are done). The backward on
//     attention_bwd_tiles.cuh's (the same code as attention_bwd, reading
//     qkv and dattn through L2) in the ring.
//   * Per-sample sums need T dividing 128 (T <= 64, even): every sample lies
//     in one row tile, and dgate, dshift and dscale are column sums inside
//     the staged tile, as mp_gemm.cu's GATE_RESIDUAL_BWD epilogue forms
//     them: consumer thread (g, c) sums rows 8g .. 8g+7 of columns 8c ..
//     8c+7 in order, and for T > 8 a sample's row groups are added in order
//     through shared memory. dgain: each dh tile's partial (a thread's
//     sums, a shuffle tree in the warp, the eight warps in order) goes to
//     global memory; the item that takes the last ticket of them sums them
//     in tile order and divides by den. No float atomics: the same bits on
//     every run.
//   * Two kernels a head width in bf16: attn_branch_kernel<HD, false,
//     false, false> runs rows 3 and 4 (the list's kinds chosen at run
//     time), <HD, true, false, false> row 5 (the forward stages alone, p
//     stored: the backward's stages and epilogues are compiled out). Three
//     in f32: <HD, false, true, false> row 4, <HD, true, true, false> row 5
//     and <HD, false, true, true> row 3 (its own forward-only instance:
//     sharing row 4's, its consumers spilled 1332-1544 bytes a thread
//     against row 5's 48, and row 3 ran at 1.1874 ms against row 5's
//     0.8491 and its launch sequence's 0.8206 at S/2 x 256: chip_smoke.py's
//     phase-3 rows, NVIDIA H100 80GB HBM3, 700.00 W). The f32 ones are
//     built from attn_branch_f32.cu (this file with ATTN_BRANCH_F32 set),
//     a library of their own that nvcc compiles beside this one: in one
//     unit the five instances took 110 s of the kernels' build.
//   * -Xptxas -v (sm_90a): 168 registers each; rows 3 and 4's kernel 396 /
//     280 bytes of spill stores at head width 72 / 64, row 5's 56 / 44.
//   * The f32 instances (attn_branch_kernel<HD, RES, true, FWD>; a float32 model:
//     the Pallas kernels at dtype = float32, where nothing is rounded): the
//     same lists, plans and handoffs; the products on the f32 pipes through
//     the same ring at k depth 32 (gemm_pipeline.cuh consume_tile_f32, W
//     read as (K, N) in four 32-column boxes a stage); h, attn, dout and
//     dqkv stored in f32, y and dx in x's type (f32). The pre items read x
//     through the read-only path, not the ring (an f32 row of XL/2 would
//     outgrow a stage's boxes), and write f32 h. A forward unit's f32 q, k
//     and v rows (cosine_tiles.cuh's f32 core, 59 KB at hd 72) lie in the
//     ring, both groups' at once, read through L2 (no prefetch); a backward
//     unit (attention_bwd_f32.cuh: four f32 tiles and the row sums, 79 KB
//     at hd 72) lies in the ring for the first group and in the epilogue
//     tile's and sums' memory for the second, once the store warp is
//     through with the tile. dgain's tile partials are the bf16 kernel's:
//     the same 128 x 128 tiles, the same order.
// Forms built and measured (bench_attn_branch.py, S/2 graph ms of rows 3 /
// 4 over their launch sequences' in the same call; NVIDIA H100 80GB HBM3,
// 700.00 W; a machine's own speed moves both by up to ~10% between calls):
//   * first form (pre items of 4 token rows through registers with an IEEE
//     division, the f32 epilogues on the consumers): 1.97x / 1.35x;
//   * pre items of 32 token rows: 1.61x / 1.22x (128: 1.59x / 1.22x, 8:
//     1.73x / 1.26x); with the division's fast path and the rows through the
//     read-only path: 1.52x / 1.21x;
//   * the f32 tiles stored by two warps of the producer warpgroup: 1.35x /
//     1.13x, then 1.21x / 0.99x in another call of the same form;
//   * pre items by TMA through the ring: 1.21x / 0.98x; the forward
//     attention's rows staged by TMA for the next unit: 1.22x / 1.01x
//     (staging 46 -> 17 us a CTA, computing 17 -> 35: the stage got
//     shorter, the kernel no faster);
//   * the f32 tiles by bulk copies of the store warp: 1.16x / 0.99x; the
//     epilogues' loads four rows at a time: 1.19x, bwd 0.3857 ms (its
//     sequence's outlier 0.4456 in that call);
//   * the attention backward's next unit asked into L2 while one runs:
//     slower (its stage 133 -> 167 us a CTA): dropped.
// What bounds it now (--trace at S/2, a CTA's ms): row 3: pre 0.023, qkv
// 0.050 (2.9 us of k steps a tile, the store warp 5.4 us a tile: the
// consumers wait for the tile), attention 0.064 (two units at a time a CTA
// where the standalone kernels keep 4-8 in flight a SM; staging 16 us,
// computing 33-37), out 0.032. Row 4: the same four stages, then dattn
// 0.015, attention_bwd 0.133 (staging its four f32 operands 67 us of the
// units' 119), dh 0.055.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <initializer_list>

#include "attention_bwd_f32.cuh"
#include "attention_bwd_tiles.cuh"
#include "work_list.cuh"

// Which element type this translation unit instantiates and exports: the
// bf16 instances here, the f32 ones where attn_branch_f32.cu includes this
// file with ATTN_BRANCH_F32 set, so that nvcc compiles the two at once.
#ifndef ATTN_BRANCH_F32
#define ATTN_BRANCH_F32 0
#endif

namespace {

constexpr bool TU_F32 = ATTN_BRANCH_F32;

using namespace work_list;

// the products' epilogues
enum { EPI_F32 = 0, EPI_RESIDUAL = 1, EPI_GATE_BWD = 2, EPI_MOD_BWD = 3 };
// tensor-map slots: the products' A operands and weights (the _KN ones
// read W as (K, N), 64-row boxes)
enum { MAP_H = 0, MAP_WQKV, MAP_ATTN, MAP_WOUT, MAP_DOUT, MAP_WOUT_KN, MAP_DQKV, MAP_WQKV_KN, MAP_X, MAP_QKV32, N_MAPS };
// the branch plans' words: the TP header (its word P_MODS_SPLITS holds the
// dgain ticket word here) and up to seven stages
constexpr int PLAN_WORDS = P_STAGE + PS_WORDS * 7;
enum { P_DGAIN_TICKET = P_MODS_SPLITS, P_PRE_ROWS = P_MODS_TICKET };
// the per-sample sums: a consumer thread a (row group, 8-column chunk); the
// epilogues' rows whose loads a thread has in flight together
constexpr int GR_ROWS = 8, GR_GROUPS = BM / GR_ROWS, FLIGHT = 4;
static_assert(GR_GROUPS * (BN / 8) == CONSUMER_THREADS, "one consumer thread a row group and chunk");
constexpr int SUMS_FLOATS = 2 * GR_GROUPS * BN;  // dshift's and dscale's (dgate's) row-group partials
// shared memory: the ring, the handoff words (with the f32 tile's two
// mbarriers), the f32 epilogue tile, the sums' partials, the warps' dgain
// sums
constexpr int HAND_BYTES = 96;
constexpr int SMEM_BYTES = 1024 + Ring<STAGES>::BYTES + HAND_BYTES + TILE_BYTES + SUMS_FLOATS * 4 + 64;
// the store warp: the producer warpgroup's third warp stores the f32
// products' tiles (EPI_F32, scaled as they are staged) by bulk copies,
// while the consumers go on to their next item
constexpr int STORE_WARP = PRODUCER_WARP + 2;
static_assert(2 * attn_bwd_tiles::BwdLayout<72, 1>::BYTES <= STAGES * STAGE_BYTES,
              "two attention backward units must fit in the ring");
static_assert(TILE_BYTES % 16 == 0 && 2 * AttnSmem<72>::BYTES <= TILE_BYTES + SUMS_FLOATS * 4,
              "two attention units' tiles must fit in the f32 tile's and the sums' memory");
// the f32 instances: both forward units' f32 rows in the ring
// (work_list.cuh checks that they fit); a backward unit in the ring and one
// in the f32 tile's and the sums' memory
constexpr int F32_BWD_BYTES = attn_bwd_f32::Layout<72, attn_tiles::TILE>::BYTES;
static_assert(F32_BWD_BYTES <= STAGES * STAGE_BYTES && F32_BWD_BYTES <= TILE_BYTES + SUMS_FLOATS * 4,
              "an f32 attention backward unit must fit in the ring and in the tile's memory");
// the trace, a CTA's ns: [s] in the items of stage s (up to seven), [7] in
// its pre items' bodies, [8] its start and [9] its end (the clock), [10] in
// product mainloops (ring waits included), [11] in product epilogues, [12]
// its product items, [13] in the last dgain sum, [14] in the attention
// backward units' waits for their rows, [15] the store warp's ns storing
// tiles; the first group's forward attention units: [16] waiting for their
// rows, [17] staging them, [18] computing and storing; [19] its backward
// units' bodies, of which [20] staging the rows, [21] the query rows' part,
// [22] the key rows' part, [23] the stores
constexpr int TRACE_WORDS = 24;
enum { T_PRE_BODY = 7, T_START, T_END, T_MAINLOOP, T_EPILOGUE, T_ITEMS, T_DGAIN, T_ATTN_WAIT, T_STORE,
       T_ATTN_PHASES, T_ATTN_BWD_BODY = T_ATTN_PHASES + 3, T_ATTN_BWD_PHASES };

// the handoffs besides work_list.cuh's: the f32 tile is full (consumers ->
// store warp) and free again (store warp -> consumers)
struct TileHand {
  uint32_t full, free;
};

// The forward attention's rows of one unit, staged by TMA: q, k and v, each
// a box of 64 rows of HD f32 (a group's next unit, while it computes this
// one), two groups' in the ring; the units' bf16 tiles then lie in the f32
// tile's and the sums' memory.
template <int HD>
struct Staged {
  static constexpr int BOX_BYTES = attn_tiles::TILE * HD * 4;
  static constexpr int BYTES = 3 * BOX_BYTES;
};
// the prefetch state of the two groups (shared memory): the unit staged or
// in flight (-1: none), the prefetches issued
struct Prefetch {
  int unit[2];
  unsigned issued[2];
};

struct Maps {
  CUtensorMap m[N_MAPS];
};

struct Args {
  // what work_list.cuh's templates read
  int m, samples, t, d, heads, d_l;
  int stages;
  int kind[MAX_STAGES];
  int items[MAX_STAGES];
  int counter_off[MAX_STAGES];
  int target_off[MAX_STAGES];
  Prod prod[MAX_STAGES];
  const __nv_bfloat16* x;
  const void* shift;  // a sample's shift at shift + sample * shift_ld (elements); likewise scale, gate
  const void* scale;
  int shift_ld, scale_ld, rows_kind;
  const float* gain;
  __nv_bfloat16* amod;  // h
  const float* qkv;
  __nv_bfloat16* attn;
  unsigned* sync;
  int sync_words;
  unsigned long long* trace;
  int pre_rows;  // token rows of a pre item
  // the half-block's own
  int bwd;  // the backward's list: normalise-first attention, attention_bwd
  float* probs;  // row 5's f32 p (samples, heads, t, t), or null; a launch with it runs attn_branch_kernel<HD, true>
  const void* gate;
  int gate_ld;
  const void* dy;  // the cotangent of y, bf16 or f32 (dy_bf16)
  int dy_bf16;
  float db_fac, dx_fac;  // 0.3 / sqrt(0.58), 0.7 / sqrt(0.58)
  const float* dattn;    // attention_bwd's input (the dattn product's output)
  __nv_bfloat16* dqkv;
  float* dgate;
  float* dshift;
  float* dscale;
  float* dgain;
  float* dgain_partial;  // one a dh tile
  int dgain_ticket;      // sync word
  // the f32 instances' x, h, attn and dqkv (f32; y, dout and dx go through
  // the products' C)
  const float* x32;
  float* amod32;
  float* attn32;
  float* dqkv32;
};

// the element of x, y, h, attn, dout, dqkv and dx: bf16, or f32 in the f32
// instances
template <bool F32>
struct Elem {
  using T = __nv_bfloat16;
};
template <>
struct Elem<true> {
  using T = float;
};

template <bool F32>
__device__ __forceinline__ const typename Elem<F32>::T* x_of(const Args& A) {
  if constexpr (F32)
    return A.x32;
  else
    return A.x;
}

__device__ __forceinline__ void load_rows8(const Args& A, const void* rows, int ld, int64_t sample, int col,
                                           float (&v)[8]) {
  if (A.rows_kind == ROWS_IN_BF16)
    modulate::load8(static_cast<const __nv_bfloat16*>(rows) + sample * ld + col, v);
  else
    modulate::load8(static_cast<const float*>(rows) + sample * ld + col, v);
}

__device__ __forceinline__ void load_dy8(const Args& A, int64_t idx, float (&v)[8]) {
  if (A.dy_bf16)
    modulate::load8(static_cast<const __nv_bfloat16*>(A.dy) + idx, v);
  else
    modulate::load8(static_cast<const float*>(A.dy) + idx, v);
}


__device__ __forceinline__ void read_tile8(const float* tile, int r, int c, float (&v)[8]) {
  const float4 lo = *reinterpret_cast<const float4*>(tile + r * LDT + c);
  const float4 hi = *reinterpret_cast<const float4*>(tile + r * LDT + c + 4);
  v[0] = lo.x; v[1] = lo.y; v[2] = lo.z; v[3] = lo.w;
  v[4] = hi.x; v[5] = hi.y; v[6] = hi.z; v[7] = hi.w;
}

// The forward's out epilogue on the staged tile: y = mp_sum(x, gate * (v *
// alpha), 0.3) in x's type (gemm_pipeline.cuh's residual8, mp_gemm.cu's
// RESIDUAL). A consumer thread's chunks share its eight columns (rows tid /
// 16 + 16 k), their x and gate loads FLIGHT rows at a time.
template <bool F32>
__device__ __forceinline__ void residual_tile(const Args& A, const Prod& p, const float* tile, int m0, int n0,
                                              int tid) {
  constexpr int STEP = CONSUMER_THREADS / (BN / 8);
  const int c = 8 * (tid % (BN / 8)), col = n0 + c, r0 = tid / (BN / 8);
  if (col >= p.n) return;
  typename Elem<F32>::T* y = static_cast<typename Elem<F32>::T*>(p.c);
  for (int h = 0; h < BM / STEP; h += FLIGHT) {
    float xv[FLIGHT][8], g[FLIGHT][8];
#pragma unroll
    for (int i = 0; i < FLIGHT; ++i) {
      const int row = min(m0 + r0 + STEP * (h + i), p.m - 1);
      modulate::load8(x_of<F32>(A) + static_cast<int64_t>(row) * p.n + col, xv[i]);
      load_rows8(A, A.gate, A.gate_ld, row / A.t, col, g[i]);
    }
#pragma unroll
    for (int i = 0; i < FLIGHT; ++i) {
      const int r = r0 + STEP * (h + i);
      if (m0 + r >= p.m) break;
      float v[8];
      read_tile8(tile, r, c, v);
      residual8(v, xv[i], g[i], p.alpha);
      modulate::store8(y + static_cast<int64_t>(m0 + r) * p.n + col, v);
    }
  }
}

// A sample's row groups' partials (GR_GROUPS x BN f32 planes) summed in row
// group order by (sample, chunk) threads, then finish(sample, col, sums).
template <class Finish>
__device__ __forceinline__ void sample_sums(const float* plane_a, const float* plane_b, int m, int n, int t, int m0,
                                            int n0, int tid, const Finish& finish) {
  consumer_sync();
  const int groups = t / GR_ROWS, samples = BM / t, chunk = tid % (BN / 8);
  if (tid >= samples * (BN / 8)) return;
  const int s = tid / (BN / 8), row0 = m0 + s * t, col = n0 + 8 * chunk;
  if (row0 >= m || col >= n) return;
  float a[8], b[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) a[e] = b[e] = 0.f;
  for (int j = 0; j < groups; ++j) {
    const int at = (s * groups + j) * BN + 8 * chunk;
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      a[e] += plane_a[at + e];
      if (plane_b != nullptr) b[e] += plane_b[at + e];
    }
  }
  finish(row0 / t, col, a, b);
}

// The backward's out epilogue on the staged tile (out = v * alpha, never
// stored): dout = bf16(db * gate), dgate = sum_t db * out, db = dy * db_fac;
// mp_gemm.cu's GATE_RESIDUAL_BWD layout and order (its FLIGHT 1 form).
template <bool F32>
__device__ __forceinline__ void gate_bwd_tile(const Args& A, const Prod& p, const float* tile, float* sums, int m0,
                                              int n0, int tid) {
  const int chunk = tid % (BN / 8), grp = tid / (BN / 8);
  const int col = n0 + 8 * chunk, t = A.t, r0 = GR_ROWS * grp;
  const int rows = min(GR_ROWS, p.m - (m0 + r0));
  typename Elem<F32>::T* dout = static_cast<typename Elem<F32>::T*>(p.c);
  float acc[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f}, gate[8];
  if (col < p.n) {
    for (int h = 0; h < rows; h += FLIGHT) {
      // the loads of FLIGHT rows in flight together (rows past the last
      // read it again: no branch between the loads)
      float dy[FLIGHT][8];
#pragma unroll
      for (int i = 0; i < FLIGHT; ++i)
        load_dy8(A, static_cast<int64_t>(m0 + r0 + min(h + i, rows - 1)) * p.n + col, dy[i]);
#pragma unroll
      for (int i = 0; i < FLIGHT; ++i) {
        if (h + i >= rows) break;
        const int row = m0 + r0 + h + i, sample = row / t;
        const int64_t idx = static_cast<int64_t>(row) * p.n + col;
        float out[8], d[8];
        read_tile8(tile, r0 + h + i, col - n0, out);
        if (h + i == 0 || row % t == 0) load_rows8(A, A.gate, A.gate_ld, sample, col, gate);
        scale8(out, p.alpha);
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const float db = dy[i][e] * A.db_fac;
          acc[e] += db * out[e];
          d[e] = db * gate[e];
        }
        modulate::store8(dout + idx, d);
        if (t <= GR_ROWS && row % t == t - 1) {
          // the sample ends inside this thread's rows: its dgate is whole
          modulate::store8(A.dgate + static_cast<int64_t>(sample) * p.n + col, acc);
#pragma unroll
          for (int e = 0; e < 8; ++e) acc[e] = 0.f;
        }
      }
    }
  }
  if (t <= GR_ROWS) return;
  modulate::store8(sums + grp * BN + 8 * chunk, acc);
  sample_sums(sums, nullptr, p.m, p.n, t, m0, n0, tid, [&](int sample, int c, float (&a)[8], float (&)[8]) {
    modulate::store8(A.dgate + static_cast<int64_t>(sample) * p.n + c, a);
  });
}

// The dh epilogue on the staged tile (dh = v * alpha, never stored):
// modulate's backward with the residual's direct path, attn_branch_bwd.cu's
// modulate_bwd arithmetic, a thread's rows summed in order. Returns the
// thread's share of the tile's dgain sum.
template <bool F32>
__device__ __forceinline__ float mod_bwd_tile(const Args& A, const Prod& p, const float* tile, float* sums, int m0,
                                              int n0, int tid) {
  const int chunk = tid % (BN / 8), grp = tid / (BN / 8);
  const int col = n0 + 8 * chunk, t = A.t, r0 = GR_ROWS * grp;
  const int rows = min(GR_ROWS, p.m - (m0 + r0));
  const float g = __ldg(A.gain);
  const float den = modulate::denominator(g);
  const float du_fac = (1.f - g) / den, dsh_fac = g / den;
  typename Elem<F32>::T* dx = static_cast<typename Elem<F32>::T*>(p.c);
  float acc_dh[8], acc_sc[8], sh[8], sc[8], acc_gain = 0.f;
#pragma unroll
  for (int e = 0; e < 8; ++e) acc_dh[e] = acc_sc[e] = 0.f;
  if (col < p.n) {
    for (int h = 0; h < rows; h += FLIGHT) {
      float xv[FLIGHT][8], yv[FLIGHT][8];
#pragma unroll
      for (int i = 0; i < FLIGHT; ++i) {
        const int64_t idx = static_cast<int64_t>(m0 + r0 + min(h + i, rows - 1)) * p.n + col;
        modulate::load8(x_of<F32>(A) + idx, xv[i]);
        load_dy8(A, idx, yv[i]);
      }
#pragma unroll
      for (int i = 0; i < FLIGHT; ++i) {
        if (h + i >= rows) break;
        const int row = m0 + r0 + h + i, sample = row / t;
        const int64_t idx = static_cast<int64_t>(row) * p.n + col;
        float gh[8], out[8];
        read_tile8(tile, r0 + h + i, col - n0, gh);
        if (h + i == 0 || row % t == 0) {
          load_rows8(A, A.shift, A.shift_ld, sample, col, sh);
          load_rows8(A, A.scale, A.scale_ld, sample, col, sc);
        }
        scale8(gh, p.alpha);
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const float u = xv[i][e] * sc[e];
          const float du = gh[e] * du_fac;
          acc_dh[e] += gh[e];
          acc_gain += gh[e] * (sh[e] - u);
          out[e] = __fmul_rn(yv[i][e], A.dx_fac) + du * sc[e];
          acc_sc[e] += du * xv[i][e];
        }
        modulate::store8(dx + idx, out);
        if (t <= GR_ROWS && row % t == t - 1) {
#pragma unroll
          for (int e = 0; e < 8; ++e) acc_dh[e] *= dsh_fac;
          modulate::store8(A.dshift + static_cast<int64_t>(sample) * p.n + col, acc_dh);
          modulate::store8(A.dscale + static_cast<int64_t>(sample) * p.n + col, acc_sc);
#pragma unroll
          for (int e = 0; e < 8; ++e) acc_dh[e] = acc_sc[e] = 0.f;
        }
      }
    }
  }
  if (t > GR_ROWS) {
    modulate::store8(sums + grp * BN + 8 * chunk, acc_dh);
    modulate::store8(sums + GR_GROUPS * BN + grp * BN + 8 * chunk, acc_sc);
    sample_sums(sums, sums + GR_GROUPS * BN, p.m, p.n, t, m0, n0, tid,
                [&](int sample, int c, float (&a)[8], float (&b)[8]) {
                  const int64_t at = static_cast<int64_t>(sample) * p.n + c;
#pragma unroll
                  for (int e = 0; e < 8; ++e) a[e] *= dsh_fac;
                  modulate::store8(A.dshift + at, a);
                  modulate::store8(A.dscale + at, b);
                });
  }
  return acc_gain;
}

// The dgain sum: this dh tile's partial (the warps' shuffle trees, the
// eight warps in order) out, then a ticket; the item that takes the last
// one sums every tile's partial in tile order and writes dgain = sum / den.
__device__ __forceinline__ void dgain_tile(const Args& A, const Prod& p, int tile_i, float part, float* sums,
                                           float* warp_sums, volatile int* last, unsigned long long* spent) {
  const int tid = threadIdx.x, lane = tid & 31;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) part += __shfl_xor_sync(0xffffffffu, part, o);
  consumer_sync();  // every thread is through with sums and warp_sums of the item before
  if (lane == 0) warp_sums[tid >> 5] = part;
  consumer_sync();
  if (tid == 0) {
    float s = 0.f;
    for (int w = 0; w < CONSUMER_THREADS / 32; ++w) s += warp_sums[w];
    A.dgain_partial[tile_i] = s;
  }
  const int parts = cdiv_d(p.m, BM) * p.nt;
  if (!take_ticket(A.sync + A.dgain_ticket, parts, last)) return;
  const unsigned long long t0 = global_ns();
  float total = 0.f;
  for (int c0 = 0; c0 < parts; c0 += SUMS_FLOATS) {
    const int count = min(SUMS_FLOATS, parts - c0);
    for (int i = tid; i < count; i += CONSUMER_THREADS) sums[i] = __ldcg(A.dgain_partial + c0 + i);
    consumer_sync();
    if (tid == 0)
      for (int i = 0; i < count; ++i) total += sums[i];
    consumer_sync();
  }
  if (tid == 0) {
    A.dgain[0] = total / modulate::denominator(__ldg(A.gain));
    spent[T_DGAIN] += global_ns() - t0;
  }
}

// The consumers' side of product item j of stage s: the k steps, the
// staged tile, the stage's epilogue (RES: a forward list, row 5's or an f32
// row 3's, forward epilogues only; F32: the f32 instances, products on the
// f32 pipes).
template <bool RES, bool F32>
__device__ __forceinline__ void consume_product(const Args& A, const Ring<STAGES>& ring, float* tile, float* sums,
                                                float* warp_sums, const TileHand& th, uint32_t& f32_staged, int s,
                                                int j, volatile int* last, uint32_t& it, unsigned long long* spent) {
  const int tid = threadIdx.x, lane = tid & 31, wg = tid >> 7;
  const Prod& p = A.prod[s];
  const Tile tl(p, j);
  const bool active = tl.m0 + 64 * wg < p.m;
  unsigned long long t0 = global_ns();
  {
    float acc[64];
    if constexpr (F32) {
      if (p.w_kn)
        consume_tile_f32<STAGES, true>(ring, acc, tid, active, tl.nk, it);
      else
        consume_tile_f32<STAGES, false>(ring, acc, tid, active, tl.nk, it);
    } else if (p.w_kn) {
      consume_tile<STAGES, true>(ring, acc, wg, lane, active, tl.nk, it);
    } else {
      consume_tile<STAGES, false>(ring, acc, wg, lane, active, tl.nk, it);
    }
    if (tid == 0) {
      const unsigned long long t1 = global_ns();
      spent[T_MAINLOOP] += t1 - t0;
      spent[T_ITEMS] += 1;
      t0 = t1;
    }
    // the store warp is through with the last f32 tile handed to it
    if (f32_staged > 0) mbar_wait(th.free, (f32_staged - 1) & 1);
    if (p.epi == EPI_F32) {
#pragma unroll
      for (int i = 0; i < 64; ++i) acc[i] *= p.alpha;
    }
    stage_tile(tile, acc, active, tid);
  }
  switch (p.epi) {
    case EPI_F32:
      // the store warp copies it out (store_main) and counts it done: the
      // tile's writes are made visible to its bulk copies first
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      consumer_sync();
      if (tid == 0) mbar_arrive(th.full);
      ++f32_staged;
      break;
    case EPI_RESIDUAL:
      residual_tile<F32>(A, p, tile, tl.m0, tl.n0, tid);
      break;
    case EPI_GATE_BWD:
      if constexpr (!RES) gate_bwd_tile<F32>(A, p, tile, sums, tl.m0, tl.n0, tid);
      break;
    default:
      if constexpr (!RES)
        dgain_tile(A, p, tl.tile_i, mod_bwd_tile<F32>(A, p, tile, sums, tl.m0, tl.n0, tid), sums, warp_sums, last,
                   spent);
  }
  if (tid == 0) spent[T_EPILOGUE] += global_ns() - t0;
}

struct GroupSync {
  int id;
  __device__ __forceinline__ void operator()() const {
    asm volatile("bar.sync %0, %1;\n" ::"r"(id), "n"(attn_tiles::THREADS) : "memory");
  }
};

// The group's barrier that, where `slots` is given, also adds the ns since
// the last one to the next slot (the trace's phases of a unit).
struct LapSync {
  int id;
  unsigned long long* slots;
  unsigned long long* stamp;
  int* k;
  __device__ __forceinline__ void operator()() const {
    asm volatile("bar.sync %0, %1;\n" ::"r"(id), "n"(attn_tiles::THREADS) : "memory");
    if (slots != nullptr) {
      const unsigned long long now = global_ns();
      slots[(*k)++] += now - *stamp;
      *stamp = now;
    }
  }
};

// One (sample, head) unit of the attention backward on a group of four
// consumer warps: wait for the dattn rows of the sample's row tiles (qkv's
// lie further back on the same chain), run attention_bwd_tiles.cuh's unit
// in the ring's memory, count the unit done for them.
template <int HD>
__device__ __forceinline__ void attention_bwd_item(const Args& A, int s, int unit, uint8_t* buf, int group,
                                                   unsigned long long* spent) {
  using L = attn_bwd_tiles::BwdLayout<HD, 1>;
  static_assert(L::THREADS == attn_tiles::THREADS, "a unit on four warps");
  const int tid = threadIdx.x % attn_tiles::THREADS;
  const int sample = unit / A.heads, head = unit % A.heads, t = A.t;
  const int r0 = sample * t / BM, r1 = (sample * t + t - 1) / BM;
  const GroupSync sync{1 + group};
  if (tid == 0) {
    const unsigned long long t0 = global_ns();
    for (int r = r0; r <= r1; ++r) spin_until(counter(A, s - 1, r), per_row(A, s - 1, r));
    __threadfence();
    if (group == 0) spent[T_ATTN_WAIT] += global_ns() - t0;
  }
  sync();
  const bool timed = tid == 0 && group == 0;
  const unsigned long long t0 = global_ns();
  unsigned long long stamp = t0;
  int k = 0;
  attn_bwd_tiles::attention_bwd_unit<HD, 1, true>(
      A.qkv, A.dattn, A.dqkv, t, A.heads, sample, head, buf + group * L::BYTES, tid,
      LapSync{1 + group, timed ? spent + T_ATTN_BWD_PHASES : nullptr, &stamp, &k});
  if (timed) {
    const unsigned long long now = global_ns();
    spent[T_ATTN_BWD_BODY] += now - t0;
    spent[T_ATTN_BWD_PHASES + 3] += now - stamp;
  }
  // the dh product's TMA loads read these rows
  asm volatile("fence.proxy.async;\n" ::: "memory");
  sync();
  if (tid == 0) {
    __threadfence();
    for (int r = r0; r <= r1; ++r) atomicAdd(counter(A, s, r), 1u);
  }
}

// a thread's share of one staged box (64 rows of HD f32; rows >= rows read
// as zeros), laid out as cosine_tiles::fetch lays it out
template <int HD>
__device__ __forceinline__ void fetch_staged(cosine_tiles::Rows<HD>& f, const float* box, int rows, int tid) {
  using R = cosine_tiles::Rows<HD>;
  const int sub = tid & 3;
#pragma unroll
  for (int p = 0; p < R::PASSES; ++p) {
    const int r = (tid >> 2) + p * (attn_tiles::THREADS / 4);
    const float4* row = reinterpret_cast<const float4*>(box + r * HD);
#pragma unroll
    for (int j = 0; j < R::PER; ++j) {
      const int c = sub + 4 * j;
      f.x[p][j] = (r < rows && c < R::C4) ? row[c] : make_float4(0.f, 0.f, 0.f, 0.f);
    }
  }
}

// The group's unit of the CTA's next item (g + ctas), where it lies in
// stage s and the rows it reads (stage s - 1's counters of its sample's row
// tiles) are done already, else -1. One thread; relaxed loads, so that the
// thread's work goes on meanwhile (prefetch_unit orders them).
__device__ __forceinline__ int next_ready_unit(const Args& A, const Work& W, int g, int s, int group) {
  if (g + static_cast<int>(gridDim.x) >= W.total) return -1;
  int s2, j2;
  W.locate(g + gridDim.x, s2, j2);
  const int unit = 2 * j2 + group;
  if (s2 != s || unit >= A.samples * A.heads) return -1;
  const int t = A.t, sample = unit / A.heads;
  for (int r = sample * t / BM; r <= (sample * t + t - 1) / BM; ++r) {
    unsigned v;
    asm volatile("ld.relaxed.gpu.global.u32 %0, [%1];\n" : "=r"(v) : "l"(counter(A, s - 1, r)) : "memory");
    if (v < per_row(A, s - 1, r)) return -1;
  }
  return unit;
}

// The TMA loads of unit's q, k and v boxes into dst (next_ready_unit found
// its rows done: the fence makes that read an acquire). One thread.
template <int HD>
__device__ __forceinline__ void prefetch_unit(const Args& A, const CUtensorMap* tm, int unit, uint32_t dst,
                                              uint32_t bar) {
  const int sample = unit / A.heads, head = unit % A.heads;
  __threadfence();
  asm volatile("fence.proxy.async;\n" ::: "memory");
  mbar_expect_tx(bar, Staged<HD>::BYTES);
  for (int c = 0; c < 3; ++c)
    tma_load_2d(dst + c * Staged<HD>::BOX_BYTES, tm, bar, c * A.d + head * HD, sample * A.t);
}

// One forward attention item on the group of four consumer warps this
// thread is in: unit 2j + group, its rows staged by the prefetch of the
// group's item before (or, where there was none, read through L2 once they
// are done), its tiles in `work`; then the group's unit of the CTA's next
// item is prefetched into `stage` where it lies in this stage and its rows
// are done, and the unit is computed and counted done.
template <int HD, bool NORM_FIRST, bool STORE_P = false>
__device__ __forceinline__ void attention_item(const Args& A, const Maps& maps, const Work& W, int s, int g, int j,
                                               uint8_t* stage, uint8_t* work, Prefetch* pf, uint32_t pf_bar,
                                               unsigned long long* spent) {
  using namespace cosine_tiles;
  using D = Dims<HD>;
  const int group = threadIdx.x / attn_tiles::THREADS, tid = threadIdx.x % attn_tiles::THREADS;
  const int warp = tid >> 5, lane = tid & 31, units = A.samples * A.heads, unit = 2 * j + group;
  if (unit >= units) return;
  const int sample = unit / A.heads, head = unit % A.heads, t = A.t, ld = 3 * A.d;
  const int r0 = sample * t / BM, r1 = (sample * t + t - 1) / BM;
  const GroupSync sync{1 + group};
  const uint32_t bar = pf_bar + 8 * group;
  uint8_t* mine = stage + group * Staged<HD>::BYTES;
  __nv_bfloat16* sq = reinterpret_cast<__nv_bfloat16*>(work + group * AttnSmem<HD>::BYTES);
  __nv_bfloat16* sk = sq + TILE * D::LD;
  __nv_bfloat16* sv = sk + TILE * D::LD;
  float* qsc = reinterpret_cast<float*>(sv + TILE * D::LD);
  float* ksc = qsc + TILE;
  const bool timed = tid == 0 && group == 0;
  unsigned long long stamp = timed ? global_ns() : 0;
  const auto lap = [&](int i) {
    if (timed) {
      const unsigned long long now = global_ns();
      spent[T_ATTN_PHASES + i] += now - stamp;
      stamp = now;
    }
  };
  // the next unit's rows: checked now, prefetched once the staged boxes are free
  const int next = tid == 0 ? next_ready_unit(A, W, g, s, group) : -1;
  Rows<HD> fq, fk, fv;
  if (pf->unit[group] == unit) {
    mbar_wait(bar, (pf->issued[group] - 1) & 1);
    lap(0);
    const float* box = reinterpret_cast<const float*>(mine);
    fetch_staged<HD>(fq, box, t, tid);
    fetch_staged<HD>(fk, box + attn_tiles::TILE * HD, t, tid);
    fetch_staged<HD>(fv, box + 2 * attn_tiles::TILE * HD, t, tid);
  } else {
    if (tid == 0) {
      for (int r = r0; r <= r1; ++r) spin_until(counter(A, s - 1, r), per_row(A, s - 1, r));
      __threadfence();
    }
    sync();
    lap(0);
    const float* base = A.qkv + static_cast<int64_t>(sample) * t * ld + head * HD;
    fetch<HD, true>(fq, base, ld, t, tid);
    fetch<HD, true>(fk, base + A.d, ld, t, tid);
    fetch<HD, true>(fv, base + 2 * A.d, ld, t, tid);
  }
  commit<HD>(fq, sq, qsc, tid);
  commit<HD>(fk, sk, ksc, tid);
  commit<HD>(fv, sv, nullptr, tid);
  sync();  // the tiles are whole, the staged boxes free
  lap(1);
  if (tid == 0) {
    if (next >= 0) {
      prefetch_unit<HD>(A, &maps.m[MAP_QKV32], next, smem_u32(mine), bar);
      ++pf->issued[group];
    }
    pf->unit[group] = next;
  }
  attention_core<HD, NORM_FIRST>(sq, sk, sv, qsc, ksc, A.attn + static_cast<int64_t>(sample) * t * A.d + head * HD,
                                 A.d, t, warp, lane,
                                 STORE_P ? A.probs + static_cast<int64_t>(unit) * t * t : nullptr);
  // the out product's TMA loads read these rows
  asm volatile("fence.proxy.async;\n" ::: "memory");
  sync();
  if (tid == 0) {
    __threadfence();
    for (int r = r0; r <= r1; ++r) atomicAdd(counter(A, s, r), 1u);
  }
  lap(2);
}

// ---------------------------------------------------------------------------
// the f32 instances' attention items (a float32 model: the Pallas kernels
// at dtype = float32, nothing rounded); their pre items and attention core
// are work_list.cuh's pre_item_f32 and attention_core_f32

// One forward attention item in f32 on the group of four consumer warps
// this thread is in: unit 2j + group, its rows read through L2 once they
// are done, its f32 tiles in the group's part of the ring; then counted done.
template <int HD, bool NORM_FIRST, bool STORE_P>
__device__ __forceinline__ void attention_item_f32(const Args& A, int s, int j, uint8_t* ring_mem,
                                                   unsigned long long* spent) {
  using namespace cosine_tiles;
  using D = DimsF32<HD>;
  const int group = threadIdx.x / attn_tiles::THREADS, tid = threadIdx.x % attn_tiles::THREADS;
  const int warp = tid >> 5, lane = tid & 31, unit = 2 * j + group;
  if (unit >= A.samples * A.heads) return;
  const int sample = unit / A.heads, head = unit % A.heads, t = A.t, ld = 3 * A.d;
  const int r0 = sample * t / BM, r1 = (sample * t + t - 1) / BM;
  const GroupSync sync{1 + group};
  float* sq = reinterpret_cast<float*>(ring_mem + group * D::BYTES);
  float* sk = sq + TILE * D::LD;
  float* sv = sk + TILE * D::LD;
  float* qsc = sv + TILE * D::LD;
  float* ksc = qsc + TILE;
  const unsigned long long t0 = global_ns();
  if (tid == 0) {
    for (int r = r0; r <= r1; ++r) spin_until(counter(A, s - 1, r), per_row(A, s - 1, r));
    __threadfence();
  }
  sync();
  const unsigned long long t1 = global_ns();
  const float* base = A.qkv + static_cast<int64_t>(sample) * t * ld + head * HD;
  Rows<HD> fq, fk, fv;
  fetch<HD, true>(fq, base, ld, t, tid);
  fetch<HD, true>(fk, base + A.d, ld, t, tid);
  fetch<HD, true>(fv, base + 2 * A.d, ld, t, tid);
  commit_f32<HD>(fq, sq, qsc, tid);
  commit_f32<HD>(fk, sk, ksc, tid);
  commit_f32<HD>(fv, sv, nullptr, tid);
  sync();
  const unsigned long long t2 = global_ns();
  attention_core_f32<HD, NORM_FIRST>(sq, sk, sv, qsc, ksc,
                                     A.attn32 + static_cast<int64_t>(sample) * t * A.d + head * HD, A.d, t, warp,
                                     lane, STORE_P ? A.probs + static_cast<int64_t>(unit) * t * t : nullptr);
  // the out product's TMA loads read these rows
  asm volatile("fence.proxy.async;\n" ::: "memory");
  sync();
  if (tid == 0) {
    __threadfence();
    for (int r = r0; r <= r1; ++r) atomicAdd(counter(A, s, r), 1u);
  }
  if (tid == 0 && group == 0) {
    const unsigned long long t3 = global_ns();
    spent[T_ATTN_PHASES] += t1 - t0;
    spent[T_ATTN_PHASES + 1] += t2 - t1;
    spent[T_ATTN_PHASES + 2] += t3 - t2;
  }
}

// One (sample, head) unit of the attention backward in f32 on a group of
// four consumer warps (attention_bwd_f32.cuh), its tiles at buf: wait for
// the dattn rows of the sample's row tiles, run the unit, count it done.
template <int HD>
__device__ __forceinline__ void attention_bwd_item_f32(const Args& A, int s, int unit, float* buf, int group,
                                                       unsigned long long* spent) {
  const int tid = threadIdx.x % attn_tiles::THREADS;
  const int sample = unit / A.heads, head = unit % A.heads, t = A.t;
  const int r0 = sample * t / BM, r1 = (sample * t + t - 1) / BM;
  const GroupSync sync{1 + group};
  if (tid == 0) {
    const unsigned long long t0 = global_ns();
    for (int r = r0; r <= r1; ++r) spin_until(counter(A, s - 1, r), per_row(A, s - 1, r));
    __threadfence();
    if (group == 0) spent[T_ATTN_WAIT] += global_ns() - t0;
  }
  sync();
  const unsigned long long t0 = global_ns();
  attn_bwd_f32::attention_bwd_unit<HD, attn_tiles::TILE>(A.qkv, A.dattn, A.dqkv32, t, A.heads, sample, head, buf,
                                                         tid, sync);
  if (tid == 0 && group == 0) spent[T_ATTN_BWD_BODY] += global_ns() - t0;
  // the dh product's TMA loads read these rows
  asm volatile("fence.proxy.async;\n" ::: "memory");
  sync();
  if (tid == 0) {
    __threadfence();
    for (int r = r0; r <= r1; ++r) atomicAdd(counter(A, s, r), 1u);
  }
}

// The producer warpgroup: the TMA thread loads each pre item's rows of x
// into a ring stage and issues each product item's loads once the rows it
// reads are done (and none while the consumers run an attention item in the
// ring); the signalling thread counts each product item done once the
// consumers hand it over. Attention items are the consumers' alone, and in
// the f32 instances (F32) the pre items too.
template <bool F32>
__device__ __forceinline__ void producer_main(const Maps& maps, const Args& A, const Ring<STAGES>& ring,
                                              const Handoff& hand, const Work& W) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane != 0 || (warp != PRODUCER_WARP && warp != PRODUCER_WARP + 1)) return;
  const bool loads = warp == PRODUCER_WARP;
  uint32_t it = 0, handed = 0;
  unsigned attn_seen = 0;
  for (int g = blockIdx.x; g < W.total; g += gridDim.x) {
    int s, j;
    W.locate(g, s, j);
    const int kind = A.kind[s];
    if (kind == S_PRE) {
      if (loads && !F32) produce_pre(A, ring, &maps.m[MAP_X], j, it++);
      continue;
    }
    if (kind == S_ATTN || kind == S_ATTN_BWD) {
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
    const Prod& p = A.prod[s];
    const Tile tl(p, j);
    if (!loads && p.epi == EPI_F32) continue;  // the store warp counts it
    if (loads) {
      const auto wait = [&] {
        spin_until(counter(A, s - 1, tl.r), per_row(A, s - 1, tl.r));
        asm volatile("fence.proxy.async;\n" ::: "memory");
      };
      constexpr int KSTEP = F32 ? BK_F32 : BK;
      if (p.w_kn)
        produce_item<true, KSTEP>(ring, &maps.m[p.a_map], &maps.m[p.w_map], tl, it, wait);
      else
        produce_item<false, KSTEP>(ring, &maps.m[p.a_map], &maps.m[p.w_map], tl, it, wait);
    } else {
      mbar_wait(hand.done, handed & 1);
      __threadfence();
      atomicAdd(counter(A, s, tl.r), 1u);
      mbar_arrive(hand.ack);
      ++handed;
    }
  }
}

// The store warp (the producer warpgroup's third): for each f32 product
// item of this CTA, in order, the staged tile (already times alpha) to
// global memory, one bulk copy a row; once the copies have read the tile it
// is free again, once they are done the item is counted done (a release add
// to its row tile's counter).
__device__ __forceinline__ void store_main(const Args& A, const float* tile, const TileHand& th, const Work& W,
                                           unsigned long long* spent) {
  const int lane = threadIdx.x & 31;
  uint32_t k = 0;
  for (int g = blockIdx.x; g < W.total; g += gridDim.x) {
    int s, j;
    W.locate(g, s, j);
    if (A.kind[s] != S_GEMM || A.prod[s].epi != EPI_F32) continue;
    const Prod& p = A.prod[s];
    const Tile tl(p, j);
    mbar_wait(th.full, k & 1);
    const unsigned long long t0 = global_ns();
    const int rows = min(BM, p.m - tl.m0), bytes = 4 * min(BN, p.n - tl.n0);
    float* c = static_cast<float*>(p.c) + static_cast<int64_t>(tl.m0) * p.n + tl.n0;
    for (int r = lane; r < rows; r += 32) {
      asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n" ::"l"(c + static_cast<int64_t>(r) * p.n),
                   "r"(smem_u32(tile + r * LDT)), "r"(bytes)
                   : "memory");
    }
    asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
    asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
    __syncwarp();
    if (lane == 0) mbar_arrive(th.free);
    asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
    __syncwarp();
    if (lane == 0) {
      __threadfence();
      atomicAdd(counter(A, s, tl.r), 1u);
      spent[T_STORE] += global_ns() - t0;
    }
    ++k;
  }
}

// The two consumer warpgroups: their share of the list, in order (RES: row
// 5's, whose attention stores p; F32: the f32 instances; FWD: row 3's list
// alone, the backward's stages compiled out).
template <int HD, bool RES, bool F32, bool FWD>
__device__ __forceinline__ void consumer_main(const Maps& maps, const Args& A, const Ring<STAGES>& ring,
                                              uint8_t* ring_mem, float* tile, float* sums, float* warp_sums,
                                              const Handoff& hand, const TileHand& th, Prefetch* pf,
                                              uint32_t pf_bar, const Work& W, volatile int* last,
                                              unsigned long long* spent) {
  const int tid = threadIdx.x, lane = tid & 31;
  uint32_t it = 0, handed = 0, f32_staged = 0;
  for (int g = blockIdx.x; g < W.total; g += gridDim.x) {
    int s, j;
    W.locate(g, s, j);
    const unsigned long long t0 = global_ns();
    const int kind = A.kind[s];
    if (kind == S_PRE) {
      if constexpr (F32)
        pre_item_f32(A, s, j, spent + T_PRE_BODY);
      else
        consume_pre(A, ring, s, j, it, spent + T_PRE_BODY);
    } else if (kind == S_ATTN || kind == S_ATTN_BWD) {
      // units 2j (the first group) and 2j + 1 (the second)
      const int group = tid / attn_tiles::THREADS, unit = 2 * j + group;
      if (!RES && !FWD && kind == S_ATTN_BWD) {
        if constexpr (F32) {
          // the second group's unit takes the f32 tile's memory: the store
          // warp is through with it
          if (f32_staged > 0) mbar_wait(th.free, (f32_staged - 1) & 1);
          float* buf = group == 0 ? reinterpret_cast<float*>(ring_mem) : tile;
          if (unit < A.samples * A.heads) attention_bwd_item_f32<HD>(A, s, unit, buf, group, spent);
        } else if (unit < A.samples * A.heads) {
          attention_bwd_item<HD>(A, s, unit, ring_mem, group, spent);
        }
      } else if constexpr (F32) {
        if (RES)
          attention_item_f32<HD, true, true>(A, s, j, ring_mem, spent);
        else if (!FWD && A.bwd)
          attention_item_f32<HD, true, false>(A, s, j, ring_mem, spent);
        else
          attention_item_f32<HD, false, false>(A, s, j, ring_mem, spent);
      } else {
        // the units' tiles take the f32 tile's memory: the store warp
        // are through with it
        if (f32_staged > 0) mbar_wait(th.free, (f32_staged - 1) & 1);
        uint8_t* work = reinterpret_cast<uint8_t*>(tile);
        if constexpr (RES)
          attention_item<HD, true, true>(A, maps, W, s, g, j, ring_mem, work, pf, pf_bar, spent);
        else if (A.bwd)
          attention_item<HD, true>(A, maps, W, s, g, j, ring_mem, work, pf, pf_bar, spent);
        else
          attention_item<HD, false>(A, maps, W, s, g, j, ring_mem, work, pf, pf_bar, spent);
      }
      // the producer may load into the ring again
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      consumer_sync();
      if (tid == 0) *hand.attn_done = *hand.attn_done + 1;
    } else {
      consume_product<RES || FWD, F32>(A, ring, tile, sums, warp_sums, th, f32_staged, s, j, last, it, spent);
      if (A.prod[s].epi == EPI_F32) {
        if (tid == 0) spent[s] += global_ns() - t0;
        continue;
      }
      // later items (other CTAs' TMA loads among them) read these stores
      asm volatile("fence.proxy.async;\n" ::: "memory");
      __syncwarp();
      if (lane == 0) {
        if (handed > 0) mbar_wait(hand.ack, (handed - 1) & 1);
        mbar_arrive(hand.done);
      }
      ++handed;
    }
    if (tid == 0) spent[s] += global_ns() - t0;
  }
}

template <int HD, bool RES, bool F32, bool FWD>
__global__ void __launch_bounds__(KERNEL_THREADS, 1)
    attn_branch_kernel(const __grid_constant__ Maps maps, const __grid_constant__ Args A) {
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  uint8_t* smem = smem_raw + (base - smem_u32(smem_raw));
  const Ring<STAGES> ring{base};
  const Handoff hand{base + Ring<STAGES>::BYTES, base + Ring<STAGES>::BYTES + 8,
                     reinterpret_cast<volatile unsigned*>(smem + Ring<STAGES>::BYTES + 16)};
  volatile int* last = reinterpret_cast<volatile int*>(smem + Ring<STAGES>::BYTES + 20);
  const TileHand th{base + Ring<STAGES>::BYTES + 24, base + Ring<STAGES>::BYTES + 32};
  const uint32_t pf_bar = base + Ring<STAGES>::BYTES + 40;
  Prefetch* pf = reinterpret_cast<Prefetch*>(smem + Ring<STAGES>::BYTES + 56);
  float* tile = reinterpret_cast<float*>(smem + Ring<STAGES>::BYTES + HAND_BYTES);
  float* sums = tile + TILE_BYTES / 4;
  float* warp_sums = sums + SUMS_FLOATS;
  __shared__ Work W;
  __shared__ unsigned long long spent[TRACE_WORDS];
  if (threadIdx.x == 0) {
    W.init(A);
    for (int i = 0; i < TRACE_WORDS; ++i) spent[i] = 0;
    ring.init();
    mbar_init(hand.done, CONSUMER_THREADS / 32);
    mbar_init(hand.ack, 1);
    mbar_init(th.full, 1);
    mbar_init(th.free, 1);
    mbar_init(pf_bar, 1);
    mbar_init(pf_bar + 8, 1);
    pf->unit[0] = pf->unit[1] = -1;
    pf->issued[0] = pf->issued[1] = 0;
    *hand.attn_done = 0;
  }
  __syncthreads();
  const unsigned long long start = global_ns();
  if (threadIdx.x >= CONSUMER_THREADS) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS) : "memory");
    const int warp = threadIdx.x >> 5;
    if (warp == STORE_WARP)
      store_main(A, tile, th, W, spent);
    else if (warp < STORE_WARP)
      producer_main<F32>(maps, A, ring, hand, W);
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS) : "memory");
    consumer_main<HD, RES, F32, FWD>(maps, A, ring, smem, tile, sums, warp_sums, hand, th, pf, pf_bar, W, last,
                                     spent);
  }
  __syncthreads();
  if (A.trace != nullptr && threadIdx.x == 0) {
    unsigned long long* trace = A.trace + TRACE_WORDS * blockIdx.x;
    for (int i = 0; i < TRACE_WORDS; ++i) trace[i] = spent[i];
    trace[T_START] = start;
    trace[T_END] = global_ns();
  }
  leave_launch(A);
}

template <int HD, bool RES, bool F32, bool FWD>
cudaError_t configure() {
  static bool configured = false;
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(attn_branch_kernel<HD, RES, F32, FWD>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
    if (e == cudaSuccess) {
      e = cudaFuncSetAttribute(attn_branch_kernel<HD, RES, F32, FWD>, cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
    }
    if (e != cudaSuccess) return e;
    configured = true;
  }
  return cudaSuccess;
}

template <int HD, bool RES, bool F32, bool FWD = false>
int resident_ctas() {
  cudaError_t e = configure<HD, RES, F32, FWD>();
  int dev = 0, sms = 0, per_sm = 0;
  if (e == cudaSuccess) e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, attn_branch_kernel<HD, RES, F32, FWD>, KERNEL_THREADS,
                                                      SMEM_BYTES);
  return e == cudaSuccess ? sms * per_sm : -static_cast<int>(e);
}

// the CTAs every kernel of a head width and element type (rows 3 and 4,
// row 5; in f32 also row 3's own) keeps resident at once, so one plan's
// CTAs suit any of them
template <int HD, bool F32>
int resident_ctas_both() {
  int least = resident_ctas<HD, false, F32>();
  int fwd_only = least;
  if constexpr (F32) fwd_only = resident_ctas<HD, false, true, true>();
  for (const int c : {resident_ctas<HD, true, F32>(), fwd_only})
    least = least < 0 ? least : c < 0 ? c : c < least ? c : least;
  return least;
}

// One cooperative launch (every CTA resident, so a CTA may wait on another).
template <int HD, bool RES, bool F32, bool FWD = false>
int launch(const Maps& maps, const Args& args, int ctas, void* stream) {
  cudaError_t e = configure<HD, RES, F32, FWD>();
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(ctas);
  cfg.blockDim = dim3(KERNEL_THREADS);
  cfg.dynamicSmemBytes = SMEM_BYTES;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeCooperative;
  attr[0].val.cooperative = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, attn_branch_kernel<HD, RES, F32, FWD>, maps, args);
  return static_cast<int>(e != cudaSuccess ? e : cudaGetLastError());
}

// an f32 row-major (rows, cols) matrix read in (box_rows, box_cols) boxes,
// no swizzle, zeros outside (the forward attention's staged rows of qkv)
bool encode_f32(CUtensorMap* map, const void* ptr, int rows, int cols, int box_rows, int box_cols) {
  EncodeTiled fn = encode_fn();
  if (fn == nullptr) return false;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(cols) * 4};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(box_cols), static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t elem[2] = {1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, const_cast<void*>(ptr), dims, strides, box, elem,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// Row 5 on its own instance, rows 3 and 4 on theirs; in f32 row 3 on one of
// its own as well (the notes at the top)
template <bool F32>
int run(int hd, const Maps& maps, const Args& args, int ctas, void* stream) {
  if (args.probs != nullptr)
    return hd == 64 ? launch<64, true, F32>(maps, args, ctas, stream) : launch<72, true, F32>(maps, args, ctas, stream);
  if constexpr (F32) {
    if (!args.bwd)
      return hd == 64 ? launch<64, false, true, true>(maps, args, ctas, stream)
                      : launch<72, false, true, true>(maps, args, ctas, stream);
  }
  return hd == 64 ? launch<64, false, F32>(maps, args, ctas, stream) : launch<72, false, F32>(maps, args, ctas, stream);
}

// What both lists share, into args: the shapes (the domain: head widths 64
// and 72, an even T <= 64 dividing 128, D a multiple of 8), the modulate's
// inputs, h, qkv and attn, the sync buffer and the trace. false outside it.
bool common(Args& args, const void* x, const void* shift, int shift_ld, const void* scale, int scale_ld,
            const void* gate, int gate_ld, int rows_bf16, const void* gain, void* h, void* qkv, void* attn,
            void* sync, int n, int t, int d, int heads, void* trace) {
  const int hd = heads > 0 ? d / heads : 0;
  const int per16 = rows_bf16 ? 8 : 4;
  args.m = n * t;
  args.samples = n;
  args.t = t;
  args.d = d;
  args.heads = heads;
  args.d_l = d;
  args.x = static_cast<const __nv_bfloat16*>(x);
  args.shift = shift;
  args.scale = scale;
  args.gate = gate;
  args.shift_ld = shift_ld;
  args.scale_ld = scale_ld;
  args.gate_ld = gate_ld;
  args.rows_kind = rows_bf16 ? ROWS_IN_BF16 : ROWS_IN_F32;
  args.gain = static_cast<const float*>(gain);
  args.amod = static_cast<__nv_bfloat16*>(h);
  args.qkv = static_cast<const float*>(qkv);
  args.attn = static_cast<__nv_bfloat16*>(attn);
  args.sync = static_cast<unsigned*>(sync);
  args.trace = static_cast<unsigned long long*>(trace);
  return n >= 1 && t >= 2 && t <= attn_tiles::TILE && t % 2 == 0 && BM % t == 0 && d % 8 == 0 &&
         hd * heads == d && (hd == 64 || hd == 72) && shift != nullptr && scale != nullptr && gate != nullptr &&
         gain != nullptr && shift_ld % per16 == 0 && scale_ld % per16 == 0 && gate_ld % per16 == 0 &&
         aligned16({x, shift, scale, gate, h, qkv, attn, sync});
}

// the plan's token rows of a pre item: a multiple of 8 dividing the row tile
// (its boxes 1024-byte aligned for the swizzle, its rows in one row tile),
// whose rows of x fill at most one ring stage
bool pre_rows_ok(const int* plan, int d) {
  if (plan == nullptr) return false;
  const int rows = plan[P_PRE_ROWS];
  return rows >= 8 && rows % 8 == 0 && BM % rows == 0 && (d + 63) / 64 * rows * 128 <= STAGE_BYTES;
}

}  // namespace

// CTAs resident at once for head width hd (64, 72) on the current device,
// or a negative CUDA error code (attn_branch_f32_resident_ctas: the same for
// the f32 instances).
#if ATTN_BRANCH_F32
extern "C" int attn_branch_f32_resident_ctas(int hd) {
#else
extern "C" int attn_branch_resident_ctas(int hd) {
#endif
  switch (hd) {
    case 64:
      return resident_ctas_both<64, TU_F32>();
    case 72:
      return resident_ctas_both<72, TU_F32>();
    default:
      return -static_cast<int>(cudaErrorInvalidValue);
  }
}

namespace {

// Rows 3 and 5: the forward list, p stored where probs is given; in the
// f32 unit the f32 instances (x, the weights, y, h and attn f32).
int forward(const void* x, const void* w_qkv, const void* w_out, const void* shift, int shift_ld, const void* scale,
            int scale_ld, const void* gate, int gate_ld, int rows_bf16, const void* gain, void* y, void* h, void* qkv,
            void* attn, void* probs, void* sync, const int* plan, int n, int t, int d, int heads, int ctas,
            float alpha_d, void* stream, void* trace) {
  constexpr bool f32 = TU_F32;
  Args args = {};
  const int kstep = f32 ? BK_F32 : BK;
  if (!common(args, x, shift, shift_ld, scale, scale_ld, gate, gate_ld, rows_bf16, gain, h, qkv, attn, sync, n, t, d,
              heads, trace) ||
      !aligned16({w_qkv, w_out, y, probs}) || !pre_rows_ok(plan, d) || plan[P_DGAIN_TICKET] != 0 ||
      !read_plan(plan, args, ctas, {S_PRE, S_GEMM, S_ATTN, S_GEMM},
                 {{3 * d, d, MAP_H, MAP_WQKV, EPI_F32, alpha_d, qkv, nullptr, 0, kstep},
                  {d, d, MAP_ATTN, MAP_WOUT, EPI_RESIDUAL, alpha_d, y, nullptr, 0, kstep}}, BN, plan[P_PRE_ROWS]))
    return static_cast<int>(cudaErrorInvalidValue);
  args.probs = static_cast<float*>(probs);
  const int m = n * t;
  Maps maps = {};
  bool ok = cached_map(&maps.m[MAP_H], h, m, d, BM, f32) && cached_map(&maps.m[MAP_WQKV], w_qkv, 3 * d, d, BN, f32) &&
            cached_map(&maps.m[MAP_ATTN], attn, m, d, BM, f32) && cached_map(&maps.m[MAP_WOUT], w_out, d, d, BN, f32);
  if (f32) {
    args.x32 = static_cast<const float*>(x);
    args.amod32 = static_cast<float*>(h);
    args.attn32 = static_cast<float*>(attn);
  } else {
    ok = ok && cached_map(&maps.m[MAP_X], x, m, d, args.pre_rows) &&
         encode_f32(&maps.m[MAP_QKV32], qkv, m, 3 * d, attn_tiles::TILE, d / heads);
  }
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  return run<TU_F32>(d / heads, maps, args, ctas, stream);
}

// Row 4 without its dW products; in the f32 unit the f32 instance (x, the
// weights, dx, h, attn, dout and dqkv f32).
int backward(const void* dy, int dy_bf16, const void* x, const void* w_qkv, const void* w_out, const void* shift,
             int shift_ld, const void* scale, int scale_ld, const void* gate, int gate_ld, int rows_bf16,
             const void* gain, void* dx, void* dshift, void* dscale, void* dgate, void* dgain, void* h, void* qkv,
             void* attn, void* dout, void* dattn, void* dqkv, void* dgain_partial, void* sync, const int* plan, int n,
             int t, int d, int heads, int ctas, float alpha_d, float db_fac, float dx_fac, void* stream,
             void* trace) {
  constexpr bool f32 = TU_F32;
  Args args = {};
  const int kstep = f32 ? BK_F32 : BK;
  if (!common(args, x, shift, shift_ld, scale, scale_ld, gate, gate_ld, rows_bf16, gain, h, qkv, attn, sync, n, t, d,
              heads, trace) ||
      dgain == nullptr || dgain_partial == nullptr ||
      !aligned16({dy, w_qkv, w_out, dx, dshift, dscale, dgate, dout, dattn, dqkv}) || !pre_rows_ok(plan, d) ||
      !read_plan(plan, args, ctas, {S_PRE, S_GEMM, S_ATTN, S_GEMM, S_GEMM, S_ATTN_BWD, S_GEMM},
                 {{3 * d, d, MAP_H, MAP_WQKV, EPI_F32, alpha_d, qkv, nullptr, 0, kstep},
                  {d, d, MAP_ATTN, MAP_WOUT, EPI_GATE_BWD, alpha_d, dout, nullptr, 0, kstep},
                  {d, d, MAP_DOUT, MAP_WOUT_KN, EPI_F32, alpha_d, dattn, nullptr, 1, kstep},
                  {d, 3 * d, MAP_DQKV, MAP_WQKV_KN, EPI_MOD_BWD, alpha_d, dx, nullptr, 1, kstep}},
                 BN, plan[P_PRE_ROWS]))
    return static_cast<int>(cudaErrorInvalidValue);
  args.dgain_ticket = plan[P_DGAIN_TICKET];
  if (args.dgain_ticket < SYNC_DONE || args.dgain_ticket >= args.sync_words) return static_cast<int>(cudaErrorInvalidValue);
  args.bwd = 1;
  args.dy = dy;
  args.dy_bf16 = dy_bf16;
  args.db_fac = db_fac;
  args.dx_fac = dx_fac;
  args.dattn = static_cast<const float*>(dattn);
  args.dqkv = static_cast<__nv_bfloat16*>(dqkv);
  args.dgate = static_cast<float*>(dgate);
  args.dshift = static_cast<float*>(dshift);
  args.dscale = static_cast<float*>(dscale);
  args.dgain = static_cast<float*>(dgain);
  args.dgain_partial = static_cast<float*>(dgain_partial);
  const int m = n * t;
  // the (K, N) reads of W: boxes of a k step's rows (BK bf16 rows by 64
  // columns, or BK_F32 f32 rows by 32)
  const int kn_rows = f32 ? BK_F32 : BK;
  Maps maps = {};
  bool ok = cached_map(&maps.m[MAP_H], h, m, d, BM, f32) && cached_map(&maps.m[MAP_WQKV], w_qkv, 3 * d, d, BN, f32) &&
            cached_map(&maps.m[MAP_ATTN], attn, m, d, BM, f32) && cached_map(&maps.m[MAP_WOUT], w_out, d, d, BN, f32) &&
            cached_map(&maps.m[MAP_DOUT], dout, m, d, BM, f32) &&
            cached_map(&maps.m[MAP_WOUT_KN], w_out, d, d, kn_rows, f32) &&
            cached_map(&maps.m[MAP_DQKV], dqkv, m, 3 * d, BM, f32) &&
            cached_map(&maps.m[MAP_WQKV_KN], w_qkv, 3 * d, d, kn_rows, f32);
  if (f32) {
    args.x32 = static_cast<const float*>(x);
    args.amod32 = static_cast<float*>(h);
    args.attn32 = static_cast<float*>(attn);
    args.dqkv32 = static_cast<float*>(dqkv);
  } else {
    ok = ok && cached_map(&maps.m[MAP_X], x, m, d, args.pre_rows) &&
         encode_f32(&maps.m[MAP_QKV32], qkv, m, 3 * d, attn_tiles::TILE, d / heads);
  }
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  return run<TU_F32>(d / heads, maps, args, ctas, stream);
}

}  // namespace

#if !ATTN_BRANCH_F32
// Row 3. x: bf16 (n*t, d); w_qkv: bf16 (3d, d); w_out: bf16 (d, d); shift,
// scale, gate: a sample's row at ptr + sample * ld (elements), f32 or bf16
// (rows_bf16), read as they are; gain: one f32 value; y: bf16 (n*t, d). h,
// qkv and attn: scratch the wrapper lays out (branch_plan's layout); plan:
// the host's PLAN_WORDS words; sync: the plan's buffer on the card (its
// sync words zero, then its targets); trace: null, or TRACE_WORDS int64 a
// CTA.
extern "C" int attn_branch_fwd(const void* x, const void* w_qkv, const void* w_out, const void* shift, int shift_ld,
                               const void* scale, int scale_ld, const void* gate, int gate_ld, int rows_bf16,
                               const void* gain, void* y, void* h, void* qkv, void* attn, void* sync, const int* plan,
                               int n, int t, int d, int heads, int ctas, float alpha_d, void* stream, void* trace) {
  return forward(x, w_qkv, w_out, shift, shift_ld, scale, scale_ld, gate, gate_ld, rows_bf16, gain, y, h, qkv, attn,
                 nullptr, sync, plan, n, t, d, heads, ctas, alpha_d, stream, trace);
}

// Row 5: row 3's list, its attention normalising p first (rounded to bf16
// before P.V) and storing it in f32. The arguments of attn_branch_fwd, but
// attn (bf16, n*t x d) is the caller's output, not scratch, and probs the
// f32 (n, heads, t, t) p; qkv: scratch (branch_plan("res_fwd")); h may be
// attn (the wrapper passes it so): a row tile's attention units start once
// every qkv item of the tile, the only readers of its h rows, is done.
extern "C" int attn_branch_res_fwd(const void* x, const void* w_qkv, const void* w_out, const void* shift,
                                   int shift_ld, const void* scale, int scale_ld, const void* gate, int gate_ld,
                                   int rows_bf16, const void* gain, void* y, void* h, void* qkv, void* attn,
                                   void* probs, void* sync, const int* plan, int n, int t, int d, int heads, int ctas,
                                   float alpha_d, void* stream, void* trace) {
  if (probs == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  return forward(x, w_qkv, w_out, shift, shift_ld, scale, scale_ld, gate, gate_ld, rows_bf16, gain, y, h, qkv, attn,
                 probs, sync, plan, n, t, d, heads, ctas, alpha_d, stream, trace);
}

// Row 4 without its dW products. dy: (n*t, d), bf16 or f32 (dy_bf16); x,
// the weights, shift, scale, gate, gain as for attn_branch_fwd. Writes dx
// (bf16, n*t x d), dshift, dscale, dgate (f32, n x d), dgain (one f32) and,
// in the scratch the wrapper lays out, the dW operands h, attn, dout and
// dqkv (bf16) besides qkv and dattn (f32) and one dgain partial a dh tile.
// db_fac, dx_fac: 0.3 / sqrt(0.58) and 0.7 / sqrt(0.58), as f32.
extern "C" int attn_branch_bwd(const void* dy, int dy_bf16, const void* x, const void* w_qkv, const void* w_out,
                               const void* shift, int shift_ld, const void* scale, int scale_ld, const void* gate,
                               int gate_ld, int rows_bf16, const void* gain, void* dx, void* dshift, void* dscale,
                               void* dgate, void* dgain, void* h, void* qkv, void* attn, void* dout, void* dattn,
                               void* dqkv, void* dgain_partial, void* sync, const int* plan, int n, int t, int d,
                               int heads, int ctas, float alpha_d, float db_fac, float dx_fac, void* stream,
                               void* trace) {
  return backward(dy, dy_bf16, x, w_qkv, w_out, shift, shift_ld, scale, scale_ld, gate, gate_ld, rows_bf16, gain, dx,
                  dshift, dscale, dgate, dgain, h, qkv, attn, dout, dattn, dqkv, dgain_partial, sync, plan, n, t, d,
                  heads, ctas, alpha_d, db_fac, dx_fac, stream, trace);
}

#else
// The f32 instances (a float32 model: the Pallas kernels at dtype =
// float32, nothing rounded): the arguments of attn_branch_fwd,
// attn_branch_res_fwd and attn_branch_bwd with x, the weights, y, dx and
// the scratch's h, attn, dout and dqkv in f32; the plan is
// branch_plan(..., f32=True) on attn_branch_f32_resident_ctas CTAs.
extern "C" int attn_branch_fwd_f32(const void* x, const void* w_qkv, const void* w_out, const void* shift,
                                   int shift_ld, const void* scale, int scale_ld, const void* gate, int gate_ld,
                                   int rows_bf16, const void* gain, void* y, void* h, void* qkv, void* attn,
                                   void* sync, const int* plan, int n, int t, int d, int heads, int ctas,
                                   float alpha_d, void* stream, void* trace) {
  return forward(x, w_qkv, w_out, shift, shift_ld, scale, scale_ld, gate, gate_ld, rows_bf16, gain, y, h, qkv, attn,
                 nullptr, sync, plan, n, t, d, heads, ctas, alpha_d, stream, trace);
}

extern "C" int attn_branch_res_fwd_f32(const void* x, const void* w_qkv, const void* w_out, const void* shift,
                                       int shift_ld, const void* scale, int scale_ld, const void* gate, int gate_ld,
                                       int rows_bf16, const void* gain, void* y, void* h, void* qkv, void* attn,
                                       void* probs, void* sync, const int* plan, int n, int t, int d, int heads,
                                       int ctas, float alpha_d, void* stream, void* trace) {
  if (probs == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  return forward(x, w_qkv, w_out, shift, shift_ld, scale, scale_ld, gate, gate_ld, rows_bf16, gain, y, h, qkv, attn,
                 probs, sync, plan, n, t, d, heads, ctas, alpha_d, stream, trace);
}

extern "C" int attn_branch_bwd_f32(const void* dy, int dy_bf16, const void* x, const void* w_qkv, const void* w_out,
                                   const void* shift, int shift_ld, const void* scale, int scale_ld, const void* gate,
                                   int gate_ld, int rows_bf16, const void* gain, void* dx, void* dshift, void* dscale,
                                   void* dgate, void* dgain, void* h, void* qkv, void* attn, void* dout, void* dattn,
                                   void* dqkv, void* dgain_partial, void* sync, const int* plan, int n, int t, int d,
                                   int heads, int ctas, float alpha_d, float db_fac, float dx_fac, void* stream,
                                   void* trace) {
  return backward(dy, dy_bf16, x, w_qkv, w_out, shift, shift_ld, scale, scale_ld, gate, gate_ld, rows_bf16, gain, dx,
                  dshift, dscale, dgate, dgain, h, qkv, attn, dout, dattn, dqkv, dgain_partial, sync, plan, n, t, d,
                  heads, ctas, alpha_d, db_fac, dx_fac, stream, trace);
}
#endif

extern "C" int attn_branch_plan_words() { return PLAN_WORDS; }

extern "C" const char* attn_branch_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
