// mp_gemm: C = epilogue(prologue(A) . op(W) * alpha), bf16 operands, f32 sums,
// op(W) = W^T for W stored (N, K) or W itself for W stored (K, N).
//
// Replaces the matrix products of the Pallas block kernels together with the
// elementwise stages the Pallas kernels kept in VMEM around them:
//   mapdit_tpu/ops/pallas/dit_block.py:_block_body (l.279, the five products
//   of _fwd_impl / _stack_fwd_impl), _attn_kernel (l.512), the dattn and dh
//   products of _attn_bwd_math (l.636, 683), _attn_tp_kernel,
//   _block_tp_kernel and _mlp_tp_kernel (l.1408, 1575, 1683), and
//   mapdit_tpu/ops/pallas/mlp_block.py:_kernel (l.35).
//   prologue  MODULATE: per-sample modulate of A before it is rounded to
//             bf16, (a*scale + (shift - a*scale)*g) / sqrt((1-g)^2 + g^2),
//             sample = row / tokens, shift/scale read from an f32 (N, *)
//             modulation buffer at column offsets, g read from device memory
//             (no host sync);
//   epilogue  SILU: silu(c) / 0.596 (MP-SiLU);
//             RESIDUAL: (x + (gate*c - x)*0.3) / sqrt(0.58), the gated MP
//             residual, with x read from the stream (f32 or bf16);
//             GATE_RESIDUAL_BWD: the backward of that residual through its
//             branch, taken on the product out = c that is never stored
//             (the residual backward of _attn_bwd_math, dit_block.py:620-633,
//             whose Pallas kernel also keeps out in VMEM): db = dy*0.3/rd,
//             dout = bf16(db*gate) in C, dgate = sum_t db*out (N, D) f32.
// W is stored (out, in), as the port stores every weight: the forward
// products read it as (N, K) and take W^T (the K-major B operand of wgmma);
// the attention half-block's backward (dattn = dout . Wout, dh = dqkv .
// Wqkv) reads the same array as (K, N) and takes W itself through wgmma's
// MN-major B operand, so no transposed weight copy is ever made. The layout
// is a template parameter: a run-time branch in the tile loop cost the S/2
// headline 4% in the first form.
//
// Bound on the H100 (max of bytes / 3.35 TB/s and FLOPs / 989 TFLOP/s, as
// chip_smoke.py counts them): the S/2 sampling products (M = 4096) by their
// bytes, 0.0007 / 0.0069 / 0.0039 / 0.0060 / 0.0070 ms (modulation, qkv, out,
// fc1, fc2: f32 operands and results); the S/2 training products (M = 16384)
// dattn 0.0114 and dh 0.0190 ms (bytes); row 9 at B/2 (M = 4096) 0.0195 ms
// a product (operations); XL/2 on one card (M = 512, weight streaming)
// 0.0048 / 0.0049 / 0.0022 / 0.0055 / 0.0056 ms.
//
// Design (sm_90a):
//   * CTA tile 128 x 128, k depth 64: two consumer warpgroups of 64 rows
//     each issue wgmma.mma_async m64n128k16 (bf16 -> f32, both operands from
//     shared memory, 64 f32 accumulators a thread); one producer warp keeps
//     TMA loads (cp.async.bulk.tensor, 128-byte swizzle, full/empty mbarrier
//     pairs) in flight. The 128-row tile shares each W tile between the two
//     warpgroups; 128 columns keep the small-N products (N = 384-1152) in
//     enough tiles.
//   * Three stages (32 KB each, 96 KB) and at most 96 registers a thread, so
//     two CTAs share an SM and one's pipeline fill and epilogue hide behind
//     the other's products. Four stages at one CTA an SM were measured in the
//     same calls (NVIDIA H100 80GB HBM3, 700.00 W, graph-timed device ms;
//     this and the other forms below were built for the comparison and are
//     not kept, so these numbers cannot be re-run from the repo): faster
//     at the K = 384 products (qkv 0.0210 against 0.0256 ms), slower at the
//     long ones (B/2 fc1 0.0865 against 0.0656, XL fc1 0.0333 against
//     0.0275).
//     A persistent form (one CTA an SM walking the tiles, four stages, an
//     epilogue tile of its own so the next tile's loads run under the
//     epilogue), measured in one call against this one: faster at the
//     training products (dattn 0.0213 against 0.0269 ms, dh 0.0378 against
//     0.0462) and XL's split ones, slower where many tiles meet a short K
//     (B/2 fc1 0.0746 against 0.0594, S/2 fc1 0.0311 against 0.0269), even
//     over the five S/2 products (0.0853 against 0.0854 ms); not kept.
//   * wgmma of k step i overlaps the loads of step i+1 (wgmma.wait_group 1;
//     a stage is released one step late).
//   * What bounds it now: a 128 x 128 x 64 step moves 32 KB from L2 for
//     2.1 MFLOP, 64 FLOP a byte where the tensor cores need ~180 from L2;
//     B/2 fc1 streams ~300 MB of tiles through L2 in ~0.06 ms (~5 TB/s).
//     Wider tiles, or TMA multicast of W across a cluster, are the next
//     step; the K = 384 products also pay the pipeline fill and epilogue
//     of every tile.
//   * The prologue: a bf16 A without MODULATE is read where TMA put it. An
//     f32 A, or the modulate, first goes through mp_gemm_prologue, an
//     elementwise pass that writes the modulated A, rounded once to bf16 as
//     the plain version rounds it, into an (M, K) bf16 buffer the wrapper
//     allocates; the product then reads that. Converting inside the product
//     instead, (a) into registers for wgmma's register-A form or (b) into a
//     swizzled bf16 copy of each tile in shared memory, converts A again for
//     every column tile: N / 128 times, 9x at S/2 qkv, 36x at XL fc1. Route
//     (b), built and measured against the pass in one call (graph-timed
//     device ms, same card, both with the earlier per-thread epilogue): qkv
//     0.0455 and fc1 0.0806 ms, against 0.0273 and 0.0401; its conversion,
//     not the tensor cores, set the pace (~64 KB of L1 traffic a CTA and k
//     step for the shift/scale rows alone). Route (a) shares that cost. The
//     pass itself takes 0.0034 ms at S/2 qkv and fc1.
//   * The epilogue goes through shared memory: the accumulators, padded
//     rows, then eight consecutive columns a thread, so x, the gate and C
//     move in 16-byte accesses; alpha, MP-SiLU or the gated residual on f32.
//   * Small grids: shapes with fewer than 66 tiles (the XL/2 products at
//     M = 512, the modulation GEMVs at M = 8 or 64) split K over blockIdx.z
//     into f32 partials (allocated by the wrapper) that mp_gemm_reduce sums
//     in split order, then applies alpha and the epilogue: the same bits on
//     every run. The split count is mp_gemm_splits(M, N, K): enough for two
//     CTAs an SM, at least three k steps a split, at most 8. Rows past M
//     (M = 8 fills 8 of 128) are TMA's out-of-bounds zeros.
//   * GATE_RESIDUAL_BWD (the attention backward's out product, mp_gemm_gate_
//     residual_bwd): on the staged tile, consumer thread (g, c) takes rows
//     8g .. 8g + 7 of columns 8c .. 8c + 7: dy and the gate row in 16-byte
//     loads, dout in 16-byte stores, db*out summed down the rows in order.
//     Where T divides 128 (T = 64, 16, 4 at 16 x 16 latents) a 128-row
//     tile holds whole samples: for T <= 8 the thread's rows hold whole
//     samples and it writes their dgate; for T > 8 its partial sum goes to
//     shared memory and (sample, 8 columns) threads add a sample's T/8
//     partials in row order. Where T does not divide 128 (T = 256 at 32 x
//     32 latents; any T > 8) a sample spans row tiles, so each tile writes
//     its row-ordered sum of each sample it meets to a (row tiles, samples
//     a tile meets, N) f32 buffer, and mp_gemm_gate_sum adds a sample's
//     tile sums in tile order (a second launch; no atomics). A thread's 8
//     rows meet at most two samples there: the rows before a sample's
//     start go to a second slot of its partial. Split-K grids run the same
//     epilogue in mp_gemm_reduce_gate, a block a tile, each thread summing
//     its rows' split partials in split order (a first form there, one
//     thread a (sample, 8 columns) over all T rows, was latency-bound: 1.9x
//     the pair it replaced at N = 3, T = 64). No float atomics: the same
//     bits on every run. The f32 out the earlier route wrote for a separate
//     pass (one thread a column, a serial loop over T, 0.0368 ms against a
//     bound of 0.0153 at S/2 training) is gone.
//   * The f32 form (mp_gemm_f32: f32 A, W and C, the products of the Pallas
//     block body and of the attention half-block at dtype = float32, where
//     nothing is rounded): the
//     same tiles and ring at k depth 32 (128-byte f32 rows, 32 KB stages),
//     the products on the f32 pipes in k order (gemm_pipeline.cuh
//     consume_tile_f32: a TF32 wgmma would round each operand to 10
//     mantissa bits, past the 2e-4 the f32 kernel is held to), the same
//     epilogues. A without MODULATE is read where TMA put it; with it, the
//     prologue pass writes the modulated A in f32 (mp_gemm_prologue_f32),
//     nothing rounded. Split-K counts k steps of 32. Bound at the S/2
//     sampling products: operations, 2*M*N*K / 67 TFLOP/s (the H100's f32
//     pipes), 0.0541 ms at qkv and 0.0721 at fc1 and fc2 (M = 4096). The
//     attention backward's products at f32: dattn and dh read W as (K, N)
//     (four 32-column boxes a stage, gemm_pipeline.cuh), and the out
//     product's GATE_RESIDUAL_BWD epilogue writes f32 dout
//     (mp_gemm_f32_gate_residual_bwd), split-K and tile sums as in bf16.
//   * TMA needs 16-byte aligned rows and pointers: K and N multiples of 8;
//     the modulation rows are read as float4 (the wrapper raises otherwise).
//     The tensor maps are encoded on the host with cuTensorMapEncodeTiled,
//     taken from the driver library the process has loaded (dlopen/dlsym of
//     libcuda.so.1), so the library links no libcuda and builds with plain
//     nvcc, whatever the toolkit's runtime entry-point API.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "gemm_pipeline.cuh"
#include "modulate.cuh"

namespace {

using namespace gemm_pipeline;

constexpr int SMS = 132;

enum { PRO_NONE = 0, PRO_MODULATE = 1 };
enum { EPI_NONE = 0, EPI_SILU = 1, EPI_RESIDUAL = 2, EPI_GATE_RESIDUAL_BWD = 3 };
// rows of one sample and column chunk a thread of the GATE_RESIDUAL_BWD
// epilogue takes; BM / GR_ROWS row groups of BN / 8 chunks are the 256
// consumer threads
constexpr int GR_ROWS = 8;
constexpr int GR_GROUPS = BM / GR_ROWS;
// rows whose loads a thread puts in flight together: one in the product's
// epilogue (two CTAs an SM cap a thread at 112 registers; four rows spilled
// and took the S/2 call from 0.029 to 0.035 ms), all of them in the split-K
// reduction
constexpr int FLIGHT_TILE = 1;

constexpr int STAGES = 3;
// 1 KB of slack to align the ring to the 1024 bytes the swizzle needs, then
// the barriers
constexpr int SMEM_BYTES = STAGES * STAGE_BYTES + 1024 + 2 * STAGES * 8;
// GATE_RESIDUAL_BWD: a thread a (row group, chunk), and the row groups'
// partial sums (two slots a group: the rows before and after a sample's
// start inside it) beside the staged tile, inside the ring
static_assert(GR_GROUPS * (BN / 8) == CONSUMER_THREADS, "one consumer thread a row group and chunk");
static_assert(TILE_BYTES + 2 * GR_GROUPS * BN * 4 <= STAGES * STAGE_BYTES, "partials past the ring");
// samples a 128-row tile meets at T > GR_ROWS (at most 16, at T = 9: one
// (sample, chunk) thread each)
__host__ __device__ constexpr int gate_slots(int t) { return (BM - 1) / t + 2; }
static_assert(gate_slots(GR_ROWS + 1) * (BN / 8) <= CONSUMER_THREADS, "a thread a sample and chunk of a tile");

struct Params {
  void* c;
  int c_dtype;
  float* partial;
  int m, n, k;
  int kt, splits;
  float alpha;
  const float* mods;
  int mods_ld, shift_off, scale_off, gate_off;
  const float* gain;
  int tokens;
  int epilogue;
  const void* x;  // the stream x (RESIDUAL) or the cotangent dy (GATE_RESIDUAL_BWD)
  int x_dtype;
  float* dgate;    // GATE_RESIDUAL_BWD: (M / tokens, N) f32
  float db_fac;    // GATE_RESIDUAL_BWD: 0.3 / sqrt(0.58)
  // GATE_RESIDUAL_BWD where T does not divide BM: each tile's sums of each
  // sample it meets, (row tiles, gate_slots(T), N) f32, summed in tile
  // order by mp_gemm_gate_sum; null where T divides BM
  float* tile_partial;
};

// The prologue pass: A (f32 or bf16), modulated when asked, rounded once to
// the bf16 copy the product reads; eight elements a thread and step, the
// modulate in f32 as the plain version writes it (modulate.cuh).
template <bool A_F32, bool MOD>
__global__ void __launch_bounds__(256) mp_gemm_prologue(const void* a, uint4* out, const Params p) {
  float g = 0.f, den = 1.f;
  if (MOD) {
    g = *p.gain;
    den = modulate::denominator(g);
  }
  const int chunks = p.k / 8;
  const int64_t total = static_cast<int64_t>(p.m) * chunks;
  for (int64_t q = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x; q < total;
       q += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    float v[8];
    if (A_F32) {
      const float4 lo = __ldg(static_cast<const float4*>(a) + 2 * q);
      const float4 hi = __ldg(static_cast<const float4*>(a) + 2 * q + 1);
      v[0] = lo.x; v[1] = lo.y; v[2] = lo.z; v[3] = lo.w;
      v[4] = hi.x; v[5] = hi.y; v[6] = hi.z; v[7] = hi.w;
    } else {
      const uint4 u = __ldg(static_cast<const uint4*>(a) + q);
      v[0] = bf16_lo(u.x); v[1] = bf16_hi(u.x); v[2] = bf16_lo(u.y); v[3] = bf16_hi(u.y);
      v[4] = bf16_lo(u.z); v[5] = bf16_hi(u.z); v[6] = bf16_lo(u.w); v[7] = bf16_hi(u.w);
    }
    if (MOD) {
      const int row = static_cast<int>(q / chunks), col = 8 * static_cast<int>(q % chunks);
      const float* mrow = p.mods + static_cast<int64_t>(row / p.tokens) * p.mods_ld;
      modulate::apply8(v, mrow + p.shift_off + col, mrow + p.scale_off + col, g, den);
    }
    out[q] = make_uint4(pack_bf16(v[0], v[1]), pack_bf16(v[2], v[3]), pack_bf16(v[4], v[5]), pack_bf16(v[6], v[7]));
  }
}

// The f32 form's prologue pass: the modulated f32 A, nothing rounded, into
// the (M, K) f32 buffer the product reads.
__global__ void __launch_bounds__(256) mp_gemm_prologue_f32(const float* a, float4* out, const Params p) {
  const float g = *p.gain, den = modulate::denominator(g);
  const int chunks = p.k / 8;
  const int64_t total = static_cast<int64_t>(p.m) * chunks;
  for (int64_t q = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x; q < total;
       q += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    float v[8];
    modulate::load8(a + 8 * q, v);
    const int row = static_cast<int>(q / chunks), col = 8 * static_cast<int>(q % chunks);
    const float* mrow = p.mods + static_cast<int64_t>(row / p.tokens) * p.mods_ld;
    modulate::apply8(v, mrow + p.shift_off + col, mrow + p.scale_off + col, g, den);
    out[2 * q] = make_float4(v[0], v[1], v[2], v[3]);
    out[2 * q + 1] = make_float4(v[4], v[5], v[6], v[7]);
  }
}

// eight consecutive elements of an f32 or bf16 row-major matrix, 16-byte
// aligned
__device__ __forceinline__ void load8(const void* ptr, int dtype, int64_t i, float (&v)[8]) {
  if (dtype == DT_F32) {
    const float4 lo = *reinterpret_cast<const float4*>(static_cast<const float*>(ptr) + i);
    const float4 hi = *reinterpret_cast<const float4*>(static_cast<const float*>(ptr) + i + 4);
    v[0] = lo.x; v[1] = lo.y; v[2] = lo.z; v[3] = lo.w;
    v[4] = hi.x; v[5] = hi.y; v[6] = hi.z; v[7] = hi.w;
  } else {
    const uint4 u = *reinterpret_cast<const uint4*>(static_cast<const __nv_bfloat16*>(ptr) + i);
    v[0] = bf16_lo(u.x); v[1] = bf16_hi(u.x); v[2] = bf16_lo(u.y); v[3] = bf16_hi(u.y);
    v[4] = bf16_lo(u.z); v[5] = bf16_hi(u.z); v[6] = bf16_lo(u.w); v[7] = bf16_hi(u.w);
  }
}

// alpha, the epilogue and the store of C[row, col..col+7] from the f32
// sums v: 16- or 32-byte loads of x and the gate, one store
__device__ __forceinline__ void finish8(const Params& p, int row, int col, float (&v)[8]) {
  const int64_t idx = static_cast<int64_t>(row) * p.n + col;
  if (p.epilogue == EPI_RESIDUAL) {
    float x[8], gate[8];
    load8(p.x, p.x_dtype, idx, x);
    load8(p.mods, DT_F32, static_cast<int64_t>(row / p.tokens) * p.mods_ld + p.gate_off + col, gate);
    residual8(v, x, gate, p.alpha);
  } else if (p.epilogue == EPI_SILU) {
    silu8(v, p.alpha);
  } else {
    scale8(v, p.alpha);
  }
  if (p.c_dtype == DT_F32) {
    float4* out = reinterpret_cast<float4*>(static_cast<float*>(p.c) + idx);
    out[0] = make_float4(v[0], v[1], v[2], v[3]);
    out[1] = make_float4(v[4], v[5], v[6], v[7]);
  } else {
    *reinterpret_cast<uint4*>(static_cast<__nv_bfloat16*>(p.c) + idx) =
        make_uint4(pack_bf16(v[0], v[1]), pack_bf16(v[2], v[3]), pack_bf16(v[4], v[5]), pack_bf16(v[6], v[7]));
  }
}

__device__ __forceinline__ void store8(float* dst, const float (&v)[8]) {
  reinterpret_cast<float4*>(dst)[0] = make_float4(v[0], v[1], v[2], v[3]);
  reinterpret_cast<float4*>(dst)[1] = make_float4(v[4], v[5], v[6], v[7]);
}

// db = dy*db_fac for eight columns, dout = db*gate (bf16, or f32 in the f32 form) stored at idx,
// and acc += db*out
__device__ __forceinline__ void gate_residual8(const Params& p, int64_t idx, const float (&out)[8],
                                               const float (&dy)[8], const float (&gate)[8], float (&acc)[8]) {
  float d[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    const float db = dy[e] * p.db_fac;
    acc[e] += db * out[e];
    d[e] = db * gate[e];
  }
  if (p.c_dtype == DT_F32)
    store8(static_cast<float*>(p.c) + idx, d);
  else
    *reinterpret_cast<uint4*>(static_cast<__nv_bfloat16*>(p.c) + idx) =
        make_uint4(pack_bf16(d[0], d[1]), pack_bf16(d[2], d[3]), pack_bf16(d[4], d[5]), pack_bf16(d[6], d[7]));
}

// The GATE_RESIDUAL_BWD epilogue of one 128 x 128 tile at (m0, n0) over
// 256 threads (all of them reach the named barrier): see the notes at the
// top. A thread's GR_ROWS rows go FLIGHT at a time, their loads issued
// together: sums(r0, col, rows, v) gives the f32 sums of tile rows r0 ..
// r0 + rows - 1, columns col .. col + 7 (from the staged tile, or the
// split-K partials), then dy of those rows is read. ``partial`` holds
// 2 x GR_GROUPS x BN f32 of shared memory.
template <int FLIGHT, class Sums>
__device__ __forceinline__ void gate_residual_tile(const Sums& sums, float* partial, const Params& p, int m0, int n0,
                                                   int tid) {
  const int chunk = tid % (BN / 8), g = tid / (BN / 8);
  const int col = n0 + 8 * chunk, t = p.tokens, r0 = GR_ROWS * g;
  const int rows = min(GR_ROWS, p.m - (m0 + r0));
  float acc[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f}, gate[8];
  // at T > GR_ROWS a sample may start inside the thread's rows (T not a
  // multiple of GR_ROWS): the rows before it went to slot 0
  bool split = false;
  if (col < p.n) {
#pragma unroll
    for (int h = 0; h < GR_ROWS; h += FLIGHT) {
      const int n_rows = min(FLIGHT, rows - h);
      if (n_rows <= 0) break;
      float out[FLIGHT][8], dy[FLIGHT][8];
      sums(r0 + h, col, n_rows, out);
      // rows past n_rows read the last one again: no branch between the
      // loads, so they are in flight together
#pragma unroll
      for (int i = 0; i < FLIGHT; ++i)
        load8(p.x, p.x_dtype, static_cast<int64_t>(m0 + r0 + h + min(i, n_rows - 1)) * p.n + col, dy[i]);
#pragma unroll
      for (int i = 0; i < FLIGHT; ++i) {
        if (i >= n_rows) break;
        const int row = m0 + r0 + h + i, sample = row / t;
        if (t > GR_ROWS && h + i > 0 && row % t == 0) {
          store8(partial + g * BN + 8 * chunk, acc);
#pragma unroll
          for (int e = 0; e < 8; ++e) acc[e] = 0.f;
          split = true;
        }
        if (h + i == 0 || row % t == 0) {
          load8(p.mods, DT_F32, static_cast<int64_t>(sample) * p.mods_ld + p.gate_off + col, gate);
        }
        scale8(out[i], p.alpha);
        gate_residual8(p, static_cast<int64_t>(row) * p.n + col, out[i], dy[i], gate, acc);
        if (t <= GR_ROWS && row % t == t - 1) {
          // the sample ends inside this thread's rows: its dgate is whole
          store8(p.dgate + static_cast<int64_t>(sample) * p.n + col, acc);
#pragma unroll
          for (int e = 0; e < 8; ++e) acc[e] = 0.f;
        }
      }
    }
  }
  if (t <= GR_ROWS) return;
  store8(partial + ((split ? GR_GROUPS : 0) + g) * BN + 8 * chunk, acc);
  asm volatile("bar.sync %0, %1;\n" ::"n"(CONSUMER_BAR), "n"(CONSUMER_THREADS) : "memory");
  // (sample, chunk) threads: the row groups of each sample the tile meets,
  // in row order (slot 1 of a group where the sample starts inside it);
  // the whole dgate where T divides BM, else the tile's part of it
  const int first = m0 / t, samples = (min(m0 + BM, p.m) - 1) / t - first + 1;
  if (tid >= samples * (BN / 8) || col >= p.n) return;
  const int j = tid / (BN / 8), s = first + j;
  const int lo = max(s * t, m0) - m0, hi = min(min(s * t + t, m0 + BM), p.m) - m0;
  float sum[8];
  for (int e = 0; e < 8; ++e) sum[e] = 0.f;
  for (int grp = lo / GR_ROWS; grp <= (hi - 1) / GR_ROWS; ++grp) {
    const float* src = partial + ((GR_ROWS * grp < lo ? GR_GROUPS : 0) + grp) * BN + 8 * chunk;
#pragma unroll
    for (int e = 0; e < 8; ++e) sum[e] += src[e];
  }
  if (p.tile_partial == nullptr)
    store8(p.dgate + static_cast<int64_t>(s) * p.n + col, sum);
  else
    store8(p.tile_partial + (static_cast<int64_t>(m0 / BM) * gate_slots(t) + j) * p.n + col, sum);
}

// GATE_RESIDUAL_BWD where T does not divide BM: dgate of each sample, the
// tile sums of the row tiles it spans added in tile order; eight columns a
// thread
__global__ void __launch_bounds__(256) mp_gemm_gate_sum(const Params p) {
  const int t = p.tokens, chunks = p.n / 8, slots = gate_slots(t);
  const int64_t total = static_cast<int64_t>(p.m / t) * chunks;
  for (int64_t i = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x; i < total;
       i += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    const int s = static_cast<int>(i / chunks), col = 8 * static_cast<int>(i % chunks);
    float sum[8];
    for (int e = 0; e < 8; ++e) sum[e] = 0.f;
    for (int r = s * t / BM; r <= (s * t + t - 1) / BM; ++r) {
      float v[8];
      load8(p.tile_partial, DT_F32, (static_cast<int64_t>(r) * slots + s - r * BM / t) * p.n + col, v);
#pragma unroll
      for (int e = 0; e < 8; ++e) sum[e] += v[e];
    }
    store8(p.dgate + static_cast<int64_t>(s) * p.n + col, sum);
  }
}

// F32: f32 A and W, k steps of BK_F32 on the f32 pipes (the f32 form)
template <bool W_KN, bool F32>
__global__ void __launch_bounds__(THREADS, 2)
    mp_gemm_kernel(const __grid_constant__ CUtensorMap tm_a, const __grid_constant__ CUtensorMap tm_w, const Params p) {
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  const Ring<STAGES> ring{(smem_u32(smem_raw) + 1023u) & ~1023u};

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int kb = blockIdx.z * p.kt / p.splits, ke = (blockIdx.z + 1) * p.kt / p.splits;
  const int nk = ke - kb;

  if (tid == 0) ring.init();
  __syncthreads();

  uint32_t it = 0;
  if (warp == PRODUCER_WARP) {
    // producer: one thread keeps the ring full
    if (lane == 0) {
      asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(&tm_a)) : "memory");
      asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(&tm_w)) : "memory");
      produce_tile<STAGES, W_KN, F32 ? BK_F32 : BK>(ring, &tm_a, &tm_w, m0, n0, kb, nk, it);
    }
    return;
  }

  // consumers: warpgroup wg owns rows 64*wg .. 64*wg + 63 of the tile
  const int wg = warp >> 2;
  const bool active = m0 + 64 * wg < p.m;
  float acc[64];
  if constexpr (F32) {
    consume_tile_f32<STAGES, W_KN>(ring, acc, tid, active, nk, it);
  } else {
    consume_tile<STAGES, W_KN>(ring, acc, wg, lane, active, nk, it);
  }

  if (p.splits > 1) {
    if (!active) return;
    store_partial(p.partial, acc, blockIdx.z, p.m, p.n, m0, n0, tid);
    return;
  }
  // the epilogue goes through the ring, free once both warpgroups are past
  // their last wgmma: the tile in f32, then eight consecutive columns a
  // thread, with 16-byte loads and stores
  float* tile = reinterpret_cast<float*>(smem_raw + (ring.base - smem_u32(smem_raw)));
  stage_tile(tile, acc, active, tid);
  if (p.epilogue == EPI_GATE_RESIDUAL_BWD) {
    const auto staged = [&](int r0, int col, int rows, float (&v)[FLIGHT_TILE][8]) {
#pragma unroll
      for (int i = 0; i < FLIGHT_TILE; ++i) {
        if (i >= rows) break;
        const float4 lo = *reinterpret_cast<const float4*>(tile + (r0 + i) * LDT + col - n0);
        const float4 hi = *reinterpret_cast<const float4*>(tile + (r0 + i) * LDT + col - n0 + 4);
        v[i][0] = lo.x; v[i][1] = lo.y; v[i][2] = lo.z; v[i][3] = lo.w;
        v[i][4] = hi.x; v[i][5] = hi.y; v[i][6] = hi.z; v[i][7] = hi.w;
      }
    };
    gate_residual_tile<FLIGHT_TILE>(staged, tile + BM * LDT, p, m0, n0, tid);
    return;
  }
  epilogue_tile(tile, p.m, p.n, m0, n0, tid, [&](int row, int col, float (&v)[8]) { finish8(p, row, col, v); });
}

// split-K: sums the partials of every split in split order, then alpha and
// the epilogue; eight columns a thread
__global__ void __launch_bounds__(256) mp_gemm_reduce(const Params p) {
  const int64_t mn = static_cast<int64_t>(p.m) * p.n, chunks = mn / 8;
  for (int64_t i = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x; i < chunks;
       i += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    const int64_t e = 8 * i;
    float v[8];
    load8(p.partial, DT_F32, e, v);
    for (int z = 1; z < p.splits; ++z) {
      float u[8];
      load8(p.partial, DT_F32, z * mn + e, u);
#pragma unroll
      for (int j = 0; j < 8; ++j) v[j] += u[j];
    }
    finish8(p, static_cast<int>(e / p.n), static_cast<int>(e % p.n), v);
  }
}

// split-K with GATE_RESIDUAL_BWD: a block of 256 threads a 128 x 128
// tile, laid out as the product's epilogue, each (row, eight columns) the
// splits' partials summed in split order
__global__ void __launch_bounds__(CONSUMER_THREADS) mp_gemm_reduce_gate(const Params p) {
  __shared__ __align__(16) float partial[2 * GR_GROUPS * BN];
  const int64_t mn = static_cast<int64_t>(p.m) * p.n;
  const auto split_sums = [&](int r0, int col, int rows, float (&v)[GR_ROWS][8]) {
    // rows past ``rows`` read the last one again: no branch between the
    // loads of a split, so they are in flight together (loads behind a
    // branch each ran one after another: twice the pair's time at T = 4)
    const int64_t e = static_cast<int64_t>(blockIdx.y * BM + r0) * p.n + col;
#pragma unroll
    for (int i = 0; i < GR_ROWS; ++i) load8(p.partial, DT_F32, e + static_cast<int64_t>(min(i, rows - 1)) * p.n, v[i]);
    for (int z = 1; z < p.splits; ++z) {
      float w[GR_ROWS][8];
#pragma unroll
      for (int i = 0; i < GR_ROWS; ++i)
        load8(p.partial, DT_F32, z * mn + e + static_cast<int64_t>(min(i, rows - 1)) * p.n, w[i]);
#pragma unroll
      for (int i = 0; i < GR_ROWS; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) v[i][j] += w[i][j];
    }
  };
  gate_residual_tile<GR_ROWS>(split_sums, partial, p, blockIdx.y * BM, blockIdx.x * BN, threadIdx.x);
}

template <bool W_KN, bool F32>
cudaError_t launch(const CUtensorMap& ta, const CUtensorMap& tw, const Params& p, dim3 grid, cudaStream_t s) {
  static bool configured = false;
  if (!configured) {
    cudaError_t e =
        cudaFuncSetAttribute(mp_gemm_kernel<W_KN, F32>, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
    // all of the SM's unified memory as shared memory: room for two CTAs
    if (e == cudaSuccess) {
      e = cudaFuncSetAttribute(mp_gemm_kernel<W_KN, F32>, cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
    }
    if (e != cudaSuccess) return e;
    configured = true;
  }
  mp_gemm_kernel<W_KN, F32><<<grid, THREADS, SMEM_BYTES, s>>>(ta, tw, p);
  return cudaGetLastError();
}

int cdiv(int a, int b) { return (a + b - 1) / b; }

// Split count over the kt k steps of an (M, N) product: 1 when the tiles
// alone give every SM a CTA, else enough splits for two CTAs an SM, each at
// least three k steps deep, at most 8.
int splits_over(int m, int n, int kt) {
  const int tiles = cdiv(m, BM) * cdiv(n, BN);
  if (2 * tiles > SMS) return 1;
  int s = 2 * SMS / tiles;
  if (s > kt / 3) s = kt / 3;
  if (s > 8) s = 8;
  return s < 1 ? 1 : s;
}

}  // namespace

// Split count over K for a bf16 (M, N, K) product (k steps of 64), and for
// an f32 one (k steps of 32).
extern "C" int mp_gemm_splits(int m, int n, int k) { return splits_over(m, n, cdiv(k, BK)); }
extern "C" int mp_gemm_f32_splits(int m, int n, int k) { return splits_over(m, n, cdiv(k, BK_F32)); }

namespace {

// The product and its epilogue for the Params ``p`` (epilogue, C and the
// epilogue's operands set): encodes the maps, runs the prologue pass when A
// is f32 or modulated (bf16 form) or modulated (f32 form), the product, and
// with split-K the reduction. f32: the f32 form (f32 A and W (N, K)).
int run(const void* a, int a_dtype, const void* w, Params& p, int prologue, int w_kn, void* a_work, void* partial,
        void* stream, bool f32 = false) {
  const bool a_f32 = a_dtype == DT_F32, modulated = prologue == PRO_MODULATE;
  const void* a_tiles = (modulated || (a_f32 && !f32)) ? a_work : a;
  if (p.k % 8 || p.n % 8 || p.m < 1 || a_tiles == nullptr || (f32 && !a_f32) ||
      (reinterpret_cast<uintptr_t>(a) | reinterpret_cast<uintptr_t>(a_tiles) | reinterpret_cast<uintptr_t>(w)) % 16) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  CUtensorMap ta, tw;
  const bool maps_ok =
      f32 ? encode_f32_swizzled(&ta, a_tiles, p.m, p.k, BM, BK_F32) &&
                (w_kn ? encode_f32_swizzled(&tw, w, p.k, p.n, BK_F32, 32)
                      : encode_f32_swizzled(&tw, w, p.n, p.k, BN, BK_F32))
          : encode(&ta, a_tiles, p.m, p.k, BM, BK) &&
                (w_kn ? encode(&tw, w, p.k, p.n, BK, 64) : encode(&tw, w, p.n, p.k, BN, BK));
  if (!maps_ok) return static_cast<int>(cudaErrorInvalidValue);
  p.partial = static_cast<float*>(partial);
  p.kt = cdiv(p.k, f32 ? BK_F32 : BK);
  p.splits = splits_over(p.m, p.n, p.kt);
  if (p.splits > 1 && partial == nullptr) return static_cast<int>(cudaErrorInvalidValue);

  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (a_tiles != a) {
    const int64_t chunks = static_cast<int64_t>(p.m) * (p.k / 8);
    const int blocks = static_cast<int>(chunks / 256 + 1 < 8 * SMS ? chunks / 256 + 1 : 8 * SMS);
    if (f32) {
      mp_gemm_prologue_f32<<<blocks, 256, 0, s>>>(static_cast<const float*>(a),
                                                  static_cast<float4*>(const_cast<void*>(a_tiles)), p);
    } else {
      uint4* out = static_cast<uint4*>(const_cast<void*>(a_tiles));
      if (a_f32) {
        if (modulated) mp_gemm_prologue<true, true><<<blocks, 256, 0, s>>>(a, out, p);
        else mp_gemm_prologue<true, false><<<blocks, 256, 0, s>>>(a, out, p);
      } else {
        mp_gemm_prologue<false, true><<<blocks, 256, 0, s>>>(a, out, p);
      }
    }
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const dim3 grid(cdiv(p.n, BN), cdiv(p.m, BM), p.splits);
  cudaError_t e = f32    ? (w_kn ? launch<true, true>(ta, tw, p, grid, s) : launch<false, true>(ta, tw, p, grid, s))
                  : w_kn ? launch<true, false>(ta, tw, p, grid, s)
                         : launch<false, false>(ta, tw, p, grid, s);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (p.epilogue == EPI_GATE_RESIDUAL_BWD) {
    if (p.splits > 1) {
      mp_gemm_reduce_gate<<<dim3(grid.x, grid.y), CONSUMER_THREADS, 0, s>>>(p);
      e = cudaGetLastError();
    }
    if (e == cudaSuccess && p.tile_partial != nullptr) {
      const int64_t chunks = static_cast<int64_t>(p.m / p.tokens) * (p.n / 8);
      const int blocks = static_cast<int>(chunks / 256 + 1 < 4 * SMS ? chunks / 256 + 1 : 4 * SMS);
      mp_gemm_gate_sum<<<blocks, 256, 0, s>>>(p);
      e = cudaGetLastError();
    }
    return static_cast<int>(e);
  }
  if (p.splits == 1) return static_cast<int>(e);
  const int64_t chunks = static_cast<int64_t>(p.m) * p.n / 8;
  const int blocks = static_cast<int>(chunks / 256 + 1 < 4 * SMS ? chunks / 256 + 1 : 4 * SMS);
  mp_gemm_reduce<<<blocks, 256, 0, s>>>(p);
  return static_cast<int>(cudaGetLastError());
}

Params forward_params(void* c, int c_dtype, int m, int n, int k, float alpha, const void* mods, int mods_ld,
                      int shift_off, int scale_off, int gate_off, const void* gain, int tokens, int epilogue,
                      const void* x, int x_dtype) {
  Params p = {};
  p.c = c;
  p.c_dtype = c_dtype;
  p.m = m;
  p.n = n;
  p.k = k;
  p.alpha = alpha;
  p.mods = static_cast<const float*>(mods);
  p.mods_ld = mods_ld;
  p.shift_off = shift_off;
  p.scale_off = scale_off;
  p.gate_off = gate_off;
  p.gain = static_cast<const float*>(gain);
  p.tokens = tokens;
  p.epilogue = epilogue;
  p.x = x;
  p.x_dtype = x_dtype;
  return p;
}

}  // namespace

// a_work: an (M, K) bf16 buffer for the prologue pass, needed when A is f32
// or modulated; partial: (splits, M, N) f32, needed when mp_gemm_splits > 1.
extern "C" int mp_gemm(const void* a, int a_dtype, const void* w, void* c, int c_dtype, int m, int n, int k,
                       float alpha, int prologue, const void* mods, int mods_ld, int shift_off, int scale_off,
                       int gate_off, const void* gain, int tokens, int epilogue, const void* x, int x_dtype,
                       int w_kn, void* a_work, void* partial, void* stream) {
  if (epilogue == EPI_GATE_RESIDUAL_BWD) return static_cast<int>(cudaErrorInvalidValue);
  Params p = forward_params(c, c_dtype, m, n, k, alpha, mods, mods_ld, shift_off, scale_off, gate_off, gain, tokens,
                            epilogue, x, x_dtype);
  return run(a, a_dtype, w, p, prologue, w_kn, a_work, partial, stream);
}

// The f32 form: a f32 (M, K), w f32 (N, K) or, w_kn, (K, N), C f32 or bf16
// (c_dtype), the same prologue and epilogues; a_work: an (M, K) f32
// buffer, needed when modulated; partial: (splits, M, N) f32, needed when
// mp_gemm_f32_splits > 1. The residual backward has its own entry,
// mp_gemm_f32_gate_residual_bwd.
extern "C" int mp_gemm_f32(const void* a, const void* w, void* c, int c_dtype, int m, int n, int k, float alpha,
                           int prologue, const void* mods, int mods_ld, int shift_off, int scale_off, int gate_off,
                           const void* gain, int tokens, int epilogue, const void* x, int x_dtype, int w_kn,
                           void* a_work, void* partial, void* stream) {
  if (epilogue == EPI_GATE_RESIDUAL_BWD) return static_cast<int>(cudaErrorInvalidValue);
  Params p = forward_params(c, c_dtype, m, n, k, alpha, mods, mods_ld, shift_off, scale_off, gate_off, gain, tokens,
                            epilogue, x, x_dtype);
  return run(a, DT_F32, w, p, prologue, w_kn, a_work, partial, stream, true);
}

namespace {

// The residual backward's product and epilogue: bf16 attn, W and dout, or
// (f32) the f32 form's f32 attn, W and dout.
int gate_residual_bwd(const void* attn, const void* w, void* dout, void* dgate, int m, int n, int k, float alpha,
                      const void* rows, int rows_ld, int gate_off, const void* dy, int dy_dtype, int tokens,
                      void* partial, void* tile_partial, void* stream, bool f32) {
  const bool whole = tokens > 0 && BM % tokens == 0;
  if (tokens < 1 || (!whole && (tokens <= GR_ROWS || tile_partial == nullptr)) || m % tokens || rows_ld % 4 ||
      gate_off % 4 || reinterpret_cast<uintptr_t>(tile_partial) % 16 ||
      (reinterpret_cast<uintptr_t>(dout) | reinterpret_cast<uintptr_t>(dgate) | reinterpret_cast<uintptr_t>(rows) |
       reinterpret_cast<uintptr_t>(dy)) % 16) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const double t_res = 0.3, rd = sqrt((1.0 - t_res) * (1.0 - t_res) + t_res * t_res);
  Params p = {};
  p.c = dout;
  p.c_dtype = f32 ? DT_F32 : DT_BF16;
  p.m = m;
  p.n = n;
  p.k = k;
  p.alpha = alpha;
  p.mods = static_cast<const float*>(rows);
  p.mods_ld = rows_ld;
  p.gate_off = gate_off;
  p.tokens = tokens;
  p.epilogue = EPI_GATE_RESIDUAL_BWD;
  p.x = dy;
  p.x_dtype = dy_dtype;
  p.dgate = static_cast<float*>(dgate);
  p.db_fac = static_cast<float>(t_res / rd);
  p.tile_partial = whole ? nullptr : static_cast<float*>(tile_partial);
  return run(attn, f32 ? DT_F32 : DT_BF16, w, p, PRO_NONE, 0, nullptr, partial, stream, f32);
}

}  // namespace

// The attention backward's out product with the residual backward as its
// epilogue: out = attn . W^T * alpha (bf16 attn (M, K), W (N, K)), never
// stored; dout (M, N) bf16 = bf16(db*gate), dgate (M / tokens, N) f32 =
// sum over each sample's rows of db*out, db = dy*0.3/sqrt(0.58), the gate
// at column gate_off of the f32 rows (M / tokens, rows_ld). Takes tokens
// dividing 128 (a tile holds whole samples) or above 8 (a row group of 8
// meets at most two samples) and 16-byte aligned tensors; where tokens do
// not divide 128, tile_partial holds mp_gemm_gate_partial_floats floats.
extern "C" int mp_gemm_gate_residual_bwd(const void* attn, const void* w, void* dout, void* dgate, int m, int n,
                                         int k, float alpha, const void* rows, int rows_ld, int gate_off,
                                         const void* dy, int dy_dtype, int tokens, void* partial, void* tile_partial,
                                         void* stream) {
  return gate_residual_bwd(attn, w, dout, dgate, m, n, k, alpha, rows, rows_ld, gate_off, dy, dy_dtype, tokens,
                           partial, tile_partial, stream, false);
}

// Its f32 form (a float32 model: row 4 at dtype = float32): f32 attn (M,
// K), W (N, K) and dout (M, N), the product on the f32 pipes; partial:
// (mp_gemm_f32_splits, M, N) f32 where that is above 1. The rest as above.
extern "C" int mp_gemm_f32_gate_residual_bwd(const void* attn, const void* w, void* dout, void* dgate, int m, int n,
                                             int k, float alpha, const void* rows, int rows_ld, int gate_off,
                                             const void* dy, int dy_dtype, int tokens, void* partial,
                                             void* tile_partial, void* stream) {
  return gate_residual_bwd(attn, w, dout, dgate, m, n, k, alpha, rows, rows_ld, gate_off, dy, dy_dtype, tokens,
                           partial, tile_partial, stream, true);
}

// floats of mp_gemm_gate_residual_bwd's tile_partial for an (M, N) output
// at T = tokens: 0 where tokens divide 128
extern "C" int64_t mp_gemm_gate_partial_floats(int m, int n, int tokens) {
  if (tokens < 1 || BM % tokens == 0) return 0;
  return static_cast<int64_t>(cdiv(m, BM)) * gate_slots(tokens) * n;
}

extern "C" const char* mp_gemm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
