"""Tensor-parallel (TP) DiT block islands on Hopper: the three partial
kernels, their plain versions and the islands around them.

Port of the TP islands of ``mapdit_tpu/ops/pallas/dit_block.py``. Each rank
of a mesh's model axis holds a contiguous block of heads (and, under
``mega_tp``, of MLP hidden lanes) and computes the PARTIAL output of a
branch on it; one all-reduce over the model group sums the partials, and
the gated MP residual, linear in the branch, follows replicated in plain
PyTorch, as the JAX package runs it in plain ``jnp`` after its ``psum``.

  * row 6, ``attn_tp_partial`` (``_attn_tp_partial_impl``): modulate ->
    local qkv (N*T, 3*D_l) = h . W_qkv_l^T / sqrt(D) -> cosine attention
    over ``heads_local`` heads -> partial = attn . W_out_l^T / sqrt(D), f32;
  * row 7, ``block_tp_attn`` (``_block_tp_attn_impl``): the modulation head
    mods = a . W_mod^T / sqrt(D), f32 (N, 6D), the same on every rank, then
    row 6 with shift = mods[:, 0], scale = mods[:, 1], gain = gains[0] read
    from that buffer;
  * row 8, ``mlp_tp_partial`` (``_mlp_tp_partial_impl``): modulate -> local
    fc1 = h . W1_l^T / sqrt(D) -> MP-SiLU -> bf16 -> partial = . W2_l^T *
    inv_h, f32, with inv_h = 1/sqrt(H) of the GLOBAL hidden width.

On the card each is ONE persistent launch of ``csrc/dit_block_tp.cu``
and no other device operation: rows 6 and 7 run its ``tp_attn`` kernel
(row 7 with the modulation stage switched on), row 8 its ``tp_mlp``
kernel; :func:`tp_plan` lays out their work list, counters and scratch,
the launch reads the plan's words and its table of counter targets, and
the CPU tests walk the same plan. Each takes x and the weights all bf16 or
all f32 (a float32 model, as the Pallas kernels at ``dtype = float32``:
the f32 instances ``tp_attn_f32`` and ``tp_mlp_f32`` of
``csrc/dit_block_tp_f32.cu``, products on the f32 pipes, amod, attn and h
in f32, nothing rounded); a mixed set raises. The attention
kernel takes one tile of 64 queries and keys: at T > 64 rows 6 and 7 take
:func:`attn_tp_launch_sequence` / :func:`block_tp_launch_sequence` (the
route before the kernel, separate launches of ``mp_gemm`` and
``cosine_attention``), an explicit rule on the shape
(:func:`tp_attn_route`) counted under a key of its own; it never catches an
error. :func:`mlp_tp_launch_sequence` is row 8's former route, kept as the
yardstick.

The Pallas roundings are kept: the modulate's math in f32, products on
operands of the weights' type with f32 sums, f32 partials (bf16 partials
would put ~1e-3 relative error on the branch). shift and scale given as
rows (rows 6 and 8) are rounded to the weights' type, as the Pallas
kernels' one-hot row select does (the bf16 kernels round them as they read
them in place; in f32 nothing is rounded); row 7 reads its f32 modulation
rows as they are.

Each wrapper takes its kernel for a CUDA tensor (and raises on what it does
not take) and its plain version for a CPU tensor. ``LAUNCHES`` counts, on
the card: wrapper calls (``attn_tp_partial``, ``block_tp_attn``,
``mlp_tp_partial``), launches of the two kernels (``dit_block_tp/attn``,
``dit_block_tp/mlp``) and calls that took a launch sequence
(``<row>/sequence``; the sequence's own ``mp_gemm`` and
``cosine_attention`` launches are counted in ``dit_block.LAUNCHES``). The
islands are inference-only, as in the JAX package: under autograd with an
input that requires grad they raise instead of cutting the graph.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import math
from typing import Optional

import torch
import torch.distributed as dist

from mapdit_tpu_torch.ops.cuda.dit_block import (
    ATTENTION_HEAD_WIDTHS,
    H100_SMS,
    RES_DENOM,
    RES_T,
    STACK_K,
    STACK_TILE,
    StackProduct,
    _cdiv,
    _raise_on,
    _require_cuda,
    cosine_attention,
    cosine_attention_plain,
    mp_gemm,
    mp_gemm_plain,
    needs_grad,
)

LAUNCHES = {
    "attn_tp_partial": 0,
    "block_tp_attn": 0,
    "mlp_tp_partial": 0,
    "dit_block_tp/attn": 0,
    "dit_block_tp/mlp": 0,
    "attn_tp_partial/sequence": 0,
    "block_tp_attn/sequence": 0,
    "mlp_tp_partial/sequence": 0,
}


def reset_launch_counts() -> None:
    for key in LAUNCHES:
        LAUNCHES[key] = 0


def _gain(gain, device) -> torch.Tensor:
    """One f32 device value, as the kernels read it."""
    return torch.as_tensor(gain, dtype=torch.float32, device=device).detach().reshape(1).contiguous()


def _rows(shift, scale, dtype) -> torch.Tensor:
    """(N, 2D) f32 rows [shift | scale], rounded to the weights' type."""
    return torch.cat([shift, scale], dim=1).to(dtype).float().contiguous()


def check_types(what: str, *tensors) -> None:
    """Off the CPU: the tensors (x and the weights) all bf16 (the bf16
    forms) or all f32 (the f32 forms), the rule of the Pallas kernels,
    which take the weights' type; a mixed set raises."""
    types = {z.dtype for z in tensors}
    if tensors[0].device.type != "cpu" and types not in ({torch.bfloat16}, {torch.float32}):
        raise ValueError(f"the CUDA {what} kernels and their launch sequences take x and the weights all bf16 "
                         f"(the bf16 forms) or all f32 (the f32 forms), got {sorted(str(z) for z in types)}")


def _check(x, w_in, w_out, n_rows, what, *more):
    n, t, d = x.shape
    if w_in.shape[1] != d or w_out.shape[0] != d or w_out.shape[1] * n_rows != w_in.shape[0]:
        raise ValueError(f"{what}: weights {tuple(w_in.shape)}, {tuple(w_out.shape)} do not fit D={d}")
    check_types(f"{what} (rows 6-8)", x, w_in, w_out, *more)


def _check_heads(d_l, heads_local):
    if d_l % heads_local:
        raise ValueError(f"D_l={d_l} does not split into {heads_local} heads")


def _check_block(x, a, gains, w_mod):
    n, _, d = x.shape
    if w_mod.shape != (6 * d, d) or a.shape != (n, d) or gains.shape != (2,):
        raise ValueError(f"w_mod must be (6D, D), a (N, D) and gains (2,), got {tuple(w_mod.shape)}, "
                         f"{tuple(a.shape)}, {tuple(gains.shape)}")


# ---------------------------------------------------------------------------
# the plain versions and the launch sequences


def _attn_partial(x, mods, shift_off, scale_off, gain, w_qkv_l, w_out_l, heads_local, gemm, attention):
    """modulate -> local qkv -> cosine attention -> f32 partial out-projection."""
    n, t, d = x.shape
    _check_heads(w_out_l.shape[1], heads_local)
    inv_d = 1.0 / math.sqrt(d)
    qkv = gemm(
        x.reshape(n * t, d), w_qkv_l, alpha=inv_d, out_dtype=torch.float32,
        modulate=(mods, shift_off, scale_off, gain), tokens=t, site="qkv",
    )
    attn = attention(qkv, t, heads_local, w_qkv_l.dtype)
    return gemm(attn, w_out_l, alpha=inv_d, out_dtype=torch.float32, site="out").reshape(n, t, d)


def _attn_tp_partial(x, shift, scale, gain, w_qkv_l, w_out_l, heads_local, gemm, attention):
    _check(x, w_qkv_l, w_out_l, 3, "attn_tp_partial")
    d = x.shape[-1]
    rows = _rows(shift, scale, w_qkv_l.dtype)
    return _attn_partial(
        x.contiguous(), rows, 0, d, _gain(gain, x.device), w_qkv_l.contiguous(), w_out_l.contiguous(),
        heads_local, gemm, attention,
    )


def attn_tp_partial_plain(x, shift, scale, gain, w_qkv_l, w_out_l, heads_local: int):
    """Plain version of :func:`attn_tp_partial`."""
    return _attn_tp_partial(
        x, shift, scale, gain, w_qkv_l, w_out_l, heads_local, mp_gemm_plain, cosine_attention_plain
    )


def attn_tp_launch_sequence(x, shift, scale, gain, w_qkv_l, w_out_l, heads_local: int):
    """Row 6 as three launches (``mp_gemm`` with the modulate prologue,
    ``cosine_attention``, ``mp_gemm`` into f32): the route of
    :func:`attn_tp_partial` at T > 64 and the yardstick of its kernel."""
    out = _attn_tp_partial(x, shift, scale, gain, w_qkv_l, w_out_l, heads_local, mp_gemm, cosine_attention)
    if x.device.type == "cuda":
        LAUNCHES["attn_tp_partial/sequence"] += 1
    return out


def _block_tp_attn(x, a, gains, w_mod, w_qkv_l, w_out_l, heads_local, gemm, attention):
    _check(x, w_qkv_l, w_out_l, 3, "block_tp_attn", a, w_mod)
    _check_block(x, a, gains, w_mod)
    n, t, d = x.shape
    mods = gemm(a.contiguous(), w_mod.contiguous(), alpha=1.0 / math.sqrt(d), out_dtype=torch.float32,
                site="modulation")
    gains = gains.detach().float().contiguous()
    partial = _attn_partial(
        x.contiguous(), mods, 0, d, gains[0:1], w_qkv_l.contiguous(), w_out_l.contiguous(), heads_local,
        gemm, attention,
    )
    return partial, mods.reshape(n, 6, d)


def block_tp_attn_plain(x, a, gains, w_mod, w_qkv_l, w_out_l, heads_local: int):
    """Plain version of :func:`block_tp_attn`."""
    return _block_tp_attn(x, a, gains, w_mod, w_qkv_l, w_out_l, heads_local, mp_gemm_plain, cosine_attention_plain)


def block_tp_launch_sequence(x, a, gains, w_mod, w_qkv_l, w_out_l, heads_local: int):
    """Row 7 as four launches (the modulation ``mp_gemm``, then row 6's
    three): the route of :func:`block_tp_attn` at T > 64 and the yardstick
    of its kernel."""
    out = _block_tp_attn(x, a, gains, w_mod, w_qkv_l, w_out_l, heads_local, mp_gemm, cosine_attention)
    if x.device.type == "cuda":
        LAUNCHES["block_tp_attn/sequence"] += 1
    return out


def _mlp_tp_partial(x, shift, scale, gains, w1_l, w2_l, inv_h, gemm):
    _check(x, w1_l, w2_l, 1, "mlp_tp_partial")
    n, t, d = x.shape
    rows = _rows(shift, scale, w1_l.dtype)
    gain = _gain(torch.as_tensor(gains)[1], x.device)
    h = gemm(
        x.contiguous().reshape(n * t, d), w1_l.contiguous(), alpha=1.0 / math.sqrt(d), out_dtype=w1_l.dtype,
        modulate=(rows, 0, d, gain), silu=True, tokens=t, site="fc1",
    )
    return gemm(h, w2_l.contiguous(), alpha=inv_h, out_dtype=torch.float32, site="fc2").reshape(n, t, d)


def mlp_tp_partial_plain(x, shift, scale, gains, w1_l, w2_l, inv_h: float):
    """Plain version of :func:`mlp_tp_partial`."""
    return _mlp_tp_partial(x, shift, scale, gains, w1_l, w2_l, inv_h, mp_gemm_plain)


def mlp_tp_launch_sequence(x, shift, scale, gains, w1_l, w2_l, inv_h: float):
    """Row 8 as two launches of ``mp_gemm`` (fc1 with the modulate prologue
    and the MP-SiLU, fc2 into f32), each with its prologue pass and split-K
    reduction: the route before the kernel, the yardstick of it."""
    out = _mlp_tp_partial(x, shift, scale, gains, w1_l, w2_l, inv_h, mp_gemm)
    if x.device.type == "cuda":
        LAUNCHES["mlp_tp_partial/sequence"] += 1
    return out


# ---------------------------------------------------------------------------
# the plan of one launch

# the attention stage takes one tile of 64 queries and keys (dit_stack's
# streams its keys and goes further: its limit is not this one)
TP_MAX_T = 64
TP_PRE_ROWS = 4  # token rows of a pre item
TP_MAX_SPLITS = 8
# k steps a split keeps at least: a list product's split partials cost a
# round trip through L2 (~5 us a tile on the H100: store, ticket, the last
# split's sums), which a split of fewer than 18 k steps did not win back at
# the XL/2 shards (variants measured from copies of the kernel; PERF.md);
# the modulation product runs before the grid barrier, where 9 did
TP_MIN_SPLIT_K = 18
TP_MIN_SPLIT_K_MODULATION = 9
# The f32 instances count k steps of 32 (a stage's 128-byte rows of f32),
# each ~6-8 us of an SM on the f32 pipes, longer than a split's round trip:
# their products split K as far as ends their items soonest, past one wave
# where that pays (_f32_splits), a round trip costing TP_F32_SPLIT_COST k
# steps, each split keeping at least TP_F32_MIN_SPLIT_K
TP_F32_SPLIT_COST = 1
TP_F32_MIN_SPLIT_K = 3
# the sync words: [0] the grid barrier (row 7), [TP_SYNC_EXIT] the CTAs that
# have left (the last zeroes the sync words), then from word TP_SYNC_DONE one
# counter a stage and row tile (8 words apart), then the tile tickets of
# every split product
TP_SYNC_EXIT = 8
TP_SYNC_DONE = 32
# the plan's words the launch reads (csrc/dit_block_tp.cu P_* and PS_*): a
# header of 8, then 6 a stage (kind, items, K splits, counter word, ticket
# word, target offset) for up to 4 stages
TP_PLAN_HEADER = 8
TP_PLAN_STAGE_WORDS = 6
TP_PLAN_WORDS = TP_PLAN_HEADER + 4 * TP_PLAN_STAGE_WORDS
# a product stage is kind 1; attention_bwd is the attention half-block's
# backward list's (ops/cuda/attn_branch.py branch_plan)
TP_STAGE_KINDS = {"pre": 0, "attention": 2, "attention_bwd": 3}
TP_TRACE_WORDS = 16  # a CTA's ns by stage and part of its items, its start and end (csrc/dit_block_tp.cu)
# the kernels of csrc/dit_block_tp.cu: rows 6 and 7, row 8, and row 9
# (``mlp_block.fused_mlp_branch``: the MLP half-block at full width)
TP_KERNELS = ("attn", "mlp", "mlp_branch")
# row 9's tiles: 256 columns, on ring stages of a 128 x 64 A tile and a
# 256 x 64 W tile of bf16; a pre item takes the most of MLP_PRE_ROWS token
# rows whose rows of x (ceil(D / 64) boxes of 64 columns) fill one stage.
# Its f32 form runs on the TP kernels' f32 instance: 128-column tiles, pre
# items of the same token rows (read through the read-only path)
MLP_WIDE = 256
MLP_STAGE_BYTES = (STACK_TILE + MLP_WIDE) * STACK_K * 2
MLP_PRE_ROWS = (32, 16, 8)


def tp_attn_route(tokens: int) -> str:
    """Rows 6 and 7 on the card: ``"kernel"`` (one launch of ``tp_attn``) for
    T <= 64, ``"sequence"`` (the launch sequence) above; the kernel's
    attention stage holds one tile of 64 queries and keys."""
    return "kernel" if tokens <= TP_MAX_T else "sequence"


def check_tp_shape(kernel: str, tokens: int, d: int, width: int, heads: int = 0) -> None:
    """Raise unless ``csrc/dit_block_tp.cu``'s ``kernel`` (one of
    TP_KERNELS) takes T tokens of width D and a width ``width`` (D_l in
    ``heads`` heads, H_l, or row 9's H): D and that width multiples of 8 (TMA rows of 16
    bytes, 16-byte accesses); for the attention, head widths 64 and 72 (the
    tiles' template instances, every registry model's) and an even T <= 64
    (one tile of queries and keys)."""
    if kernel not in TP_KERNELS:
        raise ValueError(f"kernel must be one of {TP_KERNELS}, got {kernel!r}")
    if d % 8 or width % 8:
        raise ValueError(f"dit_block_tp on CUDA takes D and the local width multiples of 8, got D={d}, {width}")
    if kernel == "attn":
        hd = width // heads if heads > 0 else 0
        if heads < 1 or width % heads or hd not in ATTENTION_HEAD_WIDTHS:
            raise ValueError(f"dit_block_tp on CUDA takes head widths {ATTENTION_HEAD_WIDTHS}, got D_l={width} in "
                             f"{heads} heads")
        if tokens > TP_MAX_T or tokens % 2 or tokens < 2:
            raise ValueError(f"dit_block_tp's attention kernel on CUDA takes an even T <= {TP_MAX_T}, got {tokens}")


@dataclasses.dataclass(frozen=True)
class TpStage:
    """One stage of the work list: ``pre`` (the modulate, the plan's
    ``pre_rows`` token rows an item), a product (``qkv``, ``out``, ``fc1``, ``fc2``) or ``attention``
    (two (sample, head) units an item)."""

    name: str
    items: int
    product: Optional[StackProduct] = None


@dataclasses.dataclass(frozen=True, eq=False)
class TpPlan:
    """The work of one launch of ``csrc/dit_block_tp.cu``: the grid, row 7's
    modulation product (run before a grid barrier), the stages of the work
    list in order, the tickets of the split products (word offsets from the
    sync words), and the layout of the scratch buffer a call takes (byte
    offsets). The sync words live in a buffer of the plan's own on the card
    (:meth:`table`: the sync words, zero, then each stage's counter targets),
    which the launch leaves zeroed again; the launch reads :meth:`words`.
    CTA c takes list items c, c + ctas, ..., as the kernel does. Plans
    compare by identity (:func:`tp_plan` gives one object per shape)."""

    kernel: str
    ctas: int
    samples: int
    tokens: int
    heads: int
    pre_rows: int
    modulation: Optional[StackProduct]
    stages: tuple
    tickets: dict
    sync_words: int
    layout: dict
    workspace_bytes: int

    @property
    def m(self) -> int:
        return self.samples * self.tokens

    @property
    def row_tiles(self) -> int:
        return _cdiv(self.m, STACK_TILE)

    @property
    def items(self) -> int:
        return sum(s.items for s in self.stages)

    def start(self, i: int) -> int:
        """Global index of stage i's first item."""
        return sum(s.items for s in self.stages[:i])

    def locate(self, g: int) -> tuple:
        """(stage index, index in the stage) of global item g."""
        for i, stage in enumerate(self.stages):
            if g < stage.items:
                return i, g
            g -= stage.items
        raise IndexError(g)

    def stage(self, name: str) -> TpStage:
        return next(s for s in self.stages if s.name == name)

    @property
    def products(self) -> tuple:
        """The list's products in order (row 7's modulation product is not
        one of its stages)."""
        return tuple(s.product for s in self.stages if s.product is not None)

    @property
    def pre_items(self) -> int:
        return self.stages[0].items

    def counter_word(self, i: int, r: int) -> int:
        """Sync word of stage i's counter of row tile r."""
        return TP_SYNC_DONE + 8 * (i * self.row_tiles + r)

    def _sample_tiles(self, sample: int) -> range:
        t = self.tokens
        return range(sample * t // STACK_TILE, (sample * t + t - 1) // STACK_TILE + 1)

    def units(self, j: int) -> tuple:
        """The (sample * heads + head) units of attention item j."""
        return tuple(u for u in (2 * j, 2 * j + 1) if u < self.samples * self.heads)

    def rows_of(self, i: int, j: int) -> tuple:
        """The row tiles whose stage-i counter item j adds one to, once for
        each time it does (an attention unit: each row tile its sample has
        rows in)."""
        stage = self.stages[i]
        if stage.name == "pre":
            return (j * self.pre_rows // STACK_TILE,)
        if stage.product is not None:
            return (stage.product.item(j)[0],)
        return tuple(r for u in self.units(j) for r in self._sample_tiles(u // self.heads))

    def per_row(self, i: int, r: int) -> int:
        """What stage i's counter of row tile r reaches once the stage is
        done there (the kernel's per_row)."""
        stage = self.stages[i]
        if stage.name == "pre":
            per_tile = STACK_TILE // self.pre_rows
            return min(stage.items, (r + 1) * per_tile) - r * per_tile
        if stage.product is not None:
            p = stage.product
            return p.col_tiles * p.splits
        first = r * STACK_TILE // self.tokens
        last = min(self.samples, (r * STACK_TILE + STACK_TILE + self.tokens - 1) // self.tokens) - 1
        return (last - first + 1) * self.heads

    def waits(self, i: int, j: int) -> tuple:
        """What item j of stage i waits for before it reads: (stage, row
        tile, count) of the previous stage's counters of the rows it reads."""
        if i == 0:
            return ()
        stage = self.stages[i]
        if stage.product is not None:
            rows = (stage.product.item(j)[0],)
        else:
            rows = tuple(r for u in self.units(j) for r in self._sample_tiles(u // self.heads))
        return tuple((i - 1, r, self.per_row(i - 1, r)) for r in rows)

    def walk(self):
        """What each CTA computes, in the kernel's order: the modulation
        product's items (stage ``modulation``), then its list items. Per CTA
        a list of (stage, index in the stage, what: the product item as
        :meth:`StackProduct.item` gives it, a pre item's token rows, or the
        attention item's units)."""
        out = [[] for _ in range(self.ctas)]
        if self.modulation is not None:
            for j in range(self.modulation.items):
                out[j % self.ctas].append(("modulation", j, self.modulation.item(j)))
        for g in range(self.items):
            i, j = self.locate(g)
            stage = self.stages[i]
            if stage.name == "pre":
                what = (j * self.pre_rows, min(self.m, (j + 1) * self.pre_rows))
            elif stage.product is not None:
                what = stage.product.item(j)
            else:
                what = self.units(j)
            out[g % self.ctas].append((stage.name, j, what))
        return out

    @property
    def trace_words(self) -> int:
        return TP_TRACE_WORDS * self.ctas

    def target_offset(self, i: int) -> int:
        """Word of the buffer where stage i's targets (one a row tile) lie."""
        return self.sync_words + i * self.row_tiles

    @property
    def buffer_words(self) -> int:
        return self.target_offset(len(self.stages))

    def table(self) -> tuple:
        """The plan's buffer as it stands between launches: the sync words,
        zero, then :meth:`per_row` of every stage and row tile."""
        targets = [self.per_row(i, r) for i in range(len(self.stages)) for r in range(self.row_tiles)]
        return (0,) * self.sync_words + tuple(targets)

    def words(self) -> tuple:
        """The words the launch reads (TP_PLAN_WORDS, or more for a longer
        list): stages, sync words, buffer words, CTAs, the modulation
        product's splits and ticket word (0, 0 without it; row 9's kernels
        have the token rows of a pre item in the first; the attention half-block's
        kernels their dgain ticket word (0 forward) and the token rows of a
        pre item), then for each stage its kind, items,
        K splits, counter word of row tile 0, ticket word (0 unsplit) and
        target offset."""
        mods = self.modulation
        if self.kernel.startswith("branch_"):
            first, second = self.tickets.get("dgain", 0), self.pre_rows
        else:
            first = self.pre_rows if self.kernel.startswith("mlp_branch") else mods.splits if mods else 0
            second = self.tickets.get("modulation", 0) if mods else 0
        out = [len(self.stages), self.sync_words, self.buffer_words, self.ctas, first, second, 0, 0]
        for i, stage in enumerate(self.stages):
            p = stage.product
            out += [1 if p else TP_STAGE_KINDS[stage.name], stage.items, p.splits if p else 1,
                    self.counter_word(i, 0), self.tickets.get(stage.name, 0), self.target_offset(i)]
        return tuple(out + [0] * (TP_PLAN_WORDS - len(out)))


def _f32_splits(tiles: int, kt: int, ctas: int) -> int:
    """K splits of an f32 product of ``tiles`` output tiles of ``kt`` k
    steps on ``ctas`` CTAs: the count whose items end soonest, in k steps
    (waves of tiles x splits items, each its k steps plus, split, a round
    trip of TP_F32_SPLIT_COST), at most TP_MAX_SPLITS, at least
    TP_F32_MIN_SPLIT_K k steps a split; the fewest splits of equal cost."""
    def cost(s):
        return _cdiv(tiles * s, ctas) * (_cdiv(kt, s) + (TP_F32_SPLIT_COST if s > 1 else 0))

    fits = [s for s in range(1, TP_MAX_SPLITS + 1) if s == 1 or _cdiv(kt, s) >= TP_F32_MIN_SPLIT_K]
    return min(fits, key=lambda s: (cost(s), s))


@functools.lru_cache(maxsize=None)
def tp_plan(kernel: str, n: int, t: int, d: int, width: int, heads: int = 0, modulation: bool = False,
            ctas: int = H100_SMS, f32: bool = False) -> TpPlan:
    """The plan of one launch for N samples of T tokens at width D: the
    attention kernel (``"attn"``: ``width`` = D_l in ``heads`` local heads;
    ``modulation`` switches on row 7's stage), the MLP kernel (``"mlp"``:
    ``width`` = H_l) or row 9's (``"mlp_branch"``: ``width`` = H, the
    products on MLP_WIDE-column tiles, pre items of the most of
    MLP_PRE_ROWS token rows whose rows of x fill one ring stage), on
    ``ctas`` resident CTAs. A product splits K only as far as one wave
    takes, into at most TP_MAX_SPLITS splits of at least TP_MIN_SPLIT_K k
    steps (TP_MIN_SPLIT_K_MODULATION for row 7's modulation product).
    ``f32``: the f32 instances' plan (``csrc/dit_block_tp_f32.cu``): k steps
    of 32, splits by :func:`_f32_splits`, amod, attn and h in f32 scratch,
    and row 9 on 128-column tiles with the bf16 form's pre rows."""
    if kernel not in TP_KERNELS or (modulation and kernel != "attn"):
        raise ValueError(f"no plan for kernel {kernel!r} with modulation={modulation}")
    m = n * t
    e = 4 if f32 else 2  # bytes of an element of x, amod, attn and h
    k_step = 128 // e  # a stage's rows of 128 bytes
    tile_cols = MLP_WIDE if kernel == "mlp_branch" and not f32 else STACK_TILE
    pre_rows = TP_PRE_ROWS
    if kernel == "mlp_branch":
        pre_rows = next((r for r in MLP_PRE_ROWS if _cdiv(d, 64) * r * 128 <= MLP_STAGE_BYTES), 0)
        if not pre_rows:
            raise ValueError(f"no plan at D={d}: not eight rows of x fit a ring stage")

    def product(name, rows, cols, k):
        width = STACK_TILE if name == "modulation" else tile_cols
        tiles = _cdiv(rows, STACK_TILE) * _cdiv(cols, width)
        if f32:
            return StackProduct(name, rows, cols, k, _f32_splits(tiles, _cdiv(k, k_step), ctas), width, k_step)
        min_k = TP_MIN_SPLIT_K_MODULATION if name == "modulation" else TP_MIN_SPLIT_K
        fit = 1 if tiles >= ctas else min(ctas // tiles, _cdiv(k, k_step) // min_k)
        return StackProduct(name, rows, cols, k, max(1, min(fit, TP_MAX_SPLITS)), width, k_step)

    pre = TpStage("pre", _cdiv(m, pre_rows))
    mods = product("modulation", n, 6 * d, d) if modulation else None
    if kernel == "attn":
        first, second = product("qkv", m, 3 * width, d), product("out", m, d, width)
        stages = (pre, TpStage("qkv", first.items, first), TpStage("attention", _cdiv(n * heads, 2)),
                  TpStage("out", second.items, second))
        mid = {"qkv": m * 3 * width * 4, "attn": m * width * e}
    else:
        first, second = product("fc1", m, width, d), product("fc2", m, d, width)
        stages = (pre, TpStage("fc1", first.items, first), TpStage("fc2", second.items, second))
        mid = {"h": m * width * e}
        heads = 0
    split = [p for p in (mods, first, second) if p is not None and p.splits > 1]
    words = TP_SYNC_DONE + 8 * len(stages) * _cdiv(m, STACK_TILE)
    tickets = {}
    for p in split:
        tickets[p.name] = words
        words += p.tiles
    sizes = {"amod": m * d * e, **mid}
    sizes.update({f"partial_{p.name}": p.splits * p.m * p.n * 4 for p in split})
    layout, offset = {}, 0
    for name, size in sizes.items():
        layout[name] = offset
        offset += _cdiv(size, 256) * 256
    return TpPlan(
        kernel=f"{kernel}{'_f32' if f32 else ''}", ctas=ctas, samples=n, tokens=t, heads=heads, pre_rows=pre_rows,
        modulation=mods, stages=stages, tickets=tickets, sync_words=words, layout=layout, workspace_bytes=offset,
    )


def _library(f32: bool):
    """The bf16 kernels' library, or (``f32``) the f32 instances'."""
    from mapdit_tpu_torch.ops.cuda import build

    return build.library("dit_block_tp_f32" if f32 else "dit_block_tp")


@functools.lru_cache(maxsize=None)
def _resident_ctas(device_index: int, hd: int, f32: bool = False) -> int:
    """CTAs of the TP kernel of head width ``hd`` (0: tp_mlp, and row 9's
    f32 form) resident at once on the device, in bf16 or (``f32``) of the
    f32 instance."""
    lib = _library(f32)
    with torch.cuda.device(device_index):
        ctas = (lib.dit_block_tp_resident_ctas_f32 if f32 else lib.dit_block_tp_resident_ctas)(hd)
    if ctas < 1:
        _raise_on(-ctas, lib, "dit_block_tp")
    return ctas


def _aligned(*tensors) -> None:
    if any(z is not None and z.data_ptr() % 16 for z in tensors):
        raise ValueError("dit_block_tp on CUDA reads its operands with TMA and 16-byte loads: they must be "
                         "16-byte aligned")


@functools.lru_cache(maxsize=None)
def _launch_state(plan: TpPlan, device_index: int) -> tuple:
    """The plan's words for the launch (host) and its buffer on the card:
    made once a plan and device (a copy to the card, so not while a CUDA
    graph is being captured); the kernel leaves the buffer's sync words
    zeroed after every launch."""
    if torch.cuda.is_current_stream_capturing():
        raise RuntimeError("dit_block_tp: call the kernel once at this shape before capturing a CUDA graph (its "
                           "plan's buffer is copied to the card at the first call)")
    words = plan.words()
    buffer = torch.tensor(plan.table(), dtype=torch.int32, device=torch.device("cuda", device_index))
    return (ctypes.c_int * len(words))(*words), buffer


def _scratch(plan: TpPlan, work: torch.Tensor, name: str):
    return work.data_ptr() + plan.layout[name] if name in plan.layout else None


def _trace_ptr(plan: TpPlan, trace, device):
    if trace is None:
        return None
    if trace.dtype != torch.int64 or trace.numel() < plan.trace_words or trace.device != device:
        raise ValueError(f"trace must be int64 with {plan.trace_words} words on {device}")
    return trace.data_ptr()


def _row_operands(x, *rows) -> tuple:
    """The modulation rows, shift and scale (row 9: and the gate), each (N,
    D), as the kernels read them in place: f32 or bf16 (one type), a
    sample's row at a stride of whole 16-byte chunks. Returns (*rows, bf16
    or not); a view that does not fit is copied (no path of the port passes
    one)."""
    n, _, d = x.shape
    dtype = rows[0].dtype
    if any(z.dtype != dtype for z in rows) or dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"the CUDA dit_block_tp kernels take their modulation rows as f32 or bf16 of one type, got "
                         f"{[z.dtype for z in rows]}")
    if any(z.shape != (n, d) for z in rows):
        raise ValueError(f"the modulation rows must be (N, D) = {(n, d)}, got {[tuple(z.shape) for z in rows]}")
    if any(z.device != x.device for z in rows):
        raise ValueError("the modulation rows must lie on x's CUDA device")
    per16 = 16 // rows[0].element_size()
    rows = tuple(z if z.stride(1) == 1 and z.stride(0) % per16 == 0 and z.data_ptr() % 16 == 0
                 else z.clone(memory_format=torch.contiguous_format) for z in rows)
    return (*rows, dtype == torch.bfloat16)


def tp_attn(x, shift, scale, gain, w_qkv_l, w_out_l, heads_local: int, *, a=None, w_mod=None,
            trace: Optional[torch.Tensor] = None):
    """One launch of ``tp_attn`` (``csrc/dit_block_tp.cu``) on CUDA tensors:
    x (N, T, D), w_qkv_l and w_out_l all bf16, or all f32 (the f32 instance
    ``tp_attn_f32``); shift, scale (N, D) f32 (the bf16 kernel rounds them
    to bf16 as it reads them) or bf16, or both None with ``a`` (N, D) and
    ``w_mod`` (6D, D) of x's type given (row 7: the kernel writes mods (N,
    6D) f32 first and reads shift and scale from it); gain a one-element f32
    tensor. Returns the f32 partial (N, T, D), and with ``a`` also the mods.
    ``trace``: int64 of the plan's ``trace_words`` (each CTA's ns by
    stage)."""
    n, t, d = x.shape
    d_l = w_out_l.shape[1]
    modulated = a is not None
    operands = [x, gain, w_qkv_l, w_out_l] + ([a, w_mod] if modulated else [])
    check_types("tp_attn", x, w_qkv_l, w_out_l, *([a, w_mod] if modulated else []))
    _require_cuda(*operands)
    check_tp_shape("attn", t, d, d_l, heads_local)
    f32 = x.dtype == torch.float32
    if gain.dtype != torch.float32 or gain.numel() != 1:
        raise ValueError("the modulate gain must be one f32 value")
    if modulated:
        rows, rows_bf16 = (None, 0, None, 0), False
    else:
        shift, scale, rows_bf16 = _row_operands(x, shift, scale)
        rows = (shift.data_ptr(), shift.stride(0), scale.data_ptr(), scale.stride(0))
    _aligned(*(z for z in operands if z is not gain))  # the gain is read as one float
    plan = tp_plan("attn", n, t, d, d_l, heads_local, modulated,
                   _resident_ctas(x.get_device(), d_l // heads_local, f32), f32)
    words, buffer = _launch_state(plan, x.get_device())
    lib = _library(f32)
    work = torch.empty(plan.workspace_bytes, dtype=torch.uint8, device=x.device)
    out = torch.empty(n, t, d, dtype=torch.float32, device=x.device)
    mods = torch.empty(n, 6 * d, dtype=torch.float32, device=x.device) if modulated else None
    code = (lib.tp_attn_f32 if f32 else lib.tp_attn)(
        x.data_ptr(), a.data_ptr() if modulated else None, w_mod.data_ptr() if modulated else None,
        w_qkv_l.data_ptr(), w_out_l.data_ptr(),
        *rows, rows_bf16,
        gain.data_ptr(), out.data_ptr(), mods.data_ptr() if modulated else None,
        *(_scratch(plan, work, name) for name in ("amod", "qkv", "attn", "partial_modulation", "partial_qkv",
                                                  "partial_out")),
        buffer.data_ptr(), words, n, t, d, d_l, heads_local, plan.ctas, 1.0 / math.sqrt(d),
        torch.cuda.current_stream(x.device).cuda_stream, _trace_ptr(plan, trace, x.device),
    )
    _raise_on(code, lib, "tp_attn", "dit_block_tp")
    LAUNCHES["dit_block_tp/attn"] += 1
    return (out, mods) if modulated else out


def tp_mlp(x, shift, scale, gain, w1_l, w2_l, inv_h: float, *, trace: Optional[torch.Tensor] = None):
    """One launch of ``tp_mlp`` (``csrc/dit_block_tp.cu``) on CUDA tensors:
    x (N, T, D), w1_l (H_l, D) and w2_l (D, H_l) all bf16, or all f32 (the
    f32 instance ``tp_mlp_f32``); shift and scale as for :func:`tp_attn`'s
    row 6, gain a one-element f32 tensor; returns the f32 partial (N, T, D).
    ``trace`` as for :func:`tp_attn`."""
    n, t, d = x.shape
    h_l = w1_l.shape[0]
    operands = [x, gain, w1_l, w2_l]
    check_types("tp_mlp", x, w1_l, w2_l)
    _require_cuda(*operands)
    check_tp_shape("mlp", t, d, h_l)
    f32 = x.dtype == torch.float32
    if gain.dtype != torch.float32 or gain.numel() != 1:
        raise ValueError("the modulate gain must be one f32 value")
    shift, scale, rows_bf16 = _row_operands(x, shift, scale)
    _aligned(*(z for z in operands if z is not gain))
    plan = tp_plan("mlp", n, t, d, h_l, ctas=_resident_ctas(x.get_device(), 0, f32), f32=f32)
    words, buffer = _launch_state(plan, x.get_device())
    lib = _library(f32)
    work = torch.empty(plan.workspace_bytes, dtype=torch.uint8, device=x.device)
    out = torch.empty(n, t, d, dtype=torch.float32, device=x.device)
    code = (lib.tp_mlp_f32 if f32 else lib.tp_mlp)(
        x.data_ptr(), w1_l.data_ptr(), w2_l.data_ptr(), shift.data_ptr(), shift.stride(0), scale.data_ptr(),
        scale.stride(0), rows_bf16, gain.data_ptr(), out.data_ptr(),
        *(_scratch(plan, work, name) for name in ("amod", "h", "partial_fc1", "partial_fc2")),
        buffer.data_ptr(), words, n, t, d, h_l, plan.ctas, 1.0 / math.sqrt(d), float(inv_h),
        torch.cuda.current_stream(x.device).cuda_stream, _trace_ptr(plan, trace, x.device),
    )
    _raise_on(code, lib, "tp_mlp", "dit_block_tp")
    LAUNCHES["dit_block_tp/mlp"] += 1
    return out


def _require_card(*tensors) -> None:
    """The partials' inputs on one CUDA device (views included: the wrappers
    make what the kernels read contiguous)."""
    if any(t.device.type != "cuda" or t.device != tensors[0].device for t in tensors):
        raise ValueError(f"the CUDA TP kernels take tensors on one CUDA device, got {[str(t.device) for t in tensors]}")


def _device_gains(gains, device) -> torch.Tensor:
    """gains (2,) as f32 on the device, a view where it already is one."""
    g = torch.as_tensor(gains, device=device).detach()
    return g if g.dtype == torch.float32 and g.is_contiguous() else g.float().contiguous()


# ---------------------------------------------------------------------------
# the three partials


def attn_tp_partial(x, shift, scale, gain, w_qkv_l, w_out_l, heads_local: int):
    """Row 6: one rank's partial of the attention half-block. x (N, T, D);
    shift, scale (N, D); gain one f32 value; w_qkv_l (3*D_l, D) the rank's
    rows of q, k and v stacked; w_out_l (D, D_l). Returns f32 (N, T, D)
    without gate or residual."""
    if x.device.type == "cpu":
        return attn_tp_partial_plain(x, shift, scale, gain, w_qkv_l, w_out_l, heads_local)
    _check(x, w_qkv_l, w_out_l, 3, "attn_tp_partial")
    _require_card(x, shift, scale, w_qkv_l, w_out_l)
    _check_heads(w_out_l.shape[1], heads_local)
    if tp_attn_route(x.shape[1]) == "sequence":
        out = attn_tp_launch_sequence(x, shift, scale, gain, w_qkv_l, w_out_l, heads_local)
    else:
        out = tp_attn(x.contiguous(), shift, scale, _gain(gain, x.device), w_qkv_l.contiguous(), w_out_l.contiguous(),
                      heads_local)
    LAUNCHES["attn_tp_partial"] += 1
    return out


def block_tp_attn(x, a, gains, w_mod, w_qkv_l, w_out_l, heads_local: int):
    """Row 7: the modulation head (replicated) and row 6 on its first two
    chunks. a (N, D) = mp_silu(c); gains (2,) f32; w_mod (6D, D). Returns
    (partial f32 (N, T, D), mods f32 (N, 6, D))."""
    if x.device.type == "cpu":
        return block_tp_attn_plain(x, a, gains, w_mod, w_qkv_l, w_out_l, heads_local)
    _check(x, w_qkv_l, w_out_l, 3, "block_tp_attn", a, w_mod)
    _require_card(x, a, gains, w_mod, w_qkv_l, w_out_l)
    _check_block(x, a, gains, w_mod)
    _check_heads(w_out_l.shape[1], heads_local)
    if tp_attn_route(x.shape[1]) == "sequence":
        out = block_tp_launch_sequence(x, a, gains, w_mod, w_qkv_l, w_out_l, heads_local)
    else:
        n, _, d = x.shape
        partial, mods = tp_attn(x.contiguous(), None, None, _device_gains(gains, x.device)[0:1],
                                w_qkv_l.contiguous(), w_out_l.contiguous(), heads_local, a=a.contiguous(),
                                w_mod=w_mod.contiguous())
        out = partial, mods.reshape(n, 6, d)
    LAUNCHES["block_tp_attn"] += 1
    return out


def mlp_tp_partial(x, shift, scale, gains, w1_l, w2_l, inv_h: float):
    """Row 8: one rank's partial of the MLP half-block. x (N, T, D) the
    post-attention stream; shift, scale (N, D); gains (2,) (gains[1] is
    used); w1_l (H_l, D); w2_l (D, H_l); inv_h = 1/sqrt(H) of the global
    hidden width. Returns f32 (N, T, D)."""
    if x.device.type == "cpu":
        return mlp_tp_partial_plain(x, shift, scale, gains, w1_l, w2_l, inv_h)
    _check(x, w1_l, w2_l, 1, "mlp_tp_partial")
    _require_card(x, shift, scale, w1_l, w2_l)
    out = tp_mlp(x.contiguous(), shift, scale, _device_gains(gains, x.device)[1:2], w1_l.contiguous(),
                 w2_l.contiguous(), inv_h)
    LAUNCHES["mlp_tp_partial"] += 1
    return out


# ---------------------------------------------------------------------------
# the islands


def _inference_only(what, *tensors):
    if needs_grad(*tensors):
        raise RuntimeError(
            f"{what} is inference-only (no VJP, as in the JAX package); run it under torch.no_grad()"
        )


def gated_residual(x, gate, branch):
    """mp_sum(x, gate * branch, 0.3) in f32 on (N, T, D) x and (N, D) gate
    rows, the expression order of the JAX islands."""
    branch = gate[:, None, :].float() * branch
    return (x + (branch - x) * RES_T) / RES_DENOM


def fused_attn_branch_tp(x, shift, scale, gate, gain, w_qkv_l, w_out_l, *, heads_local: int, group=None):
    """The TP attention half-block (``fused_attn_branch_tp``): row 6 on this
    rank's heads, an all-reduce of the f32 partial over ``group`` (the
    mesh's model group), then the gated MP residual. Returns the new stream
    in x's type, the same on every rank of the group."""
    _inference_only("fused_attn_branch_tp", x, shift, scale, gate, torch.as_tensor(gain), w_qkv_l, w_out_l)
    partial = attn_tp_partial(x, shift, scale, gain, w_qkv_l, w_out_l, heads_local)
    dist.all_reduce(partial, group=group)
    return gated_residual(x.float(), gate, partial).to(x.dtype)


def fused_dit_block_tp(x, a, gains, w_mod, w_qkv_l, w_out_l, w1_l, w2_l, *, heads_local: int,
                       hidden_total: int, group=None):
    """The TP whole block (``fused_dit_block_tp``): row 7, all-reduce, the
    attention residual; row 8 on the bf16 stream, all-reduce, the MLP
    residual on the f32 stream. ``hidden_total`` is the global MLP width H
    (fc2's fan-in). Returns the new stream in x's type."""
    _inference_only("fused_dit_block_tp", x, a, gains, w_mod, w_qkv_l, w_out_l, w1_l, w2_l)
    partial, mods = block_tp_attn(x, a, gains, w_mod, w_qkv_l, w_out_l, heads_local)
    dist.all_reduce(partial, group=group)
    x1 = gated_residual(x.float(), mods[:, 2], partial)
    mlp = mlp_tp_partial(x1.to(x.dtype), mods[:, 3], mods[:, 4], gains, w1_l, w2_l, 1.0 / math.sqrt(hidden_total))
    dist.all_reduce(mlp, group=group)
    return gated_residual(x1, mods[:, 5], mlp).to(x.dtype)
