"""Float32 on ``csrc/dit_block_tp.cu``: the plans of its f32 instances (the
TP partials, rows 6-8, and row 9's ``mlp_branch_f32``) walked as the kernel
walks them; the f32 launch sequences (the route of rows 6 and 7 at T > 64
and every f32 kernel's yardstick) and the plain versions the kernels are
held to on the card, against the JAX package at ``dtype = float32``, whose
Pallas kernels run in interpret mode on the CPU; the wrappers' f32 domain on
meta tensors; and a DiT-XS/2 float32 model on ``pallas`` (row 9 and
``fused_attention``) against the JAX model on the same weights. Inputs come
from numpy seeds. Tolerances are the JAX package's own f32 kernel
tolerance, rtol = atol = 2e-4 (tests/test_pallas.py:169-181); the train
step's gradients are held to 2e-4 of each tensor's largest element, as
tests/test_torch_f32.py holds ``mega``'s."""

import itertools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mapdit_tpu.diffusion import create_diffusion as jax_create_diffusion
from mapdit_tpu.models import DiT as JaxDiT
from mapdit_tpu.models import build_config as jax_build_config
from mapdit_tpu.models import init_model as jax_init_model
from mapdit_tpu.ops.pallas import dit_block as jdb
from mapdit_tpu.ops.pallas import mlp_block as jmb
from mapdit_tpu_torch.diffusion import create_diffusion
from mapdit_tpu_torch.models import DiT, build_config
from mapdit_tpu_torch.ops.cuda import dit_block as tdb
from mapdit_tpu_torch.ops.cuda import dit_block_tp as tp
from mapdit_tpu_torch.ops.cuda import mlp_block as mb
from mapdit_tpu_torch.ops.cuda.dit_block import STACK_TILE
from mapdit_tpu_torch.training import create_optimizer, create_train_state, make_train_step, warmup_flat_invsqrt
from mapdit_tpu_torch.utils.weights import state_dict_from_jax

TOL = dict(rtol=2e-4, atol=2e-4)
XS2 = dict(in_channels=4, input_size=16, num_classes=10)
F32 = torch.float32
F32_K = 32  # elements of an f32 k step: a stage's 128-byte rows
CTAS = 132
XL_D, XL_HEADS, XL_HIDDEN = 1152, 16, 4608
torch.set_num_threads(2)


# ---------------------------------------------------------------------------
# (a) the f32 plans, walked as the kernel walks them

# (kernel, modulation, N, T, D, width, heads): the TP partials at the XL/2
# shards of tp=2 and 4 (8 rows, T = 64, 16 and 4), and row 9 at the B/2
# shapes (N = 64 and 256) and the S/2, XL/2 and ragged widths
PLANS = [
    pytest.param(kernel, mods, n, t, XL_D, (XL_D if kernel == "attn" else XL_HIDDEN) // tp_, XL_HEADS // tp_,
                 id=f"{kernel}{'+mods' if mods else ''}-tp{tp_}-t{t}-n{n}")
    for kernel, mods in (("attn", False), ("attn", True), ("mlp", False))
    for tp_ in (2, 4)
    for t, n in ((64, 8), (16, 8), (4, 3))
] + [
    pytest.param("mlp_branch", False, n, t, d, h, 0, id=f"mlp_branch-n{n}-t{t}-d{d}")
    for n, t, d, h in ((64, 64, 768, 3072), (256, 64, 768, 3072), (64, 64, 384, 1536), (8, 64, 1152, 4608),
                       (5, 64, 768, 3072), (64, 4, 768, 3072))
]


def _plan(kernel, mods, n, t, d, width, heads):
    return tp.tp_plan(kernel, n, t, d, width, heads if kernel == "attn" else 0, mods, CTAS, f32=True)


def _products(plan):
    return list(plan.products) + ([plan.modulation] if plan.modulation is not None else [])


@pytest.mark.parametrize("kernel, mods, n, t, d, width, heads", PLANS)
def test_f32_plan_covers_every_tile_once_per_split(kernel, mods, n, t, d, width, heads):
    """Every output tile of every product (128 x 128 tiles, row 9 too) is
    computed once per split; the splits' k ranges, in k steps of 32,
    partition [0, kt); no product splits into more than 8 or into splits of
    fewer k steps than the f32 rule's, and no other count would end its
    items sooner by the rule's cost; the pre items cover the token rows once
    (row 9: the bf16 form's rows)."""
    plan = _plan(kernel, mods, n, t, d, width, heads)
    assert plan.kernel == kernel + "_f32"
    walked = [entry for items in plan.walk() for entry in items]
    for p in _products(plan):
        assert p.k_step == F32_K and p.width == STACK_TILE
        seen = sorted(what for name, _, what in walked if name == p.name)
        kt = -(-p.k // F32_K)
        row_tiles, col_tiles = -(-p.m // STACK_TILE), -(-p.n // STACK_TILE)
        assert len(seen) == row_tiles * col_tiles * p.splits == p.items
        by_tile = {}
        for r, c, z, kb, ke in seen:
            by_tile.setdefault((r, c), []).append((z, kb, ke))
        assert set(by_tile) == set(itertools.product(range(row_tiles), range(col_tiles)))
        for ranges in by_tile.values():
            ranges.sort()
            assert [z for z, _, _ in ranges] == list(range(p.splits))
            assert ranges[0][1] == 0 and ranges[-1][2] == kt
            assert all(a[2] == b[1] and a[1] < a[2] for a, b in zip(ranges, ranges[1:] + [(0, kt, kt)]))
        assert 1 <= p.splits <= tp.TP_MAX_SPLITS
        assert p.splits == 1 or -(-kt // p.splits) >= tp.TP_F32_MIN_SPLIT_K

        def cost(s):
            waves = -(-p.tiles * s // plan.ctas)
            return waves * (-(-kt // s) + (tp.TP_F32_SPLIT_COST if s > 1 else 0))

        fits = [s for s in range(1, tp.TP_MAX_SPLITS + 1) if s == 1 or -(-kt // s) >= tp.TP_F32_MIN_SPLIT_K]
        assert all(cost(p.splits) < cost(s) for s in fits if s < p.splits)
        assert all(cost(p.splits) <= cost(s) for s in fits)
    rows = sorted(what for name, _, what in walked if name == "pre")
    assert rows[0][0] == 0 and rows[-1][1] == plan.m
    assert all(a[1] == b[0] for a, b in zip(rows, rows[1:]))
    want_rows = mb.mlp_plan(n, t, d, width).pre_rows if kernel == "mlp_branch" else tp.TP_PRE_ROWS
    assert plan.pre_rows == want_rows and STACK_TILE % plan.pre_rows == 0


@pytest.mark.parametrize("kernel, mods, n, t, d, width, heads", PLANS)
def test_f32_plan_waits_point_backwards(kernel, mods, n, t, d, width, heads):
    """Every wait is on a counter that only earlier items raise, exactly to
    the target in the plan's table; a simulation of the CTAs (each takes
    its items in order, an item runs once its waits are met) finishes every
    item."""
    plan = _plan(kernel, mods, n, t, d, width, heads)
    table = plan.table()
    raised = {}
    for g in range(plan.items):
        i, j = plan.locate(g)
        for r in plan.rows_of(i, j):
            raised.setdefault((i, r), []).append(g)
    for g in range(plan.items):
        i, j = plan.locate(g)
        waits = plan.waits(i, j)
        assert (i == 0) == (waits == ())
        for stage, r, count in waits:
            assert stage == i - 1
            assert len(raised[(stage, r)]) == count == table[plan.target_offset(stage) + r]
            assert max(raised[(stage, r)]) < g
    queues = [list(range(c, plan.items, plan.ctas)) for c in range(plan.ctas)]
    counts, progress, done = {}, True, 0
    while progress:
        progress = False
        for q in queues:
            while q:
                i, j = plan.locate(q[0])
                if any(counts.get((s, r), 0) < table[plan.target_offset(s) + r] for s, r, _ in plan.waits(i, j)):
                    break
                for r in plan.rows_of(i, j):
                    counts[(i, r)] = counts.get((i, r), 0) + 1
                q.pop(0)
                done += 1
                progress = True
    assert done == plan.items


@pytest.mark.parametrize("kernel, mods, n, t, d, width, heads", PLANS)
def test_f32_plan_scratch_is_f32_aligned_and_apart(kernel, mods, n, t, d, width, heads):
    """The workspace's regions start at multiples of 256 bytes (16-byte
    TMA and vector accesses), do not overlap and hold what the f32
    instances write there: amod, attn and h in f32 (twice the bf16 plan's
    bytes), qkv and the split partials in f32; the tickets lie apart in the
    sync words, ahead of the targets."""
    plan = _plan(kernel, mods, n, t, d, width, heads)
    bf16 = tp.tp_plan(kernel, n, t, d, width, heads if kernel == "attn" else 0, mods, CTAS)
    m = plan.m
    need = {"amod": m * d * 4}
    if kernel == "attn":
        need.update(qkv=m * 3 * width * 4, attn=m * width * 4)
    else:
        need.update(h=m * width * 4)
    for p in _products(plan):
        if p.splits > 1:
            need[f"partial_{p.name}"] = p.splits * p.m * p.n * 4
    assert set(plan.layout) == set(need)
    spans = sorted((plan.layout[name], plan.layout[name] + size) for name, size in need.items())
    assert all(lo % 256 == 0 for lo, _ in spans)
    assert all(a[1] <= b[0] for a, b in zip(spans, spans[1:]))
    assert spans[-1][1] <= plan.workspace_bytes
    for name in ("amod", "attn", "h"):
        if name in plan.layout:
            nxt = [off for off in plan.layout.values() if off > plan.layout[name]]
            nxt_bf = [off for off in bf16.layout.values() if off > bf16.layout[name]]
            size = min(nxt, default=plan.workspace_bytes) - plan.layout[name]
            size_bf = min(nxt_bf, default=bf16.workspace_bytes) - bf16.layout[name]
            assert size >= need[name] and size_bf < need[name] <= 2 * size_bf + 256
    split = [p for p in _products(plan) if p.splits > 1]
    assert set(plan.tickets) == {p.name for p in split}
    ticket_words = sorted((plan.tickets[p.name], plan.tickets[p.name] + p.tiles) for p in split)
    assert all(a[1] <= b[0] for a, b in zip(ticket_words, ticket_words[1:]))
    assert not ticket_words or ticket_words[-1][1] <= plan.sync_words
    table = plan.table()
    assert len(table) == plan.buffer_words and not any(table[:plan.sync_words])


@pytest.mark.parametrize("kernel, mods, n, t, d, width, heads", PLANS)
def test_f32_plan_words_are_what_the_launch_checks(kernel, mods, n, t, d, width, heads):
    """The words the f32 entry points read (tp_attn_f32, tp_mlp_f32 and
    mlp_branch_f32, through read_plan at k steps of 32): the stages in the
    kernel's order with the items it counts (pre items of the plan's rows,
    two attention units an item, a product's 128 x 128 tiles times its
    splits), counters and tickets inside the sync words, targets after
    them; the header's fifth word the modulation product's splits (row 7),
    row 9's pre rows, or 0."""
    plan = _plan(kernel, mods, n, t, d, width, heads)
    words = plan.words()
    assert len(words) == tp.TP_PLAN_WORDS
    head, groups = words[:tp.TP_PLAN_HEADER], words[tp.TP_PLAN_HEADER:]
    assert head[:4] == (len(plan.stages), plan.sync_words, plan.buffer_words, CTAS) and head[6:] == (0, 0)
    if mods:
        assert head[4:6] == (plan.modulation.splits, plan.tickets.get("modulation", 0)) and head[4] >= 1
    elif kernel == "mlp_branch":
        assert head[4:6] == (plan.pre_rows, 0)
    else:
        assert head[4:6] == (0, 0)
    kinds = (0, 1, 2, 1) if kernel == "attn" else (0, 1, 1)
    row_tiles = -(-plan.m // STACK_TILE)
    for i, kind in enumerate(kinds):
        g = groups[i * tp.TP_PLAN_STAGE_WORDS:(i + 1) * tp.TP_PLAN_STAGE_WORDS]
        stage = plan.stages[i]
        assert g[0] == kind and g[1] == stage.items
        if kind == 0:
            assert g[1] == -(-plan.m // plan.pre_rows) and g[2] == 1
        elif kind == 2:
            assert g[1] == -(-n * plan.heads // 2) and g[2] == 1
        else:
            p = stage.product
            assert g[1] == row_tiles * -(-p.n // STACK_TILE) * g[2] and g[2] == p.splits
            assert (g[4] == 0) == (p.splits == 1)
        assert g[3] == plan.counter_word(i, 0) >= tp.TP_SYNC_DONE and g[3] + 8 * (row_tiles - 1) < plan.sync_words
        assert g[5] == plan.target_offset(i) >= plan.sync_words and g[5] + row_tiles <= plan.buffer_words
    assert all(w == 0 for w in groups[len(kinds) * tp.TP_PLAN_STAGE_WORDS:])


def test_f32_plan_splits_count_k_steps_of_32():
    """At the XL/2 shards of tp=2 on 132 CTAs the f32 plan counts k steps of
    32: qkv's 36 steps split in 2 and out's 18 in 3, where the bf16 plan's
    18 and 9 steps of 64 stay whole; row 7's modulation product splits its
    36 steps in 2 in both; row 8's fc1 (72 tiles of 36 steps) splits in 3,
    two waves of 12-step items, where one wave of 36 steps left 60 CTAs
    idle. Row 9's f32 plan runs 128-column tiles at the bf16 form's pre
    rows."""
    f32 = tp.tp_plan("attn", 8, 64, XL_D, XL_D // 2, XL_HEADS // 2, True, CTAS, f32=True)
    bf16 = tp.tp_plan("attn", 8, 64, XL_D, XL_D // 2, XL_HEADS // 2, True, CTAS)
    assert f32.stage("qkv").product.kt == 36 and f32.stage("qkv").product.splits == 2
    assert f32.stage("out").product.kt == 18 and f32.stage("out").product.splits == 3
    assert bf16.stage("qkv").product.kt == 18 and bf16.stage("qkv").product.splits == 1
    assert bf16.stage("out").product.splits == 1
    assert f32.modulation.kt == 36 and f32.modulation.splits >= 2
    fc1 = tp.tp_plan("mlp", 8, 64, XL_D, 2304, ctas=CTAS, f32=True).stage("fc1").product
    assert (fc1.tiles, fc1.kt, fc1.splits) == (72, 36, 3)
    wide, narrow = mb.mlp_plan(64, 64, 768, 3072), mb.mlp_plan(64, 64, 768, 3072, f32=True)
    assert [p.width for p in wide.products] == [tp.MLP_WIDE] * 2
    assert [p.width for p in narrow.products] == [STACK_TILE] * 2 and narrow.pre_rows == wide.pre_rows


@pytest.mark.parametrize("hd", tdb.ATTENTION_HEAD_WIDTHS)
def test_f32_attention_units_fit_shared_memory(hd):
    """The TP kernels' ring is dit_stack's (four stages of 32 KB, the same
    shared memory): two f32 attention units (a group's 64 f32 q, k and v
    rows at a stride of hd + 4 floats and two scale vectors, 59 KB at hd
    72) fit the ring at both head widths, and a CTA's shared memory fits
    227 KB."""
    unit = tdb.stack_attention_smem(hd, 4)
    assert unit == 3 * 64 * (hd + 4) * 4 + 2 * 64 * 4
    assert 2 * unit <= tdb.STACK_RING_BYTES
    assert tdb.STACK_SMEM_BYTES <= tdb.MAX_SMEM_BYTES


# ---------------------------------------------------------------------------
# (b) the f32 launch sequences and plain versions against the JAX package


def _rand(rng, *shape, scale=1.0, shift=0.0):
    return (rng.normal(size=shape) * scale + shift).astype(np.float32)


def _t(*arrays):
    return [torch.from_numpy(np.asarray(a)) for a in arrays]


def _j(*arrays):
    return [jnp.asarray(a) for a in arrays]


def _tp_inputs(seed, n=4, t=16, d=128, d_l=64, h_l=192):
    """f32 x, shift, scale, a, the gains and the rank's weights at the
    shapes of tests/test_torch_tp.py."""
    rng = np.random.default_rng(seed)
    s = 1 / math.sqrt(d)
    return dict(x=_rand(rng, n, t, d), shift=_rand(rng, n, d, scale=0.1), scale=_rand(rng, n, d, scale=0.1, shift=1.0),
                a=_rand(rng, n, d), gains=np.asarray([0.3, 0.6], np.float32), w_mod=_rand(rng, 6 * d, d, scale=s),
                w_qkv=_rand(rng, 3 * d_l, d, scale=s), w_out=_rand(rng, d, d_l, scale=s),
                w1=_rand(rng, h_l, d, scale=s), w2=_rand(rng, d, h_l, scale=1 / math.sqrt(2 * h_l)))


@pytest.mark.parametrize("t", [16, 64])
def test_f32_attn_tp_sequence_and_plain_match_pallas(t):
    """Row 6 at f32: the launch sequence (mp_gemm and cosine_attention,
    their plain versions on the CPU) equals the plain version, and both lie
    within 2e-4 of the JAX Pallas kernel at float32 (interpret mode)."""
    v = _tp_inputs(21, t=t)
    args = (*_t(v["x"], v["shift"], v["scale"]), torch.tensor(0.2), *_t(v["w_qkv"], v["w_out"]), 2)
    seq, plain = tp.attn_tp_launch_sequence(*args), tp.attn_tp_partial_plain(*args)
    assert seq.dtype == F32 and torch.equal(seq, plain)
    want = jdb._attn_tp_partial_impl(*_j(v["x"], v["shift"], v["scale"]), jnp.float32(0.2),
                                     *_j(v["w_qkv"], v["w_out"]), 2)
    np.testing.assert_allclose(seq.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("t", [16, 64])
def test_f32_block_tp_sequence_and_plain_match_pallas(t):
    """Row 7 at f32: the launch sequence equals the plain version (partial
    and mods), both within 2e-4 of the JAX Pallas kernel at float32."""
    v = _tp_inputs(22, t=t)
    args = (*_t(v["x"], v["a"], v["gains"], v["w_mod"], v["w_qkv"], v["w_out"]), 2)
    (seq, seq_mods), (plain, plain_mods) = tp.block_tp_launch_sequence(*args), tp.block_tp_attn_plain(*args)
    assert torch.equal(seq, plain) and torch.equal(seq_mods, plain_mods)
    want, want_mods = jdb._block_tp_attn_impl(*_j(v["x"], v["a"], v["gains"], v["w_mod"], v["w_qkv"], v["w_out"]), 2)
    np.testing.assert_allclose(seq.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(seq_mods.numpy(), np.asarray(want_mods), **TOL)


@pytest.mark.parametrize("t", [16, 64])
def test_f32_mlp_tp_sequence_and_plain_match_pallas(t):
    """Row 8 at f32: the launch sequence equals the plain version, h kept in
    f32 (the weights' type), both within 2e-4 of the JAX Pallas kernel at
    float32."""
    v = _tp_inputs(23, t=t)
    inv_h = 1.0 / math.sqrt(2 * v["w1"].shape[0])
    args = (*_t(v["x"], v["shift"], v["scale"], v["gains"], v["w1"], v["w2"]), inv_h)
    seq, plain = tp.mlp_tp_launch_sequence(*args), tp.mlp_tp_partial_plain(*args)
    assert torch.equal(seq, plain)
    want = jdb._mlp_tp_partial_impl(*_j(v["x"], v["shift"], v["scale"], v["gains"], v["w1"], v["w2"]), inv_h)
    np.testing.assert_allclose(seq.numpy(), np.asarray(want), **TOL)


def _mlp_inputs(seed, n=4, t=16, d=128, hidden=512, deep=0.0):
    """Row 9's f32 inputs, w1 and w2 rows normalised as the folded weights
    are; ``deep`` scales every 16th row of w1 (bench_mlp_branch.DEEP's
    pre-activations below -88)."""
    rng = np.random.default_rng(seed)

    def w(*s):
        m = rng.normal(size=s).astype(np.float32)
        return (m * np.sqrt(s[-1]) / (np.linalg.norm(m, axis=-1, keepdims=True) + 1e-4)).astype(np.float32)

    w1 = w(hidden, d)
    if deep:
        w1[::16] *= deep
    f = [rng.normal(size=s).astype(np.float32) for s in ((n, t, d), (n, d), (n, d), (n, d))]
    return [*f, np.float32(0.37), w1, w(d, hidden)]


@pytest.mark.parametrize("t, deep", [(16, 0.0), (64, 0.0), (4, 0.0), (16, 300.0)],
                         ids=["t16", "t64", "t4", "t16-fc1-below-88"])
def test_f32_mlp_branch_plain_and_sequence_match_pallas(t, deep):
    """Row 9 at f32: the plain version against JAX ``mlp_block._fwd_impl``
    (the Pallas kernel at dtype = w1.dtype = float32, interpret mode) at
    2e-4, and the launch sequence (mp_gemm's plain versions on the CPU, h
    in f32) equal to it, also with fc1 pre-activations far below -88 where
    the MP-SiLU gives -0."""
    inputs = _mlp_inputs(31, t=t, deep=deep)
    want = np.asarray(jmb._fwd_impl(*_j(*inputs)))
    args = _t(*inputs)
    got, seq = mb.fused_mlp_branch_plain(*args), mb.mlp_launch_sequence(*args)
    assert got.dtype == F32 and torch.equal(seq, got) and np.isfinite(want).all()
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    np.testing.assert_allclose(mb.fused_mlp_branch(*args).numpy(), want, **TOL)


# ---------------------------------------------------------------------------
# (c) the wrappers' f32 domain on meta tensors (nothing is built)


def _meta(*shape, dtype=F32):
    return torch.empty(*shape, dtype=dtype, device="meta")


@pytest.mark.parametrize("mixed", ["x", "w_in", "w_out", "none"])
def test_f32_tp_and_mlp_wrappers_reach_the_cuda_check(mixed):
    """Off the CPU, rows 6-9's wrappers and kernel calls take x and the
    weights all bf16 or all f32: an all-f32 set reaches the CUDA check (the
    f32 instances), a set with one bf16 tensor raises naming the rule,
    before anything is built."""
    n, t, d, d_l, h = 2, 16, 128, 64, 256
    bf = torch.bfloat16

    def typed(name, *shape):
        return _meta(*shape, dtype=bf if name == mixed else F32)

    x = typed("x", n, t, d)
    r, g = _meta(n, d), _meta(1)
    w_qkv, w_out = typed("w_in", 3 * d_l, d), typed("w_out", d, d_l)
    w1, w2 = typed("w_in", h, d), typed("w_out", d, h)
    fw1, fw2 = typed("w_in", 4 * d, d), typed("w_out", d, 4 * d)
    match = "CUDA" if mixed == "none" else "all bf16 .* or all f32"
    calls = [
        lambda: tp.attn_tp_partial(x, r, r, g, w_qkv, w_out, 1),
        lambda: tp.block_tp_attn(x, _meta(n, d, dtype=x.dtype), _meta(2), _meta(6 * d, d, dtype=x.dtype), w_qkv,
                                 w_out, 1),
        lambda: tp.mlp_tp_partial(x, r, r, _meta(2), w1, w2, 0.1),
        lambda: tp.tp_attn(x, r, r, g, w_qkv, w_out, 1),
        lambda: tp.tp_mlp(x, r, r, g, w1, w2, 0.1),
        lambda: mb.fused_mlp_branch(x, r, r, r, g, fw1, fw2),
        lambda: mb.mlp_branch(x, r, r, r, g, fw1, fw2),
    ]
    for call in calls:
        with pytest.raises(ValueError, match=match):
            call()


def test_f32_row7_refuses_a_mixed_modulation_input():
    """Row 7's a and w_mod follow the rule too: with x and the weights f32,
    a bf16 a or w_mod raises."""
    n, t, d, d_l = 2, 16, 128, 64
    x, w_qkv, w_out = _meta(n, t, d), _meta(3 * d_l, d), _meta(d, d_l)
    for a, w_mod in ((_meta(n, d, dtype=torch.bfloat16), _meta(6 * d, d)),
                     (_meta(n, d), _meta(6 * d, d, dtype=torch.bfloat16))):
        with pytest.raises(ValueError, match="all bf16 .* or all f32"):
            tp.block_tp_attn(x, a, _meta(2), w_mod, w_qkv, w_out, 1)


# ---------------------------------------------------------------------------
# (d) a DiT-XS/2 float32 model on pallas against the JAX model


@pytest.fixture(scope="module")
def xs2():
    """DiT-XS/2 cut to depth 2 at 16 x 16 latents (T = 64), float32: JAX
    init weights with the block gains drawn away from their zero init, and
    seeded inputs."""
    cfg = jax_build_config("DiT-XS/2", depth=2, **XS2)
    _, variables = jax_init_model(cfg, seed=5)
    rng = np.random.default_rng(5)
    params = dict(variables["params"])
    for i in range(cfg.depth):
        blk = dict(params[f"blocks_{i}"])
        blk["gain_msa"], blk["gain_mlp"] = (jnp.asarray(v, jnp.float32) for v in rng.uniform(0.1, 0.9, 2))
        params[f"blocks_{i}"] = blk
    variables = dict(variables, params=params)
    x = rng.normal(size=(4, 4, 16, 16)).astype(np.float32)
    t = np.array([10.0, 300.0, 650.0, 999.0], np.float32)
    y = np.array([1, 4, 7, 10], np.int32)
    return cfg, variables, (x, t, y)


PALLAS = dict(block_kernel="pallas", attention_impl="pallas")


def test_xs2_f32_pallas_forward_matches_jax(xs2):
    """Every block's MLP half through fused_mlp_branch and its attention
    through fused_attention at float32, against the JAX model under the
    same flags (its Pallas kernels in interpret mode)."""
    jcfg, variables, inputs = xs2
    want = np.asarray(JaxDiT(jcfg.replace(**PALLAS)).apply(variables, *_j(*inputs)))
    cfg = build_config("DiT-XS/2", depth=2, **PALLAS, **XS2)
    assert cfg.dtype == F32
    model = DiT(cfg).eval()
    model.load_state_dict(state_dict_from_jax(variables, cfg))
    x, t, y = inputs
    with torch.no_grad():
        got = model(*_t(x, t), torch.from_numpy(y.astype(np.int64)))
    assert got.dtype == F32
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_xs2_f32_pallas_train_step_matches_jax(xs2):
    """One train step of the float32 model on pallas (the kernels' forward,
    the gradients recomputed through their references) with the JAX step's
    draws: the loss against the JAX loss under the same flags (2e-4
    relative) and every gradient against jax.grad of it (2e-4 of the
    tensor's largest element)."""
    jcfg, variables, _ = xs2
    jcfg = jcfg.replace(**PALLAS)
    rng = np.random.default_rng(13)
    b = 4
    mean = rng.normal(size=(b, 4, 16, 16)).astype(np.float32)
    batch = {"mean": mean, "std": np.full_like(mean, 0.5), "y": np.array([0, 3, 6, 9], np.int32)}
    stats_mean, stats_std = np.zeros(4, np.float32), np.ones(4, np.float32)
    draws = {"posterior_eps": rng.normal(size=mean.shape).astype(np.float32),
             "t": np.array([5, 250, 600, 990], np.int64), "noise": rng.normal(size=mean.shape).astype(np.float32)}
    x = mean + draws["posterior_eps"] * batch["std"]
    diffusion = jax_create_diffusion("")
    rest = {key: v for key, v in variables.items() if key != "params"}

    def loss_fn(params):
        def model_fn(xt, tt, y):
            return JaxDiT(jcfg).apply(dict(rest, params=params), xt, tt, y)

        return jnp.mean(diffusion.training_losses(
            model_fn, jnp.asarray(x), jnp.asarray(draws["t"]), model_kwargs={"y": jnp.asarray(batch["y"])},
            noise=jnp.asarray(draws["noise"]))["loss"])

    want_loss, grads = jax.value_and_grad(loss_fn)(variables["params"])
    want = state_dict_from_jax({"params": grads})
    cfg = build_config("DiT-XS/2", depth=2, **PALLAS, **XS2)
    tx = create_optimizer(warmup_flat_invsqrt(1e-2, 5, 50))
    state = create_train_state(cfg, tx, device="cpu", state_dict=state_dict_from_jax(variables, cfg))
    metrics = make_train_step(cfg, create_diffusion("", device="cpu"), tx, stats_mean, stats_std,
                              model_train=False)(state, batch, draws=draws)
    np.testing.assert_allclose(float(metrics["loss"]), float(want_loss), rtol=2e-4)
    params = dict(state.model.named_parameters())
    assert set(want) == set(params)
    for name, p in params.items():
        w = want[name].numpy()
        scale = np.abs(w).max() + 1e-12
        np.testing.assert_allclose(p.grad.numpy() / scale, w / scale, rtol=0, atol=2e-4, err_msg=name)
