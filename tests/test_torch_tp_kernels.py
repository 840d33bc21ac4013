"""The tensor-parallel partial kernels' plan and shape rule
(``mapdit_tpu_torch/ops/cuda/dit_block_tp.py``: ``tp_plan``, whose words
and table of counter targets the launch of ``csrc/dit_block_tp.cu`` reads;
``check_tp_shape``; ``tp_attn_route``), walked on the CPU as the kernel
walks it, at the DiT-XL/2 shard shapes of tp=2 and tp=4 and at other shapes
the kernels take.
The kernels themselves run on the card only (``chip_smoke.py`` phase 3);
their plain versions are held to the Pallas TP kernels in
``tests/test_torch_tp.py``.
"""

import itertools

import pytest
import torch

from mapdit_tpu_torch.ops.cuda import dit_block_tp as tpk
from mapdit_tpu_torch.ops.cuda.dit_block import STACK_K, STACK_TILE

XL_D, XL_HEADS, XL_HIDDEN = 1152, 16, 4608
CTAS = 132
# 8 samples: phase 3's rows and the TP server's larger buckets; 2: its bucket 1
PLANS = [
    pytest.param(kernel, tp, t, mods, n, id=f"{kernel}{'+mods' if mods else ''}-tp{tp}-t{t}-n{n}")
    for kernel, mods in (("attn", False), ("attn", True), ("mlp", False))
    for tp in (2, 4)
    for t in (64, 16, 4)
    for n in (8, 2)
]


def _plan(kernel, tp, t, mods, n=8, ctas=CTAS):
    if kernel == "attn":
        return tpk.tp_plan("attn", n, t, XL_D, XL_D // tp, XL_HEADS // tp, mods, ctas)
    return tpk.tp_plan("mlp", n, t, XL_D, XL_HIDDEN // tp, ctas=ctas)


def _products(plan):
    return [s.product for s in plan.stages if s.product is not None] + (
        [plan.modulation] if plan.modulation is not None else [])


@pytest.mark.parametrize("kernel, tp, t, mods, n", PLANS)
def test_plan_covers_every_tile_once_per_split(kernel, tp, t, mods, n):
    """Every output tile of every product is computed once per split, the
    splits' k ranges partition [0, kt), no product splits into more than 8
    or beyond one wave or into splits of fewer k steps than the rule's, and
    the pre items cover the token rows once."""
    plan = _plan(kernel, tp, t, mods, n)
    walked = [entry for items in plan.walk() for entry in items]
    for p in _products(plan):
        seen = sorted(what for name, _, what in walked if name == p.name)
        kt = -(-p.k // STACK_K)
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
        assert 1 <= p.splits <= tpk.TP_MAX_SPLITS
        assert p.splits == 1 or p.tiles * p.splits <= plan.ctas
        min_k = tpk.TP_MIN_SPLIT_K_MODULATION if p.name == "modulation" else tpk.TP_MIN_SPLIT_K
        assert p.splits == 1 or kt // p.splits >= min_k
    rows = sorted(what for name, _, what in walked if name == "pre")
    assert rows[0][0] == 0 and rows[-1][1] == plan.m
    assert all(a[1] == b[0] for a, b in zip(rows, rows[1:]))


@pytest.mark.parametrize("kernel, tp, t, mods, n", PLANS)
def test_plan_attention_units_cover_samples_and_heads_once(kernel, tp, t, mods, n):
    plan = _plan(kernel, tp, t, mods, n)
    units = [u for items in plan.walk() for name, _, what in items if name == "attention" for u in what]
    if kernel == "mlp":
        assert units == [] and plan.heads == 0
    else:
        assert sorted(units) == list(range(n * (XL_HEADS // tp)))


@pytest.mark.parametrize("kernel, tp, t, mods, n", PLANS)
def test_plan_waits_point_backwards(kernel, tp, t, mods, n):
    """Every wait of an item is on a counter that only earlier items of
    the list raise, and those items raise it exactly to the count waited
    for, which is the target the launch reads from the plan's table; a
    simulation of the CTAs (each takes its items in order, an item runs
    once the table's targets of its waits are met) then finishes every
    item."""
    plan = _plan(kernel, tp, t, mods, n)
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
    # the counters' words are distinct and lie below the tickets
    words = {plan.counter_word(i, r) for i in range(len(plan.stages)) for r in range(plan.row_tiles)}
    assert len(words) == len(plan.stages) * plan.row_tiles
    assert min(words) >= tpk.TP_SYNC_DONE and max(words) < min(plan.tickets.values(), default=plan.sync_words)

    queues = [[g for g in range(c, plan.items, plan.ctas)] for c in range(plan.ctas)]
    done = [False] * plan.items
    counts = {}
    progress = True
    while progress:
        progress = False
        for q in queues:
            while q:
                i, j = plan.locate(q[0])
                if any(counts.get((s, r), 0) < table[plan.target_offset(s) + r] for s, r, _ in plan.waits(i, j)):
                    break
                for r in plan.rows_of(i, j):
                    counts[(i, r)] = counts.get((i, r), 0) + 1
                done[q.pop(0)] = True
                progress = True
    assert all(done)


@pytest.mark.parametrize("kernel, tp, t, mods, n", PLANS)
def test_plan_scratch_regions_are_aligned_and_apart(kernel, tp, t, mods, n):
    """The workspace's regions start at multiples of 256 bytes, do not
    overlap, and hold what the kernel writes there: the modulated A, the
    intermediate (qkv and attn, or h) and each split product's f32
    partials; the sync words (counters, then one ticket a tile of every
    split product) lie apart in the plan's buffer, ahead of its targets."""
    plan = _plan(kernel, tp, t, mods, n)
    m, d = plan.m, XL_D
    width = XL_D // tp if kernel == "attn" else XL_HIDDEN // tp
    need = {"amod": m * d * 2}
    if kernel == "attn":
        need.update(qkv=m * 3 * width * 4, attn=m * width * 2)
    else:
        need.update(h=m * width * 2)
    for p in _products(plan):
        if p.splits > 1:
            need[f"partial_{p.name}"] = p.splits * p.m * p.n * 4
    assert set(plan.layout) == set(need)
    spans = sorted((plan.layout[name], plan.layout[name] + size) for name, size in need.items())
    assert all(lo % 256 == 0 for lo, _ in spans)
    assert all(a[1] <= b[0] for a, b in zip(spans, spans[1:]))
    assert spans[-1][1] <= plan.workspace_bytes
    split = [p for p in _products(plan) if p.splits > 1]
    assert set(plan.tickets) == {p.name for p in split}
    ticket_words = sorted((plan.tickets[p.name], plan.tickets[p.name] + p.tiles) for p in split)
    assert all(a[1] <= b[0] for a, b in zip(ticket_words, ticket_words[1:]))
    assert not ticket_words or ticket_words[-1][1] <= plan.sync_words
    table = plan.table()
    assert len(table) == plan.buffer_words and not any(table[:plan.sync_words])
    assert tpk.TP_SYNC_EXIT < tpk.TP_SYNC_DONE


@pytest.mark.parametrize("kernel, tp, t, mods, n", PLANS)
def test_plan_words_are_what_the_launch_checks(kernel, tp, t, mods, n):
    """The words the launch reads (csrc/dit_block_tp.cu read_plan) give the
    stages it runs, in its order, with the items it counts for each (the
    token rows in pre items, two attention units an item, a product's tiles
    times its splits), counters and tickets inside the sync words, and
    targets inside the table after them; the modulation product's splits
    and ticket word where row 7's stage is on, zeros where not."""
    plan = _plan(kernel, tp, t, mods, n)
    words = plan.words()
    assert len(words) == tpk.TP_PLAN_WORDS
    head, groups = words[:tpk.TP_PLAN_HEADER], words[tpk.TP_PLAN_HEADER:]
    assert head[:4] == (len(plan.stages), plan.sync_words, plan.buffer_words, CTAS) and head[6:] == (0, 0)
    if mods:
        assert head[4:6] == (plan.modulation.splits, plan.tickets.get("modulation", 0)) and head[4] >= 1
    else:
        assert head[4:6] == (0, 0)
    kinds = (0, 1, 2, 1) if kernel == "attn" else (0, 1, 1)
    row_tiles = -(-plan.m // STACK_TILE)
    for i, kind in enumerate(kinds):
        g = groups[i * tpk.TP_PLAN_STAGE_WORDS:(i + 1) * tpk.TP_PLAN_STAGE_WORDS]
        stage = plan.stages[i]
        assert g[0] == kind and g[1] == stage.items
        if kind == 0:
            assert g[1] == -(-plan.m // tpk.TP_PRE_ROWS) and g[2] == 1
        elif kind == 2:
            assert g[1] == -(-n * plan.heads // 2) and g[2] == 1
        else:
            p = stage.product
            assert g[1] == row_tiles * -(-p.n // STACK_TILE) * g[2] and g[2] == p.splits
            assert (g[4] == 0) == (p.splits == 1)
            assert g[2] == 1 or tpk.TP_SYNC_DONE <= g[4] and g[4] + p.tiles <= plan.sync_words
        assert g[3] == plan.counter_word(i, 0) >= tpk.TP_SYNC_DONE and g[3] + 8 * (row_tiles - 1) < plan.sync_words
        assert g[5] == plan.target_offset(i) >= plan.sync_words and g[5] + row_tiles <= plan.buffer_words
    assert all(w == 0 for w in groups[len(kinds) * tpk.TP_PLAN_STAGE_WORDS:])


def test_plan_at_the_xl_shards_splits_as_the_kernel_note_says():
    """The splits the header note of csrc/dit_block_tp.cu reasons about at
    tp=2 (8 samples x 64 tokens, 132 CTAs): the modulation product's 54
    tiles in two splits of 9 k steps, fc2's 36 tiles in two of 18, the
    rest unsplit."""
    attn = _plan("attn", 2, 64, True)
    assert [(s.name, s.items) for s in attn.stages] == [("pre", 128), ("qkv", 56), ("attention", 32), ("out", 36)]
    assert (attn.modulation.tiles, attn.modulation.splits) == (54, 2)
    mlp = _plan("mlp", 2, 64, False)
    assert [(s.name, s.items, s.product.splits if s.product else 1) for s in mlp.stages] == [
        ("pre", 128, 1), ("fc1", 72, 1), ("fc2", 72, 2)]
    assert set(mlp.tickets) == {"fc2"} and set(attn.tickets) == {"modulation"}


def test_plan_refusals():
    """No plan for what the kernels do not run: the modulation stage on the
    MLP kernel, a third kernel."""
    with pytest.raises(ValueError, match="no plan"):
        tpk.tp_plan("mlp", 8, 64, XL_D, XL_HIDDEN // 2, modulation=True)
    with pytest.raises(ValueError, match="no plan"):
        tpk.tp_plan("gemm", 8, 64, XL_D, XL_D // 2)


@pytest.mark.parametrize("tokens, d, width, heads", [(64, 1152, 576, 8), (64, 1152, 288, 4), (16, 768, 384, 6),
                                                     (4, 384, 192, 3), (2, 1152, 576, 8), (62, 1152, 576, 8)])
def test_shape_rule_takes_the_registry_shards(tokens, d, width, heads):
    tpk.check_tp_shape("attn", tokens, d, width, heads)
    tpk.check_tp_shape("mlp", tokens, d, 4 * width)
    assert tpk.tp_attn_route(tokens) == "kernel"


@pytest.mark.parametrize("kernel, tokens, d, width, heads, what", [
    ("attn", 64, 1152, 640, 8, "head widths"),       # hd 80
    ("attn", 64, 1152, 576, 7, "head widths"),       # does not split
    ("attn", 63, 1152, 576, 8, "even T"),
    ("attn", 66, 1152, 576, 8, "even T"),
    ("attn", 64, 1148, 576, 8, "multiples of 8"),
    ("mlp", 64, 1152, 2300, 0, "multiples of 8"),
    ("conv", 64, 1152, 576, 8, "kernel must be"),
])
def test_shape_rule_raises_outside(kernel, tokens, d, width, heads, what):
    with pytest.raises(ValueError, match=what):
        tpk.check_tp_shape(kernel, tokens, d, width, heads)


@pytest.mark.parametrize("tokens, route", [(4, "kernel"), (64, "kernel"), (66, "sequence"), (256, "sequence")])
def test_attention_route_is_the_shape_rule(tokens, route):
    """Rows 6 and 7 take the one-launch kernel at T <= 64 and the launch
    sequence above; the MLP kernel has no T limit."""
    assert tpk.tp_attn_route(tokens) == route
    if route == "kernel":
        tpk.check_tp_shape("attn", tokens, 1152, 576, 8)
    else:
        with pytest.raises(ValueError, match="T <= 64"):
            tpk.check_tp_shape("attn", tokens, 1152, 576, 8)
    tpk.check_tp_shape("mlp", tokens, 1152, 2304)


@pytest.mark.parametrize("t", [16, 80])
def test_launch_sequences_are_the_plain_versions_on_the_cpu(t):
    """The launch sequences (the T > 64 route and the kernels' yardstick)
    run mp_gemm and cosine_attention, whose CPU route is their plain
    version: on CPU tensors they give the plain versions' bits and count
    nothing."""
    g = torch.Generator().manual_seed(3)
    n, d, heads, tp = 2, 128, 2, 2
    d_l, hid = d // tp, 2 * d

    def randn(*shape):
        return torch.randn(*shape, generator=g)

    x, a, shift, scale = randn(n, t, d), randn(n, d), randn(n, d), randn(n, d)
    gains = torch.rand(2, generator=g)
    w_mod, w_qkv, w_out, w1, w2 = randn(6 * d, d), randn(3 * d_l, d), randn(d, d_l), randn(hid, d), randn(d, hid)
    tpk.reset_launch_counts()
    pairs = [
        (tpk.attn_tp_launch_sequence(x, shift, scale, gains[0], w_qkv, w_out, 1),
         tpk.attn_tp_partial_plain(x, shift, scale, gains[0], w_qkv, w_out, 1)),
        (tpk.block_tp_launch_sequence(x, a, gains, w_mod, w_qkv, w_out, 1)[0],
         tpk.block_tp_attn_plain(x, a, gains, w_mod, w_qkv, w_out, 1)[0]),
        (tpk.mlp_tp_launch_sequence(x, shift, scale, gains, w1, w2, 0.5),
         tpk.mlp_tp_partial_plain(x, shift, scale, gains, w1, w2, 0.5)),
    ]
    for got, want in pairs:
        assert torch.equal(got, want)
    assert all(v == 0 for v in tpk.LAUNCHES.values())
