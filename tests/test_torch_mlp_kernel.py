"""Row 9's kernel plan (``mapdit_tpu_torch/ops/cuda/mlp_block.py``
``mlp_plan``: the TP kernels' ``tp_plan("mlp_branch")``, whose words and
table of counter targets the launch of ``mlp_branch`` in
``csrc/dit_block_tp.cu`` reads), walked on the CPU as the kernel walks it, at the DiT-B/2 shapes of phase 3 (N = 64 and 256), at the
S/2 and XL/2 widths and at T = 4, 16 and 256. The kernel itself runs on the
card only (``chip_smoke.py`` phase 3, the bench
``mapdit_tpu_torch/tools/bench_mlp_branch.py``); its plain version is held
to the Pallas kernel in interpret mode in ``tests/test_torch_attention.py``.
Row 8's plan, whose kernel shares the file and the plan, is held to its
words as they were before row 9 joined it.
"""

import itertools

import pytest
import torch

from mapdit_tpu_torch.ops.cuda import dit_block_tp as tpk
from mapdit_tpu_torch.ops.cuda import mlp_block as mb
from mapdit_tpu_torch.ops.cuda.dit_block import STACK_K, STACK_TILE

CTAS = 132
# (id, samples, tokens, D, H): B/2 at 32 x 2 CFG rows and a P1 train batch;
# the S/2, L/2 and XL/2 widths; the registry's other token counts; an odd
# count of row tiles with a ragged last one; one sample of 4 tokens (fc2
# splits K)
SHAPES = [("b2-n64", 64, 64, 768, 3072), ("b2-n256", 256, 64, 768, 3072), ("s2-n64", 64, 64, 384, 1536),
          ("l2-n8", 8, 64, 1024, 4096), ("xl2-n8", 8, 64, 1152, 4608), ("b2-t4", 64, 4, 768, 3072),
          ("b2-t16", 64, 16, 768, 3072), ("b2-t256", 8, 256, 768, 3072), ("b2-rows320", 5, 64, 768, 3072),
          ("xl2-n1-t4", 1, 4, 1152, 4608)]
# the card's 132 SMs, and a grid short of them
PLANS = [pytest.param(*shape[1:], ctas, id=f"{shape[0]}-g{ctas}")
         for shape, ctas in itertools.product(SHAPES, (CTAS, 120))]
SIG = "n, t, d, hid, ctas"


@pytest.mark.parametrize(SIG, PLANS)
def test_plan_covers_every_tile_once_per_split(n, t, d, hid, ctas):
    """Every output tile of both products is computed once per split, the
    splits' k ranges partition [0, kt), no product splits into more than 8
    or beyond one wave or into splits shorter than the TP kernels' rule,
    and the pre items cover the token rows once, each inside one row tile
    and its rows of x inside one ring stage."""
    plan = mb.mlp_plan(n, t, d, hid, ctas)
    walked = [entry for items in plan.walk() for entry in items]
    for p in plan.products:
        seen = [what for name, _, what in walked if name == p.name]
        assert len(seen) == p.items == p.row_tiles * -(-p.n // tpk.MLP_WIDE) * p.splits
        by_tile = {}
        for r, c, z, kb, ke in seen:
            by_tile.setdefault((r, c), []).append((z, kb, ke))
        assert set(by_tile) == set(itertools.product(range(p.row_tiles), range(p.col_tiles)))
        kt = -(-p.k // STACK_K)
        for ranges in by_tile.values():
            ranges.sort()
            assert [z for z, _, _ in ranges] == list(range(p.splits))
            assert ranges[0][1] == 0 and ranges[-1][2] == kt
            assert all(a[2] == b[1] and a[1] < a[2] for a, b in zip(ranges, ranges[1:]))
        assert 1 <= p.splits <= tpk.TP_MAX_SPLITS
        assert p.splits == 1 or (p.tiles * p.splits <= plan.ctas and kt // p.splits >= tpk.TP_MIN_SPLIT_K)
    rows = sorted(what for name, _, what in walked if name == "pre")
    assert len(rows) == plan.pre_items == -(-plan.m // plan.pre_rows)
    assert all(0 < hi - lo <= plan.pre_rows and lo // STACK_TILE == (hi - 1) // STACK_TILE for lo, hi in rows)
    assert rows[0][0] == 0 and rows[-1][1] == plan.m
    assert all(a[1] == b[0] for a, b in zip(rows, rows[1:]))
    assert plan.pre_rows in tpk.MLP_PRE_ROWS and -(-d // 64) * plan.pre_rows * 128 <= tpk.MLP_STAGE_BYTES
    assert plan.pre_rows == max(r for r in tpk.MLP_PRE_ROWS if -(-d // 64) * r * 128 <= tpk.MLP_STAGE_BYTES)


@pytest.mark.parametrize(SIG, PLANS)
def test_plan_waits_point_backwards(n, t, d, hid, ctas):
    """Every wait of an item is on a counter that only earlier items of
    the list raise, and they raise it exactly to the count waited for,
    which is the target the launch reads from the plan's table; a
    simulation of the CTAs (each takes its items in order, an item runs
    once the table's targets of its waits are met) then finishes every
    item."""
    plan = mb.mlp_plan(n, t, d, hid, ctas)
    table = plan.table()
    raised = {}
    for g in range(plan.items):
        i, j = plan.locate(g)
        for r in plan.rows_of(i, j):
            raised.setdefault((i, r), []).append(g)
    for g in range(plan.items):
        i, j = plan.locate(g)
        assert len(plan.waits(i, j)) == (i > 0)
        for stage, r, count in plan.waits(i, j):
            assert stage == i - 1
            assert len(raised[(stage, r)]) == count == table[plan.target_offset(stage) + r]
            assert max(raised[(stage, r)]) < g
    words = {plan.counter_word(i, r) for i in range(3) for r in range(plan.row_tiles)}
    assert len(words) == 3 * plan.row_tiles
    assert min(words) >= tpk.TP_SYNC_DONE and max(words) < min(plan.tickets.values(), default=plan.sync_words)

    counts, done = {}, [False] * plan.items
    queues = [list(range(c, plan.items, plan.ctas)) for c in range(plan.ctas)]
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


@pytest.mark.parametrize(SIG, PLANS)
def test_plan_grid_is_the_resident_ctas_given(n, t, d, hid, ctas):
    """The plan takes the CTAs it is given (the wrapper gives it the
    resident ones: every CTA of the cooperative launch resident) and
    spreads the list over all of them as the kernel does: pre items, then
    fc1's, then fc2's, CTA c taking items c, c + ctas, ..."""
    plan = mb.mlp_plan(n, t, d, hid, ctas)
    assert plan.ctas == ctas
    walk = plan.walk()
    assert len(walk) == ctas and sum(map(len, walk)) == plan.items
    assert max(map(len, walk)) - min(map(len, walk)) <= 1
    stages = [plan.locate(g)[0] for g in range(plan.items)]
    assert stages == sorted(stages)


@pytest.mark.parametrize(SIG, PLANS)
def test_plan_scratch_regions_are_aligned_and_apart(n, t, d, hid, ctas):
    """The workspace's regions start at multiples of 256 bytes, do not
    overlap, and hold what the kernel writes there: amod, h and each split
    product's f32 partials; the tickets lie apart after the counters, in
    the sync words, ahead of the targets."""
    plan = mb.mlp_plan(n, t, d, hid, ctas)
    m = plan.m
    need = {"amod": m * d * 2, "h": m * hid * 2}
    for p in plan.products:
        if p.splits > 1:
            need[f"partial_{p.name}"] = p.splits * p.m * p.n * 4
    assert set(plan.layout) == set(need)
    spans = sorted((plan.layout[name], plan.layout[name] + size) for name, size in need.items())
    assert all(lo % 256 == 0 for lo, _ in spans)
    assert all(a[1] <= b[0] for a, b in zip(spans, spans[1:]))
    assert spans[-1][1] <= plan.workspace_bytes
    split = [p for p in plan.products if p.splits > 1]
    assert set(plan.tickets) == {p.name for p in split}
    tickets = sorted((plan.tickets[p.name], plan.tickets[p.name] + p.tiles) for p in split)
    assert all(a[1] <= b[0] for a, b in zip(tickets, tickets[1:]))
    assert not tickets or (tickets[0][0] > plan.counter_word(2, plan.row_tiles - 1)
                           and tickets[-1][1] <= plan.sync_words)
    table = plan.table()
    assert len(table) == plan.buffer_words and not any(table[:plan.sync_words])


@pytest.mark.parametrize(SIG, PLANS)
def test_plan_words_are_what_the_launch_checks(n, t, d, hid, ctas):
    """The words the launch reads (csrc/dit_block_tp.cu read_mlp_plan,
    which hands them to the TP kernels' read_plan): the TP header with the
    pre items' token rows in the modulation product's word, then the three
    stages with the items the launch counts (the pre items, a product's row
    tiles times its 256-column tiles times its splits), counters and
    tickets inside the sync words and targets after them, then a fourth
    stage's words, zero."""
    plan = mb.mlp_plan(n, t, d, hid, ctas)
    words = plan.words()
    assert len(words) == tpk.TP_PLAN_WORDS and not any(words[tpk.TP_PLAN_HEADER + 3 * tpk.TP_PLAN_STAGE_WORDS:])
    assert words[:tpk.TP_PLAN_HEADER] == (3, plan.sync_words, plan.buffer_words, ctas, plan.pre_rows, 0, 0, 0)
    row_tiles = -(-plan.m // STACK_TILE)
    for i in range(3):
        g = words[tpk.TP_PLAN_HEADER + i * tpk.TP_PLAN_STAGE_WORDS:][:tpk.TP_PLAN_STAGE_WORDS]
        assert g[3] == plan.counter_word(i, 0) >= tpk.TP_SYNC_DONE and g[3] + 8 * (row_tiles - 1) < plan.sync_words
        assert g[5] == plan.target_offset(i) >= plan.sync_words and g[5] + row_tiles <= plan.buffer_words
        if i == 0:
            assert g[:3] == (0, -(-plan.m // plan.pre_rows), 1) and g[4] == 0
            continue
        p = plan.products[i - 1]
        assert g[0] == 1 and g[1] == row_tiles * -(-p.n // tpk.MLP_WIDE) * g[2] and g[2] == p.splits
        assert (g[4] == 0) == (p.splits == 1)
        assert g[2] == 1 or tpk.TP_SYNC_DONE <= g[4] and g[4] + p.tiles <= plan.sync_words


def test_plan_at_b2_is_what_the_kernel_note_says():
    """The plans the header note of csrc/dit_block_tp.cu reasons about on
    132 CTAs: at N=64, 128 pre items of 32 rows, fc1's 384 tiles of 12 k
    steps and fc2's 96 of 48, unsplit; CTAs 0-79 take a pre item, three fc1
    items and one fc2 item (84 k steps), CTAs 80-115 no fc2 item; at N=256
    four times the items; one sample of 4 tokens at XL/2 splits fc2's 5
    tiles four ways."""
    p64 = mb.mlp_plan(64, 64, 768, 3072, CTAS)
    fc1, fc2 = p64.products
    assert (p64.pre_items, p64.pre_rows) == (128, 32)
    assert (fc1.items, fc1.kt, fc2.items, fc2.kt, fc2.splits) == (384, 12, 96, 48, 1)
    walk = p64.walk()
    steps = [sum(w[4] - w[3] for name, _, w in cta if name != "pre") for cta in walk]
    assert max(steps) == 84 and steps[:80] == [84] * 80
    assert all(not any(name == "fc2" for name, _, _ in walk[c]) for c in range(80, 116))
    p256 = mb.mlp_plan(256, 64, 768, 3072, CTAS)
    assert (p256.pre_items, *(p.items for p in p256.products)) == (512, 1536, 384)
    assert mb.mlp_plan(1, 4, 1152, 4608, CTAS).stage("fc2").product.splits == 4


# row 8's plan words and table at the XL/2 shard shapes (8 samples of 64
# tokens, D=1152, H_l = 4608 / tp, 132 CTAs), as they stood before row 9
# joined its kernel's file
ROW8_WORDS = {
    2: (3, 164, 176, 132, 0, 0, 0, 0, 0, 128, 1, 32, 0, 164, 1, 72, 1, 64, 0, 168, 1, 72, 2, 96, 128, 172,
        0, 0, 0, 0, 0, 0),
    4: (3, 128, 140, 132, 0, 0, 0, 0, 0, 128, 1, 32, 0, 128, 1, 36, 1, 64, 0, 132, 1, 36, 1, 96, 0, 136,
        0, 0, 0, 0, 0, 0),
}


@pytest.mark.parametrize("tp", sorted(ROW8_WORDS))
def test_row8_plan_words_are_unchanged(tp):
    plan = tpk.tp_plan("mlp", 8, 64, 1152, 4608 // tp, ctas=CTAS)
    assert plan.words() == ROW8_WORDS[tp]
    assert plan.table()[plan.sync_words:] == tuple(plan.per_row(i, r) for i in range(3) for r in range(4))


@pytest.mark.parametrize("d, hid, ok", [(768, 3072, True), (384, 1536, True), (1152, 4608, True), (1148, 4608, False),
                                        (768, 3068, False)])
def test_shape_rule(d, hid, ok):
    if ok:
        tpk.check_tp_shape("mlp_branch", 64, d, hid)
    else:
        with pytest.raises(ValueError, match="multiples of 8"):
            tpk.check_tp_shape("mlp_branch", 64, d, hid)


def test_plan_refuses_a_width_whose_rows_fill_no_stage():
    """Eight rows of x must fit a 48 KB ring stage: D up to 3072."""
    assert mb.mlp_plan(8, 64, 3072, 12288, CTAS).pre_rows == 8
    with pytest.raises(ValueError, match="no plan"):
        mb.mlp_plan(8, 64, 3136, 12544, CTAS)


@pytest.mark.parametrize("t", [4, 16])
def test_launch_sequence_is_the_plain_version_on_the_cpu(t):
    """The yardstick route runs mp_gemm, whose CPU route is its plain
    version: on CPU tensors it gives the plain version's bits, as the
    wrapper does, and counts nothing."""
    g = torch.Generator().manual_seed(4)
    n, d, hid = 3, 32, 128
    x, shift, scale, gate = (torch.randn(*s, generator=g) for s in ((n, t, d), (n, d), (n, d), (n, d)))
    w1, w2 = torch.randn(hid, d, generator=g), torch.randn(d, hid, generator=g)
    gain = torch.tensor(0.4)
    mb.reset_launch_counts()
    want = mb.fused_mlp_branch_plain(x, shift, scale, gate, gain, w1, w2)
    assert torch.equal(mb.mlp_launch_sequence(x, shift, scale, gate, gain, w1, w2), want)
    assert torch.equal(mb.fused_mlp_branch(x, shift, scale, gate, gain, w1, w2), want)
    assert all(v == 0 for v in mb.LAUNCHES.values())
