"""The attention half-block's one-launch kernels of rows 3, 4 and 5
(``csrc/attn_branch.cu``) on the CPU: their plan (``ops/cuda/attn_branch.py``
``branch_plan``, the words and counter targets the launch reads) walked as
the kernel walks it at the DiT-S/2, B/2 and XL/2 training shapes and at a
ragged last tile; the route and the shape rule; an emulation that runs the
plan's items in list order, each with its plain math, against
``attn_fwd_plain`` / ``attn_bwd_plain`` / ``attn_res_fwd_plain`` bit for
bit; the port's cotangents against the JAX package's ``_attn_bwd`` and its
residual forward against ``_attn_res_fwd_impl`` (their Pallas kernels in
interpret mode) at the JAX package's tolerances, for head widths 64 and 72.
The kernels themselves run on the card only (``chip_smoke.py`` phase 3).
"""

import collections
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mapdit_tpu.ops.pallas import dit_block as jdb
from mapdit_tpu_torch.ops.cuda import attn_branch as ab
from mapdit_tpu_torch.ops.cuda import dit_block as tdb
from mapdit_tpu_torch.ops.cuda import dit_block_tp as tpk
from mapdit_tpu_torch.ops.cuda.dit_block import STACK_TILE

GRAD_TOL = dict(rtol=5e-4, atol=5e-4)
FWD_TOL = dict(rtol=2e-4, atol=2e-4)
CTAS = 132
# name -> (N, T, D, heads): the training shapes at batch 256, then a ragged
# last row tile (N = 3 at T = 64), and the short sequences
WALKS = {
    "s2": (256, 64, 384, 6),
    "b2": (256, 64, 768, 12),
    "xl": (256, 64, 1152, 16),
    "n3": (3, 64, 384, 6),
    "xl-t16": (8, 16, 1152, 16),
    "t2": (5, 2, 384, 6),
}
PLANS = [pytest.param(kind, name, id=f"{kind}-{name}") for kind in ("fwd", "bwd", "res_fwd") for name in WALKS]


def _plan(kind, name, ctas=CTAS):
    n, t, d, heads = WALKS[name]
    return ab.branch_plan(kind, n, t, d, heads, ctas)


@pytest.mark.parametrize("kind, name", PLANS)
def test_plan_stages_cover_the_work_once(kind, name):
    """The list is the kind's stages in order; every product's tiles are
    computed once (no K splits), the pre items cover the token rows once,
    and each attention stage's units cover every (sample, head) once."""
    plan = _plan(kind, name)
    n, t, d, heads = WALKS[name]
    assert tuple(s.name for s in plan.stages) == ab.BRANCH_STAGES[kind]
    walked = [entry for items in plan.walk() for entry in items]
    assert len(walked) == plan.items
    for stage in plan.stages:
        seen = [what for sname, _, what in walked if sname == stage.name]
        if stage.product is not None:
            p = stage.product
            assert p.splits == 1 and p.m == n * t
            assert sorted((r, c) for r, c, *_ in seen) == [(r, c) for r in range(p.row_tiles)
                                                           for c in range(p.col_tiles)]
            assert all(kb == 0 and ke == p.kt for *_, kb, ke in seen)
        elif stage.name == "pre":
            rows = sorted(seen)
            assert rows[0][0] == 0 and rows[-1][1] == n * t and all(a[1] == b[0] for a, b in zip(rows, rows[1:]))
        else:
            assert sorted(u for units in seen for u in units) == list(range(n * heads))
    shapes = {s.name: (s.product.n, s.product.k) for s in plan.stages if s.product is not None}
    want = {"qkv": (3 * d, d), "out": (d, d), "dattn": (d, d), "dh": (d, 3 * d)}
    assert shapes == {k: v for k, v in want.items() if k in shapes}


@pytest.mark.parametrize("kind, name", PLANS)
def test_plan_waits_point_backwards_and_counters_reach_their_targets(kind, name):
    """Every wait of an item is on the previous stage's counter of a row
    tile it reads, which only earlier items raise, exactly to the count
    waited for and to the target the launch reads from the table; every
    counter reaches its target once the list is done; a simulation of the
    CTAs (each takes items c, c + ctas, ... in order, an item runs once its
    waits are met) finishes every item, at the card's CTAs and at a few."""
    plan = _plan(kind, name)
    table = plan.table()
    raised = collections.defaultdict(list)
    for g in range(plan.items):
        i, j = plan.locate(g)
        for r in plan.rows_of(i, j):
            raised[(i, r)].append(g)
    for i in range(len(plan.stages)):
        for r in range(plan.row_tiles):
            assert len(raised[(i, r)]) == plan.per_row(i, r) == table[plan.target_offset(i) + r] > 0
    for g in range(plan.items):
        i, j = plan.locate(g)
        waits = plan.waits(i, j)
        assert (i == 0) == (waits == ())
        for stage, r, count in waits:
            assert stage == i - 1 and count == len(raised[(stage, r)]) and max(raised[(stage, r)]) < g
    for ctas in (CTAS, 7):
        small = _plan(kind, name, ctas)
        queues = [collections.deque(range(c, small.items, ctas)) for c in range(ctas)]
        counts = collections.Counter()
        done = 0
        progress = True
        while progress:
            progress = False
            for q in queues:
                while q:
                    i, j = small.locate(q[0])
                    if any(counts[(s, r)] < n for s, r, n in small.waits(i, j)):
                        break
                    counts.update((i, r) for r in small.rows_of(i, j))
                    q.popleft()
                    done += 1
                    progress = True
        assert done == small.items


@pytest.mark.parametrize("kind, name", PLANS)
def test_each_sample_lies_in_one_row_tile(kind, name):
    """T divides 128, so every sample's rows lie in one row tile: its
    attention units wait on, and raise, one counter, and the per-sample
    sums (dgate, dshift, dscale) are sums inside a tile."""
    plan = _plan(kind, name)
    n, t, _, heads = WALKS[name]
    for sample in range(n):
        assert sample * t // STACK_TILE == (sample * t + t - 1) // STACK_TILE
    for i, stage in enumerate(plan.stages):
        if stage.product is None and stage.name != "pre":
            for j in range(stage.items):
                assert len(plan.rows_of(i, j)) == len(plan.units(j))  # one counter a unit
                assert all(len(w) == 3 for w in plan.waits(i, j)) and len(plan.waits(i, j)) == len(plan.units(j))


@pytest.mark.parametrize("kind, name", PLANS)
def test_plan_words_sync_words_and_scratch_are_what_the_launch_reads(kind, name):
    """The words: the TP plans' header (stages, sync words, buffer words,
    CTAs, the dgain ticket word for the backward, the token rows of a pre
    item) and a group a stage
    (kind, items, one split, counter word of row tile 0, no ticket, target
    offset), padded to BRANCH_PLAN_WORDS; the counters and the ticket lie
    inside the sync words, the table after them; the workspace's regions
    are 256-byte aligned, apart and hold what the kernel writes."""
    plan = _plan(kind, name)
    n, t, d, heads = WALKS[name]
    m = n * t
    words = plan.words()
    assert len(words) <= ab.BRANCH_PLAN_WORDS
    ticket = plan.tickets.get("dgain", 0)
    assert words[:tpk.TP_PLAN_HEADER] == (len(plan.stages), plan.sync_words, plan.buffer_words, CTAS, ticket,
                                          plan.pre_rows, 0, 0)
    # the most of 32, 16, 8 rows whose rows of x (64-column boxes) fill a 32 KB ring stage
    assert plan.pre_rows == {384: 32, 768: 16, 1152: 8}[d] and STACK_TILE % plan.pre_rows == 0
    for i, stage in enumerate(plan.stages):
        g = words[tpk.TP_PLAN_HEADER + i * tpk.TP_PLAN_STAGE_WORDS:][:tpk.TP_PLAN_STAGE_WORDS]
        kind_word = 1 if stage.product is not None else tpk.TP_STAGE_KINDS[stage.name]
        assert g == (kind_word, stage.items, 1, plan.counter_word(i, 0), 0, plan.target_offset(i))
    counters = {plan.counter_word(i, r) for i in range(len(plan.stages)) for r in range(plan.row_tiles)}
    assert min(counters) >= tpk.TP_SYNC_DONE and max(counters) < plan.sync_words
    assert (ticket == 0) == (kind in ("fwd", "res_fwd"))
    if ticket:
        assert ticket not in counters and ticket == plan.sync_words - 1
    assert plan.buffer_words == plan.sync_words + len(plan.stages) * plan.row_tiles
    # row 5's attn is an output of the call (the backward keeps it), not
    # scratch, and its h lies in attn's memory
    sizes = {"qkv": m * 3 * d * 4} if kind == "res_fwd" else {"h": m * d * 2, "qkv": m * 3 * d * 4, "attn": m * d * 2}
    if kind == "bwd":
        dh = plan.stage("dh").product
        sizes.update(dout=m * d * 2, dattn=m * d * 4, dqkv=m * 3 * d * 2, dgain_partial=dh.tiles * 4)
    assert set(plan.layout) == set(sizes)
    spans = sorted((plan.layout[k], plan.layout[k] + v) for k, v in sizes.items())
    assert all(a % 256 == 0 for a, _ in spans) and spans[-1][1] <= plan.workspace_bytes
    assert all(a[1] <= b[0] for a, b in zip(spans, spans[1:]))


@pytest.mark.parametrize("t, d, heads, route", [
    (64, 384, 6, "kernel"), (16, 768, 12, "kernel"), (4, 1152, 16, "kernel"), (2, 384, 6, "kernel"),
    (48, 384, 6, "sequence"), (96, 384, 6, "sequence"), (256, 384, 6, "sequence"), (64, 480, 6, "sequence"),
    (64, 132, 2, "sequence"), (64, 2112, 33, "sequence"),
], ids=["s2", "b2-t16", "xl-t4", "t2", "t48", "t96", "t256", "hd80", "d-not-8", "d-past-a-stage"])
def test_route_is_the_shape_rule(t, d, heads, route):
    """The one-launch kernel takes an even T <= 64 dividing 128, head
    widths 64 and 72, D a multiple of 8, x and weights all bf16 or all f32
    (its f32 instances); elsewhere the launch sequence (which raises where
    it raises: at head width 80 cosine_attention does, on a mixed set
    _check); the shape rule and the plan raise outside the domain."""
    x = torch.zeros(2, t, d, dtype=torch.bfloat16)
    w_qkv, w_out = torch.zeros(3 * d, d, dtype=torch.bfloat16), torch.zeros(d, d, dtype=torch.bfloat16)
    assert ab.branch_route(x, w_qkv, w_out, heads) == route
    assert ab.branch_route(x.float(), w_qkv.float(), w_out.float(), heads) == route
    assert ab.branch_route(x.float(), w_qkv, w_out, heads) == "sequence"
    if route == "kernel":
        ab.check_branch_shape(t, d, heads)
        assert ab.branch_plan("bwd", 2, t, d, heads).tokens == t
        assert ab.branch_plan("res_fwd", 2, t, d, heads).kernel == "branch_res_fwd"
    else:
        with pytest.raises(ValueError, match="attn_branch on CUDA"):
            ab.check_branch_shape(t, d, heads)
        for kind in ("fwd", "res_fwd"):
            with pytest.raises(ValueError, match="attn_branch on CUDA"):
                ab.branch_plan(kind, 2, t, d, heads)


@pytest.mark.parametrize("t, switch, route", [(64, True, "kernel"), (64, False, "sequence"), (48, True, "sequence")],
                         ids=["s2", "switched-off", "t48"])
def test_res_fwd_route_off_the_cpu(monkeypatch, t, switch, route):
    """Row 5 on a tensor that is not on the CPU (a meta tensor: nothing is
    built or launched) takes the one-launch kernel where branch_route takes
    the shape, which raises naming CUDA before anything is counted, and
    otherwise its launch sequence, counted as attn_branch/res_fwd/sequence,
    whose first kernel raises naming CUDA; BRANCH_KERNELS False switches row
    5 to its sequence with rows 3 and 4."""
    monkeypatch.setattr(ab, "BRANCH_KERNELS", switch)
    n, d, heads, bf = 2, 384, 6, torch.bfloat16
    x = torch.empty(n, t, d, dtype=bf, device="meta")
    r = torch.empty(n, d, dtype=bf, device="meta")
    w_qkv, w_out = torch.empty(3 * d, d, dtype=bf, device="meta"), torch.empty(d, d, dtype=bf, device="meta")
    assert ab.branch_route(x, w_qkv, w_out, heads) == route
    ab.reset_launch_counts()
    with pytest.raises(ValueError, match="CUDA"):
        ab.attn_res_fwd(x, r, r, r, torch.empty((), device="meta"), w_qkv, w_out, heads)
    seq = 1 if route == "sequence" else 0
    assert ab.LAUNCHES["attn_branch/res_fwd/sequence"] == seq and ab.LAUNCHES["attn_branch/res_fwd"] == 0
    ab.reset_launch_counts()


def test_route_follows_the_switch(monkeypatch):
    x = torch.zeros(2, 64, 384, dtype=torch.bfloat16)
    w_qkv, w_out = torch.zeros(3 * 384, 384, dtype=torch.bfloat16), torch.zeros(384, 384, dtype=torch.bfloat16)
    monkeypatch.setattr(ab, "BRANCH_KERNELS", False)
    assert ab.branch_route(x, w_qkv, w_out, 6) == "sequence"


def test_one_launch_wrappers_are_their_plain_versions_on_the_cpu():
    *args, dy = _inputs(np.random.default_rng(0), 2, 16, 128, 2)
    assert torch.equal(ab.attn_branch_fwd(*args, 2), ab.attn_fwd_plain(*args, 2))
    *five, (h, attn, dout, dqkv) = ab.attn_branch_bwd(dy, *args, 2)
    want = ab.attn_bwd_plain(dy, *args, 2)
    assert all(torch.equal(a, b) for a, b in zip(five, want[:5]))
    assert h.shape == attn.shape == dout.shape == (32, 128) and dqkv.shape == (32, 384)
    assert h.dtype == attn.dtype == dout.dtype == dqkv.dtype == torch.bfloat16
    inv_d = 1 / math.sqrt(128)
    assert torch.equal(want[5], ab._dw_product(dqkv, h, inv_d)) and torch.equal(want[6], ab._dw_product(dout, attn, inv_d))
    res = ab.attn_branch_res_fwd(*args, 2)
    assert all(torch.equal(a, b) for a, b in zip(res, ab.attn_res_fwd_plain(*args, 2)))
    assert [tuple(v.shape) for v in res] == [(2, 16, 128), (2, 2, 16, 16), (2, 16, 128)]
    assert [v.dtype for v in res] == [torch.bfloat16, torch.float32, torch.bfloat16]


# ---------------------------------------------------------------------------
# the emulation: the plan's items in list order, each with its plain math


def _inputs(rng, n, t, d, heads, dtype=torch.bfloat16):
    def f(*s, scale=1.0):
        return torch.from_numpy(rng.normal(size=s).astype(np.float32) * scale)

    x = f(n, t, d).to(dtype)
    shift, scale, gate = (f(n, d).to(dtype) for _ in range(3))
    gain = torch.tensor(0.37)
    w_qkv, w_out = f(3 * d, d, scale=d**-0.5).to(dtype), f(d, d, scale=d**-0.5).to(dtype)
    return x, shift, scale, gate, gain, w_qkv, w_out, f(n, t, d).to(dtype)


def _unit_cols(head, hd, d):
    return torch.cat([torch.arange(c * d + head * hd, c * d + (head + 1) * hd) for c in range(3)])


def emulate(kind, args, heads, dy=None):
    """Runs branch_plan(kind)'s items in list order on the CPU, each with
    the plain math of its stage on the rows (and columns) it covers, after
    asserting that what it waits for is done. Every array starts as NaN, so
    an item that read rows no earlier item wrote, or a tile no item
    covered, shows in the result. A product item takes its tile of the
    stage's plain product over the whole (partly written) operand: a row of
    a product depends on its own row of A alone, and the library's sums
    over K differ between sub-blocks of one shape and another. Returns y
    (fwd), y, p and attn (res_fwd: row 3's list whose attention normalises
    p first and stores it, as the bwd list's recompute does without the
    store; h and attn are one array, as the launch lays them out, so an
    attention item that overwrote h rows a qkv item had still to read would
    show) or the seven cotangents (bwd), the dW pair from the emulated
    operands."""
    x, shift, scale, gate, gain, w_qkv, w_out = args
    n, t, d = x.shape
    m, hd, inv_d = n * t, d // heads, 1.0 / math.sqrt(d)
    bf, f32 = w_qkv.dtype, torch.float32
    plan = ab.branch_plan(kind, n, t, d, heads, CTAS)
    rows, g = ab._pack(shift, scale, gate, gain)
    xf = x.reshape(m, d)
    dyf = None if dy is None else dy.reshape(m, d)

    def nan(*shape, dtype=f32):
        return torch.full(shape, float("nan"), dtype=dtype)

    h, qkv, attn = nan(m, d, dtype=bf), nan(m, 3 * d), nan(m, d, dtype=bf)
    if kind == "res_fwd":
        attn = h
    y, dout, dattn, dqkv = nan(m, d, dtype=x.dtype), nan(m, d, dtype=bf), nan(m, d), nan(m, 3 * d, dtype=bf)
    dx, dshift, dscale, dgate = nan(m, d, dtype=x.dtype), nan(n, d), nan(n, d), nan(n, d)
    probs = nan(n, heads, t, t)
    partials = []
    counts = collections.Counter()
    for gi in range(plan.items):
        i, j = plan.locate(gi)
        stage = plan.stages[i]
        assert all(counts[(s, r)] == c for s, r, c in plan.waits(i, j))
        counts.update((i, r) for r in plan.rows_of(i, j))
        if stage.name == "pre":
            r0, r1 = j * plan.pre_rows, min(m, (j + 1) * plan.pre_rows)
            if r1 - r0 <= t and r0 // t == (r1 - 1) // t:
                h[r0:r1] = ab.modulate_fwd_plain(xf[r0:r1], rows[r0 // t : r0 // t + 1], g, r1 - r0, bf)
            else:
                h[r0:r1] = ab.modulate_fwd_plain(xf[r0:r1], rows[r0 // t : r1 // t], g, t, bf)
            continue
        if stage.product is None:
            for u in plan.units(j):
                sample, head = divmod(u, heads)
                rs, cols = slice(sample * t, (sample + 1) * t), _unit_cols(head, hd, d)
                if stage.name == "attention":
                    p_unit = probs[sample, head : head + 1][None] if kind == "res_fwd" else None
                    attn[rs, head * hd : (head + 1) * hd] = tdb.cosine_attention_plain(
                        qkv[rs][:, cols], t, 1, bf, normalize_first=kind != "fwd", probs=p_unit)
                else:
                    dqkv[rs, cols] = ab.attention_bwd_plain(qkv[rs][:, cols], dattn[rs, head * hd : (head + 1) * hd],
                                                            t, 1, bf)
            continue
        r, c = stage.product.item(j)[:2]
        r0, r1 = r * STACK_TILE, min(m, (r + 1) * STACK_TILE)
        rs, samples = slice(r0, r1), slice(r0 // t, r1 // t)
        c0 = c * STACK_TILE
        if stage.name == "qkv":
            cs = slice(c0, min(3 * d, c0 + STACK_TILE))
            qkv[rs, cs] = tdb.mp_gemm_plain(h, w_qkv, alpha=inv_d, out_dtype=f32)[rs, cs]
            continue
        cs = slice(c0, min(d, c0 + STACK_TILE))
        width = cs.stop - cs.start
        if stage.name == "out" and kind != "bwd":
            y[rs, cs] = tdb.mp_gemm_plain(attn, w_out, alpha=inv_d, out_dtype=x.dtype, residual=(xf, rows, 2 * d),
                                          tokens=t)[rs, cs]
        elif stage.name == "out":
            out = tdb.mp_gemm_plain(attn, w_out, alpha=inv_d, out_dtype=f32)[rs, cs]
            dout[rs, cs], dgate[samples, cs] = ab.gate_residual_bwd_plain(dyf[rs, cs], out, rows[samples],
                                                                          2 * d + c0, t, bf)
        elif stage.name == "dattn":
            dattn[rs, cs] = tdb.mp_gemm_plain(dout, w_out, alpha=inv_d, out_dtype=f32, w_kn=True)[rs, cs]
        else:
            dh = tdb.mp_gemm_plain(dqkv, w_qkv, alpha=inv_d, out_dtype=f32, w_kn=True)[rs, cs]
            tile_rows = torch.cat([rows[samples, cs], rows[samples, d + c0 : d + c0 + width]], dim=1)
            dx[rs, cs], dshift[samples, cs], dscale[samples, cs], _ = ab.modulate_bwd_plain(
                dh, xf[rs, cs], tile_rows, g, dyf[rs, cs], t)
            partials.append(ab.dgain_terms(dh, xf[rs, cs], tile_rows, g, t).contiguous().sum())
    if kind == "fwd":
        return y.reshape(n, t, d)
    if kind == "res_fwd":
        return y.reshape(n, t, d), probs, attn.reshape(n, t, d)
    total = partials[0]
    for p in partials[1:]:
        total = total + p
    gg = g.reshape(())
    dgain = (total / torch.sqrt((1.0 - gg) ** 2 + gg**2)).reshape(1)
    dw_qkv, dw_out = ab._dw_pair(dqkv, h, dout, attn, inv_d, ab.dw_gemm_plain)
    return dx.reshape(n, t, d), dshift, dscale, dgate, dgain, dw_qkv, dw_out


EMULATED = {
    "hd64-t16-ragged": (10, 16, 128, 2),
    "hd64-t64-n3": (3, 64, 64, 1),
    "hd72-t16-ragged-cols": (10, 16, 144, 2),
    "hd72-t4": (6, 4, 72, 1),
    "hd64-t2": (5, 2, 64, 1),
}


@pytest.mark.parametrize("name", EMULATED)
def test_emulated_forward_plan_is_the_plain_forward_bit_for_bit(name):
    n, t, d, heads = EMULATED[name]
    *args, _ = _inputs(np.random.default_rng(1), n, t, d, heads)
    want = ab.attn_fwd_plain(*args, heads)
    assert torch.equal(emulate("fwd", args, heads), want)
    assert torch.equal(ab.attn_fwd(*args, heads), want)


@pytest.mark.parametrize("name", EMULATED)
def test_emulated_residual_forward_plan_is_the_plain_residual_forward_bit_for_bit(name):
    """y, the f32 p and attn of row 5's list in order equal
    attn_res_fwd_plain's bits; the wrappers on the CPU give the same."""
    n, t, d, heads = EMULATED[name]
    *args, _ = _inputs(np.random.default_rng(3), n, t, d, heads)
    want = ab.attn_res_fwd_plain(*args, heads)
    for nm, got, w in zip(("y", "p", "attn"), emulate("res_fwd", args, heads), want):
        assert got.dtype == w.dtype and got.shape == w.shape and torch.equal(got, w), nm
    for wrapper in (ab.attn_res_fwd, ab.attn_branch_res_fwd):
        assert all(torch.equal(a, b) for a, b in zip(wrapper(*args, heads), want))


@pytest.mark.parametrize("name", EMULATED)
def test_emulated_backward_plan_is_the_plain_backward_bit_for_bit(name):
    """All seven cotangents, the in-tile dgate, dshift and dscale sums and
    dgain summed tile by tile in the list's order among them; the wrapper
    on the CPU gives the same bits."""
    n, t, d, heads = EMULATED[name]
    *args, dy = _inputs(np.random.default_rng(2), n, t, d, heads)
    want = ab.attn_bwd_plain(dy, *args, heads)
    for nm, got, w in zip(("dx", "dshift", "dscale", "dgate", "dgain", "dw_qkv", "dw_out"),
                          emulate("bwd", args, heads, dy), want):
        assert got.dtype == w.dtype and got.shape == w.shape and torch.equal(got, w), nm
    for got, w in zip(ab.attn_bwd(dy, *args, heads), want):
        assert torch.equal(got, w)
    *five, ops = ab.attn_branch_bwd(dy, *args, heads)
    assert all(torch.equal(a, b) for a, b in zip(five, want[:5])) and len(ops) == 4


def test_dgain_in_tile_order_sums_the_tiles_in_order():
    terms = torch.randn(300, 200, generator=torch.Generator().manual_seed(3))
    gain = torch.tensor(0.25)
    tiles = [terms[r:r + 128, c:c + 128].sum() for r in (0, 128, 256) for c in (0, 128)]
    want = tiles[0]
    for p in tiles[1:]:
        want = want + p
    got = ab.dgain_in_tile_order(terms, gain)
    assert got.shape == (1,)
    torch.testing.assert_close(got, want.reshape(1) / math.sqrt(0.75**2 + 0.25**2))
    torch.testing.assert_close(got, terms.double().sum().reshape(1).float() / math.sqrt(0.625), rtol=1e-5, atol=1e-3)


# ---------------------------------------------------------------------------
# against the JAX package's backward


@pytest.mark.parametrize("d, heads", [(128, 2), (144, 2)], ids=["hd64", "hd72"])
def test_cotangents_match_jax_attn_bwd(d, heads):
    """The port's seven cotangents (the plain math of both one-launch
    kernels and the dW pair, on the CPU) against JAX's ``_attn_bwd`` on the
    same numpy inputs, its Pallas kernel in interpret mode, at the JAX
    package's tolerance (rtol = atol = 5e-4)."""
    rng = np.random.default_rng(5)
    n, t = 4, 16

    def f(*s, scale=1.0):
        return rng.normal(size=s).astype(np.float32) * scale

    args = [f(n, t, d), f(n, d), f(n, d), f(n, d), np.float32(0.4), f(3 * d, d, scale=d**-0.5),
            f(d, d, scale=d**-0.5)]
    dy = f(n, t, d)
    want = jdb._attn_bwd(jnp.asarray(dy), *(jnp.asarray(a) for a in args), heads)
    got = ab.attn_bwd(torch.from_numpy(dy), *(torch.as_tensor(a) for a in args), heads)
    for nm, g_, w_ in zip(("dx", "dshift", "dscale", "dgate", "dgain", "dw_qkv", "dw_out"), got, want):
        w_ = np.asarray(w_)
        assert g_.numpy().size == w_.size, nm
        np.testing.assert_allclose(g_.numpy().reshape(w_.shape), w_, err_msg=nm, **GRAD_TOL)


@pytest.mark.parametrize("d, heads", [(128, 2), (144, 2)], ids=["hd64", "hd72"])
def test_residual_forward_matches_jax_attn_res_fwd(d, heads):
    """attn_res_fwd (its plain math on the CPU, which the emulation above
    holds row 5's list to bit for bit) against JAX's ``_attn_res_fwd_impl``
    (its Pallas kernel in interpret mode) on the same numpy inputs: y, the
    f32 p and the pre-projection attention at the JAX package's forward
    tolerance (rtol = atol = 2e-4), at the head widths the kernel takes."""
    rng = np.random.default_rng(6)
    n, t = 4, 16

    def f(*s, scale=1.0):
        return rng.normal(size=s).astype(np.float32) * scale

    args = [f(n, t, d), f(n, d), f(n, d), f(n, d), np.float32(0.4), f(3 * d, d, scale=d**-0.5),
            f(d, d, scale=d**-0.5)]
    want = jdb._attn_res_fwd_impl(*(jnp.asarray(a) for a in args), heads)
    got = ab.attn_res_fwd(*(torch.as_tensor(a) for a in args), heads)
    shapes = ((n, t, d), (n, heads, t, t), (n, t, d))
    for nm, g_, w_, shape in zip(("y", "p", "attn"), got, want, shapes):
        w_ = np.asarray(w_)
        assert tuple(g_.shape) == shape and g_.dtype == torch.float32, nm
        np.testing.assert_allclose(g_.numpy(), w_.reshape(shape), err_msg=nm, **FWD_TOL)
