"""The port's block kernels (ops/cuda/dit_block.py) against the JAX Pallas
kernels, which run in interpret mode on the CPU. On CPU tensors the port's
wrappers run their plain versions, so this holds the math the CUDA kernels
compute; the kernels themselves are held against the same plain versions on
the card by chip_smoke.py. Tolerance 2e-4 in float32, as the JAX package's
own kernel parity (mapdit_tpu/ops/pallas/dit_block.py:57-59)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mapdit_tpu.ops.pallas import dit_block as jdb
from mapdit_tpu_torch.ops.cuda import dit_block as tdb

N, T, D, HEADS, H, DEPTH = 4, 16, 64, 2, 256, 2
TOL = dict(rtol=2e-4, atol=2e-4)


def _inputs(seed, depth=None):
    rng = np.random.default_rng(seed)
    lead = () if depth is None else (depth,)

    def f(*s):
        return rng.normal(size=s).astype(np.float32)

    def w(*s):
        m = f(*lead, *s)
        return m * np.sqrt(s[-1]) / (np.linalg.norm(m, axis=-1, keepdims=True) + 1e-4)

    gains = rng.uniform(0.1, 0.9, size=lead + (2,)).astype(np.float32)
    return [f(N, T, D), f(N, D), gains, w(6 * D, D), w(3 * D, D), w(D, D), w(H, D), w(D, H)]


def _port(fn, args, dtype=torch.float32):
    out = fn(*[torch.from_numpy(a).to(dtype if a.ndim > 1 else torch.float32) for a in args], HEADS)
    return out.float().numpy()


def test_fused_dit_block_matches_jax():
    args = _inputs(0)
    want = np.asarray(jdb.fused_dit_block(*[jnp.asarray(a) for a in args], HEADS))
    np.testing.assert_allclose(_port(tdb.fused_dit_block, args), want, **TOL)


def test_fused_dit_stack_matches_jax():
    args = _inputs(1, depth=DEPTH)
    want = np.asarray(jdb.fused_dit_stack(*[jnp.asarray(a) for a in args], HEADS))
    np.testing.assert_allclose(_port(tdb.fused_dit_stack, args), want, **TOL)


def test_stack_equals_block_sequence():
    args = _inputs(2, depth=DEPTH)
    x, a, gains, *ws = [torch.from_numpy(v) for v in args]
    step = x
    for b in range(DEPTH):
        step = tdb.fused_dit_block(step, a, gains[b], *[w[b] for w in ws], HEADS)
    torch.testing.assert_close(tdb.fused_dit_stack(x, a, gains, *ws, HEADS), step, rtol=0, atol=0)


@pytest.mark.parametrize("n", [4, 3])
def test_attention_core_matches_jax(n):
    """The plain cosine-attention core against the Pallas body's
    _attention_core called directly on arrays (n=4 takes its paired-sample
    form, n=3 its per-head form)."""
    qkv = np.random.default_rng(n).normal(size=(n * T, 3 * D)).astype(np.float32)
    want = np.asarray(jdb._attention_core(jnp.asarray(qkv), n, T, D, HEADS, jnp.float32))
    got = tdb.cosine_attention(torch.from_numpy(qkv), T, HEADS, torch.float32).numpy()
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize(
    "n, t, heads, hd", [(4, 16, 2, 72), (3, 16, 2, 72), (4, 256, 2, 32), (3, 256, 2, 32)],
    ids=["hd72-n4", "hd72-n3", "t256-n4", "t256-n3"],
)
def test_attention_core_shapes_match_jax(n, t, heads, hd):
    """The plain cosine-attention core against the Pallas _attention_core
    at the XL head width and at T=256 (input size 32), at n=4 and n=3, the
    two forms of the Pallas body (paired samples where they fit, per head)."""
    d = heads * hd
    qkv = np.random.default_rng(10 + n).normal(size=(n * t, 3 * d)).astype(np.float32)
    want = np.asarray(jdb._attention_core(jnp.asarray(qkv), n, t, d, heads, jnp.float32))
    got = tdb.cosine_attention_plain(torch.from_numpy(qkv), t, heads, torch.float32).numpy()
    np.testing.assert_allclose(got, want, **TOL)


def test_cosine_attention_serves_every_registry_model():
    """Every registry model at input sizes 16 and 32 (T = 4 ... 256, head
    widths 64 and 72, and the tensor-parallel shards, which keep the head
    width) is in the tensor-core kernel's domain; another head width or an
    odd T raises."""
    from mapdit_tpu_torch.models.registry import DIT_MODELS

    for name, spec in DIT_MODELS.items():
        hd = spec["hidden_size"] // spec["num_heads"]
        for size in (16, 32):
            tdb.check_attention_shape((size // spec["patch_size"]) ** 2, hd)
    with pytest.raises(ValueError, match="head widths"):
        tdb.check_attention_shape(64, 32)
    with pytest.raises(ValueError, match="even T"):
        tdb.check_attention_shape(9, 64)


def test_cosine_attention_refuses_an_f32_output_off_the_cpu():
    """The kernel's products are bf16 on the tensor cores: off the CPU an
    f32 output raises, naming the bf16-only kernel, before anything is
    built (the plain version on the CPU takes f32 and rounds nothing)."""
    qkv = torch.empty(8, 3 * 128, device="meta")
    with pytest.raises(ValueError, match="bf16 only"):
        tdb.cosine_attention(qkv, 4, 2, torch.float32)
    with pytest.raises(ValueError, match="bf16 only"):
        tdb.cosine_attention(qkv, 4, 2, torch.float32, normalize_first=True)
    with pytest.raises(ValueError, match="CUDA"):
        tdb.cosine_attention(qkv, 4, 2, torch.bfloat16)


def test_fused_dit_block_bf16():
    """bf16 operands and stream, as the sampling path runs them. The two
    packages round the modulate output, attention, hidden and stream to
    bf16 at the same places but sum in another order, so one element may
    land a bf16 ulp (2^-8 relative) apart and carry that through the next
    product: bound 5e-2 absolute on unit-scale activations, mean 2e-3."""
    args = _inputs(3)
    jargs = [jnp.asarray(a, jnp.bfloat16) if a.ndim > 1 else jnp.asarray(a) for a in args]
    want = np.asarray(jdb.fused_dit_block(*jargs, HEADS).astype(jnp.float32))
    got = _port(tdb.fused_dit_block, args, torch.bfloat16)
    err = np.abs(got - want)
    assert err.max() < 5e-2, err.max()
    assert err.mean() < 2e-3, err.mean()


def test_mp_gemm_modes_match_plain_algebra():
    """The prologue and epilogues of mp_gemm, written out by hand."""
    rng = np.random.default_rng(5)
    m, k, n, tokens = 8, 16, 12, 4
    a, w = torch.from_numpy(rng.normal(size=(m, k)).astype(np.float32)), torch.from_numpy(rng.normal(size=(n, k)).astype(np.float32))
    mods = torch.from_numpy(rng.normal(size=(m // tokens, 3 * k)).astype(np.float32))
    x = torch.from_numpy(rng.normal(size=(m, n)).astype(np.float32))
    g = torch.tensor([0.3])
    rows = torch.arange(m) // tokens
    shift, scale, gate = mods[rows, :k], mods[rows, k : 2 * k], mods[rows, 2 * k : 2 * k + n]
    h = (a * scale + (shift - a * scale) * 0.3) / np.sqrt(0.7**2 + 0.3**2)
    got = tdb.mp_gemm(a, w, alpha=0.5, out_dtype=torch.float32, modulate=(mods, 0, k, g), silu=True, tokens=tokens)
    torch.testing.assert_close(got, torch.nn.functional.silu(h @ w.t() * 0.5) / 0.596)
    got = tdb.mp_gemm(a, w, alpha=0.5, out_dtype=torch.float32, residual=(x, mods, 2 * k), tokens=tokens)
    torch.testing.assert_close(got, (x + (gate * (a @ w.t() * 0.5) - x) * 0.3) / np.sqrt(0.58))


@pytest.mark.parametrize("n, t, depth", [(3, 64, 1), (3, 64, 3), (4, 16, 3), (5, 4, 1), (5, 4, 3)],
                         ids=["n3-t64-d1", "n3-t64-d3", "n4-t16-d3", "n5-t4-d1", "n5-t4-d3"])
def test_dit_stack_plain_matches_jax(n, t, depth):
    """The plain version of the persistent stack kernel, in the kernel's
    order (the modulation rows of every block first, then each block's
    stages over its columns of them), against JAX fused_dit_stack in
    interpret mode at T = 64 / 16 / 4, odd N, depth 1 and 3."""
    rng = np.random.default_rng(100 * n + t + depth)

    def f(*s):
        return rng.normal(size=s).astype(np.float32)

    def w(*s):
        m = f(depth, *s)
        return m * np.sqrt(s[-1]) / (np.linalg.norm(m, axis=-1, keepdims=True) + 1e-4)

    gains = rng.uniform(0.1, 0.9, size=(depth, 2)).astype(np.float32)
    args = [f(n, t, D), f(n, D), gains, w(6 * D, D), w(3 * D, D), w(D, D), w(H, D), w(D, H)]
    want = np.asarray(jdb.fused_dit_stack(*[jnp.asarray(a) for a in args], HEADS))
    got = tdb.dit_stack_plain(*[torch.from_numpy(a) for a in args], HEADS).numpy()
    np.testing.assert_allclose(got, want, **TOL)


def test_dit_stack_plain_has_the_launch_sequences_bits():
    """Reordering the modulation rows changes no rounding: the plain
    version of the kernel equals fused_dit_stack_plain (the launch sequence
    over the plain callables) bit for bit, in f32 and in bf16, and so does
    stack_launch_sequence, the kernel's yardstick, on CPU tensors."""
    args = _inputs(4, depth=DEPTH)
    for dtype in (torch.float32, torch.bfloat16):
        ts = [torch.from_numpy(v).to(dtype if v.ndim > 2 or v.shape != (DEPTH, 2) else torch.float32) for v in args]
        want = tdb.fused_dit_stack_plain(*ts, HEADS)
        torch.testing.assert_close(tdb.dit_stack_plain(*ts, HEADS), want, rtol=0, atol=0)
        # the launch sequence the kernel replaced, on CPU tensors
        torch.testing.assert_close(tdb.stack_launch_sequence(*ts, HEADS), want, rtol=0, atol=0)


def _bf16_stack(seed):
    """_inputs at DEPTH in the card's types: bf16 activations and weights,
    f32 gains."""
    return [torch.from_numpy(v).to(torch.float32 if v.shape == (DEPTH, 2) else torch.bfloat16)
            for v in _inputs(seed, depth=DEPTH)]


def test_fused_dit_stack_plain_sums_in_f32_by_default():
    """sum_dtype=torch.float32 is the plain version as it was: the same bits
    as the call without it, as a chain of depth-1 plain blocks and as the
    kernel-order plain version, in bf16 and in f32."""
    args = _inputs(0, depth=DEPTH)
    for ts in (_bf16_stack(0), [torch.from_numpy(v) for v in args]):
        x, a, gains, *ws = ts
        got = tdb.fused_dit_stack_plain(*ts, HEADS, sum_dtype=torch.float32)
        assert got.dtype == x.dtype
        step = x
        for b in range(DEPTH):
            step = tdb.fused_dit_block_plain(step, a, gains[b], *[w[b] for w in ws], HEADS)
        for want in (tdb.fused_dit_stack_plain(*ts, HEADS), step, tdb.dit_stack_plain(*ts, HEADS)):
            assert torch.equal(got, want)


def test_fused_dit_stack_plain_f64_witness_lies_within_bf16_rounding():
    """sum_dtype=torch.float64 keeps the bf16 rounding points and sums in
    float64: at depth 2 it lands within one bf16 ulp at unit scale plus one
    of the element (2^-7 absolute + 2^-7 relative) of the f32 plain version
    (0.67 of that limit here, at most 0.88 over seeds 0-29), and differs
    from it (113 elements here), so the sums did change type."""
    ts = _bf16_stack(0)
    o32 = tdb.fused_dit_stack_plain(*ts, HEADS)
    o64 = tdb.fused_dit_stack_plain(*ts, HEADS, sum_dtype=torch.float64)
    assert o64.dtype == torch.bfloat16 and o64.shape == o32.shape
    torch.testing.assert_close(o64.float(), o32.float(), rtol=2**-7, atol=2**-7)
    assert not torch.equal(o64, o32)
    with pytest.raises(ValueError, match="sum_dtype"):
        tdb.fused_dit_stack_plain(*ts, HEADS, sum_dtype=torch.bfloat16)


def _sampling_shapes():
    """(model, samples N, T, depth, width, heads, MLP width) of every
    registry model at 16 x 16 latents, at the headline's 32 x 2 CFG rows and
    at the XL layout's 4 x 2, and the same at 32 x 32 latents (T = 256, 64,
    16)."""
    from mapdit_tpu_torch.models.registry import DIT_MODELS

    for size, tag in ((16, ""), (32, "-32x32")):
        for name, spec in DIT_MODELS.items():
            d = spec["hidden_size"]
            for n in (64, 8):
                yield pytest.param(name, n, (size // spec["patch_size"]) ** 2, spec["depth"], d, spec["num_heads"],
                                   4 * d, id=f"{name}-n{n}{tag}")


@pytest.mark.parametrize("model, n, t, depth, d, heads, hidden", list(_sampling_shapes()))
def test_stack_plan_covers_every_tile_once(model, n, t, depth, d, heads, hidden):
    """The persistent kernel's plan at every registry model's sampling
    shapes, walked as the kernel walks it: every product tile and K split
    of every block is computed once, the splits of a tile cover its k steps
    once in order and run at once on distinct CTAs, every (sample, head,
    query tile of 64) attention unit of every block once, and each row
    tile's out product waits for exactly the units that read or write a row
    of it (a unit reads its whole sample's qkv rows: two row tiles a sample
    at T = 256), so the next block's qkv items, which follow that out
    product, never overwrite rows a unit still reads; every split but the modulation
    rows' depends on one block's shapes only (so the stack sums as a chain
    of depth-1 calls does); the shared memory fits a block's 227 KB with the
    attention buffers inside the ring, the grid is resident, the tickets fit
    the sync words, and the scratch parts are disjoint and 256-byte
    aligned."""
    tdb.check_stack_shape(t, d, heads)
    plan = tdb.stack_plan(n, t, d, hidden, heads, depth)
    one = tdb.stack_plan(n, t, d, hidden, heads, 1)
    assert [p.name for p in plan.products] == ["modulation", "qkv", "out", "fc1", "fc2"]
    seen, units, where = {}, {}, {}
    for cta, items in enumerate(plan.walk()):
        for b, stage, j, what in items:
            if stage == "attention":
                for u in what:
                    assert (b, u) not in units
                    units[(b, u)] = cta
                continue
            assert (b, stage, what[:3]) not in seen
            seen[(b, stage, what[:3])] = what[3:]
            where.setdefault((b, stage), []).append(cta)
    qt = -(-t // tdb.STACK_QUERY_TILE)
    assert len(units) == depth * n * heads * qt
    assert {plan.unit(u)[:3] for b, u in units if b == 0} == {
        (s, h, q * tdb.STACK_QUERY_TILE) for s in range(n) for h in range(heads) for q in range(qt)}
    row_tiles = -(-n * t // tdb.STACK_TILE)
    waits = [0] * row_tiles
    for u in range(plan.attention_items):
        s, _, q0, rows = plan.unit(u)
        reads, writes = (s * t, s * t + t), (s * t + q0, s * t + q0 + rows)
        assert reads[0] <= writes[0] < writes[1] <= reads[1]
        for r in range(row_tiles):
            if r * tdb.STACK_TILE < reads[1] and reads[0] < (r + 1) * tdb.STACK_TILE:
                waits[r] += 1
    assert [plan.units_of(r) for r in range(row_tiles)] == waits
    for prod in plan.products:
        blocks = [-1] if prod.name == "modulation" else range(depth)
        kt = -(-prod.k // tdb.STACK_K)
        for b in blocks:
            for mt in range(-(-prod.m // tdb.STACK_TILE)):
                for nt in range(-(-prod.n // tdb.STACK_TILE)):
                    ranges = [seen.pop((b, prod.name, (mt, nt, z))) for z in range(prod.splits)]
                    assert ranges[0][0] == 0 and ranges[-1][1] == kt
                    assert all(r[1] == s[0] and r[1] > r[0] for r, s in zip(ranges, ranges[1:] + [(kt, kt)]))
            if prod.splits > 1:
                assert len(set(where[(b, prod.name)])) == prod.items <= plan.ctas
        if prod.name != "modulation":
            assert prod.splits == one.product(prod.name).splits
    assert not seen
    assert plan.product("modulation").splits == 1
    assert plan.smem_bytes <= tdb.MAX_SMEM_BYTES
    assert plan.attention_smem_bytes <= tdb.STACK_RING_BYTES
    assert plan.ctas <= tdb.H100_SMS * (tdb.SM_SMEM_BYTES // (plan.smem_bytes + 1024))
    assert plan.attention_items == n * heads * qt
    assert plan.items_per_block == sum(p.items for p in plan.products[1:]) + (n * heads * qt + 1) // 2
    spans = sorted(plan.layout.items(), key=lambda kv: kv[1])
    assert spans[0] == ("sync", 0) and all(off % 256 == 0 for _, off in spans)
    assert plan.layout["mods"] >= 4 * (tdb.STACK_SYNC_DONE + 40 * -(-n * t // tdb.STACK_TILE) + plan.tickets)
    split = [p for p in plan.products if p.splits > 1]
    assert plan.tickets == depth * sum(p.tiles for p in split)
    assert plan.layout["attn"] - plan.layout["partial"] >= sum(p.splits * p.m * p.n * 4 for p in split)
    assert plan.workspace_bytes >= plan.layout["amod"] + n * t * d * 2


def test_dit_stack_serves_the_registry_and_raises_outside():
    """Every registry model at 16 x 16 and 32 x 32 latents (T = 256, 64, 16,
    4; head widths 64 and 72) is in the kernel's domain, an even T that
    crosses row tiles (144) too; T past STACK_MAX_T, an odd T and another
    head width raise, naming CUDA."""
    from mapdit_tpu_torch.models.registry import DIT_MODELS

    for spec in DIT_MODELS.values():
        for size in (16, 32):
            tdb.check_stack_shape((size // spec["patch_size"]) ** 2, spec["hidden_size"], spec["num_heads"])
    tdb.check_stack_shape(144, 384, 6)
    for tokens, d, heads in ((tdb.STACK_MAX_T + 2, 384, 6), (9, 384, 6), (64, 256, 8)):
        with pytest.raises(ValueError, match="CUDA"):
            tdb.check_stack_shape(tokens, d, heads)
