"""The port's attention half-block (ops/cuda/attn_branch.py) against the JAX
Pallas kernels, which run in interpret mode on the CPU, and each new
kernel's plain version against torch autograd of plain ops. On CPU tensors
the port's wrappers run their plain versions, so this holds the math the
CUDA kernels compute; chip_smoke.py holds the kernels to the same plain
versions on the card. Tolerances are the JAX package's own: 2e-4 for the
forward (mapdit_tpu/ops/pallas/dit_block.py:57-59), 5e-4 for the
cotangents (:1059-1061), 2e-5 between the two forwards."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mapdit_tpu.ops.pallas import dit_block as jdb
from mapdit_tpu_torch.ops.cuda import attn_branch as ab
from mapdit_tpu_torch.ops.cuda import dit_block as tdb
from mapdit_tpu_torch.ops.mp import mp_sum, normalize

HEADS = 2
FWD_TOL = dict(rtol=2e-4, atol=2e-4)
GRAD_TOL = dict(rtol=5e-4, atol=5e-4)
NAMES = ("x", "shift", "scale", "gate", "gain", "w_qkv", "w_out")


def _args(seed, n, t=16, d=64):
    rng = np.random.default_rng(seed)

    def f(*s):
        return rng.normal(size=s).astype(np.float32)

    return [f(n, t, d), f(n, d), f(n, d), f(n, d), np.float32(0.37 if n == 6 else 0.4), f(3 * d, d), f(d, d)]


def _torch(args, grad=False):
    return [torch.tensor(np.asarray(a), requires_grad=grad) for a in args]


def _jax(args):
    return [jnp.asarray(a) for a in args]


def test_forward_matches_jax():
    args = _args(1, 4)
    want = np.asarray(jdb.fused_attn_branch(*_jax(args), HEADS))
    ref = np.asarray(jdb._attn_reference(*_jax(args), HEADS))
    with torch.no_grad():
        got = ab.fused_attn_branch(*_torch(args), HEADS).numpy()
    np.testing.assert_allclose(got, want, **FWD_TOL)
    np.testing.assert_allclose(got, ref, **FWD_TOL)


def test_residual_forward_matches_jax():
    args = _args(3, 4)
    y_res, p, attn = (np.asarray(v) for v in jdb._attn_res_fwd_impl(*_jax(args), HEADS))
    got_y, got_p, got_attn = (v.numpy() for v in ab.attn_res_fwd(*_torch(args), HEADS))
    np.testing.assert_allclose(got_y, ab.attn_fwd(*_torch(args), HEADS).numpy(), rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(got_y, y_res, **FWD_TOL)
    assert got_p.shape == p.shape == (4, HEADS, 16, 16) and got_p.dtype == np.float32
    np.testing.assert_allclose(got_p, p, **FWD_TOL)
    np.testing.assert_allclose(got_attn, attn, **FWD_TOL)


def test_residual_attention_matches_jax_at_t256():
    """The residual mode's plain attention (p and the pre-projection
    attention) against the Pallas residual forward at T=256 (input size 32),
    where the kernel runs two sweeps over its key tiles."""
    args = _args(11, 2, t=256)
    _, p, attn = (np.asarray(v) for v in jdb._attn_res_fwd_impl(*_jax(args), HEADS))
    _, got_p, got_attn = (v.numpy() for v in ab.attn_res_fwd(*_torch(args), HEADS))
    assert got_p.shape == p.shape == (2, HEADS, 256, 256)
    np.testing.assert_allclose(got_p, p, **FWD_TOL)
    np.testing.assert_allclose(got_attn, attn, **FWD_TOL)


@pytest.mark.parametrize("bwd", ab.BWD_IMPLS)
def test_cotangents_match_jax(bwd):
    """All seven cotangents of each VJP against jax.grad through the JAX
    fused_attn_branch with the same bwd (n=6 puts three sample groups on the
    Pallas grid, so its cross-step accumulation is exercised)."""
    args = _args(7, 6)
    cot = np.random.default_rng(8).normal(size=args[0].shape).astype(np.float32)
    want = jax.grad(
        lambda *a: jnp.sum(jdb.fused_attn_branch(*a, HEADS, bwd=bwd) * cot), argnums=tuple(range(7))
    )(*_jax(args))
    xs = _torch(args, grad=True)
    (ab.fused_attn_branch(*xs, HEADS, bwd=bwd) * torch.from_numpy(cot)).sum().backward()
    for name, x, w in zip(NAMES, xs, want):
        assert x.grad.shape == x.shape and x.grad.dtype == x.dtype, name
        np.testing.assert_allclose(x.grad.numpy(), np.asarray(w), err_msg=name, **GRAD_TOL)


def test_dw_in_kernel_cotangents_match_jax(monkeypatch):
    """Row 4': with DW_IN_KERNEL_BUDGET raised in both packages, the seven
    cotangents of fused_attn_branch(bwd="pallas") against the JAX
    in-kernel-dW Pallas variant in interpret mode and against jax.grad of
    the reference, at the JAX test's shape (n=6, t=16, d=64, heads=2),
    rtol = atol = 5e-4 (the JAX package's own). Both dW products go through
    dw_gemm (its plain version on the CPU), none through the f32 matmuls."""
    budget = 5 * 2**20
    monkeypatch.setattr(jdb, "_DW_IN_KERNEL_BUDGET", budget)
    assert not ab.dw_in_kernel(64)
    monkeypatch.setattr(ab, "DW_IN_KERNEL_BUDGET", budget)
    assert ab.dw_in_kernel(64) and not ab.dw_in_kernel(768)
    calls = []

    def recording_dw(a, b, alpha):
        calls.append((tuple(a.shape), tuple(b.shape)))
        return ab.dw_gemm(a, b, alpha)

    monkeypatch.setattr(ab, "_KERNELS", ab._KERNELS[:-1] + (recording_dw,))
    args = _args(7, 6)
    cot = np.random.default_rng(8).normal(size=args[0].shape).astype(np.float32)

    def jax_grads(bwd):
        return jax.grad(lambda *a: jnp.sum(jdb.fused_attn_branch(*a, HEADS, bwd=bwd) * cot),
                        argnums=tuple(range(7)))(*_jax(args))

    xs = _torch(args, grad=True)
    (ab.fused_attn_branch(*xs, HEADS, bwd="pallas") * torch.from_numpy(cot)).sum().backward()
    assert calls == [((96, 192), (96, 64)), ((96, 64), (96, 64))]
    for bwd in ("pallas", "reference"):
        for name, x, w in zip(NAMES, xs, jax_grads(bwd)):
            np.testing.assert_allclose(x.grad.numpy(), np.asarray(w), err_msg=f"{bwd}: {name}", **GRAD_TOL)
    # the switch changes where the products run, not what they are
    monkeypatch.setattr(ab, "DW_IN_KERNEL_BUDGET", 0)
    ys = _torch(args, grad=True)
    (ab.fused_attn_branch(*ys, HEADS, bwd="pallas") * torch.from_numpy(cot)).sum().backward()
    assert len(calls) == 2
    for name, x, y in zip(NAMES, xs, ys):
        torch.testing.assert_close(x.grad, y.grad, rtol=1e-6, atol=1e-6, msg=name)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dw_products_match_jax(dtype):
    """dw_gemm (its plain version on the CPU) against the JAX kernel's own
    product, dot_general contracting the rows of both operands with f32
    accumulation, times 1/sqrt(D): a ragged M; 1e-5 relative of the largest
    element (f32 sums in another order; products of bf16 values are exact
    in f32)."""
    rng = np.random.default_rng(3)
    m, p_, q = 150, 192, 64
    a, b = rng.normal(size=(m, p_)).astype(np.float32), rng.normal(size=(m, q)).astype(np.float32)
    ja, jb = jnp.asarray(a).astype(dtype), jnp.asarray(b).astype(dtype)
    want = np.asarray(jax.lax.dot_general(ja, jb, dimension_numbers=(((0,), (0,)), ((), ())),
                                          preferred_element_type=jnp.float32)) / np.sqrt(q)
    tdt = getattr(torch, dtype)
    ta, tb = torch.from_numpy(a).to(tdt), torch.from_numpy(b).to(tdt)
    got = ab.dw_gemm(ta, tb, 1 / np.sqrt(q))
    assert got.dtype == torch.float32 and got.shape == (p_, q)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5 * np.abs(want).max())
    torch.testing.assert_close(got, ab.dw_gemm_plain(ta, tb, 1 / np.sqrt(q)), rtol=0, atol=0)


@pytest.mark.parametrize("n, t, d", [(4, 16, 64), (2, 64, 128)])
def test_attention_bwd_bf16_roundings_match_jax(n, t, d):
    """attention_bwd_plain in bf16, the yardstick the CUDA kernel is held to
    on the card, against the JAX half-block backward's own math in bf16
    (_attn_bwd_math, the body of the Pallas kernel, called as plain jnp with
    bf16 weights) on the same numpy-seeded inputs: dqkv rounded to bf16, as
    the Pallas kernel stores it. The port recomputes qkv and dattn with its
    plain products (f32 sums in another order), so a few elements land one
    bf16 rounding away (5e-5 to 6e-4 relative L2 here): held at 2e-3. The
    same inputs through the products in f32 (no rounding of p, dlog or the
    normalised rows) land ~3.7e-3 away, outside it, so the check sees the
    rounding points."""
    rng = np.random.default_rng(n * t + d)

    def f(*s):
        return rng.normal(size=s).astype(np.float32)

    x, shift, scale, gate, dy = f(n, t, d), f(n, d), f(n, d), f(n, d), f(n, t, d)
    bf, f32 = torch.bfloat16, torch.float32
    wq, wo = (normalize(torch.from_numpy(f(*s))).to(bf) for s in ((3 * d, d), (d, d)))
    gain, inv_d = np.float32(0.37), 1 / np.sqrt(d)
    out = jdb._attn_bwd_math(
        jnp.float32(gain), jnp.asarray(dy), jnp.asarray(x), *(jnp.asarray(v)[:, None] for v in (shift, scale, gate)),
        *(jnp.asarray(w.float().numpy()).astype(jnp.bfloat16) for w in (wq, wo)), HEADS, inv_d)
    want = torch.tensor(np.asarray(out[6].astype(jnp.bfloat16).astype(jnp.float32)))

    rows = torch.from_numpy(np.concatenate([shift, scale, gate], axis=1))
    h = ab.modulate_fwd_plain(torch.from_numpy(x).reshape(n * t, d), rows, torch.tensor([gain]), t, bf)
    qkv = tdb.mp_gemm_plain(h, wq, alpha=inv_d, out_dtype=f32)
    attn = tdb.cosine_attention_plain(qkv, t, HEADS, bf, normalize_first=True)
    y = tdb.mp_gemm_plain(attn, wo, alpha=inv_d, out_dtype=f32)
    dout, _ = ab.gate_residual_bwd_plain(torch.from_numpy(dy), y, rows, 2 * d, t, bf)
    dattn = tdb.mp_gemm_plain(dout, wo, alpha=inv_d, out_dtype=f32, w_kn=True)
    got = ab.attention_bwd_plain(qkv, dattn, t, HEADS, bf)
    assert got.dtype == bf and got.shape == want.shape == (n * t, 3 * d)

    def rel(a):
        return float((a.float() - want).norm() / want.norm())

    assert rel(got) <= 2e-3, rel(got)
    assert rel(ab._attention_vjp(qkv, dattn, t, HEADS, f32)) > 2e-3


def test_attn_bwd_from_res_matches_fused_backward():
    args = _torch(_args(9, 4))
    dy = torch.randn(args[0].shape, generator=torch.Generator().manual_seed(0))
    _, p, attn = ab.attn_res_fwd(*args, HEADS)
    fused = ab.attn_bwd(dy, *args, HEADS)
    for name, a, b in zip(NAMES, ab.attn_bwd_from_res(dy, *args, p, attn, HEADS), fused):
        np.testing.assert_allclose(a.numpy().reshape(b.shape), b.numpy(), err_msg=name, **GRAD_TOL)


# ---------------------------------------------------------------------------
# each kernel's plain version against torch autograd of plain ops


def _rand(*shape, seed=0):
    return torch.randn(*shape, generator=torch.Generator().manual_seed(seed), dtype=torch.float64).float()


def _vjp(fn, inputs, cot):
    xs = [x.clone().requires_grad_() for x in inputs]
    return torch.autograd.grad(fn(*xs), xs, cot)


def test_mp_gemm_kn_is_the_product_vjp():
    """dattn = dout . W: the (K, N) layout is the VJP of a . W^T."""
    a, w, dout = _rand(12, 16, seed=1), _rand(8, 16, seed=2), _rand(12, 8, seed=3)
    (want,) = _vjp(lambda a: a @ w.t() * 0.25, [a], dout)
    got = tdb.mp_gemm(dout, w, alpha=0.25, out_dtype=torch.float32, w_kn=True, site="dattn")
    torch.testing.assert_close(got, want)


def test_residual_attention_is_softmax_then_pv():
    t, heads, hd, n = 8, 2, 16, 3
    qkv = _rand(n * t, 3 * heads * hd, seed=4)
    probs = torch.empty(n, heads, t, t)
    got = tdb.cosine_attention(qkv, t, heads, torch.float32, normalize_first=True, probs=probs)
    q, k, v = qkv.reshape(n, t, 3, heads, hd).permute(2, 0, 3, 1, 4)
    p = torch.softmax(normalize(q) @ normalize(k).transpose(-1, -2) / hd**0.5, dim=-1)
    torch.testing.assert_close(probs, p)
    torch.testing.assert_close(got, (p @ v).transpose(1, 2).reshape(n * t, heads * hd))


def test_gate_residual_bwd_is_the_residual_vjp():
    n, t, d = 3, 4, 8
    x, out, dy = _rand(n * t, d, seed=5), _rand(n * t, d, seed=6), _rand(n * t, d, seed=7)
    rows = _rand(n, 3 * d, seed=8)

    def residual(x, out, rows):
        gate = tdb._rows(rows[:, 2 * d :], t)
        return mp_sum(x, gate * out, t=tdb.RES_T)

    want_dx, want_dout, want_drows = _vjp(residual, [x, out, rows], dy)
    dout, dgate = ab.gate_residual_bwd_plain(dy, out, rows, 2 * d, t, torch.float32)
    torch.testing.assert_close(dout, want_dout)
    torch.testing.assert_close(dgate, want_drows[:, 2 * d :])
    # the direct path x -> y is modulate_bwd's: with dh = 0 its dx is it
    dx = ab.modulate_bwd(torch.zeros(n * t, d), x, rows, torch.tensor([0.35]), dy, t)[0]
    torch.testing.assert_close(dx, want_dx)


@pytest.mark.parametrize("n, t", [(5, 4), (3, 16), (3, 64)], ids=["t4", "t16", "t64"])
def test_out_gate_residual_bwd_plain_is_the_product_then_the_residual_pass(n, t):
    """out_gate_residual_bwd on CPU tensors (its plain version) gives the
    bits of the two-step route it replaced: mp_gemm_plain's f32 out, then
    gate_residual_bwd_plain, in the card's types (bf16 attn, weight and dy;
    f32 rows), at the registry's T = 4, 16, 64 with N not a multiple of
    128/T (a tile of the CUDA product holds a partial set of samples)."""
    d, bf = 64, torch.bfloat16
    attn, dy = _rand(n * t, d, seed=40).to(bf), _rand(n * t, d, seed=41).to(bf)
    w_out = normalize(_rand(d, d, seed=42)).to(bf)
    rows = _rand(n, 3 * d, seed=43)
    dout, dgate = ab.out_gate_residual_bwd(attn, w_out, dy, rows, 2 * d, t)
    out = tdb.mp_gemm_plain(attn, w_out, alpha=1 / d**0.5, out_dtype=torch.float32)
    want_dout, want_dgate = ab.gate_residual_bwd_plain(dy, out, rows, 2 * d, t, bf)
    assert dout.dtype == bf and dgate.dtype == torch.float32 and dgate.shape == (n, d)
    assert torch.equal(dout, want_dout) and torch.equal(dgate, want_dgate)


@pytest.mark.parametrize("what", ["t-not-dividing-128", "f32-attn", "dy-wrong-size"])
def test_out_gate_residual_bwd_raises_on_cuda_outside_its_domain(what):
    """The CUDA out_gate_residual_bwd takes T dividing 128 (a product tile
    holds whole samples) or above 8 (a sample's sums cross tiles: T = 256,
    48, 144), bf16 attn and a dy of N*T*D elements; on a tensor off the CPU
    it raises, naming CUDA, before anything is built (T = 6: below 8 and
    not dividing 128)."""
    for t in (64, 16, 4, 128, 1, 256, 48, 144, 9):
        ab.check_out_gate_residual_shape(t)
    n, t, d, bf = 2, {"t-not-dividing-128": 6}.get(what, 16), 64, torch.bfloat16
    attn = torch.empty(n * t, d, dtype=torch.float32 if what == "f32-attn" else bf, device="meta")
    dy = torch.empty(n * t + (1 if what == "dy-wrong-size" else 0), d, dtype=bf, device="meta")
    w_out = torch.empty(d, d, dtype=bf, device="meta")
    rows = torch.empty(n, 3 * d, device="meta")
    before = dict(ab.LAUNCHES)
    with pytest.raises(ValueError, match="CUDA"):
        ab.out_gate_residual_bwd(attn, w_out, dy, rows, 2 * d, t)
    assert ab.LAUNCHES == before


def test_attention_bwd_is_the_attention_vjp():
    n, t, heads, hd = 2, 8, 2, 16
    d = heads * hd
    qkv, dattn = _rand(n * t, 3 * d, seed=9), _rand(n * t, d, seed=10)

    def attention(qkv):
        q, k, v = qkv.reshape(n, t, 3, heads, hd).permute(2, 0, 3, 1, 4)
        o = torch.softmax(normalize(q) @ normalize(k).transpose(-1, -2) / hd**0.5, dim=-1) @ v
        return o.transpose(1, 2).reshape(n * t, d)

    (want,) = _vjp(attention, [qkv], dattn)
    torch.testing.assert_close(ab.attention_bwd(qkv, dattn, t, heads, torch.float32), want, rtol=1e-4, atol=1e-5)


def test_modulate_fwd_and_bwd_are_modulate_and_its_vjp():
    n, t, d = 3, 4, 8
    x, dh, dy = _rand(n, t, d, seed=11), _rand(n * t, d, seed=12), _rand(n * t, d, seed=13)
    shift, scale = _rand(n, d, seed=14), _rand(n, d, seed=15)
    gain = torch.tensor([0.35])
    rows = torch.cat([shift, scale, _rand(n, d, seed=16)], dim=1)

    def modulate(x, shift, scale, gain):
        return tdb.modulate_reference(x, shift, scale, gain.reshape(())).reshape(n * t, d)

    h = ab.modulate_fwd(x.reshape(n * t, d), rows, gain, t, torch.float32)
    torch.testing.assert_close(h, modulate(x, shift, scale, gain))
    want = _vjp(modulate, [x, shift, scale, gain], dh)
    dx, dshift, dscale, dgain = ab.modulate_bwd(dh, x.reshape(n * t, d), rows, gain, dy, t)
    torch.testing.assert_close(dx, dy * ab.DX_FAC + want[0].reshape(n * t, d))
    torch.testing.assert_close(dshift, want[1])
    torch.testing.assert_close(dscale, want[2])
    torch.testing.assert_close(dgain, want[3])


@pytest.mark.parametrize("x_dtype, dy_dtype", [("float32", "float32"), ("bfloat16", "bfloat16"),
                                               ("bfloat16", "float32")])
def test_modulate_bwd_forms_dx0_as_the_residual_did(x_dtype, dy_dtype):
    """modulate_bwd_plain(dh, x, rows, gain, dy, t) gives the same bits as
    the composition it replaces: gate_residual_bwd's f32 dx0 = dy*DX_FAC,
    then (dx0 + du*scale) in x's type."""
    n, t, d = 3, 4, 16
    x = _rand(n * t, d, seed=21).to(getattr(torch, x_dtype))
    dy = _rand(n * t, d, seed=22).to(getattr(torch, dy_dtype))
    dh, rows, gain = _rand(n * t, d, seed=23), _rand(n, 3 * d, seed=24), torch.tensor([0.37])
    dx = ab.modulate_bwd_plain(dh, x, rows, gain, dy, t)[0]
    g = gain.reshape(())
    du = dh * ((1.0 - g) / torch.sqrt((1.0 - g) ** 2 + g**2))
    dx0 = dy.float() * ab.DX_FAC
    want = (dx0 + du * tdb._rows(rows[:, d : 2 * d], t)).to(x.dtype)
    assert dx.dtype == x.dtype and torch.equal(dx, want)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_modulate_stage_chain_matches_jax_attn_bwd_math(dtype):
    """The port's stage chain (attn_bwd on CPU tensors: the plain versions of
    modulate_fwd, the products, cosine_attention, gate_residual_bwd,
    attention_bwd and modulate_bwd with dy in place of dx0) against JAX's
    _attn_bwd_math (the Pallas kernel's body, called as plain jnp) on the same
    numpy-seeded inputs, N = 2, T = 16, D = 64, 2 heads, weights in
    ``dtype``: dx, dshift, dscale within relative L2 ``tol``, dgain (a sum
    whose terms cancel) within ``tol`` of its terms' root-sum-square. Both
    sides round at the same points and sum in f32 in other orders: 7e-8 to
    3e-7 relative L2 here in f32 and in bf16 (no bf16 rounding tips on these
    inputs). f32 is held at 1e-5; bf16 at 1e-4, where one tipped rounding of
    an operand (~4e-3 of that element) would still pass and a rounding left
    out (attention_bwd's products in f32: 8e-4 to 3.4e-3 here) would not."""
    tol = {"float32": 1e-5, "bfloat16": 1e-4}[dtype]
    n, t, d = 2, 16, 64
    rng = np.random.default_rng(31)

    def f(*s):
        return rng.normal(size=s).astype(np.float32)

    x, shift, scale, gate, dy = f(n, t, d), f(n, d), f(n, d), f(n, d), f(n, t, d)
    wdt = getattr(torch, dtype)
    wq, wo = (normalize(torch.from_numpy(f(*s))).to(wdt) for s in ((3 * d, d), (d, d)))
    gain, inv_d = np.float32(0.37), 1 / np.sqrt(d)
    out = jdb._attn_bwd_math(
        jnp.float32(gain), jnp.asarray(dy), jnp.asarray(x), *(jnp.asarray(v)[:, None] for v in (shift, scale, gate)),
        *(jnp.asarray(w.float().numpy()).astype(dtype) for w in (wq, wo)), HEADS, inv_d)
    want = [torch.tensor(np.asarray(v)) for v in out[:5]]
    got = ab.attn_bwd(torch.from_numpy(dy), torch.from_numpy(x), *(torch.from_numpy(v) for v in (shift, scale, gate)),
                      torch.tensor(gain), wq, wo, HEADS)

    def rel(a, b):
        return float((a.float() - b).norm() / b.norm())

    for name, i in (("dx", 0), ("dshift", 1), ("dscale", 2)):
        assert got[i].shape == want[i].shape, name
        assert rel(got[i], want[i]) <= tol, (name, rel(got[i], want[i]))
    # dgain's terms, dh*(shift - x*scale)/den, from the port's own dh
    f32 = torch.float32
    xf = torch.from_numpy(x).reshape(n * t, d)
    rows = torch.from_numpy(np.concatenate([shift, scale, gate], axis=1))
    h = ab.modulate_fwd_plain(xf, rows, torch.tensor([gain]), t, wdt)
    qkv = tdb.mp_gemm_plain(h, wq, alpha=inv_d, out_dtype=f32)
    y = tdb.mp_gemm_plain(tdb.cosine_attention_plain(qkv, t, HEADS, wdt, normalize_first=True), wo, alpha=inv_d,
                          out_dtype=f32)
    dout, _ = ab.gate_residual_bwd_plain(torch.from_numpy(dy), y, rows, 2 * d, t, wdt)
    dattn = tdb.mp_gemm_plain(dout, wo, alpha=inv_d, out_dtype=f32, w_kn=True)
    dqkv = ab.attention_bwd_plain(qkv, dattn, t, HEADS, wdt)
    dh = tdb.mp_gemm_plain(dqkv, wq, alpha=inv_d, out_dtype=f32, w_kn=True)
    shift_r, scale_r = ab._modulate_rows(rows, d, t)
    terms = dh * (shift_r - xf * scale_r) / np.sqrt((1 - gain) ** 2 + gain**2)
    rss = float(terms.double().square().sum().sqrt())
    assert abs(float(got[4].reshape(())) - float(want[4])) <= tol * rss, (float(got[4]), float(want[4]), rss)


def test_modulate_passes_raise_outside_their_domain():
    """The CUDA modulate passes take D a multiple of 8 (16-byte accesses):
    check_modulate_shape raises on 388 (D of a 97-head model of width 4)
    and on 12, passes every registry width, and the wrappers raise on a
    tensor off the CPU outside it before anything is built."""
    for d in (256, 384, 768, 1024, 1152):
        ab.check_modulate_shape(d)
    for d in (388, 12, 4):
        with pytest.raises(ValueError, match="multiple of 8"):
            ab.check_modulate_shape(d)
    n, t, d = 2, 4, 12
    x = torch.empty(n * t, d, dtype=torch.bfloat16, device="meta")
    rows, gain = torch.empty(n, 3 * d, device="meta"), torch.empty(1, device="meta")
    with pytest.raises(ValueError, match="multiple of 8"):
        ab.modulate_fwd(x, rows, gain, t, torch.bfloat16)
    with pytest.raises(ValueError, match="multiple of 8"):
        ab.modulate_bwd(torch.empty(n * t, d, device="meta"), x, rows, gain, x, t)
    assert all(v == 0 for v in ab.LAUNCHES.values()), ab.LAUNCHES


# ---------------------------------------------------------------------------
# the repaired whole-block and whole-stack VJPs


def _block_args(seed, depth=None, n=3, t=16, d=64, hidden=256):
    rng = np.random.default_rng(seed)
    lead = () if depth is None else (depth,)

    def f(*s):
        return rng.normal(size=s).astype(np.float32)

    def w(*s):
        # float32, as JAX (no x64) reads them: the VJP recomputes in the
        # inputs' own types
        m = f(*lead, *s)
        return (m * np.sqrt(s[-1]) / (np.linalg.norm(m, axis=-1, keepdims=True) + 1e-4)).astype(np.float32)

    gains = rng.uniform(0.1, 0.9, size=lead + (2,)).astype(np.float32)
    return [f(n, t, d), f(n, d), gains, w(6 * d, d), w(3 * d, d), w(d, d), w(hidden, d), w(d, hidden)]


@pytest.mark.parametrize("stack", [False, True])
def test_block_kernel_vjp_matches_jax(stack):
    """fused_dit_block / fused_dit_stack carry a gradient (their backward
    recomputes through the reference math), equal to jax.grad of the JAX
    kernels' recomputing VJPs."""
    args = _block_args(11, depth=2 if stack else None)
    jfn, tfn = (jdb.fused_dit_stack, tdb.fused_dit_stack) if stack else (jdb.fused_dit_block, tdb.fused_dit_block)
    cot = np.random.default_rng(12).normal(size=args[0].shape).astype(np.float32)
    want = jax.grad(lambda *a: jnp.sum(jfn(*a, HEADS) * cot), argnums=tuple(range(8)))(*_jax(args))
    xs = _torch(args, grad=True)
    out = tfn(*xs, HEADS)
    assert out.grad_fn is not None
    (out * torch.from_numpy(cot)).sum().backward()
    for i, (x, w) in enumerate(zip(xs, want)):
        np.testing.assert_allclose(x.grad.numpy(), np.asarray(w), err_msg=str(i), **GRAD_TOL)
