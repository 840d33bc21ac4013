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
    dx0, dout, dgate = ab.gate_residual_bwd(dy, out, rows, 2 * d, t, torch.float32)
    torch.testing.assert_close(dx0, want_dx)
    torch.testing.assert_close(dout, want_dout)
    torch.testing.assert_close(dgate, want_drows[:, 2 * d :])


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
    x, dh, dx0 = _rand(n, t, d, seed=11), _rand(n * t, d, seed=12), _rand(n * t, d, seed=13)
    shift, scale = _rand(n, d, seed=14), _rand(n, d, seed=15)
    gain = torch.tensor([0.35])
    rows = torch.cat([shift, scale, _rand(n, d, seed=16)], dim=1)

    def modulate(x, shift, scale, gain):
        return tdb.modulate_reference(x, shift, scale, gain.reshape(())).reshape(n * t, d)

    h = ab.modulate_fwd(x.reshape(n * t, d), rows, gain, t, torch.float32)
    torch.testing.assert_close(h, modulate(x, shift, scale, gain))
    want = _vjp(modulate, [x, shift, scale, gain], dh)
    dx, dshift, dscale, dgain = ab.modulate_bwd(dh, x.reshape(n * t, d), rows, gain, dx0, t)
    torch.testing.assert_close(dx, dx0 + want[0].reshape(n * t, d))
    torch.testing.assert_close(dshift, want[1])
    torch.testing.assert_close(dscale, want[2])
    torch.testing.assert_close(dgain, want[3])


# ---------------------------------------------------------------------------
# the repaired whole-block and whole-stack VJPs


def _block_args(seed, depth=None, n=3, t=16, d=64, hidden=256):
    rng = np.random.default_rng(seed)
    lead = () if depth is None else (depth,)

    def f(*s):
        return rng.normal(size=s).astype(np.float32)

    def w(*s):
        m = f(*lead, *s)
        return m * np.sqrt(s[-1]) / (np.linalg.norm(m, axis=-1, keepdims=True) + 1e-4)

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
