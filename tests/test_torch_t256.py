"""32 x 32 latents (T = 256 at patch 2) through the port's kernel wrappers
against the JAX package, whose Pallas kernels run in interpret mode on the
CPU: the whole block and the whole stack, the attention half-block's
gradient with the Pallas backward, the out product's gated-residual
backward, and a DiT-XS/2 cut to depth 2 on mega_stack and on mega_attn. On
CPU tensors the wrappers run their plain versions, so this holds the math
the CUDA kernels compute at T = 256; chip_smoke.py holds the kernels to the
same plain versions on the card. Tolerances are the JAX package's own: 2e-4
for a forward (mapdit_tpu/ops/pallas/dit_block.py:57-59), 5e-4 for
gradients (:1059-1061)."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mapdit_tpu.models import DiT as JaxDiT
from mapdit_tpu.models import build_config as jax_build_config
from mapdit_tpu.models import init_model as jax_init_model
from mapdit_tpu.ops.pallas import dit_block as jdb
from mapdit_tpu.runtime import build_block_stack as jax_build_block_stack
from mapdit_tpu.runtime import fold_weights_for_inference as jax_fold
from mapdit_tpu_torch.models import DiT, build_config
from mapdit_tpu_torch.ops.cuda import attn_branch as ab
from mapdit_tpu_torch.ops.cuda import dit_block as tdb
from mapdit_tpu_torch.ops.cuda import dit_block_tp
from mapdit_tpu_torch.runtime import build_block_stack, fold_weights_for_inference
from mapdit_tpu_torch.utils.weights import state_dict_from_jax

T = 256
N, D, HEADS, H, DEPTH = 2, 128, 2, 512, 2
FWD_TOL = dict(rtol=2e-4, atol=2e-4)
GRAD_TOL = dict(rtol=5e-4, atol=5e-4)
XS2_32 = dict(in_channels=4, input_size=32, num_classes=10)
torch.set_num_threads(2)


def _block_inputs(seed, depth=None):
    rng = np.random.default_rng(seed)
    lead = () if depth is None else (depth,)

    def f(*s):
        return rng.normal(size=s).astype(np.float32)

    def w(*s):
        m = f(*lead, *s)
        return m * np.sqrt(s[-1]) / (np.linalg.norm(m, axis=-1, keepdims=True) + 1e-4)

    gains = rng.uniform(0.1, 0.9, size=lead + (2,)).astype(np.float32)
    return [f(N, T, D), f(N, D), gains, w(6 * D, D), w(3 * D, D), w(D, D), w(H, D), w(D, H)]


def _port(fn, args):
    return fn(*[torch.from_numpy(a) for a in args], HEADS).numpy()


def test_fused_dit_block_matches_jax_at_t256():
    args = _block_inputs(0)
    want = np.asarray(jdb.fused_dit_block(*[jnp.asarray(a) for a in args], HEADS))
    np.testing.assert_allclose(_port(tdb.fused_dit_block, args), want, **FWD_TOL)


def test_fused_dit_stack_matches_jax_at_t256():
    args = _block_inputs(1, depth=DEPTH)
    want = np.asarray(jdb.fused_dit_stack(*[jnp.asarray(a) for a in args], HEADS))
    np.testing.assert_allclose(_port(tdb.fused_dit_stack, args), want, **FWD_TOL)


def _branch_args(seed, n=2, d=64):
    rng = np.random.default_rng(seed)

    def f(*s):
        return rng.normal(size=s).astype(np.float32)

    return [f(n, T, d), f(n, d), f(n, d), f(n, d), np.float32(0.4), f(3 * d, d), f(d, d)]


def test_attn_branch_pallas_cotangents_match_jax_at_t256():
    """All seven cotangents of fused_attn_branch(bwd="pallas") at T = 256
    (the route whose attention_bwd takes the form past T = 64 and whose out
    product sums each sample's dgate across two row tiles on the card)
    against jax.grad through the JAX fused_attn_branch with the same bwd."""
    args = _branch_args(7)
    cot = np.random.default_rng(8).normal(size=args[0].shape).astype(np.float32)
    want = jax.grad(lambda *a: jnp.sum(jdb.fused_attn_branch(*a, HEADS, bwd="pallas") * cot),
                    argnums=tuple(range(7)))(*[jnp.asarray(a) for a in args])
    xs = [torch.tensor(np.asarray(a), requires_grad=True) for a in args]
    (ab.fused_attn_branch(*xs, HEADS, bwd="pallas") * torch.from_numpy(cot)).sum().backward()
    for name, x, w in zip(("x", "shift", "scale", "gate", "gain", "w_qkv", "w_out"), xs, want):
        assert x.grad.shape == x.shape, name
        np.testing.assert_allclose(x.grad.numpy(), np.asarray(w), err_msg=name, **GRAD_TOL)


def test_out_gate_residual_bwd_plain_matches_jax_at_t256():
    """out_gate_residual_bwd (its plain version on the CPU) at T = 256, N =
    3 (a sample spans two 128-row tiles of the card's product; the middle
    one starts inside a tile), against the JAX package's out product and
    gated-residual backward (_attn_bwd_math: out = attn . Wout^T / sqrt(D),
    y = (x + (gate*out - x)*0.3)/rd), taken by jax.vjp: dout = db*gate and
    dgate = sum_t db*out."""
    n, d = 3, 64
    rng = np.random.default_rng(21)
    attn, dy = (rng.normal(size=(n * T, d)).astype(np.float32) for _ in range(2))
    w = rng.normal(size=(d, d)).astype(np.float32)
    rows = rng.normal(size=(n, 3 * d)).astype(np.float32)
    gate = rows[:, 2 * d :]
    out = jax.lax.dot_general(jnp.asarray(attn), jnp.asarray(w), (((1,), (1,)), ((), ())),
                              preferred_element_type=jnp.float32).reshape(n, T, d) / math.sqrt(d)
    x0 = jnp.zeros((n, T, d), jnp.float32)
    _, vjp = jax.vjp(lambda g, o: (x0 + (g[:, None, :] * o - x0) * jdb._RES_T) / jdb._RES_DENOM,
                     jnp.asarray(gate), out)
    want_dgate, want_dout = vjp(jnp.asarray(dy).reshape(n, T, d))
    dout, dgate = ab.out_gate_residual_bwd(torch.from_numpy(attn), torch.from_numpy(w), torch.from_numpy(dy),
                                           torch.from_numpy(rows), 2 * d, T)
    assert dout.shape == (n * T, d) and dgate.shape == (n, d)
    np.testing.assert_allclose(dout.numpy(), np.asarray(want_dout).reshape(n * T, d), **FWD_TOL)
    np.testing.assert_allclose(dgate.numpy(), np.asarray(want_dgate), **GRAD_TOL)


@pytest.fixture(scope="module")
def xs2_32():
    """DiT-XS/2 cut to depth 2 at 32 x 32 latents: JAX init weights with the
    block gains drawn away from their zero init, and seeded inputs."""
    cfg = jax_build_config("DiT-XS/2", depth=2, **XS2_32)
    _, variables = jax_init_model(cfg, seed=5)
    rng = np.random.default_rng(5)
    params = dict(variables["params"])
    for i in range(cfg.depth):
        blk = dict(params[f"blocks_{i}"])
        blk["gain_msa"], blk["gain_mlp"] = (jnp.asarray(v, jnp.float32) for v in rng.uniform(0.1, 0.9, 2))
        params[f"blocks_{i}"] = blk
    variables = dict(variables, params=params)
    x = rng.normal(size=(2, 4, 32, 32)).astype(np.float32)
    t = np.array([40.0, 700.0], np.float32)
    y = np.array([3, 10], np.int32)
    return cfg, variables, (x, t, y)


def _torch_inputs(inputs):
    x, t, y = inputs
    return torch.from_numpy(x), torch.from_numpy(t), torch.from_numpy(y.astype(np.int64))


def test_xs2_mega_stack_forward_matches_jax_at_32(xs2_32):
    """The whole-stack path (folded weights, one fused_dit_stack call) at 32
    x 32 latents against the JAX model under block_kernel="mega_stack"."""
    jcfg, variables, inputs = xs2_32
    jcfg = jcfg.replace(fold_weights=True, block_kernel="mega_stack")
    jv = dict(variables, params=jax_fold(variables["params"], jcfg))
    want = np.asarray(JaxDiT(jcfg).apply(jv, *[jnp.asarray(v) for v in inputs],
                                         block_stack=jax_build_block_stack(jv["params"], jcfg)))
    cfg = build_config("DiT-XS/2", depth=2, fold_weights=True, block_kernel="mega_stack", **XS2_32)
    assert cfg.num_patches == T
    sd = fold_weights_for_inference(state_dict_from_jax(variables, cfg), cfg)
    model = DiT(cfg).eval()
    model.load_state_dict(sd)
    with torch.no_grad():
        got = model(*_torch_inputs(inputs), block_stack=build_block_stack(sd, cfg))
    np.testing.assert_allclose(got.numpy(), want, **FWD_TOL)


def test_xs2_mega_attn_forward_and_gradients_match_jax_at_32(xs2_32):
    """The attention half-block path with the Pallas backward at 32 x 32
    latents: the model output and the gradient of sum(out * cot) with
    respect to every parameter against the JAX model under
    block_kernel="mega_attn", attn_bwd="pallas" (jax.grad)."""
    jcfg, variables, inputs = xs2_32
    jcfg = jcfg.replace(block_kernel="mega_attn", attn_bwd="pallas")
    jin = [jnp.asarray(v) for v in inputs]
    model_j = JaxDiT(jcfg)
    want = np.asarray(model_j.apply(variables, *jin))
    cot = np.random.default_rng(6).normal(size=want.shape).astype(np.float32)
    rest = {key: v for key, v in variables.items() if key != "params"}
    grads = jax.grad(lambda p: jnp.sum(model_j.apply(dict(rest, params=p), *jin) * cot))(variables["params"])
    want_grads = state_dict_from_jax({"params": grads})

    cfg = build_config("DiT-XS/2", depth=2, block_kernel="mega_attn", attn_bwd="pallas", **XS2_32)
    model = DiT(cfg)
    model.load_state_dict(state_dict_from_jax(variables, cfg))
    got = model(*_torch_inputs(inputs))
    np.testing.assert_allclose(got.detach().numpy(), want, **FWD_TOL)
    (got * torch.from_numpy(cot)).sum().backward()
    params = dict(model.named_parameters())
    assert set(want_grads) == set(params)
    for name, w in want_grads.items():
        np.testing.assert_allclose(params[name].grad.numpy(), w.numpy(), err_msg=name, **GRAD_TOL)


def test_tp_attention_kernel_keeps_its_one_tile_limit():
    """tp_attn's attention stage still takes one tile of 64 queries and keys:
    its limit stays 64 while dit_stack's rises, and T = 256 takes the
    launch sequence."""
    assert dit_block_tp.TP_MAX_T == 64 < tdb.STACK_MAX_T
    assert dit_block_tp.tp_attn_route(64) == "kernel" and dit_block_tp.tp_attn_route(T) == "sequence"
    with pytest.raises(ValueError, match="T <= 64"):
        dit_block_tp.check_tp_shape("attn", T, 384, 384, 6)
