"""Float32 on the whole-block path: the plain versions that the f32 kernels
(``mp_gemm_f32``, ``cosine_attention_f32``, ``dit_stack_f32``) are held to
on the card, against the JAX package at ``dtype = float32``, whose Pallas
kernels run in interpret mode on the CPU; a DiT-XS/2 float32 model on
``mega`` and ``mega_stack`` against the JAX model on the same weights; the
f32 plan's shared memory; and the wrappers' f32 domain on meta tensors.
Inputs come from numpy seeds. Tolerances are the JAX package's own f32
kernel tolerance, rtol = atol = 2e-4 (tests/test_pallas.py:169-181); the
train step's gradients are held to 2e-4 of each tensor's largest element,
as tests/test_torch_train.py holds the first step's."""

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
from mapdit_tpu.ops import mp as jmp
from mapdit_tpu.ops.pallas import dit_block as jdb
from mapdit_tpu.runtime import build_block_stack as jax_build_block_stack
from mapdit_tpu.runtime import fold_weights_for_inference as jax_fold
from mapdit_tpu_torch.diffusion import create_diffusion
from mapdit_tpu_torch.models import DiT, build_config
from mapdit_tpu_torch.ops.cuda import attn_branch as ab
from mapdit_tpu_torch.ops.cuda import dit_block as tdb
from mapdit_tpu_torch.ops.cuda import dit_block_tp as tp
from mapdit_tpu_torch.ops.cuda import mlp_block as mb
from mapdit_tpu_torch.runtime import build_block_stack, fold_weights_for_inference
from mapdit_tpu_torch.training import create_optimizer, create_train_state, make_train_step, warmup_flat_invsqrt
from mapdit_tpu_torch.utils.weights import state_dict_from_jax

N, D, HEADS, H, DEPTH = 2, 128, 2, 512, 2
TOKENS = (16, 256)  # 8 x 8 latents at patch 2, and one T > 64 (32 x 32)
TOL = dict(rtol=2e-4, atol=2e-4)
XS2 = dict(in_channels=4, input_size=16, num_classes=10)
F32 = torch.float32
torch.set_num_threads(2)


def _block_inputs(seed, t, depth=None):
    rng = np.random.default_rng(seed)
    lead = () if depth is None else (depth,)

    def f(*s):
        return rng.normal(size=s).astype(np.float32)

    def w(*s):
        m = f(*lead, *s)
        return m * np.sqrt(s[-1]) / (np.linalg.norm(m, axis=-1, keepdims=True) + 1e-4)

    gains = rng.uniform(0.1, 0.9, size=lead + (2,)).astype(np.float32)
    return [f(N, t, D), f(N, D), gains, w(6 * D, D), w(3 * D, D), w(D, D), w(H, D), w(D, H)]


def _torch(args):
    return [torch.from_numpy(np.asarray(a)) for a in args]


def _jax(args):
    return [jnp.asarray(a) for a in args]


# ---------------------------------------------------------------------------
# (a) the plain versions at f32 against the JAX package's f32 functions


@pytest.mark.parametrize("site", ["modulation", "qkv", "out", "fc1", "fc2"])
def test_mp_gemm_plain_f32_products_match_jax(site):
    """The five products of the block body (_block_body, mapdit_tpu/ops/
    pallas/dit_block.py:279) with their prologue and epilogues, through
    mp_gemm (its plain version on the CPU) at f32, against the JAX
    reference's f32 arithmetic (_reference, :406: the modulate, mp_silu
    and mp_sum of the JAX package)."""
    t = 16
    x, a, gains, w_mod, w_qkv, w_out, w1, w2 = _block_inputs(3, t)
    rng = np.random.default_rng(4)
    attn = rng.normal(size=(N * t, D)).astype(np.float32)
    h = rng.normal(size=(N * t, H)).astype(np.float32)
    mods = np.array(jnp.asarray(a) @ jnp.asarray(w_mod).T / math.sqrt(D))
    sm, scm, gm, sl, scl, gl = (jnp.asarray(mods[:, i * D:(i + 1) * D]) for i in range(6))
    xj = jnp.asarray(x)
    mods_t, xf = torch.from_numpy(mods), torch.from_numpy(x).reshape(N * t, D)
    inv_d = 1 / math.sqrt(D)
    if site == "modulation":
        got = tdb.mp_gemm(torch.from_numpy(a), torch.from_numpy(w_mod), alpha=inv_d, out_dtype=F32, site=site)
        want = mods
    elif site == "qkv":
        got = tdb.mp_gemm(xf, torch.from_numpy(w_qkv), alpha=inv_d, out_dtype=F32,
                          modulate=(mods_t, 0, D, torch.from_numpy(gains[0:1])), tokens=t, site=site)
        want = jdb._modulate(xj, sm[:, None], scm[:, None], gains[0]) @ jnp.asarray(w_qkv).T / math.sqrt(D)
    elif site == "out":
        got = tdb.mp_gemm(torch.from_numpy(attn), torch.from_numpy(w_out), alpha=inv_d, out_dtype=F32,
                          residual=(xf, mods_t, 2 * D), tokens=t, site=site)
        out = (jnp.asarray(attn) @ jnp.asarray(w_out).T / math.sqrt(D)).reshape(N, t, D)
        want = jmp.mp_sum(xj, gm[:, None, :] * out, t=jdb._RES_T)
    elif site == "fc1":
        got = tdb.mp_gemm(xf, torch.from_numpy(w1), alpha=inv_d, out_dtype=F32,
                          modulate=(mods_t, 3 * D, 4 * D, torch.from_numpy(gains[1:2])), silu=True, tokens=t,
                          site=site)
        want = jmp.mp_silu(jdb._modulate(xj, sl[:, None], scl[:, None], gains[1]) @ jnp.asarray(w1).T / math.sqrt(D))
    else:
        got = tdb.mp_gemm(torch.from_numpy(h), torch.from_numpy(w2), alpha=1 / math.sqrt(H), out_dtype=F32,
                          residual=(xf, mods_t, 5 * D), tokens=t, site=site)
        y = (jnp.asarray(h) @ jnp.asarray(w2).T / math.sqrt(H)).reshape(N, t, D)
        want = jmp.mp_sum(xj, gl[:, None, :] * y, t=jdb._RES_T)
    assert got.dtype == F32
    np.testing.assert_allclose(got.numpy().reshape(np.shape(want)), np.asarray(want), **TOL)


@pytest.mark.parametrize("t", TOKENS)
def test_cosine_attention_plain_f32_matches_attention_core(t):
    """Normal mode at f32 against the Pallas core _attention_core (l.129,
    with _cosine_scales l.49) at dtype = float32, where it rounds nothing."""
    qkv = np.random.default_rng(t).normal(size=(N * t, 3 * D)).astype(np.float32)
    want = np.asarray(jdb._attention_core(jnp.asarray(qkv), N, t, D, HEADS, jnp.float32))
    got = tdb.cosine_attention(torch.from_numpy(qkv), t, HEADS, F32)
    assert got.dtype == F32 and got.shape == (N * t, D)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("t", TOKENS)
def test_cosine_attention_plain_f32_residual_mode_matches_res_fwd(t):
    """Residual mode (normalize_first) at f32, out and p, against the
    Pallas residual forward (_attn_res_fwd_impl, l.1136) on f32 inputs:
    qkv from the same modulated product, p (N, heads, T, T) f32 and the
    pre-projection attention."""
    rng = np.random.default_rng(30 + t)
    x = rng.normal(size=(N, t, D)).astype(np.float32)
    shift, scale, gate = (rng.normal(size=(N, D)).astype(np.float32) for _ in range(3))
    gain = np.float32(0.4)
    w_qkv, w_out = (rng.normal(size=s).astype(np.float32) for s in ((3 * D, D), (D, D)))
    _, p, attn = (np.asarray(v) for v in jdb._attn_res_fwd_impl(
        *_jax([x, shift, scale, gate, gain, w_qkv, w_out]), HEADS))
    rows = torch.from_numpy(np.concatenate([shift, scale], axis=1))
    qkv = tdb.mp_gemm(torch.from_numpy(x).reshape(N * t, D), torch.from_numpy(w_qkv), alpha=1 / math.sqrt(D),
                      out_dtype=F32, modulate=(rows, 0, D, torch.tensor([gain])), tokens=t)
    probs = torch.empty(N, HEADS, t, t)
    got = tdb.cosine_attention(qkv, t, HEADS, F32, normalize_first=True, probs=probs)
    np.testing.assert_allclose(probs.numpy(), p, **TOL)
    np.testing.assert_allclose(got.numpy(), attn.reshape(N * t, D), **TOL)


@pytest.mark.parametrize("t", TOKENS)
def test_fused_dit_block_plain_f32_matches_jax(t):
    """The whole block at f32: fused_dit_block_plain and the wrapper the
    model calls (its plain version on the CPU, dit_stack's order) against
    the Pallas fused_dit_block in interpret mode on f32 operands."""
    args = _block_inputs(10 + t, t)
    want = np.asarray(jdb.fused_dit_block(*_jax(args), HEADS))
    got = tdb.fused_dit_block_plain(*_torch(args), HEADS)
    assert got.dtype == F32
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    np.testing.assert_allclose(tdb.fused_dit_block(*_torch(args), HEADS).numpy(), want, **TOL)


@pytest.mark.parametrize("t", TOKENS)
def test_fused_dit_stack_plain_f32_matches_jax(t):
    """The whole stack at f32 (depth 2): fused_dit_stack_plain, the f32
    launch sequence's route on the CPU and the kernel's plain version
    against the Pallas fused_dit_stack in interpret mode; the float64
    witness lands on the f32 plain version within the same tolerance."""
    args = _block_inputs(20 + t, t, depth=DEPTH)
    want = np.asarray(jdb.fused_dit_stack(*_jax(args), HEADS))
    got = tdb.fused_dit_stack_plain(*_torch(args), HEADS)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    np.testing.assert_allclose(tdb.stack_launch_sequence(*_torch(args), HEADS).numpy(), want, **TOL)
    np.testing.assert_allclose(tdb.dit_stack_plain(*_torch(args), HEADS).numpy(), want, **TOL)
    witness = tdb.fused_dit_stack_plain(*_torch(args), HEADS, sum_dtype=torch.float64)
    np.testing.assert_allclose(witness.numpy(), got.numpy(), **TOL)


# ---------------------------------------------------------------------------
# (b) a DiT-XS/2 float32 model on mega and mega_stack


@pytest.fixture(scope="module")
def xs2():
    """DiT-XS/2 cut to depth 2 at 16 x 16 latents (T = 64), float32: JAX
    init weights with the block gains drawn away from their zero init, and
    seeded inputs."""
    cfg = jax_build_config("DiT-XS/2", depth=2, **XS2)
    _, variables = jax_init_model(cfg, seed=3)
    rng = np.random.default_rng(3)
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


def _torch_inputs(inputs):
    x, t, y = inputs
    return torch.from_numpy(x), torch.from_numpy(t), torch.from_numpy(y.astype(np.int64))


def test_xs2_f32_mega_forward_matches_jax(xs2):
    """Every block through fused_dit_block at float32 against the JAX model
    under block_kernel="mega" (its Pallas block kernel in interpret mode)."""
    jcfg, variables, inputs = xs2
    want = np.asarray(JaxDiT(jcfg.replace(block_kernel="mega")).apply(variables, *_jax(inputs)))
    cfg = build_config("DiT-XS/2", depth=2, block_kernel="mega", **XS2)
    assert cfg.dtype == F32
    model = DiT(cfg).eval()
    model.load_state_dict(state_dict_from_jax(variables, cfg))
    with torch.no_grad():
        got = model(*_torch_inputs(inputs))
    assert got.dtype == F32
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_xs2_f32_mega_stack_forward_matches_jax(xs2):
    """The whole stack in one fused_dit_stack call at float32 (folded f32
    weights, the f32 block stack runtime.build_block_stack builds) against
    the JAX model under block_kernel="mega_stack"."""
    jcfg, variables, inputs = xs2
    jcfg = jcfg.replace(fold_weights=True, block_kernel="mega_stack")
    jv = dict(variables, params=jax_fold(variables["params"], jcfg))
    want = np.asarray(JaxDiT(jcfg).apply(jv, *_jax(inputs), block_stack=jax_build_block_stack(jv["params"], jcfg)))
    cfg = build_config("DiT-XS/2", depth=2, fold_weights=True, block_kernel="mega_stack", **XS2)
    sd = fold_weights_for_inference(state_dict_from_jax(variables, cfg), cfg)
    stack = build_block_stack(sd, cfg)
    assert all(v.dtype == F32 for v in stack.values())
    model = DiT(cfg).eval()
    model.load_state_dict(sd)
    with torch.no_grad():
        got = model(*_torch_inputs(inputs), block_stack=stack)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_xs2_f32_mega_train_step_matches_jax(xs2):
    """One train step of the float32 model on mega (fused_dit_block
    forward, the gradient recomputed through block_reference) with the JAX
    step's draws: the loss against the JAX loss under block_kernel="mega"
    (2e-4 relative) and every gradient against jax.grad of it (2e-4 of the
    tensor's largest element)."""
    jcfg, variables, _ = xs2
    jcfg = jcfg.replace(block_kernel="mega")
    rng = np.random.default_rng(12)
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
    cfg = build_config("DiT-XS/2", depth=2, block_kernel="mega", **XS2)
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


# ---------------------------------------------------------------------------
# (c) the f32 plan's shared memory


@pytest.mark.parametrize("hd", tdb.ATTENTION_HEAD_WIDTHS)
@pytest.mark.parametrize("t", (64, 256))
def test_f32_stack_plan_fits_shared_memory(hd, t):
    """dit_stack's f32 instances: the two attention groups' f32 rows fit
    the ring (4 stages of 32 KB) and a CTA's shared memory fits 227 KB at
    the S/2 (hd 64) and XL/2 (hd 72) head widths, T = 64 and 256; the k
    steps are 32 deep and the f32 scratch is twice the bf16 plan's."""
    heads = 6
    d = hd * heads
    n = 4096 // t
    plan = tdb.stack_plan(n, t, d, 4 * d, heads, 12, elem_bytes=4)
    bf16 = tdb.stack_plan(n, t, d, 4 * d, heads, 12)
    assert plan.smem_bytes <= tdb.MAX_SMEM_BYTES and plan.smem_bytes == bf16.smem_bytes
    assert plan.attention_smem_bytes <= tdb.STACK_RING_BYTES
    assert plan.attention_smem_bytes == 2 * (3 * 64 * (hd + 4) * 4 + 2 * 64 * 4)
    assert all(p.k_step == 32 and p.kt == -(-p.k // 32) for p in plan.products)
    for name in ("attn", "h", "amod"):
        nxt = list(plan.layout)[list(plan.layout).index(name) + 1] if name != "amod" else None
        size = (plan.layout[nxt] if nxt else plan.workspace_bytes) - plan.layout[name]
        want = n * t * (4 * d if name == "h" else d) * 4
        assert want <= size < want + 256, name


def test_f32_plan_splits_count_k_steps_of_32():
    """A split product counts k steps of 32 in the f32 plan (XL/2 at 8 rows:
    qkv, out and fc2 split K); every split keeps at least three k steps."""
    plan = tdb.stack_plan(8, 64, 1152, 4608, 16, 28, elem_bytes=4)
    split = [p for p in plan.products if p.splits > 1]
    assert split and all(p.kt // p.splits >= 3 for p in split)
    with pytest.raises(ValueError, match="elem_bytes"):
        tdb.stack_plan(8, 64, 1152, 4608, 16, 28, elem_bytes=8)


# ---------------------------------------------------------------------------
# (d) the wrappers' f32 domain, on meta tensors (nothing is built)


def _meta(*shape, dtype=F32):
    return torch.empty(*shape, dtype=dtype, device="meta")


def _block_meta(dtypes):
    """x, a, gains and the five weights of a depth-1 block on meta tensors,
    x, a and the weights in ``dtypes`` (one type, or eight)."""
    n, t, d, h = 2, 16, 128, 512
    shapes = [(n, t, d), (n, d), (2,), (6 * d, d), (3 * d, d), (d, d), (h, d), (d, h)]
    return [_meta(*s, dtype=F32 if i == 2 else dt) for i, (s, dt) in enumerate(zip(shapes, dtypes))]


def test_block_args_accept_all_f32_and_refuse_a_mixed_set():
    bf = torch.bfloat16
    for dt in (F32, bf):
        args = _block_meta([dt] * 8)
        tdb._check_block_args(args[0], args[1], args[2], args[3:], None)
        with pytest.raises(ValueError, match="CUDA"):
            tdb.fused_dit_block(*args, 2)
        stacked = [z[None] if i > 2 else z for i, z in enumerate(args)]
        stacked[2] = _meta(1, 2)
        with pytest.raises(ValueError, match="CUDA"):
            tdb.fused_dit_stack(*stacked, 2)
    for mixed in ([bf] + [F32] * 7, [F32, F32, F32, F32, bf, F32, F32, F32], [F32] * 7 + [bf]):
        args = _block_meta(mixed)
        with pytest.raises(ValueError, match="all bf16 .* or all f32"):
            tdb.fused_dit_block(*args, 2)


def test_mp_gemm_and_cosine_attention_take_f32_to_the_cuda_check():
    m, n, k = 32, 64, 128
    with pytest.raises(ValueError, match="CUDA"):
        tdb.mp_gemm(_meta(m, k), _meta(n, k), alpha=1.0, out_dtype=F32)
    with pytest.raises(ValueError, match="CUDA"):
        tdb.mp_gemm(_meta(m, k), _meta(n, k), alpha=1.0, out_dtype=F32, silu=True)
    with pytest.raises(ValueError, match="f32 form takes an f32 a"):
        tdb.mp_gemm(_meta(m, k, dtype=torch.bfloat16), _meta(n, k), alpha=1.0, out_dtype=F32)
    # the attention backward's products read an f32 W as (K, N) since its
    # float32 slice
    with pytest.raises(ValueError, match="CUDA"):
        tdb.mp_gemm(_meta(m, k), _meta(k, n), alpha=1.0, out_dtype=F32, w_kn=True)
    qkv = _meta(8 * 16, 3 * 128)
    probs = _meta(8, 2, 16, 16)
    for kw in ({}, {"normalize_first": True}, {"normalize_first": True, "probs": probs}):
        with pytest.raises(ValueError, match="CUDA"):
            tdb.cosine_attention(qkv, 16, 2, F32, **kw)


def test_half_block_and_tp_kernels_still_refuse_f32():
    """Rows 3-5 (the attention half-block) and their launch sequences' parts
    take f32 since their float32 slice, and row 9 and rows 6-8 (the TP
    partials) since theirs: off the CPU an f32 model reaches the CUDA check,
    and a mixed set raises."""
    n, t, d = 2, 16, 128
    x, r, g = _meta(n, t, d), _meta(n, d), _meta(1)
    wq, wo = _meta(3 * d, d), _meta(d, d)
    for fn in (ab.fused_attn_branch, ab.attn_fwd, ab.attn_res_fwd):
        with pytest.raises(ValueError, match="CUDA"):
            fn(x, r, r, r, g, wq, wo, 2)
        with pytest.raises(ValueError, match="all bf16 .* or all f32"):
            fn(x, r, r, r, g, wq.to(torch.bfloat16), wo, 2)
    mb._check(x, r, r, r, g, _meta(4 * d, d), _meta(d, 4 * d))
    tp._check(x, wq, _meta(d, d), 3, "attn_tp_partial")
    with pytest.raises(ValueError, match="CUDA"):
        mb.fused_mlp_branch(x, r, r, r, g, _meta(4 * d, d), _meta(d, 4 * d))
    with pytest.raises(ValueError, match="CUDA"):
        tp.attn_tp_partial(x, r, r, g, wq, _meta(d, d), 2)
    with pytest.raises(ValueError, match=r"row 9\).*all bf16 .* or all f32"):
        mb._check(x, r, r, r, g, _meta(4 * d, d, dtype=torch.bfloat16), _meta(d, 4 * d))
    with pytest.raises(ValueError, match=r"rows 6-8\).*all bf16 .* or all f32"):
        tp._check(x, wq.to(torch.bfloat16), _meta(d, d), 3, "attn_tp_partial")
    with pytest.raises(ValueError, match="CUDA"):
        ab.out_gate_residual_bwd(_meta(n * t, d), wo, _meta(n * t, d), _meta(n, 3 * d), 2 * d, t)
    with pytest.raises(ValueError, match="both bf16 or both f32"):
        ab.out_gate_residual_bwd(_meta(n * t, d), wo.to(torch.bfloat16), _meta(n * t, d), _meta(n, 3 * d), 2 * d, t)
