"""Float32 on the attention half-block: the plain versions that rows 3, 5
and 4's f32 kernels (``csrc/attn_branch.cu``'s f32 instances) and their
launch sequences' f32 kernels (``attention_bwd_f32``, ``modulate_fwd_f32``,
the f32 ``out_gate_residual_bwd``, the dattn and dh products reading an f32
W as (K, N)) are held to on the card, against the JAX package at ``dtype =
float32``, whose Pallas kernels run in interpret mode on the CPU; the dW
pair at f32 against JAX's ``dot_general``; a DiT-XS/2 float32 model on
``mega_attn`` (``pallas`` and ``residual``) against the JAX model on the
same weights; the f32 plan and its shared memory; and the wrappers' f32
domain on meta tensors. Inputs come from numpy seeds. Tolerances are the
JAX package's own f32 kernel tolerance, rtol = atol = 2e-4
(tests/test_pallas.py:169-181); the train step's gradients are held to
2e-4 of each tensor's largest element, as tests/test_torch_f32.py holds
``mega``'s."""

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
from mapdit_tpu_torch.diffusion import create_diffusion
from mapdit_tpu_torch.models import DiT, build_config
from mapdit_tpu_torch.ops.cuda import attn_branch as ab
from mapdit_tpu_torch.ops.cuda import dit_block as tdb
from mapdit_tpu_torch.ops.cuda import dit_block_tp as tp
from mapdit_tpu_torch.ops.cuda import mlp_block as mb
from mapdit_tpu_torch.tools import bench_attn_branch as bab
from mapdit_tpu_torch.training import create_optimizer, create_train_state, make_train_step, warmup_flat_invsqrt
from mapdit_tpu_torch.utils.weights import state_dict_from_jax

N, D, HEADS = 2, 128, 2
TOKENS = (16, 64, 256)  # 8 x 8 and 16 x 16 latents at patch 2, and 32 x 32 (past one row tile a sample)
TOL = dict(rtol=2e-4, atol=2e-4)
XS2 = dict(in_channels=4, input_size=16, num_classes=10)
F32 = torch.float32
torch.set_num_threads(2)


def _branch_inputs(seed, t, n=N, d=D):
    """x, shift, scale, gate, the gain, W_qkv, W_out (rows normalised, as
    the model's folded weights are) and dy, f32 numpy."""
    rng = np.random.default_rng(seed)

    def f(*s):
        return rng.normal(size=s).astype(np.float32)

    def w(*s):
        m = f(*s)
        return (m * np.sqrt(s[-1]) / (np.linalg.norm(m, axis=-1, keepdims=True) + 1e-4)).astype(np.float32)

    return [f(n, t, d), f(n, d), f(n, d), f(n, d), np.float32(0.37), w(3 * d, d), w(d, d)], f(n, t, d)


def _torch(args):
    return [torch.as_tensor(np.asarray(a)) for a in args]


def _jax(args):
    return [jnp.asarray(a) for a in args]


def _jax_bwd(args, dy):
    """The JAX package's fused backward kernel (_attn_bwd_impl, its Pallas
    kernel in interpret mode) on f32 operands: dx, dshift, dscale, dgate,
    dgain and the dW pair's operands h, dqkv, attn, dout."""
    return [np.asarray(v) for v in jdb._attn_bwd_impl(jnp.asarray(dy), *_jax(args), HEADS)]


# ---------------------------------------------------------------------------
# (a) the plain versions at f32 against the JAX package's f32 functions


@pytest.mark.parametrize("t", TOKENS)
def test_attention_bwd_plain_f32_matches_jax_attn_bwd_impl(t):
    """The f32 launch sequence's stages through their plain versions (the
    wrappers on the CPU): h from modulate_fwd at f32, the qkv product, the
    normalise-first attention, dout from out_gate_residual_bwd, the dattn
    product, then attention_bwd_plain writing f32 dqkv (no rounding) against
    the f32 h, attn, dout and dqkv of the Pallas backward _attn_bwd_impl
    (mapdit_tpu/ops/pallas/dit_block.py:861) at dtype = float32."""
    args, dy = _branch_inputs(t, t)
    want_h, want_dqkv, want_attn, want_dout = _jax_bwd(args, dy)[5:]
    x, shift, scale, gate, gain, wq, wo = _torch(args)
    m, inv_d = N * t, 1 / math.sqrt(D)
    rows = torch.cat([shift, scale, gate], dim=1)
    h = ab.modulate_fwd(x.reshape(m, D), rows, gain.reshape(1), t, F32)
    qkv = tdb.mp_gemm(h, wq, alpha=inv_d, out_dtype=F32, site="qkv")
    attn = tdb.cosine_attention(qkv, t, HEADS, F32, normalize_first=True)
    dout, _ = ab.out_gate_residual_bwd(attn, wo, torch.from_numpy(dy).reshape(m, D), rows, 2 * D, t)
    dattn = tdb.mp_gemm(dout, wo, alpha=inv_d, out_dtype=F32, w_kn=True, site="dattn")
    dqkv = ab.attention_bwd(qkv, dattn, t, HEADS, F32)
    for name, got, want in (("h", h, want_h), ("attn", attn, want_attn), ("dout", dout, want_dout),
                            ("dqkv", dqkv, want_dqkv)):
        assert got.dtype == F32, name
        np.testing.assert_allclose(got.numpy(), want.reshape(got.shape), **TOL, err_msg=name)


@pytest.mark.parametrize("t", TOKENS)
def test_branch_bwd_plain_f32_cotangents_match_jax_attn_bwd_impl(t):
    """attn_branch_bwd_plain at f32 (dgain in the one-launch kernel's tile
    order) and attn_bwd on CPU tensors: dx, dshift, dscale and dgate against
    the f32 Pallas backward; dgain, a sum whose terms cancel, within 2e-4 of
    its terms' root-sum-square (phase 3's f32 rule); the operands of the dW
    pair in f32."""
    args, dy = _branch_inputs(100 + t, t)
    want = _jax_bwd(args, dy)
    targs, tdy = _torch(args) + [HEADS], torch.from_numpy(dy)
    got = ab.attn_branch_bwd_plain(tdy, *targs)
    grads = ab.attn_bwd(tdy, *targs)
    for i, name in enumerate(("dx", "dshift", "dscale", "dgate")):
        assert got[i].dtype == F32 and grads[i].dtype == F32, name
        np.testing.assert_allclose(got[i].numpy(), want[i], **TOL, err_msg=name)
        np.testing.assert_allclose(grads[i].numpy(), want[i], **TOL, err_msg=name)
    terms = bab.dgain_terms(targs, tdy)
    rss = float(terms.double().square().sum().sqrt())
    for dgain in (got[4], grads[4]):
        assert abs(float(dgain) - float(want[4].reshape(()))) <= 2e-4 * rss
    assert all(z.dtype == F32 for z in got[5])


@pytest.mark.parametrize("t", (16, 64))
def test_modulate_fwd_plain_writes_f32_h(t):
    """modulate_fwd at out_dtype f32 (modulate_fwd_f32 on the card) against
    the JAX package's _modulate at f32: nothing rounded, f32 x or bf16 x."""
    args, _ = _branch_inputs(200 + t, t)
    x, shift, scale = args[:3]
    want = np.asarray(jdb._modulate(jnp.asarray(x), jnp.asarray(shift)[:, None], jnp.asarray(scale)[:, None],
                                    jnp.float32(0.37)))
    rows = torch.from_numpy(np.concatenate([shift, scale, args[3]], axis=1))
    got = ab.modulate_fwd(torch.from_numpy(x).reshape(N * t, D), rows, torch.tensor([0.37]), t, F32)
    assert got.dtype == F32
    np.testing.assert_allclose(got.numpy(), want.reshape(N * t, D), **TOL)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    want_b = np.asarray(jdb._modulate(jnp.asarray(xb.float().numpy()), jnp.asarray(shift)[:, None],
                                      jnp.asarray(scale)[:, None], jnp.float32(0.37)))
    got_b = ab.modulate_fwd(xb.reshape(N * t, D), rows, torch.tensor([0.37]), t, F32)
    np.testing.assert_allclose(got_b.numpy(), want_b.reshape(N * t, D), **TOL)


@pytest.mark.parametrize("n, t", [(4, 64), (3, 256), (5, 48)])
def test_out_gate_residual_bwd_plain_f32_matches_jax(n, t):
    """The out product with the residual backward at f32, across row tiles
    (T = 256: every sample spans two tiles of 128 rows; T = 48: samples
    straddle them): dout = dy*0.3/rd*gate in f32 and dgate = sum_t
    dy*0.3/rd*out, against the arithmetic of _attn_bwd_math's residual
    backward (dit_block.py:620-633) in jnp f32."""
    rng = np.random.default_rng(300 + t)
    attn, dy = (rng.normal(size=(n * t, D)).astype(np.float32) for _ in range(2))
    args, _ = _branch_inputs(301 + t, t, n=n)
    wo, gate = args[6], args[3]
    rows = np.concatenate([args[1], args[2], gate], axis=1)
    out = jnp.asarray(attn) @ jnp.asarray(wo).T / math.sqrt(D)
    rd = math.sqrt((1 - jdb._RES_T) ** 2 + jdb._RES_T**2)
    db = jnp.asarray(dy) * (jdb._RES_T / rd)
    want_dgate = (db * out).reshape(n, t, D).sum(axis=1)
    want_dout = (db.reshape(n, t, D) * jnp.asarray(gate)[:, None, :]).reshape(n * t, D)
    dout, dgate = ab.out_gate_residual_bwd(torch.from_numpy(attn), torch.from_numpy(wo), torch.from_numpy(dy),
                                           torch.from_numpy(rows), 2 * D, t)
    assert dout.dtype == F32 and dgate.dtype == F32
    np.testing.assert_allclose(dout.numpy(), np.asarray(want_dout), **TOL)
    np.testing.assert_allclose(dgate.numpy(), np.asarray(want_dgate), **TOL)


def test_dw_pair_f32_matches_jax_dot_general():
    """The dW pair of a float32 model (_dw_pair off the in-kernel variant,
    _dw_product on f32 operands) against JAX's two dot_general products with
    preferred_element_type=float32 (_attn_bwd, dit_block.py:948-970) on the
    f32 operands of its own backward kernel."""
    t = 64
    args, dy = _branch_inputs(400, t)
    want = [np.asarray(v) for v in jdb._attn_bwd(jnp.asarray(dy), *_jax(args), HEADS)]
    h, dqkv, attn, dout = (torch.from_numpy(np.array(v).reshape(N * t, -1)) for v in _jax_bwd(args, dy)[5:])
    assert not ab.dw_in_kernel(D)
    dw_qkv, dw_out = ab._dw_pair(dqkv, h, dout, attn, 1 / math.sqrt(D), ab.dw_gemm)
    assert dw_qkv.dtype == F32 and dw_out.dtype == F32
    np.testing.assert_allclose(dw_qkv.numpy(), want[5], **TOL)
    np.testing.assert_allclose(dw_out.numpy(), want[6], **TOL)


# ---------------------------------------------------------------------------
# (b) a DiT-XS/2 float32 model on mega_attn


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


def test_xs2_f32_mega_attn_forward_matches_jax(xs2):
    """Every block's attention half through fused_attn_branch at float32
    (attn_fwd: row 3's f32 instance on the card) against the JAX model
    under block_kernel="mega_attn" (its Pallas half-block kernel in
    interpret mode)."""
    jcfg, variables, inputs = xs2
    want = np.asarray(JaxDiT(jcfg.replace(block_kernel="mega_attn")).apply(variables, *_jax(inputs)))
    cfg = build_config("DiT-XS/2", depth=2, block_kernel="mega_attn", **XS2)
    assert cfg.dtype == F32
    model = DiT(cfg).eval()
    model.load_state_dict(state_dict_from_jax(variables, cfg))
    x, t, y = inputs
    with torch.no_grad():
        got = model(torch.from_numpy(x), torch.from_numpy(t), torch.from_numpy(y.astype(np.int64)))
    assert got.dtype == F32
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("bwd", ["pallas", "residual"])
def test_xs2_f32_mega_attn_train_step_matches_jax(xs2, bwd):
    """One train step of the float32 model on mega_attn with attn_bwd
    ``bwd`` (pallas: rows 3 and 4, the fused backward recomputing the
    forward; residual: row 5 and the plain backward over its residuals) with
    the JAX step's draws: the loss against the JAX loss under the same
    block_kernel and attn_bwd (2e-4 relative) and every gradient against
    jax.grad of it (2e-4 of the tensor's largest element)."""
    jcfg, variables, _ = xs2
    jcfg = jcfg.replace(block_kernel="mega_attn", attn_bwd=bwd)
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
    cfg = build_config("DiT-XS/2", depth=2, block_kernel="mega_attn", attn_bwd=bwd, **XS2)
    tx = create_optimizer(warmup_flat_invsqrt(1e-2, 5, 50))
    state = create_train_state(cfg, tx, device="cpu", state_dict=state_dict_from_jax(variables, cfg))
    tbatch = {key: torch.from_numpy(v) for key, v in batch.items()}
    tbatch["y"] = tbatch["y"].long()
    tdraws = {key: torch.from_numpy(v) for key, v in draws.items()}
    tdraws["drop"] = torch.zeros(b, dtype=torch.long)
    metrics = make_train_step(cfg, create_diffusion("", device="cpu"), tx, torch.from_numpy(stats_mean),
                              torch.from_numpy(stats_std), model_train=False)(state, tbatch, draws=tdraws)
    np.testing.assert_allclose(float(metrics["loss"]), float(want_loss), rtol=2e-4)
    params = dict(state.model.named_parameters())
    assert set(want) == set(params)
    for name, p in params.items():
        w = want[name].numpy()
        scale = np.abs(w).max() + 1e-12
        np.testing.assert_allclose(p.grad.numpy() / scale, w / scale, rtol=0, atol=2e-4, err_msg=name)


# ---------------------------------------------------------------------------
# (c) the f32 plan and its shared memory

WALKS = {"s2": (256, 64, 384, 6), "xl": (256, 64, 1152, 16), "xl-t4-n3": (3, 4, 1152, 16)}


@pytest.mark.parametrize("kind", ["fwd", "res_fwd", "bwd"])
@pytest.mark.parametrize("name", list(WALKS))
def test_f32_branch_plan_is_the_bf16_walk_with_f32_scratch(kind, name):
    """The f32 instances run the bf16 plan's list: the same stages, items,
    words and counter targets (tests/test_torch_attn_branch_kernel.py walks
    and simulates them), pre items of the same token rows (the f32 pre items
    read x through L2, not the ring); only the scratch differs: h, attn,
    dout and dqkv in f32, each region 256-byte aligned and apart."""
    n, t, d, heads = WALKS[name]
    plan = ab.branch_plan(kind, n, t, d, heads, 132, f32=True)
    bf16 = ab.branch_plan(kind, n, t, d, heads, 132)
    assert plan.kernel == bf16.kernel + "_f32"
    assert plan.words() == bf16.words() and plan.table() == bf16.table() and plan.items == bf16.items
    assert [s.items for s in plan.stages] == [s.items for s in bf16.stages]
    m = n * t
    sizes = {"qkv": m * 3 * d * 4} if kind == "res_fwd" else {"h": m * d * 4, "qkv": m * 3 * d * 4, "attn": m * d * 4}
    if kind == "bwd":
        sizes.update(dout=m * d * 4, dattn=m * d * 4, dqkv=m * 3 * d * 4,
                     dgain_partial=plan.stage("dh").product.tiles * 4)
    assert set(plan.layout) == set(sizes)
    spans = sorted((plan.layout[k], plan.layout[k] + v) for k, v in sizes.items())
    assert all(a % 256 == 0 for a, _ in spans) and spans[-1][1] <= plan.workspace_bytes
    assert all(a[1] <= b[0] for a, b in zip(spans, spans[1:]))


@pytest.mark.parametrize("kind", ["fwd", "res_fwd", "bwd"])
@pytest.mark.parametrize("hd", tdb.ATTENTION_HEAD_WIDTHS)
def test_f32_branch_units_fit_shared_memory(kind, hd):
    """The f32 instances' two attention units a CTA fit where
    csrc/attn_branch.cu puts them at the S/2 (hd 64) and XL/2 (hd 72) head
    widths: the forward's f32 q, k, v rows of both groups in the ring
    (105472 / 117760 bytes of 131072), the backward's four f32 tiles and row
    sums a group, one in the ring and one in the epilogue tile's and sums'
    memory (70656 / 78848 bytes of 83968); a CTA's shared memory fits the
    227 KB a block may take."""
    regions = ab.branch_f32_units(kind, hd)
    ld = hd + 4
    assert regions["ring"][0] >= 2 * (3 * 64 * ld * 4 + 2 * 64 * 4)
    for used, room in regions.values():
        assert used <= room
    if kind == "bwd":
        assert regions["tile+sums"][0] == 4 * 64 * ld * 4 + 4 * 64 * 4
    assert ab.BRANCH_SMEM_BYTES <= tdb.MAX_SMEM_BYTES


# ---------------------------------------------------------------------------
# (d) the wrappers' f32 domain, on meta tensors (nothing is built)


def _meta(*shape, dtype=F32):
    return torch.empty(*shape, dtype=dtype, device="meta")


def test_f32_wrappers_reach_the_cuda_check():
    """Off the CPU every f32 wrapper of the attention half-block goes to its
    kernel's CUDA check (it raises naming CUDA before anything is built):
    the one-launch rows 3, 5 and 4, the sequences' attention_bwd at f32
    output, modulate_fwd writing f32 h, the f32 out_gate_residual_bwd, the
    dattn and dh products with an f32 (K, N) weight, the whole backward."""
    n, t, d, heads = 2, 16, 128, 2
    x, r, g = _meta(n, t, d), _meta(n, d), _meta(1)
    wq, wo = _meta(3 * d, d), _meta(d, d)
    args = (x, r, r, r, g, wq, wo, heads)
    calls = [
        lambda: ab.attn_branch_fwd(*args),
        lambda: ab.attn_branch_res_fwd(*args),
        lambda: ab.attn_branch_bwd(_meta(n, t, d), *args),
        lambda: ab.attn_bwd(_meta(n, t, d), *args),
        lambda: ab.attention_bwd(_meta(n * t, 3 * d), _meta(n * t, d), t, heads, F32),
        lambda: ab.modulate_fwd(_meta(n * t, d), _meta(n, 3 * d), g, t, F32),
        lambda: ab.out_gate_residual_bwd(_meta(n * t, d), wo, _meta(n * t, d), _meta(n, 3 * d), 2 * d, t),
        lambda: tdb.mp_gemm(_meta(n * t, d), wo, alpha=1.0, out_dtype=F32, w_kn=True, site="dattn"),
        lambda: tdb.mp_gemm(_meta(n * t, 3 * d), wq, alpha=1.0, out_dtype=F32, w_kn=True, site="dh"),
    ]
    before = dict(ab.LAUNCHES)
    for call in calls:
        with pytest.raises(ValueError, match="CUDA"):
            call()
    assert ab.LAUNCHES == before


@pytest.mark.parametrize("mixed", ["x", "w_qkv", "w_out"])
def test_a_mixed_set_raises(mixed):
    """x and the weights all bf16 or all f32: one of them in the other type
    raises on every route (the one-launch kernel's and the sequence's)."""
    n, t, d, heads = 2, 16, 128, 2
    parts = {"x": _meta(n, t, d), "w_qkv": _meta(3 * d, d), "w_out": _meta(d, d)}
    parts[mixed] = parts[mixed].to(torch.bfloat16)
    r, g = _meta(n, d), _meta(1)
    args = (parts["x"], r, r, r, g, parts["w_qkv"], parts["w_out"], heads)
    assert ab.branch_route(parts["x"], parts["w_qkv"], parts["w_out"], heads) == "sequence"
    for fn in (ab.attn_fwd, ab.attn_res_fwd, ab.fused_attn_branch):
        with pytest.raises(ValueError, match="all bf16 .*or all f32"):
            fn(*args)
    with pytest.raises(ValueError, match="all bf16 .* or all f32"):
        ab.attn_bwd(_meta(n, t, d), *args)


def test_f32_dw_gemm_and_later_rows_raise_naming_their_slice():
    """dw_gemm (row 4', the in-kernel-dW variant, off by default) on f32
    operands raises naming its later slice rather than giving way to the
    library pair; rows 6-9 take f32 since their own slice: an all-f32 set
    reaches the CUDA check."""
    n, t, d = 2, 16, 128
    with pytest.raises(ValueError, match="row 4'.*later slice"):
        ab.dw_gemm(_meta(n * t, 3 * d), _meta(n * t, d), 0.25)
    x, r, g = _meta(n, t, d), _meta(n, d), _meta(1)
    with pytest.raises(ValueError, match="CUDA"):
        mb.mlp_branch(x, r, r, r, g, _meta(4 * d, d), _meta(d, 4 * d))
    with pytest.raises(ValueError, match="CUDA"):
        tp.tp_attn(x, r, r, g, _meta(3 * d, d), _meta(d, d), 2)
    with pytest.raises(ValueError, match="CUDA"):
        tp.tp_mlp(x, r, r, g, _meta(4 * d, d), _meta(d, 4 * d), 0.1)

