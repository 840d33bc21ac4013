"""The port's standalone attention (``fused_attention``) and MLP half-block
(``fused_mlp_branch``) against the JAX package's Pallas kernels in interpret
mode, at the JAX tests' own tolerances (tests/test_pallas.py): 2e-5 forward
and 5e-5 gradient for attention in f32, 0.05 in bf16; 2e-4 forward and 5e-4
gradient for the MLP half-block. CPU: the wrappers run their plain
versions, and their autograd functions recompute through the references."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mapdit_tpu.ops.attention import dot_product_attention as jax_dot_product_attention
from mapdit_tpu.ops.pallas.attention import fused_attention as jax_fused_attention
from mapdit_tpu.ops.pallas.mlp_block import fused_mlp_branch as jax_fused_mlp_branch
from mapdit_tpu_torch.models import DiT, build_config
from mapdit_tpu_torch.models.registry import DIT_MODELS
from mapdit_tpu_torch.ops.attention import dot_product_attention, plain_attention
from mapdit_tpu_torch.ops.cuda import attention as attn_k
from mapdit_tpu_torch.ops.cuda import dit_block, mlp_block
from mapdit_tpu_torch.ops.mp import normalize

XS2 = dict(in_channels=4, input_size=16, num_classes=10)
ATTN_TOL = dict(rtol=2e-5, atol=2e-5)
VERSIONS = {"pallas": "auto", "pallas_v2": "v2", "pallas_v3": "v3"}


def _qkv(shape, seed=0, scale=1.0):
    rng = np.random.default_rng(seed)
    return tuple((rng.normal(size=shape) * scale).astype(np.float32) for _ in range(3))


def _t(*arrays, dtype=torch.float32):
    return tuple(torch.from_numpy(a).to(dtype) for a in arrays)


@pytest.mark.parametrize("impl", list(VERSIONS))
@pytest.mark.parametrize("cosine", [True, False], ids=["cosine", "plain"])
def test_fused_attention_matches_jax(impl, cosine):
    q, k, v = _qkv((2, 4, 64, 64))
    want = np.asarray(jax_fused_attention(*map(jnp.asarray, (q, k, v)), 0.125, cosine, VERSIONS[impl]))
    got = dot_product_attention(*_t(q, k, v), 0.125, cosine=cosine, impl=impl)
    np.testing.assert_allclose(got.numpy(), want, **ATTN_TOL)


@pytest.mark.parametrize(
    "shape, version",
    [((1, 2, 16, 72), "auto"), ((2, 3, 32, 64), "v3"), ((1, 16, 4, 72), "auto"), ((1, 2, 256, 64), "v2")],
    ids=["head-width-72", "odd-heads", "xl8-t4", "t256"],
)
def test_fused_attention_shapes_match_jax(shape, version):
    q, k, v = _qkv(shape, seed=1)
    scale = shape[-1] ** -0.5
    want = np.asarray(jax_fused_attention(*map(jnp.asarray, (q, k, v)), scale, True, version))
    got = attn_k.fused_attention(*_t(q, k, v), scale, True)
    np.testing.assert_allclose(got.numpy(), want, **ATTN_TOL)


@pytest.mark.parametrize("cosine", [True, False], ids=["cosine", "plain"])
def test_fused_attention_bf16_matches_jax(cosine):
    q, k, v = _qkv((2, 4, 64, 64), seed=2)
    jq, jk, jv = (jnp.asarray(z).astype(jnp.bfloat16) for z in (q, k, v))
    want = np.asarray(jax_fused_attention(jq, jk, jv, 0.125, cosine).astype(jnp.float32))
    got = attn_k.fused_attention(*_t(q, k, v, dtype=torch.bfloat16), 0.125, cosine)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0.05, atol=0.05)


def test_fused_attention_subtracts_the_row_maximum():
    """Without the cosine normalisation logits are unbounded: with logits
    past 88 an exponential without the row maximum overflows in f32."""
    q, k, v = _qkv((1, 2, 16, 32), seed=3, scale=6.0)
    tq, tk, tv = _t(q, k, v)
    assert float((tq @ tk.transpose(-1, -2)).abs().max()) > 88.0
    want = np.asarray(jax_fused_attention(*map(jnp.asarray, (q, k, v)), 1.0, False))
    got = attn_k.fused_attention(tq, tk, tv, 1.0, False)
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-4, atol=2e-5)


@pytest.mark.parametrize("cosine", [True, False], ids=["cosine", "plain"])
def test_fused_attention_gradient_matches_jax(cosine):
    """The autograd function (kernel forward, backward through the plain
    path) against jax.grad of the Pallas kernel's custom VJP."""
    q, k, v = _qkv((2, 4, 64, 64), seed=4)
    want = jax.grad(lambda *z: jnp.sum(jax_fused_attention(*z, 0.125, cosine) ** 2), argnums=(0, 1, 2))(
        *map(jnp.asarray, (q, k, v)))
    tq, tk, tv = (z.requires_grad_() for z in _t(q, k, v))
    out = attn_k.fused_attention(tq, tk, tv, 0.125, cosine)
    assert type(out.grad_fn).__name__ == "_FusedAttentionBackward"
    out.square().sum().backward()
    for g, w in zip((tq.grad, tk.grad, tv.grad), want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=5e-5, atol=5e-5)


def test_fused_attention_takes_the_models_strided_views():
    """q, k, v as the transposed views of a split qkv product, as
    ``models/layers.py:Attention`` hands them in, give the contiguous
    result; only the first of three gradients asked for is computed."""
    rng = np.random.default_rng(5)
    b, t, h, hd = 2, 16, 4, 8
    qkv = torch.from_numpy(rng.normal(size=(b, t, 3 * h * hd)).astype(np.float32))
    q, k, v = (z.reshape(b, t, h, hd).transpose(1, 2) for z in qkv.split(h * hd, dim=-1))
    assert not q.is_contiguous()
    got = attn_k.fused_attention(q, k, v, hd**-0.5, True)
    want = plain_attention(q.contiguous(), k.contiguous(), v.contiguous(), hd**-0.5, True)
    torch.testing.assert_close(got, want, rtol=2e-5, atol=2e-5)
    q = q.detach().requires_grad_()
    (dq,) = torch.autograd.grad(attn_k.fused_attention(q, k, v, hd**-0.5, True).sum(), (q,))
    assert dq.shape == q.shape and torch.isfinite(dq).all()


def test_dispatch_impl_flag():
    q, k, v = _t(*_qkv((2, 4, 64, 64), seed=6))
    a = dot_product_attention(q, k, v, 0.125, cosine=True, impl="xla")
    want = np.asarray(jax_dot_product_attention(*(jnp.asarray(z.numpy()) for z in (q, k, v)), 0.125, cosine=True))
    np.testing.assert_allclose(a.numpy(), want, **ATTN_TOL)
    torch.testing.assert_close(dot_product_attention(q, k, v, 0.125, cosine=True), a, rtol=0, atol=0)
    for impl in VERSIONS:
        b = dot_product_attention(q, k, v, 0.125, cosine=True, impl=impl)
        np.testing.assert_allclose(b.numpy(), a.numpy(), **ATTN_TOL)
    with pytest.raises(ValueError, match="impl"):
        dot_product_attention(q, k, v, 0.125, impl="flash")


def test_query_tile_serves_every_registry_model():
    """Every registry model at input sizes 16 and 32 (T = 4 ... 256, head
    widths 64 and 72) is in the kernel's domain in both types: bf16 runs on
    the tensor cores over key tiles of 64 at any T; the f32 kernel keeps a
    query tile that fits 227 KB, and beyond what fits the wrapper raises
    with the byte count."""
    for name, spec in DIT_MODELS.items():
        hd = spec["hidden_size"] // spec["num_heads"]
        for size in (16, 32):
            t = (size // spec["patch_size"]) ** 2
            assert attn_k.check_shape(t, hd, torch.bfloat16) == 0, (name, size)
            qt = attn_k.check_shape(t, hd, torch.float32)
            assert 1 <= qt <= min(64, t) and attn_k.smem_bytes(t, hd, qt) <= dit_block.MAX_SMEM_BYTES, (name, size)
    assert attn_k.check_shape(256, 72, torch.bfloat16) == 0 and attn_k.check_shape(1024, 64, torch.bfloat16) == 0
    assert attn_k.query_tile(64, 64) == 64 and attn_k.query_tile(256, 72) == 32
    assert attn_k.smem_bytes(256, 72, 32) == 191616
    with pytest.raises(ValueError, match=str(attn_k.smem_bytes(1024, 64, 1))):
        attn_k.check_shape(1024, 64, torch.float32)
    with pytest.raises(ValueError, match="head widths"):
        attn_k.check_shape(64, 48, torch.bfloat16)


def test_fused_attention_raises_on_a_misaligned_stride():
    """bf16 rows are read with 16-byte loads: a token stride that is not a
    multiple of 8 elements raises before anything is built, and no copy is
    made."""
    bf = torch.bfloat16
    q = torch.empty(2, 2, 8, 68, dtype=bf, device="meta")[..., :64]
    assert q.stride(2) == 68
    with pytest.raises(ValueError, match="16-byte"):
        attn_k.fused_attention(q, q, q, 0.25, True)
    aligned = torch.empty(2, 8, 2, 3 * 64, dtype=bf, device="meta")[..., :64].transpose(1, 2)
    with pytest.raises(ValueError, match="CUDA"):
        attn_k.fused_attention(aligned, aligned, aligned, 0.125, True)


def test_new_wrappers_do_not_fall_back_off_cpu():
    """A tensor that is not on the CPU goes to the kernel or raises; on a
    device that is not CUDA it raises before anything is built."""
    q = torch.empty(2, 2, 8, 16, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        attn_k.fused_attention(q, q, q, 0.25, True)
    bf = torch.bfloat16
    x = torch.empty(2, 8, 16, dtype=bf, device="meta")
    r = torch.empty(2, 16, dtype=bf, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        mlp_block.fused_mlp_branch(x, r, r, r, torch.empty((), device="meta"),
                                   torch.empty(64, 16, dtype=bf, device="meta"),
                                   torch.empty(16, 64, dtype=bf, device="meta"))


# ---------------------------------------------------------------------------
# the MLP half-block


def _mlp_inputs(seed=0, n=4, t=16, d=32, hidden=128):
    rng = np.random.default_rng(seed)

    def arr(*shape):
        return rng.normal(size=shape).astype(np.float32)

    w1 = normalize(torch.from_numpy(arr(hidden, d))).numpy()
    w2 = normalize(torch.from_numpy(arr(d, hidden))).numpy()
    return [arr(n, t, d), arr(n, d), arr(n, d), arr(n, d), np.float32(0.37), w1, w2]


def test_fused_mlp_branch_matches_jax():
    inputs = _mlp_inputs()
    want = np.asarray(jax_fused_mlp_branch(*map(jnp.asarray, inputs)))
    got = mlp_block.fused_mlp_branch(*(torch.as_tensor(v) for v in inputs))
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-4, atol=2e-4)
    ref = mlp_block.mlp_reference(*(torch.as_tensor(v) for v in inputs))
    np.testing.assert_allclose(ref.numpy(), want, rtol=2e-4, atol=2e-4)


def test_fused_mlp_branch_gradients_match_jax():
    """All seven cotangents of the autograd function against jax.grad of
    the Pallas kernel's custom VJP, each scaled by its largest element."""
    inputs = _mlp_inputs(seed=1)
    rng = np.random.default_rng(2)
    cot = rng.normal(size=inputs[0].shape).astype(np.float32)
    want = jax.grad(lambda *z: jnp.sum(jax_fused_mlp_branch(*z) * cot), argnums=tuple(range(7)))(
        *map(jnp.asarray, inputs))
    tensors = [torch.as_tensor(v).requires_grad_() for v in inputs]
    out = mlp_block.fused_mlp_branch(*tensors)
    assert type(out.grad_fn).__name__ == "_MLPBranchBackward"
    (out * torch.from_numpy(cot)).sum().backward()
    names = ("x", "shift", "scale", "gate", "gain", "w1", "w2")
    for name, t_, w in zip(names, tensors, want):
        w = np.asarray(w)
        scale = np.abs(w).max() + 1e-12
        assert t_.grad.shape == t_.shape
        np.testing.assert_allclose(t_.grad.numpy() / scale, w / scale, rtol=5e-4, atol=5e-4, err_msg=name)


@pytest.mark.parametrize("attention_impl", ["auto", "pallas"])
def test_model_with_fused_mlp_matches_golden(golden, attention_impl):
    """DiT-XS/2 with block_kernel="pallas" against the reference golden, as
    tests/test_pallas.py holds the JAX model."""
    g = golden("dit_xs2")
    sd = {k[len("sd."):]: torch.from_numpy(v) for k, v in g.items() if k.startswith("sd.")}
    model = DiT(build_config("DiT-XS/2", block_kernel="pallas", attention_impl=attention_impl, **XS2)).eval()
    model.load_state_dict(sd)
    with torch.no_grad():
        out = model(torch.from_numpy(g["x"]), torch.from_numpy(g["t"]), torch.from_numpy(g["y"]))
    np.testing.assert_allclose(out.numpy(), g["out"], rtol=2e-4, atol=2e-4)


def test_new_kernel_counts_stay_zero_on_cpu():
    for mod in (attn_k, mlp_block, dit_block):
        mod.reset_launch_counts()
    cfg = build_config("DiT-XS/2", block_kernel="pallas", attention_impl="pallas", **XS2)
    model = DiT(cfg)
    model.reset_parameters(torch.Generator().manual_seed(0))
    out = model(torch.zeros(2, 4, 16, 16), torch.tensor([3.0, 7.0]), torch.tensor([1, 2]))
    out.square().sum().backward()
    assert torch.isfinite(out).all()
    for mod in (attn_k, mlp_block, dit_block):
        assert all(v == 0 for v in mod.LAUNCHES.values()), mod.LAUNCHES
