"""The port's MP primitives, patchify and positional table against the
reference goldens and the JAX functions (1e-6: the same f32 arithmetic)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mapdit_tpu.ops import mp as jmp
from mapdit_tpu.ops import patch as jpatch
from mapdit_tpu.ops.pos_embed import get_2d_sincos_pos_embed as jax_pos_embed
from mapdit_tpu_torch.ops import mp
from mapdit_tpu_torch.ops.patch import patchify, unpatchify
from mapdit_tpu_torch.ops.pos_embed import get_2d_sincos_pos_embed

TOL = dict(rtol=1e-6, atol=1e-6)


def _t(a):
    return torch.from_numpy(np.asarray(a))


@pytest.fixture(scope="module")
def g(golden):
    return golden("mp_ops")


@pytest.mark.parametrize(
    "name, port, ref, key",
    [
        ("mp_sum_03", lambda g: mp.mp_sum(_t(g["x"]), _t(g["a"]), 0.3), lambda g: jmp.mp_sum(g["x"], g["a"], 0.3), "mp_sum_03"),
        ("mp_sum_05", lambda g: mp.mp_sum(_t(g["x"]), _t(g["a"]), 0.5), lambda g: jmp.mp_sum(g["x"], g["a"], 0.5), "mp_sum_05"),
        (
            "mp_sum_tensor_t",
            lambda g: mp.mp_sum(_t(g["x"]), _t(g["a"]), _t(g["tensor_t"])),
            lambda g: jmp.mp_sum(g["x"], g["a"], jnp.asarray(g["tensor_t"])),
            "mp_sum_tensor_t",
        ),
        (
            "modulate_0",
            lambda g: mp.modulate(_t(g["x"]), _t(g["shift"]), _t(g["scale"]), 0.0),
            lambda g: jmp.modulate(g["x"], g["shift"], g["scale"], 0.0),
            "modulate_0",
        ),
        (
            "modulate_tensor",
            lambda g: mp.modulate(_t(g["x"]), _t(g["shift"]), _t(g["scale"]), _t(g["tensor_t"])),
            lambda g: jmp.modulate(g["x"], g["shift"], g["scale"], jnp.asarray(g["tensor_t"])),
            "modulate_tensor",
        ),
        ("normalize_x", lambda g: mp.normalize(_t(g["x"])), lambda g: jmp.normalize(g["x"]), "normalize_x"),
        ("normalize_w", lambda g: mp.normalize(_t(g["w"])), lambda g: jmp.normalize(g["w"]), "normalize_w"),
        ("patchify_p2", lambda g: patchify(_t(g["img"]), 2), lambda g: jpatch.patchify(g["img"], 2), "patchify_p2"),
        ("patchify_p4", lambda g: patchify(_t(g["img"]), 4), lambda g: jpatch.patchify(g["img"], 4), "patchify_p4"),
    ],
)
def test_matches_golden_and_jax(g, name, port, ref, key):
    got = port(g).numpy()
    np.testing.assert_allclose(got, g[key], **TOL, err_msg=f"{name} vs golden")
    np.testing.assert_allclose(got, np.asarray(ref(g)), **TOL, err_msg=f"{name} vs JAX")


def test_mp_silu_matches_jax():
    x = np.random.default_rng(0).normal(size=(5, 33)).astype(np.float32) * 3
    np.testing.assert_allclose(mp.mp_silu(_t(x)).numpy(), np.asarray(jmp.mp_silu(x)), **TOL)


def test_mp_sum_detaches_tensor_denominator():
    """Gradient reaches a tensor t only through the lerp numerator."""
    a, b = torch.tensor([1.0, 2.0]), torch.tensor([3.0, -1.0])
    t = torch.tensor(0.3, requires_grad=True)
    mp.mp_sum(a, b, t).sum().backward()
    denom = float(np.sqrt(0.7**2 + 0.3**2))
    np.testing.assert_allclose(t.grad.item(), float((b - a).sum()) / denom, rtol=1e-6)


@pytest.mark.parametrize("dim, grid, key", [(256, 8, "table_256_8"), (384, 8, "table_384_8"), (64, 4, "table_64_4")])
def test_pos_embed_table(golden, dim, grid, key):
    table = get_2d_sincos_pos_embed(dim, grid)
    np.testing.assert_allclose(table, golden("pos_embed")[key], rtol=1e-12, atol=1e-12)
    np.testing.assert_array_equal(table, jax_pos_embed(dim, grid))


@pytest.mark.parametrize("p, size", [(2, 16), (4, 16), (8, 32)])
def test_patchify_round_trip(p, size):
    img = torch.from_numpy(np.random.default_rng(p).normal(size=(2, 4, size, size)).astype(np.float32))
    tokens = patchify(img, p)
    assert tokens.shape == (2, (size // p) ** 2, p * p * 4)
    torch.testing.assert_close(unpatchify(tokens, size, p), img, rtol=0, atol=0)
