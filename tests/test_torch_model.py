"""The port's DiT against the reference golden (DiT-XS/2 state dict loaded as
it is) and against JAX ``DiT.apply`` on the same weights, carried across by
``state_dict_from_jax``, on the plain, per-block kernel and block-stack
paths. Tolerance 2e-4, as tests/test_model.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mapdit_tpu.models import DiT as JaxDiT
from mapdit_tpu.models import build_config as jax_build_config
from mapdit_tpu.models import init_model as jax_init_model
from mapdit_tpu.runtime import build_block_stack as jax_build_block_stack
from mapdit_tpu.runtime import fold_weights_for_inference as jax_fold
from mapdit_tpu_torch.models import DiT, build_config
from mapdit_tpu_torch.runtime import build_block_stack, fold_weights_for_inference
from mapdit_tpu_torch.utils.weights import state_dict_from_jax

XS2 = dict(in_channels=4, input_size=16, num_classes=10)
TOL = dict(rtol=2e-4, atol=2e-4)


def _model(cfg, sd):
    model = DiT(cfg).eval()
    model.load_state_dict(sd)
    return model


@pytest.fixture(scope="module")
def golden_xs2(golden):
    g = golden("dit_xs2")
    sd = {k[len("sd."):]: torch.from_numpy(v) for k, v in g.items() if k.startswith("sd.")}
    return g, sd


@pytest.mark.parametrize("block_kernel", ["off", "mega"])
def test_forward_matches_golden(golden_xs2, block_kernel):
    g, sd = golden_xs2
    model = _model(build_config("DiT-XS/2", block_kernel=block_kernel, **XS2), sd)
    with torch.no_grad():
        out = model(torch.from_numpy(g["x"]), torch.from_numpy(g["t"]), torch.from_numpy(g["y"]))
    np.testing.assert_allclose(out.numpy(), g["out"], **TOL)


def test_forward_with_cfg_matches_golden(golden_xs2):
    g, sd = golden_xs2
    model = _model(build_config("DiT-XS/2", **XS2), sd)
    with torch.no_grad():
        out = model.forward_with_cfg(
            torch.from_numpy(g["x_cfg"]), torch.from_numpy(g["t_cfg"]), torch.from_numpy(g["y_cfg"]), 4.0
        )
    np.testing.assert_allclose(out.numpy(), g["out_cfg"], **TOL)


@pytest.fixture(scope="module")
def jax_weights():
    """JAX init weights with the block gains drawn away from their zero init,
    so the modulate and residual mixing is exercised."""
    cfg = jax_build_config("DiT-XS/2", **XS2)
    _, variables = jax_init_model(cfg, seed=3)
    rng = np.random.default_rng(3)
    params = dict(variables["params"])
    for i in range(cfg.depth):
        blk = dict(params[f"blocks_{i}"])
        blk["gain_msa"], blk["gain_mlp"] = (jnp.asarray(v, jnp.float32) for v in rng.uniform(0.1, 0.9, 2))
        params[f"blocks_{i}"] = blk
    variables = dict(variables, params=params)
    rng = np.random.default_rng(4)
    x = rng.normal(size=(4, 4, 16, 16)).astype(np.float32)
    t = np.array([3.0, 250.0, 500.0, 999.0], np.float32)
    y = np.array([1, 2, 10, 10], np.int32)
    return cfg, variables, (x, t, y)


def _torch_inputs(inputs):
    x, t, y = inputs
    return torch.from_numpy(x), torch.from_numpy(t), torch.from_numpy(y.astype(np.int64))


@pytest.mark.parametrize("block_kernel", ["off", "mega"])
def test_apply_matches_jax(jax_weights, block_kernel):
    jcfg, variables, inputs = jax_weights
    jcfg = jcfg.replace(block_kernel=block_kernel)
    want = np.asarray(JaxDiT(jcfg).apply(variables, *[jnp.asarray(v) for v in inputs]))
    cfg = build_config("DiT-XS/2", block_kernel=block_kernel, **XS2)
    with torch.no_grad():
        got = _model(cfg, state_dict_from_jax(variables, cfg))(*_torch_inputs(inputs))
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_block_stack_matches_jax(jax_weights):
    jcfg, variables, inputs = jax_weights
    jcfg = jcfg.replace(fold_weights=True, block_kernel="mega_stack")
    jv = dict(variables, params=jax_fold(variables["params"], jcfg))
    want = np.asarray(
        JaxDiT(jcfg).apply(jv, *[jnp.asarray(v) for v in inputs], block_stack=jax_build_block_stack(jv["params"], jcfg))
    )
    cfg = build_config("DiT-XS/2", fold_weights=True, block_kernel="mega_stack", **XS2)
    sd = fold_weights_for_inference(state_dict_from_jax(variables, cfg), cfg)
    with torch.no_grad():
        got = _model(cfg, sd)(*_torch_inputs(inputs), block_stack=build_block_stack(sd, cfg))
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_state_dict_from_jax_names_match_golden(golden_xs2, jax_weights):
    """The JAX tree maps onto exactly the reference's state-dict keys."""
    _, sd = golden_xs2
    _, variables, _ = jax_weights
    ported = state_dict_from_jax(variables, build_config("DiT-XS/2", **XS2))
    assert set(ported) == set(sd)
    assert all(ported[k].shape == sd[k].shape for k in sd)
