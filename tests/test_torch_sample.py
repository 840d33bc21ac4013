"""The port's sampling chains: the reference's 10-step CFG chain golden, and
``build_sample_fn`` against the JAX ``build_sample_fn`` on the same weights.
Both packages draw step noise from different generators, so the chains run
on injected noise ``cos(flat_index * 0.01 + t)`` (the golden's formula)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mapdit_tpu.diffusion import create_diffusion as jax_create_diffusion
from mapdit_tpu.diffusion.gaussian import GaussianDiffusion as JaxGaussianDiffusion
from mapdit_tpu.models import build_config as jax_build_config
from mapdit_tpu.models import init_model as jax_init_model
from mapdit_tpu.runtime import build_sample_fn as jax_build_sample_fn
from mapdit_tpu_torch.diffusion import create_diffusion
from mapdit_tpu_torch.models import DiT, build_config
from mapdit_tpu_torch.runtime import build_sample_fn, fold_weights_for_inference
from mapdit_tpu_torch.utils.weights import state_dict_from_jax

XS2 = dict(in_channels=4, input_size=16, num_classes=10)


def det_noise(t, shape):
    idx = torch.arange(int(np.prod(shape)), dtype=torch.float32).reshape(shape)
    return torch.cos(idx * 0.01 + t[0].float())


def jax_det_noise(t, shape):
    idx = jnp.arange(np.prod(shape), dtype=jnp.float32).reshape(shape)
    return jnp.cos(idx * 0.01 + t[0].astype(jnp.float32))


@pytest.mark.parametrize("fold", [False, True])
def test_cfg_chain_matches_reference_golden(golden, fold):
    """p_sample_loop over forward_with_cfg, bounds of tests/test_model.py."""
    g = golden("dit_xs2")
    ge = golden("e2e_sample")
    cfg = build_config("DiT-XS/2", fold_weights=fold, **XS2)
    sd = {k[len("sd."):]: torch.from_numpy(v) for k, v in g.items() if k.startswith("sd.")}
    if fold:
        sd = fold_weights_for_inference(sd, cfg)
    model = DiT(cfg).eval()
    model.load_state_dict(sd)
    scale = float(ge["cfg_scale"])
    with torch.no_grad():
        out = create_diffusion("10", device="cpu").p_sample_loop(
            lambda x, t, y: model.forward_with_cfg(x, t, y, scale),
            torch.from_numpy(ge["z_cfg"]),
            clip_denoised=True,
            model_kwargs={"y": torch.from_numpy(ge["y_cfg"])},
            noise_fn=det_noise,
        ).numpy()
    err = np.abs(out - ge["final"])
    assert err.max() < 2e-2, err.max()
    assert err.mean() < 1e-4, err.mean()
    assert (err < 2e-3).mean() > 0.99, (err >= 2e-3).sum()


@pytest.mark.parametrize("block_kernel", ["off", "mega_stack"])
def test_build_sample_fn_matches_jax(monkeypatch, block_kernel):
    """The half-CFG fast chain, 8 steps at DiT-XS/2, at the 2e-3 bound of
    tests/test_pallas.py's runtime chain parity."""
    jcfg = jax_build_config("DiT-XS/2", block_kernel=block_kernel, **XS2)
    _, variables = jax_init_model(jcfg, seed=3)
    rng = np.random.default_rng(7)
    noise = rng.normal(size=(4, 4, 16, 16)).astype(np.float32)
    y = np.array([1, 2, 10, 10], np.int32)

    # the JAX runtime takes no noise hook: feed it through the chain it calls
    monkeypatch.setattr(
        JaxGaussianDiffusion,
        "p_sample_loop_fast",
        functools.partialmethod(JaxGaussianDiffusion.p_sample_loop_fast, noise_fn=jax_det_noise),
    )
    # eager: under jit XLA reassociates the chain's sums, and through 8
    # steps, CFG 4 and the x0 clip that alone moves a few elements by ~5e-3
    # (the port matches the eager chain to ~4e-5)
    with jax.disable_jit():
        want = np.asarray(
            jax_build_sample_fn(jcfg, variables, jax_create_diffusion("8"), cfg_scale=4.0, clip_denoised=True)(
                jnp.asarray(noise), jnp.asarray(y), jax.random.PRNGKey(0)
            )
        )

    cfg = build_config("DiT-XS/2", block_kernel=block_kernel, **XS2)
    sample = build_sample_fn(
        cfg, state_dict_from_jax(variables, cfg), create_diffusion("8", device="cpu"), cfg_scale=4.0,
        clip_denoised=True, noise_fn=det_noise, device="cpu",
    )
    assert sample.run_cfg.block_kernel == block_kernel
    got = sample(torch.from_numpy(noise), torch.from_numpy(y.astype(np.int64))).numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=2e-3, atol=2e-3)


def test_auto_stays_plain_off_cuda():
    """``auto`` takes the kernels only on a CUDA device: on the CPU, with or
    without a batch hint, the chain runs the plain path."""
    cfg = build_config("DiT-XS/2", block_kernel="auto", compute_dtype="bfloat16", **XS2)
    model = DiT(cfg)
    model.reset_parameters(torch.Generator().manual_seed(0))
    sample = build_sample_fn(cfg, model.state_dict(), create_diffusion("2", device="cpu"), cfg_scale=1.5,
                             batch_hint=2, device="cpu")
    assert sample.run_cfg.block_kernel == "auto"
