"""The port's sampling runtime against the JAX package's at DiT-XS/2 on the
same weights: ``build_sample_fn`` for every sampler, limited-interval
guidance, dynamic thresholding and block-span caching (the cases of
tests/test_cfg_interval.py, tests/test_dynamic_threshold.py and
tests/test_runtime_cache.py). Every JAX chain runs eagerly; its step noise
is reproduced by splitting its key as the chains do and fed to the port's
``noise_fn``. The port lands within 8e-5 of the eager JAX chains at CFG 4
with the x0 clip; the bound is 2e-4."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mapdit_tpu.diffusion import create_diffusion as jax_create_diffusion
from mapdit_tpu.models import build_config as jax_build_config
from mapdit_tpu.models import init_model as jax_init_model
from mapdit_tpu.runtime import build_cached_sample_fn as jax_build_cached_sample_fn
from mapdit_tpu.runtime import build_sample_fn as jax_build_sample_fn
from mapdit_tpu.runtime import cfg_interval_segments as jax_cfg_interval_segments
from mapdit_tpu_torch.diffusion import create_diffusion
from mapdit_tpu_torch.models import build_config
from mapdit_tpu_torch.models.dit import DiT
from mapdit_tpu_torch.runtime import (
    build_block_stack, build_cached_sample_fn, build_sample_fn, cfg_interval_segments, fold_weights_for_inference,
)
from mapdit_tpu_torch.utils.weights import state_dict_from_jax

XS2 = dict(in_channels=4, input_size=16, num_classes=10)
TOL = dict(rtol=1e-4, atol=2e-4)
N = 2


@pytest.fixture(scope="module")
def xs2():
    jcfg = jax_build_config("DiT-XS/2", **XS2)
    _, variables = jax_init_model(jcfg, seed=3)
    cfg = build_config("DiT-XS/2", **XS2)
    rng = np.random.default_rng(7)
    z = rng.normal(size=(N, 4, 16, 16)).astype(np.float32)
    return jcfg, variables, cfg, state_dict_from_jax(variables, cfg), np.concatenate([z, z]), np.array([1, 2, 10, 10])


def jax_noise(key, steps, shape):
    """The port's noise_fn serving the step noise a JAX chain draws on
    ``key`` (split once a step)."""
    draws = []
    for _ in range(steps):
        key, step_key = jax.random.split(key)
        draws.append(np.array(jax.random.normal(step_key, shape, jnp.float32)))
    return lambda t, shape: torch.from_numpy(draws[steps - 1 - int(t[0])])


def run_both(xs2, spacing, cfg_scale=4.0, build=(jax_build_sample_fn, build_sample_fn), **kw):
    """(JAX eager chain, port chain) on the same weights, noise and draws."""
    jcfg, variables, cfg, sd, z, y = xs2
    if cfg_scale is None:
        z, y = z[:N], y[:N]
    key = jax.random.PRNGKey(0)
    with jax.disable_jit():
        want = np.asarray(build[0](jcfg, variables, jax_create_diffusion(spacing), cfg_scale=cfg_scale, **kw)(
            jnp.asarray(z), jnp.asarray(y), key))
    d = create_diffusion(spacing, device="cpu")
    fn = build[1](cfg, sd, d, cfg_scale=cfg_scale, device="cpu",
                  noise_fn=jax_noise(key, d.num_timesteps, (N, *z.shape[1:])), **kw)
    got = fn(torch.from_numpy(z), torch.from_numpy(y)).numpy()
    assert np.isfinite(got).all()
    return want, got


@pytest.mark.parametrize("sampler, eta, spacing", [
    ("ddpm", 0.0, "6"), ("ddim", 0.0, "ddim6"), ("ddim", 1.0, "ddim6"), ("dpm++", 0.0, "6"), ("dpm++", 0.0, "karras6"),
    ("unipc", 0.0, "6"), ("unipc", 0.0, "karras6"),
])
def test_build_sample_fn_matches_jax(xs2, sampler, eta, spacing):
    want, got = run_both(xs2, spacing, sampler=sampler, eta=eta, clip_denoised=True)
    np.testing.assert_allclose(got, want, **TOL)


def test_unguided_chain_matches_jax(xs2):
    want, got = run_both(xs2, "ddim6", cfg_scale=None, sampler="ddim", clip_denoised=True)
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("spacing", ["8", "20", "10,10", "karras16", "250"])
def test_cfg_interval_segments_match_jax(spacing):
    d, jd = create_diffusion(spacing, device="cpu"), jax_create_diffusion(spacing)
    for lo, hi in [(0.3, 3.0), (0.0, 1e9), (1e6, 1e7), (0.05, 0.5), (2.0, 40.0)]:
        assert cfg_interval_segments(d, lo, hi) == jax_cfg_interval_segments(jd, lo, hi), (lo, hi)


@pytest.mark.parametrize("sampler", ["ddpm", "dpm++", "unipc"])
def test_cfg_interval_matches_jax(xs2, sampler):
    """A middle interval: cond-only, guided, cond-only segments stitched."""
    spacing = "10"
    g0, g1 = cfg_interval_segments(create_diffusion(spacing, device="cpu"), 0.3, 3.0)
    assert 0 < g0 < g1 < 10
    want, got = run_both(xs2, spacing, sampler=sampler, cfg_interval=(0.3, 3.0), clip_denoised=True)
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("sampler", ["ddpm", "dpm++", "unipc"])
def test_cfg_interval_limits(xs2, sampler):
    """The full interval is the CFG chain and the empty one the cond-only
    chain, bit for bit (the generator or the history carried through the
    empty segments)."""
    _, _, cfg, sd, z, y = xs2
    d = create_diffusion("8", device="cpu")
    z, y = torch.from_numpy(z), torch.from_numpy(y)

    def chain(cfg_scale, zz, yy, **kw):
        fn = build_sample_fn(cfg, sd, d, cfg_scale=cfg_scale, sampler=sampler, clip_denoised=True, device="cpu", **kw)
        return fn(zz, yy, torch.Generator().manual_seed(5))

    full = chain(4.0, z, y, cfg_interval=(0.0, 1e9))
    assert torch.equal(full, chain(4.0, z, y))
    empty = chain(4.0, z, y, cfg_interval=(1e6, 1e7))
    cond = chain(None, z[:N], y[:N])
    assert torch.equal(empty[:N], cond) and torch.equal(empty[N:], cond)
    assert not torch.equal(full, empty)


def test_cfg_interval_refusals(xs2):
    _, _, cfg, sd, _, _ = xs2
    d = create_diffusion("4", device="cpu")
    with pytest.raises(ValueError, match="needs CFG"):
        build_sample_fn(cfg, sd, d, cfg_interval=(0.3, 3.0), device="cpu")
    with pytest.raises(ValueError, match="ddpm, dpm\\+\\+ or unipc"):
        build_sample_fn(cfg, sd, d, cfg_scale=4.0, sampler="ddim", cfg_interval=(0.3, 3.0), device="cpu")
    with pytest.raises(NotImplementedError, match="Beyond-reference samplers"):
        build_sample_fn(cfg, sd, d, sampler="heun", device="cpu")


@pytest.fixture(scope="module")
def trained(golden):
    """The 200-step trained DiT-XS/4 of trained_reference.npz in both
    packages, with its CFG batch. Without the hard clip its chains still
    grow (to a few hundred at CFG 1.5), but stay finite where random
    weights overflow."""
    from mapdit_tpu.utils.torch_import import variables_from_torch_state_dict

    g = golden("trained_reference")
    arrays = {k[len("sd."):]: np.array(v) for k, v in g.items() if k.startswith("sd.")}
    sd = {k: torch.from_numpy(v) for k, v in arrays.items()}
    return (jax_build_config("DiT-XS/4", **XS2), variables_from_torch_state_dict(arrays), build_config("DiT-XS/4", **XS2),
            sd, g["z_cfg"], g["y_cfg"].astype(np.int64))


@pytest.mark.parametrize("sampler", ["dpm++", "unipc"])
@pytest.mark.parametrize("percentile", [0.9, 0.995])
def test_dynamic_threshold_matches_jax(trained, sampler, percentile):
    """The per-sample quantile clip inside the chain, no hard clip, at the
    trained weights; the chains reach a few hundred, so the bound is 2e-6
    of the largest element (the port reads under 1e-6 of it)."""
    want, got = run_both(trained, "6", cfg_scale=1.5, sampler=sampler, dynamic_threshold=percentile)
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-6 * np.abs(want).max())


@pytest.mark.parametrize("sampler", ["dpm++", "unipc"])
def test_dynamic_threshold_one_is_exact(trained, sampler):
    """At percentile 1 the threshold is each sample's max |x0| (floored at
    1): the chain is the unthresholded one, bit for bit."""
    _, _, cfg, sd, z, y = trained
    d = create_diffusion("6", device="cpu")
    outs = [build_sample_fn(cfg, sd, d, cfg_scale=1.5, sampler=sampler, dynamic_threshold=p, device="cpu")(
        torch.from_numpy(z), torch.from_numpy(y)) for p in (None, 1.0)]
    assert torch.isfinite(outs[0]).all() and torch.equal(*outs)


@pytest.mark.parametrize("sampler", ["ddpm", "dpm++"])
@pytest.mark.parametrize("mode", ["hold", "forecast"])
def test_cached_chain_matches_jax(xs2, sampler, mode):
    want, got = run_both(xs2, "8", build=(jax_build_cached_sample_fn, build_cached_sample_fn), sampler=sampler,
                         cache_mode=mode, cache_interval=2, clip_denoised=True)
    np.testing.assert_allclose(got, want, **TOL)


def test_cached_chain_with_cfg_interval_matches_jax(xs2):
    """Guidance snapped outward to whole cache groups, three group runs."""
    spacing = "16"  # groups [0, 4) unguided, [4, 7) guided, [7, 8) unguided
    want, got = run_both(xs2, spacing, build=(jax_build_cached_sample_fn, build_cached_sample_fn), sampler="ddpm",
                         cache_interval=2, cfg_interval=(0.3, 3.0), clip_denoised=True)
    np.testing.assert_allclose(got, want, **TOL)


def test_cached_chain_unguided_matches_jax(xs2):
    want, got = run_both(xs2, "8", cfg_scale=None, build=(jax_build_cached_sample_fn, build_cached_sample_fn),
                         sampler="dpm++", cache_interval=4, span=(1, 5), cache_mode="hold", clip_denoised=True)
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("sampler", ["ddpm", "dpm++"])
def test_cached_exact_limits(xs2, sampler):
    """An empty span or an interval of 1 is the exact chain, bit for bit."""
    _, _, cfg, sd, z, y = xs2
    d = create_diffusion("8", device="cpu")
    z, y = torch.from_numpy(z), torch.from_numpy(y)
    exact = build_sample_fn(cfg, sd, d, cfg_scale=4.0, sampler=sampler, clip_denoised=True, device="cpu")(
        z, y, torch.Generator().manual_seed(2))
    for kw in (dict(span=(2, 2), cache_interval=2), dict(cache_interval=1)):
        fn = build_cached_sample_fn(cfg, sd, d, cfg_scale=4.0, sampler=sampler, clip_denoised=True, device="cpu", **kw)
        assert torch.equal(fn(z, y, torch.Generator().manual_seed(2)), exact), kw
    lossy = build_cached_sample_fn(cfg, sd, d, cfg_scale=4.0, sampler=sampler, clip_denoised=True, device="cpu")
    assert not torch.equal(lossy(z, y, torch.Generator().manual_seed(2)), exact)


def test_cached_refusals(xs2):
    _, _, cfg, sd, z, y = xs2
    d = create_diffusion("8", device="cpu")
    cases = [
        (dict(sampler="unipc"), "ddpm or dpm\\+\\+"),
        (dict(cache_interval=3), "must divide"),
        (dict(cache_mode="linear"), "cache_mode"),
        (dict(cfg_interval=(0.3, 3.0), cfg_scale=None), "needs CFG"),
    ]
    for kw, match in cases:
        with pytest.raises(ValueError, match=match):
            build_cached_sample_fn(cfg, sd, d, device="cpu", **{"cfg_scale": 4.0, **kw})
    with pytest.raises(ValueError, match="whole-stack kernel"):
        build_cached_sample_fn(cfg.replace(block_kernel="mega_stack"), sd, d, cfg_scale=4.0, device="cpu")
    # the model refuses a span on the whole-stack path
    folded = cfg.replace(fold_weights=True)
    fsd = fold_weights_for_inference(sd, folded)
    model = DiT(folded).eval()
    model.load_state_dict(fsd)
    with pytest.raises(ValueError, match="mega_stack"):
        model(torch.from_numpy(z[:N]), torch.ones(N), torch.from_numpy(y[:N]), block_stack=build_block_stack(fsd, folded),
              span=(1, 2))


def test_span_protocol_matches_jax(xs2):
    """forward_with_cfg with span=(1, 3): the returned delta, and the
    forward that replays it, against the JAX model's."""
    from mapdit_tpu.models.dit import DiT as JaxDiT

    jcfg, variables, cfg, sd, z, y = xs2
    t = np.array([500.0, 20.0, 500.0, 20.0], np.float32)
    want, jdelta = JaxDiT(jcfg).apply(variables, jnp.asarray(z), jnp.asarray(t), jnp.asarray(y), 4.0, span=(1, 3),
                                      return_delta=True, method=JaxDiT.forward_with_cfg)
    model = DiT(cfg).eval()
    model.load_state_dict(sd)
    with torch.no_grad():
        got, delta = model.forward_with_cfg(torch.from_numpy(z), torch.from_numpy(t), torch.from_numpy(y), 4.0,
                                            span=(1, 3), return_delta=True)
        replay = model.forward_with_cfg(torch.from_numpy(z), torch.from_numpy(t), torch.from_numpy(y), 4.0,
                                        span=(1, 3), cached_delta=delta)
    np.testing.assert_allclose(delta.numpy(), np.asarray(jdelta), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-5)
    # the replayed stream is x + delta, the computed one x after the blocks:
    # equal up to the rounding of delta
    np.testing.assert_allclose(replay.numpy(), got.numpy(), rtol=1e-5, atol=1e-5)
