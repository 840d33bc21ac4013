"""The port's diffusion samplers against the JAX package: the DDIM steps and
chain, the progressive chain, the q and guidance helpers, the VLB, the ODE
samplers (DPM-Solver++(2M), UniPC) whole and stitched from segments, dynamic
thresholding, and the reference goldens no other port test reads: the
diffusion process (diffusion.npz, sampler_chains.npz), the trained model's
forward and DDIM chain (trained_reference.npz) and the per-module
activations (dit_xs2_modules.npz).

JAX draws its step noise from a key it splits once a step; the tests split
the same key the same way, draw the same normals, and feed them to the
port's ``noise_fn``. Every JAX chain runs eagerly (under jit XLA reassociates
the chain's sums)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mapdit_tpu.diffusion import create_diffusion as jax_create_diffusion
from mapdit_tpu.diffusion.dpm_solver import dpm_solver_pp_coefficients as jax_dpm_coefficients
from mapdit_tpu.diffusion.dpm_solver import dpm_solver_pp_loop as jax_dpm_loop
from mapdit_tpu.diffusion.gaussian import dynamic_threshold_fn as jax_dynamic_threshold_fn
from mapdit_tpu.diffusion.unipc import unipc_coefficients as jax_unipc_coefficients
from mapdit_tpu.diffusion.unipc import unipc_loop as jax_unipc_loop
from mapdit_tpu.models import build_config as jax_build_config
from mapdit_tpu.models import init_model as jax_init_model
from mapdit_tpu.runtime import build_model_fn as jax_build_model_fn
from mapdit_tpu_torch.diffusion import create_diffusion
from mapdit_tpu_torch.diffusion.dpm_solver import dpm_solver_pp_coefficients, dpm_solver_pp_loop
from mapdit_tpu_torch.diffusion.gaussian import dynamic_threshold_fn
from mapdit_tpu_torch.diffusion.unipc import unipc_coefficients, unipc_loop
from mapdit_tpu_torch.models import build_config
from mapdit_tpu_torch.runtime import build_model_fn
from mapdit_tpu_torch.utils.weights import state_dict_from_jax

XS2 = dict(in_channels=4, input_size=16, num_classes=10)
TABLES = ["betas", "alphas_cumprod", "alphas_cumprod_prev", "sqrt_alphas_cumprod", "sqrt_one_minus_alphas_cumprod",
          "sqrt_recip_alphas_cumprod", "sqrt_recipm1_alphas_cumprod", "posterior_variance",
          "posterior_log_variance_clipped", "posterior_mean_coef1", "posterior_mean_coef2"]


def toy_jax(x, t, **kw):
    return jnp.concatenate([0.1 * x, jnp.tanh(x)], axis=1)


def toy(x, t, **kw):
    return torch.cat([0.1 * x, torch.tanh(x)], dim=1)


def jax_draws(key, steps, shape):
    """The step noise of a JAX chain on ``key``, in chain order."""
    out = []
    for _ in range(steps):
        key, step_key = jax.random.split(key)
        out.append(np.asarray(jax.random.normal(step_key, shape, jnp.float32)))
    return out


def noise_from(draws, steps):
    """The port's noise_fn(t, shape) serving ``draws`` (chain order)."""
    return lambda t, shape: torch.from_numpy(draws[steps - 1 - int(t[0])].copy())


def t32(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


@pytest.fixture(scope="module")
def xs2():
    """DiT-XS/2 at random weights in both packages, a CFG batch, labels."""
    jcfg = jax_build_config("DiT-XS/2", **XS2)
    _, variables = jax_init_model(jcfg, seed=3)
    cfg = build_config("DiT-XS/2", **XS2)
    rng = np.random.default_rng(7)
    z = rng.normal(size=(2, 4, 16, 16)).astype(np.float32)
    return jcfg, variables, cfg, state_dict_from_jax(variables, cfg), np.concatenate([z, z]), np.array([1, 2, 10, 10])


@pytest.mark.parametrize("name", TABLES + ["alphas_cumprod_next"])
def test_tables_match_golden(golden, name):
    """The full 1000-step process against the reference's tables (the next
    cumulative alphas, which the golden lacks, against the JAX package)."""
    d = create_diffusion("", device="cpu")
    want = np.asarray(getattr(jax_create_diffusion(""), name)) if name == "alphas_cumprod_next" else (
        golden("diffusion")[name].astype(np.float32))
    np.testing.assert_allclose(getattr(d, name).numpy(), want, rtol=2e-5)


@pytest.mark.parametrize("spacing", ["250", "ddim25"])
def test_respaced_tables_match_golden(golden, spacing):
    g = golden("diffusion")
    d = create_diffusion(spacing, device="cpu")
    np.testing.assert_allclose(d.betas.numpy(), g[f"betas_{spacing}"], rtol=2e-5)
    np.testing.assert_array_equal(d.timestep_map.numpy(), g[f"timestep_map_{spacing}"])


def test_process_goldens(golden):
    """q_sample, p_mean_variance (clipped and not, full and respaced) and the
    training losses on the golden's model output."""
    g = golden("diffusion")
    d, d250 = create_diffusion("", device="cpu"), create_diffusion("250", device="cpu")
    t = torch.from_numpy(g["t"].astype(np.int64))
    xt = d.q_sample(t32(g["x0"]), t, t32(g["noise"]))
    np.testing.assert_allclose(xt.numpy(), g["xt"], rtol=2e-5, atol=1e-5)
    model_fn = lambda x, t, **kw: t32(g["model_out"])  # noqa: E731
    out = d.p_mean_variance(model_fn, t32(g["xt"]), t, clip_denoised=False)
    for key, name, atol in (("mean", "pmv_mean", 1e-5), ("variance", "pmv_var", 1e-6),
                            ("log_variance", "pmv_logvar", 1e-5), ("pred_xstart", "pmv_xstart", 1e-4)):
        np.testing.assert_allclose(out[key].numpy(), g[name], rtol=1e-4, atol=atol)
    out = d.p_mean_variance(model_fn, t32(g["xt"]), t, clip_denoised=True)
    np.testing.assert_allclose(out["mean"].numpy(), g["pmv_clip_mean"], rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(out["pred_xstart"].numpy(), g["pmv_clip_xstart"], rtol=1e-4, atol=1e-5)
    out = d250.p_mean_variance(model_fn, t32(g["xt"]), torch.from_numpy(g["t_sub"].astype(np.int64)),
                               clip_denoised=False)
    np.testing.assert_allclose(out["mean"].numpy(), g["pmv250_mean"], rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(out["log_variance"].numpy(), g["pmv250_logvar"], rtol=1e-4, atol=1e-5)
    terms = d.training_losses(model_fn, t32(g["x0"]), t, noise=t32(g["noise"]))
    np.testing.assert_allclose(terms["mse"].numpy(), g["loss_mse"], rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(terms["vb"].numpy(), g["loss_vb"], rtol=1e-3, atol=1e-4)
    np.testing.assert_allclose(terms["loss"].numpy(), g["loss"], rtol=1e-3, atol=1e-4)


@pytest.mark.parametrize("chain", ["ddpm", "ddim"])
def test_sampler_chain_golden(golden, chain):
    """The reference's 10-step chains on a fixed model: DDPM on the injected
    cos(index * 0.01 + t) noise, DDIM at eta 0 (bounds of
    tests/test_diffusion.py)."""
    g = golden("sampler_chains")
    start = t32(g["start"])
    if chain == "ddpm":
        def det(t, shape):
            idx = torch.arange(int(np.prod(shape)), dtype=torch.float32).reshape(shape)
            return torch.cos(idx * 0.01 + t[0].float())

        out = create_diffusion("10", device="cpu").p_sample_loop(toy, start, clip_denoised=True, noise_fn=det)
    else:
        out = create_diffusion("ddim10", device="cpu").ddim_sample_loop(toy, start, clip_denoised=True)
    np.testing.assert_allclose(out.numpy(), g[f"{chain}_final"], rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("eta", [0.0, 1.0])
def test_ddim_chain_matches_jax(xs2, eta):
    """The 8-step DDIM CFG chain at DiT-XS/2 against the eager JAX chain,
    max abs 1e-4 in f32; at eta 1 the port is fed JAX's draws."""
    jcfg, variables, cfg, sd, z, y = xs2
    key = jax.random.PRNGKey(11)
    with jax.disable_jit():
        want = np.asarray(jax_create_diffusion("ddim8").ddim_sample_loop(
            jax_build_model_fn(jcfg, variables, cfg_scale=4.0), jnp.asarray(z), key, clip_denoised=True,
            model_kwargs={"y": jnp.asarray(y)}, eta=eta))
    d = create_diffusion("ddim8", device="cpu")
    got = d.ddim_sample_loop(
        build_model_fn(cfg, sd, cfg_scale=4.0, device="cpu"), torch.from_numpy(z), clip_denoised=True,
        model_kwargs={"y": torch.from_numpy(y)}, eta=eta, noise_fn=noise_from(jax_draws(key, 8, z.shape), 8)).numpy()
    assert np.isfinite(got).all()
    assert np.abs(got - want).max() <= 1e-4


def test_ddim_reverse_and_progressive_match_jax():
    """ddim_reverse_sample, and p_sample_loop_progressive's stacked samples
    and x0 estimates on injected noise."""
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 4, 8, 8)).astype(np.float32)
    jd, d = jax_create_diffusion("10"), create_diffusion("10", device="cpu")
    want = jd.ddim_reverse_sample(toy_jax, jnp.asarray(x), jnp.array([3, 7]), clip_denoised=False)
    got = d.ddim_reverse_sample(toy, torch.from_numpy(x), torch.tensor([3, 7]), clip_denoised=False)
    for key in ("sample", "pred_xstart"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]), rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError, match="deterministic"):
        d.ddim_reverse_sample(toy, torch.from_numpy(x), torch.tensor([3, 7]), eta=0.5)

    key = jax.random.PRNGKey(5)
    with jax.disable_jit():
        want = jd.p_sample_loop_progressive(toy_jax, jnp.asarray(x), key, clip_denoised=True)
    got = d.p_sample_loop_progressive(toy, torch.from_numpy(x), clip_denoised=True,
                                      noise_fn=noise_from(jax_draws(key, 10, x.shape), 10))
    for key in ("sample", "pred_xstart"):
        assert got[key].shape == (10, 2, 4, 8, 8)
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]), rtol=1e-5, atol=1e-5)


def test_q_and_guidance_hooks_match_jax():
    """q_mean_variance, and condition_mean / condition_score with a linear
    cond_fn, alone and inside p_sample and ddim_sample."""
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 4, 8, 8)).astype(np.float32)
    jd, d = jax_create_diffusion("10"), create_diffusion("10", device="cpu")
    jt, t = jnp.array([3, 7]), torch.tensor([3, 7])
    for w, g in zip(jd.q_mean_variance(jnp.asarray(x), jt), d.q_mean_variance(torch.from_numpy(x), t)):
        np.testing.assert_allclose(np.broadcast_to(g.numpy(), x.shape), np.broadcast_to(np.asarray(w), x.shape),
                                   rtol=1e-6, atol=1e-7)

    jcond = lambda xx, tt, **kw: 0.3 * xx + 0.01 * tt[:, None, None, None]  # noqa: E731
    cond = lambda xx, tt, **kw: 0.3 * xx + 0.01 * tt[:, None, None, None]  # noqa: E731
    jout = jd.p_mean_variance(toy_jax, jnp.asarray(x), jt, clip_denoised=True)
    out = d.p_mean_variance(toy, torch.from_numpy(x), t, clip_denoised=True)
    np.testing.assert_allclose(d.condition_mean(cond, out, torch.from_numpy(x), t).numpy(),
                               np.asarray(jd.condition_mean(jcond, jout, jnp.asarray(x), jt)), rtol=1e-5, atol=1e-6)
    want, got = jd.condition_score(jcond, jout, jnp.asarray(x), jt), d.condition_score(cond, out, torch.from_numpy(x), t)
    for key in ("mean", "pred_xstart"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]), rtol=1e-5, atol=1e-5)

    key = jax.random.PRNGKey(2)
    noise = np.array(jax.random.normal(key, x.shape, jnp.float32))
    want = jd.p_sample(toy_jax, jnp.asarray(x), jt, key, cond_fn=jcond)
    got = d.p_sample(toy, torch.from_numpy(x), t, cond_fn=cond, noise_fn=lambda tt, shape: torch.from_numpy(noise))
    np.testing.assert_allclose(got["sample"].numpy(), np.asarray(want["sample"]), rtol=1e-5, atol=1e-5)
    want = jd.ddim_sample(toy_jax, jnp.asarray(x), jt, key, cond_fn=jcond)
    got = d.ddim_sample(toy, torch.from_numpy(x), t, cond_fn=cond)
    np.testing.assert_allclose(got["sample"].numpy(), np.asarray(want["sample"]), rtol=1e-5, atol=1e-5)


def test_vlb_matches_jax():
    """prior_bpd and calc_bpd_loop (each step's VB term, x0 and eps errors,
    the total) on JAX's draws."""
    rng = np.random.default_rng(2)
    x = np.clip(rng.normal(size=(2, 4, 8, 8)), -1, 1).astype(np.float32)
    jd, d = jax_create_diffusion("10"), create_diffusion("10", device="cpu")
    key = jax.random.PRNGKey(4)
    np.testing.assert_allclose(d.prior_bpd(torch.from_numpy(x)).numpy(), np.asarray(jd.prior_bpd(jnp.asarray(x))),
                               rtol=1e-5, atol=1e-7)
    with jax.disable_jit():
        want = jd.calc_bpd_loop(toy_jax, jnp.asarray(x), key, clip_denoised=True)
    got = d.calc_bpd_loop(toy, torch.from_numpy(x), clip_denoised=True,
                          noise_fn=noise_from(jax_draws(key, 10, x.shape), 10))
    for name in ("total_bpd", "prior_bpd", "vb", "xstart_mse", "mse"):
        assert got[name].shape == want[name].shape, name
        np.testing.assert_allclose(got[name].numpy(), np.asarray(want[name]), rtol=1e-4, atol=1e-5, err_msg=name)


@pytest.mark.parametrize("spacing", ["10", "karras8", "3", "1"])
def test_ode_coefficients_match_jax(spacing):
    acp = create_diffusion(spacing, device="cpu").alphas_cumprod.numpy()
    for got, want in zip(dpm_solver_pp_coefficients(acp), jax_dpm_coefficients(acp)):
        np.testing.assert_array_equal(got, want)
    got, want = unipc_coefficients(acp), jax_unipc_coefficients(acp)
    assert set(got) == set(want)
    for name in want:
        np.testing.assert_array_equal(got[name], want[name], err_msg=name)


@pytest.mark.parametrize("sampler", ["dpm++", "unipc"])
@pytest.mark.parametrize("spacing", ["10", "karras8"])
def test_ode_chain_matches_jax(sampler, spacing):
    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, 4, 8, 8)).astype(np.float32)
    jloop, loop = (jax_dpm_loop, dpm_solver_pp_loop) if sampler == "dpm++" else (jax_unipc_loop, unipc_loop)
    for clip in (True, False):
        with jax.disable_jit():
            want = np.asarray(jloop(jax_create_diffusion(spacing), toy_jax, jnp.asarray(x), clip_denoised=clip))
        got = loop(create_diffusion(spacing, device="cpu"), toy, torch.from_numpy(x), clip_denoised=clip).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("sampler", ["ddpm", "dpm++", "unipc"])
def test_segments_stitch_into_the_chain(xs2, sampler):
    """Segments [0, 3) and [3, T) with the same model equal the whole chain
    bit for bit: the carried generator, 2M history or UniPC 4-tuple crosses
    the boundary (tests/test_cfg_interval.py's cases); an empty segment
    passes the carry through."""
    _, _, cfg, sd, z, y = xs2
    model_fn = build_model_fn(cfg, sd, device="cpu")
    d = create_diffusion("8", device="cpu")
    x = torch.from_numpy(z[:2])
    kw = dict(clip_denoised=True, model_kwargs={"y": torch.from_numpy(y[:2])})
    if sampler == "ddpm":
        base = d.p_sample_loop_fast(model_fn, x, torch.Generator().manual_seed(0), **kw)
        gen = torch.Generator().manual_seed(0)
        x1, carry = d.p_sample_loop_fast(model_fn, x, gen, step_slice=(0, 3), return_carry=True, **kw)
        x1, carry = d.p_sample_loop_fast(model_fn, x1, carry, step_slice=(3, 3), return_carry=True, **kw)
        out = d.p_sample_loop_fast(model_fn, x1, carry, step_slice=(3, 8), **kw)
    elif sampler == "dpm++":
        base = dpm_solver_pp_loop(d, model_fn, x, **kw)
        x1, x0 = dpm_solver_pp_loop(d, model_fn, x, step_slice=(0, 3), return_carry=True, **kw)
        x1, x0 = dpm_solver_pp_loop(d, model_fn, x1, prev_x0=x0, step_slice=(3, 3), return_carry=True, **kw)
        out = dpm_solver_pp_loop(d, model_fn, x1, prev_x0=x0, step_slice=(3, 8), **kw)
    else:
        base = unipc_loop(d, model_fn, x, **kw)
        carry = unipc_loop(d, model_fn, x, step_slice=(0, 3), return_carry=True, **kw)
        carry = unipc_loop(d, model_fn, carry[0], prev_carry=carry, step_slice=(3, 3), return_carry=True, **kw)
        out = unipc_loop(d, model_fn, carry[0], prev_carry=carry, step_slice=(3, 8), **kw)
    assert torch.equal(out, base)


@pytest.mark.parametrize("percentile", [0.9, 0.995, 1.0])
def test_dynamic_threshold_matches_jax(percentile):
    """The per-sample quantile clip (linear interpolation, floor 1) on
    estimates with spikes, against jnp.quantile's."""
    rng = np.random.default_rng(4)
    x0 = (rng.normal(size=(3, 4, 8, 8)) * np.array([0.5, 2.0, 6.0])[:, None, None, None]).astype(np.float32)
    x0[1, 0, 0, :4] = 40.0
    want = np.asarray(jax_dynamic_threshold_fn(percentile)(jnp.asarray(x0)))
    got = dynamic_threshold_fn(percentile)(torch.from_numpy(x0)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    if percentile == 1.0:
        np.testing.assert_array_equal(got, x0)
    with pytest.raises(ValueError, match="percentile"):
        dynamic_threshold_fn(0.0)


def test_dynamic_threshold_in_the_ddpm_chain_matches_jax():
    """The threshold as the fast DDPM chain's denoised_fn, unclipped, on
    JAX's draws."""
    rng = np.random.default_rng(5)
    x = (3.0 * rng.normal(size=(2, 4, 8, 8))).astype(np.float32)
    key = jax.random.PRNGKey(6)
    with jax.disable_jit():
        want = np.asarray(jax_create_diffusion("10").p_sample_loop_fast(
            toy_jax, jnp.asarray(x), key, clip_denoised=False, denoised_fn=jax_dynamic_threshold_fn(0.9)))
    got = create_diffusion("10", device="cpu").p_sample_loop_fast(
        toy, torch.from_numpy(x), clip_denoised=False, denoised_fn=dynamic_threshold_fn(0.9),
        noise_fn=noise_from(jax_draws(key, 10, x.shape), 10)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("fold", [False, True])
def test_trained_reference_ddim_chain(golden, fold):
    """The reference's 8-step DDIM eta-0 CFG chain at 200-step trained
    DiT-XS/4 weights (rows off unit norm), at fold off and on, with the
    bounds of tests/test_model.py."""
    g = golden("trained_reference")
    sd = {k[len("sd."):]: torch.from_numpy(np.array(v)) for k, v in g.items() if k.startswith("sd.")}
    cfg = build_config("DiT-XS/4", **XS2)
    model_fn = build_model_fn(cfg, sd, cfg_scale=float(g["cfg_scale"]), fold=fold, device="cpu")
    out = create_diffusion("ddim8", device="cpu").ddim_sample_loop(
        model_fn, t32(g["z_cfg"]), clip_denoised=True, model_kwargs={"y": torch.from_numpy(g["y_cfg"].astype(np.int64))},
    ).numpy()
    err = np.abs(out - g["ddim_final"])
    assert err.max() < 2e-2, err.max()
    assert err.mean() < 1e-4, err.mean()
    assert (err < 2e-3).mean() > 0.99, (err >= 2e-3).sum()


def test_trained_reference_forward(golden):
    """The forward at 200-step trained DiT-XS/4 weights (bounds of
    tests/test_model.py)."""
    from mapdit_tpu_torch.models.dit import DiT

    g = golden("trained_reference")
    model = DiT(build_config("DiT-XS/4", **XS2)).eval()
    model.load_state_dict({k[len("sd."):]: torch.from_numpy(np.array(v)) for k, v in g.items() if k.startswith("sd.")})
    with torch.no_grad():
        out = model(t32(g["x"]), t32(g["t"]), torch.from_numpy(g["y"].astype(np.int64))).numpy()
    np.testing.assert_allclose(out, g["fwd"], rtol=5e-4, atol=5e-4)


def test_module_goldens(golden):
    """Block 0, the final layer and the timestep embedder of the reference
    DiT-XS/2 on the golden's activations (tests/test_model.py's bounds)."""
    from mapdit_tpu_torch.models.dit import DiT

    g, gm = golden("dit_xs2"), golden("dit_xs2_modules")
    model = DiT(build_config("DiT-XS/2", **XS2)).eval()
    model.load_state_dict({k[len("sd."):]: torch.from_numpy(np.array(v)) for k, v in g.items() if k.startswith("sd.")})
    xt, c = t32(gm["xt"]), t32(gm["c"])
    with torch.no_grad():
        np.testing.assert_allclose(model.blocks[0](xt, c).numpy(), gm["blk_out"], rtol=2e-4, atol=2e-4)
        mean, sigma = model.final_layer(xt, c)
        np.testing.assert_allclose(mean.numpy(), gm["fin_mean"], rtol=2e-4, atol=2e-4)
        np.testing.assert_allclose(sigma.numpy(), gm["fin_sigma"], rtol=2e-4, atol=2e-4)
        temb = model.t_embedder(torch.tensor([0.0, 13.0, 999.0]))
    np.testing.assert_allclose(temb.numpy(), gm["temb"], rtol=2e-4, atol=2e-4)
