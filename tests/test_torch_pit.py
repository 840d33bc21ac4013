"""Parallel-in-time DDIM of the port (``runtime.build_pit_sample_fn``) on
one device against the JAX package's, the twins of the single-device cases
of tests/test_pit.py: the same DiT-XS/8 weights (JAX's init, carried over by
``state_dict_from_jax``), inputs drawn from a numpy seed, JAX's chains run
eagerly (``jax.disable_jit()``, as the other sampling tests run them),
rtol / atol 1e-4. Full sweeps and ``shift=1`` also reproduce the port's own
sequential ddim chain. Then ``sample_fid --pit-*`` in process and the
probe grid's parallel-in-time rows. The mesh cases are
tests/test_torch_dp_sample.py's."""

import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mapdit_tpu.diffusion import create_diffusion as jax_create_diffusion
from mapdit_tpu.models import build_config as jax_build_config
from mapdit_tpu.models import init_model as jax_init_model
from mapdit_tpu.runtime import build_pit_sample_fn as jax_build_pit_sample_fn
from mapdit_tpu_torch import sample_fid, train
from mapdit_tpu_torch.diffusion import create_diffusion
from mapdit_tpu_torch.models import build_config
from mapdit_tpu_torch.runtime import build_pit_sample_fn, build_sample_fn, pit_schedule
from mapdit_tpu_torch.sample import decode_latents, load_variables
from mapdit_tpu_torch.tools import distribution_probe as probe
from mapdit_tpu_torch.utils.experiment import load_config
from mapdit_tpu_torch.utils.image import to_uint8
from mapdit_tpu_torch.utils.weights import state_dict_from_jax

XS8 = dict(in_channels=4, input_size=16, num_classes=10)
TOL = dict(rtol=1e-4, atol=1e-4)
CPU = torch.device("cpu")
torch.set_num_threads(2)  # workers share the cores (tests/test_torch_train.py)


@pytest.fixture(scope="module")
def setup():
    jcfg = jax_build_config("DiT-XS/8", **XS8)
    _, variables = jax_init_model(jcfg, seed=0)
    cfg = build_config("DiT-XS/8", **XS8)
    return jcfg, variables, cfg, state_dict_from_jax(variables, cfg)


def _inputs(seed, n=2, cfg_scale=None):
    z = np.random.default_rng(seed).normal(size=(n, 4, 16, 16)).astype(np.float32)
    y = np.arange(n, dtype=np.int32)
    if cfg_scale is not None:
        z, y = np.concatenate([z, z]), np.concatenate([y, np.full(n, XS8["num_classes"], np.int32)])
    return z, y


def _jax_pit(setup, spacing, z, y, **kw):
    jcfg, variables, _, _ = setup
    with jax.disable_jit():
        fn = jax_build_pit_sample_fn(jcfg, variables, jax_create_diffusion(spacing), clip_denoised=True, **kw)
        return np.asarray(fn(jnp.asarray(z), jnp.asarray(y), jax.random.PRNGKey(0)))


def _port_pit(setup, spacing, z, y, **kw):
    _, _, cfg, sd = setup
    fn = build_pit_sample_fn(cfg, sd, create_diffusion(spacing, device=CPU), clip_denoised=True, device=CPU, **kw)
    out = fn(torch.from_numpy(z), torch.from_numpy(y).long(), torch.Generator().manual_seed(1)).numpy()
    assert np.isfinite(out).all()
    return out


def _port_sequential(setup, spacing, z, y, cfg_scale=None):
    _, _, cfg, sd = setup
    fn = build_sample_fn(cfg, sd, create_diffusion(spacing, device=CPU), cfg_scale=cfg_scale, sampler="ddim",
                         clip_denoised=True, device=CPU)
    return fn(torch.from_numpy(z), torch.from_numpy(y).long(), torch.Generator().manual_seed(1)).numpy()


def _rel(a, b):
    return np.linalg.norm(a - b) / np.linalg.norm(b)


def test_full_sweeps_exact(setup):
    """sweeps == window: the port's pit chain equals JAX's and the port's
    own sequential ddim chain (twin of test_pit.py:36)."""
    z, y = _inputs(0)
    got = _port_pit(setup, "8", z, y, window=8, sweeps=8)
    np.testing.assert_allclose(got, _jax_pit(setup, "8", z, y, window=8, sweeps=8), **TOL)
    np.testing.assert_allclose(got, _port_sequential(setup, "8", z, y), **TOL)


def test_deviation_monotone_in_sweeps(setup):
    """Each sweep count matches JAX; rel L2 from the sequential chain
    shrinks strictly as sweeps grow (twin of test_pit.py:52)."""
    z, y = _inputs(2)
    ref = _port_sequential(setup, "8", z, y)
    devs = []
    for sweeps in (1, 2, 4, 8):
        got = _port_pit(setup, "8", z, y, window=8, sweeps=sweeps)
        np.testing.assert_allclose(got, _jax_pit(setup, "8", z, y, window=8, sweeps=sweeps), **TOL,
                                   err_msg=f"sweeps={sweeps}")
        devs.append(_rel(got, ref))
    assert devs[0] > devs[1] > devs[2] > devs[3], devs


def test_cfg_full_sweeps_exact(setup):
    """The CFG batch contract ([z; z], [y; null] in, 2N out) and exactness
    (twin of test_pit.py:71)."""
    z, y = _inputs(4, cfg_scale=1.5)
    got = _port_pit(setup, "4", z, y, cfg_scale=1.5, window=4, sweeps=4)
    want = _jax_pit(setup, "4", z, y, cfg_scale=1.5, window=4, sweeps=4)
    assert got.shape == want.shape == z.shape
    np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_allclose(got[:2], _port_sequential(setup, "4", z, y, cfg_scale=1.5)[:2], **TOL)
    np.testing.assert_array_equal(got[:2], got[2:])


def test_slide_shift1_exact(setup):
    """Sliding schedule at shift 1 (twin of test_pit.py:131)."""
    z, y = _inputs(10)
    got = _port_pit(setup, "8", z, y, window=4, shift=1)
    np.testing.assert_allclose(got, _jax_pit(setup, "8", z, y, window=4, shift=1), **TOL)
    np.testing.assert_allclose(got, _port_sequential(setup, "8", z, y), **TOL)


def test_slide_monotone_in_shift(setup):
    """Each shift matches JAX; rel L2 from the sequential chain shrinks as
    shift drops 8 -> 4 -> 2 -> 1 (twin of test_pit.py:146)."""
    z, y = _inputs(12)
    ref = _port_sequential(setup, "8", z, y)
    devs = []
    for shift in (8, 4, 2, 1):
        got = _port_pit(setup, "8", z, y, window=8, shift=shift)
        np.testing.assert_allclose(got, _jax_pit(setup, "8", z, y, window=8, shift=shift), **TOL,
                                   err_msg=f"shift={shift}")
        devs.append(_rel(got, ref))
    assert devs[0] > devs[1] > devs[2] > devs[3], devs


@pytest.mark.parametrize("kw, match", [
    (dict(window=4, sweeps=2), "divide"), (dict(window=5, shift=3), "divide"), (dict(window=16, shift=2), "longer"),
    (dict(window=5, sweeps=6), "sweeps"),
])
def test_refusals(setup, kw, match):
    """The schedules JAX asserts against raise ValueError here; the window
    must divide the chain (twin of test_pit.py:186, which JAX matches on
    "divide")."""
    _, _, cfg, sd = setup
    d = create_diffusion("10", device=CPU)
    with pytest.raises(ValueError, match=match):
        build_pit_sample_fn(cfg, sd, d, device=CPU, **kw)


def test_flops_accounting(setup):
    """A block-schedule chain makes T / window x sweeps model calls, sweeps
    x the sequential chain's (twin of test_pit.py:193); the sliding one
    window / shift - 1 + T / shift."""
    _, _, cfg, sd = setup
    t, window, sweeps = 8, 4, 2
    fn = build_pit_sample_fn(cfg, sd, create_diffusion(str(t), device=CPU), window=window, sweeps=sweeps, device=CPU)
    assert fn.model_calls == (t // window) * sweeps == sweeps * t // window
    assert (t // window) * sweeps * window == sweeps * t
    mode, warm, rows = pit_schedule(50, 10, shift=2)
    assert (mode, warm, rows.shape) == ("slide", 4, (25, 10))
    for (w, j, s), calls in (((10, 10, None), 50), ((10, 1, 1), 59), ((10, 5, None), 25), ((10, 1, 2), 29)):
        fn = build_pit_sample_fn(cfg, sd, create_diffusion("ddim50", device=CPU), window=w, sweeps=j, shift=s,
                                 device=CPU, prepared=fn.prepared)
        assert fn.model_calls == calls, (w, j, s)


def test_rows_are_position_major(setup, monkeypatch):
    """One model call a sweep over window x N rows, position-major as JAX's
    reshape(window * n, ...): the rows' timesteps are each position's, N
    at a time."""
    _, _, cfg, sd = setup
    d = create_diffusion("8", device=CPU)
    seen = []
    orig = d.ddim_sample

    def spy(model_fn, x, t, *a, **kw):
        seen.append((x.shape[0], t.tolist()))
        return orig(model_fn, x, t, *a, **kw)

    monkeypatch.setattr(d, "ddim_sample", spy)
    z, y = _inputs(5, n=3)
    build_pit_sample_fn(cfg, sd, d, window=4, sweeps=2, device=CPU)(torch.from_numpy(z), torch.from_numpy(y).long())
    assert len(seen) == 4 and all(rows == 12 for rows, _ in seen)
    assert seen[0][1] == [7] * 3 + [6] * 3 + [5] * 3 + [4] * 3 and seen[2][1] == [3] * 3 + [2] * 3 + [1] * 3 + [0] * 3


# ------------------------------------------------------- the entry points


@pytest.fixture(scope="module")
def exp(tmp_path_factory):
    """A 2-step DiT-XS/8 run of the port's train CLI (10 classes)."""
    results = tmp_path_factory.mktemp("pit_run")
    yield train.main(train.build_parser().parse_args([
        "--device", "cpu", "--data-path", "synthetic:16", "--results-dir", str(results), "--model", "DiT-XS/8",
        "--num-classes", "10", "--batch-size", "8", "--num-steps", "2", "--log-every", "1", "--ckpt-every", "2",
        "--ema-snapshot-every", "1"]))
    shutil.rmtree(results, ignore_errors=True)


def _fid_args(exp, *flags):
    return sample_fid.build_parser().parse_args(
        ["--device", "cpu", "--result-dir", exp, "--use-vae", "false", "--num-classes", "10", "--num-samples", "3",
         "--batch-size", "2", "--num-sampling-steps", "8", "--sampler", "ddim", "--clip-denoised", "true",
         "--output-file", "pit.npz", *flags])


@pytest.mark.parametrize("flags", [["--pit-window", "4", "--pit-sweeps", "2"], ["--pit-window", "4", "--pit-shift", "2"]])
def test_sample_fid_pit_runs_on_one_device(exp, flags):
    """sample_fid --pit-* on the CPU: the npz holds what
    build_pit_sample_fn gives on the script's draws (the seed rule: z, then
    labels, from one generator)."""
    path = sample_fid.main(_fid_args(exp, *flags))
    with np.load(path) as f:
        got = f["arr_0"]
    args = load_config(exp)
    sd = load_variables(exp, args, None, 0.05)
    kw = dict(window=4, sweeps=2) if "--pit-sweeps" in flags else dict(window=4, shift=2)
    fn = build_pit_sample_fn(sample_fid.run_config(args, None), sd, create_diffusion("ddim8", device=CPU),
                             cfg_scale=1.5, clip_denoised=True, device=CPU, **kw)
    gen = torch.Generator().manual_seed(42)
    want = []
    for _ in range(2):
        z = torch.randn((2, 4, 16, 16), generator=gen)
        y = torch.randint(0, 10, (2,), generator=gen)
        out = fn(torch.cat([z, z]), torch.cat([y, torch.full_like(y, 10)]), gen)[:2].numpy()
        want.append(to_uint8(decode_latents(out, args, False)))
    assert got.shape == (3, 16, 16, 4) and got.dtype == np.uint8
    np.testing.assert_array_equal(got, np.concatenate(want)[:3])


@pytest.mark.parametrize("flags, match", [
    (["--sampler", "dpm++"], "--sampler ddim --eta 0"),
    (["--eta", "0.5"], "--sampler ddim --eta 0"),
    (["--cfg-interval", "0.3", "3.0"], "gspmd layout only"),
    (["--kernel-sharding", "shard_map"], "gspmd layout only"),
])
def test_sample_fid_pit_refusals(exp, flags, match):
    """JAX sample_fid.py:96-106's refusals, as SystemExit with its words."""
    with pytest.raises(SystemExit, match=match):
        sample_fid.main(_fid_args(exp, "--pit-window", "4", *flags))


def test_probe_grid_pit_rows(exp):
    """The probe grid's ddim50 family (JAX tools/distribution_probe.py:403-408)
    on an XS model: finite latents, the accelerated rows off the exact one."""
    rows = [g for g in probe.GRID if g[0] == "ddim50"]
    assert [g[1] for g in rows] == ["ddim:50", "ddim:50:pit-slide-K10-S2", "ddim:50:pit-block-K10-J5"]
    assert [g[9:] for g in rows] == [(), ((10, None, 2),), ((10, 5, None),)]
    args = load_config(exp)
    sd = load_variables(exp, args, None, 0.05)
    out = [probe.draw_samples(sd, args, samples_per_class=1, sampler="ddim", num_sampling_steps=50,
                              time_schedule="uniform", seed=1, device="cpu", pit=g[9] if len(g) > 9 else None)
           for g in rows]
    for latents in out:
        assert latents.shape == (10, 1, 4, 16, 16) and np.isfinite(latents).all()
    assert all(0 < probe.rel_l2(latents, out[0]) for latents in out[1:])
