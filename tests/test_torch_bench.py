"""The port's bench (``python -m mapdit_tpu_torch.bench``) flags on the CPU:
for each flag of JAX ``bench.py:184-233`` one short run of the chain
:func:`bench.build_chain` picks, bit for bit against ``build_sample_fn`` or
``build_cached_sample_fn`` called directly with the JAX bench's arguments;
``--grad-accum`` against ``make_train_step``; the unit, the MFU step count
and the resolved block kernel. Timing needs the card
(``chip_smoke.py`` phase 5d)."""

import types

import numpy as np
import pytest
import torch

from mapdit_tpu_torch import bench
from mapdit_tpu_torch.diffusion import create_diffusion
from mapdit_tpu_torch.models import init_model
from mapdit_tpu_torch.runtime import (
    build_cached_sample_fn, build_sample_fn, cfg_interval_segments, resolve_run_config,
)
from mapdit_tpu_torch.training import create_optimizer, create_train_state, make_train_step, warmup_flat_invsqrt
from mapdit_tpu_torch.training.data import SyntheticLatentDataset

CPU = torch.device("cpu")
BASE = ["--model", "DiT-XS/8", "--batch", "2", "--steps", "4", "--dtype", "float32"]
torch.set_num_threads(2)  # workers share the cores (tests/test_torch_train.py)


def _args(*flags):
    return bench.build_parser().parse_args([*BASE, *flags])


@pytest.fixture(scope="module")
def weights():
    """XS/8 weights from seed 0 at the bench's two latent sizes."""
    return {size: init_model(bench.bench_config(_args("--input-size", str(size))), seed=0, device=CPU).state_dict()
            for size in (16, 32)}


def _inputs(args):
    gen = torch.Generator().manual_seed(0)
    n, side = args.batch, args.input_size
    z = torch.randn(2 * n, 4, side, side, generator=gen)
    y = torch.cat([torch.randint(0, 1000, (n,), generator=gen), torch.full((n,), 1000)])
    return z, y


# flags -> (the builder the JAX bench calls, its arguments beyond cfg_scale
# 1.5). The bench does not clip, as JAX's does not, and an untrained model's
# unclipped ddpm chain is non-finite from its third step on, so the ddpm
# cases run 2 steps and the others 4 or 10.
CASES = {
    "default": (["--steps", "2"], build_sample_fn, dict(sampler="ddpm", batch_hint=2)),
    "sampler-ddim": (["--sampler", "ddim"], build_sample_fn, dict(sampler="ddim", batch_hint=2)),
    "sampler-dpm++": (["--sampler", "dpm++"], build_sample_fn, dict(sampler="dpm++", batch_hint=2)),
    "sampler-unipc": (["--sampler", "unipc"], build_sample_fn, dict(sampler="unipc", batch_hint=2)),
    "time-schedule": (["--sampler", "dpm++", "--time-schedule", "karras"], build_sample_fn,
                      dict(sampler="dpm++", batch_hint=2)),
    "cfg-interval": (["--sampler", "dpm++", "--steps", "10", "--cfg-interval", "0.3", "3.0"], build_sample_fn,
                     dict(sampler="dpm++", cfg_interval=(0.3, 3.0), batch_hint=2)),
    "cache-interval": (["--sampler", "dpm++", "--cache-interval", "2"], build_cached_sample_fn,
                       dict(sampler="dpm++", cache_interval=2, cache_mode="forecast")),
    "cache-mode": (["--steps", "2", "--cache-interval", "2", "--cache-mode", "hold"], build_cached_sample_fn,
                   dict(sampler="ddpm", cache_interval=2, cache_mode="hold")),
    "cache-span": (["--sampler", "dpm++", "--cache-interval", "2", "--cache-span", "1,5"], build_cached_sample_fn,
                   dict(sampler="dpm++", cache_interval=2, cache_mode="forecast", span=(1, 5))),
    "input-size": (["--steps", "2", "--input-size", "32"], build_sample_fn, dict(sampler="ddpm", batch_hint=2)),
    "scan-unroll": (["--steps", "2", "--scan-unroll", "4"], build_sample_fn, dict(sampler="ddpm", batch_hint=2)),
}
SPACINGS = {"default": "2", "sampler-ddim": "ddim4", "time-schedule": "karras4", "cfg-interval": "10",
            "cache-mode": "2", "input-size": "2", "scan-unroll": "2"}


@pytest.mark.parametrize("name", list(CASES))
def test_chain_is_the_builders(weights, name):
    flags, builder, kw = CASES[name]
    args = _args(*flags)
    cfg = bench.bench_config(args)
    assert cfg.input_size == args.input_size
    sd = weights[args.input_size]
    diffusion = bench.bench_diffusion(args, CPU)
    expected_spacing = SPACINGS.get(name, "4")
    assert diffusion.timestep_map.tolist() == create_diffusion(expected_spacing, device=CPU).timestep_map.tolist()
    chain = bench.build_chain(args, cfg, sd, diffusion, CPU)
    want_fn = builder(cfg, sd, create_diffusion(expected_spacing, device=CPU), cfg_scale=1.5, device=CPU, **kw)
    z, y = _inputs(args)
    got = chain(z, y, torch.Generator().manual_seed(2))
    want = want_fn(z, y, torch.Generator().manual_seed(2))
    assert got.shape == z.shape
    assert torch.isfinite(got).all() and torch.equal(got, want)


def test_refusals(weights):
    args = _args("--cache-interval", "2", "--sampler", "unipc")
    with pytest.raises(SystemExit, match="ddpm or dpm"):
        bench.build_chain(args, bench.bench_config(args), weights[16], bench.bench_diffusion(args, CPU), CPU)
    mesh = types.SimpleNamespace(n_data=2, n_model=1)
    args = _args("--cache-interval", "2")
    with pytest.raises(SystemExit, match="one device"):
        bench.build_chain(args, bench.bench_config(args), weights[16], bench.bench_diffusion(args, CPU), CPU, mesh)


def test_grad_accum_is_make_train_step():
    """Train mode's step at --grad-accum 4: the same loss, gradient norm and
    parameters as make_train_step(grad_accum=4) on the same state seed and
    batch."""
    args = _args("--mode", "train", "--batch", "8", "--grad-accum", "4", "--resident-data")
    cfg = bench.bench_config(args)
    step_fn, state, batches = bench.build_train(args, cfg, CPU)
    ds = SyntheticLatentDataset(num_examples=1024, num_classes=1000, size=16)
    tx = create_optimizer(warmup_flat_invsqrt(1e-2, 100, 1000))
    want_fn = make_train_step(cfg, create_diffusion("", device=CPU), tx, stats_mean=ds.stats["mean"],
                              stats_std=ds.stats["std"], grad_accum=4)
    want_state = create_train_state(cfg, tx, seed=0, device=CPU)
    batch = next(batches)
    want_batch = next(ds.batches(batch_size=8, seed=0))
    np.testing.assert_array_equal(batch["mean"].numpy(), want_batch["mean"])
    for _ in range(2):
        got, want = step_fn(state, next(batches)), want_fn(want_state, want_batch)
        for key in ("loss", "grad_norm"):
            assert torch.equal(got[key], want[key]), key
    got_params = dict(state.model.named_parameters())
    for name, p in want_state.model.named_parameters():
        assert torch.equal(got_params[name], p), name


def test_unit_and_mfu_steps():
    """The default line's unit is PR 15's; the flags name the sampler, the
    schedule, the cache and the interval (JAX bench.py:418-431); mfu counts
    an unguided step of --cfg-interval as half a step and is null under a
    cache (JAX bench.py:395-412)."""
    default = bench.build_parser().parse_args([])
    assert bench.sample_unit(default, "mega_stack") == (
        "DDPM steps/s (DiT-S/2, batch 32x2 CFG, 250 respaced steps, bfloat16, block_kernel mega_stack")
    args = bench.build_parser().parse_args(["--sampler", "dpm++", "--steps", "20", "--time-schedule", "karras",
                                            "--cache-interval", "2", "--cache-mode", "hold", "--cfg-interval", "0.3",
                                            "3", "--input-size", "32"])
    assert bench.sample_unit(args, "off") == (
        "DPM++ steps/s (DiT-S/2, batch 32x2 CFG, 20 respaced steps, 32x32 latents, karras, cache-interval 2, "
        "cache-mode hold, cfg-interval 0.3-3, bfloat16, block_kernel off")
    d = create_diffusion("250", device=CPU)
    assert bench.effective_steps(default, d) == 250
    assert bench.effective_steps(bench.build_parser().parse_args(["--cache-interval", "2"]), d) is None
    g0, g1 = cfg_interval_segments(d, 0.3, 3.0)
    args = bench.build_parser().parse_args(["--cfg-interval", "0.3", "3.0"])
    assert bench.effective_steps(args, d) == (g1 - g0) + (250 - (g1 - g0)) * 0.5 and 0 < g1 - g0 < 250


@pytest.mark.parametrize("size, kernel, want", [(16, "auto", "mega_stack"), (32, "auto", "off"),
                                                (16, "mega_attn", "mega_attn"), (32, "mega", "mega")])
def test_resolved_kernel_on_the_card(size, kernel, want):
    """What the line names on a CUDA device (the policy reads the device's
    type only): auto with the batch hint takes the whole-stack kernel at
    16 x 16 (T = 64) and the plain path at 32 x 32 (T = 256, past the
    auto policy's T <= 64, where an explicit mega takes the kernels); the
    cached chain's blocks read the per-block policy."""
    cuda = torch.device("cuda")
    cfg = bench.bench_config(bench.build_parser().parse_args(["--input-size", str(size), "--block-kernel", kernel]))
    chain = types.SimpleNamespace(run_cfg=resolve_run_config(cfg, True, 32, cuda))
    assert bench.resolved_kernel(cfg, chain, cuda) == want
    per_block = "mega" if (size, kernel) == (16, "auto") else want.replace("mega_stack", "mega")
    assert bench.resolved_kernel(cfg, None, cuda) == per_block
    assert bench.resolved_kernel(cfg, chain, CPU) in (want, "off")


def test_main_refuses_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="GPU"):
        bench.main(["--sampler", "ddim"])
