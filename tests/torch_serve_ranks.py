"""Rank bodies of ``tests/test_torch_serve_dist.py``: one ``SamplerService``
over the ranks of a spawned gloo world, the lead sampling in process (its
float latents) while the other ranks follow, held against the one-device
chains the lead computes afterwards with the same threads.

A spawned rank re-imports the module that defines its target, so this
module imports torch and the port only, never JAX.
"""

import numpy as np
import pytest
import torch

from mapdit_tpu_torch import serve
from mapdit_tpu_torch.diffusion import create_diffusion, respacing_string
from mapdit_tpu_torch.runtime import build_sample_fn, data_rank_generator
from mapdit_tpu_torch.sample import decode_latents, load_variables, run_config

CPU = torch.device("cpu")
BUCKETS = (1, 4)
CFG_SCALE = 4.0
STEPS = 4
# an unclipped ddpm chain on untrained weights leaves the finite range after two steps
DDPM_STEPS = 2


def _close(got, want, tol):
    """Equal to ``tol`` of the largest value: the unclipped chain's first
    step amplifies a product's last-bit rounding (other rows, other threads)
    where values are near zero."""
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol * np.abs(want).max())


def _service(exp, n_model, **kw):
    return serve.SamplerService(exp, buckets=BUCKETS, coalesce_ms=0.0, device="cpu", n_model=n_model, **kw)


def _one_device_ddpm(service, z, labels, gen):
    """The one-device exact ddpm chain of the experiment on ``z`` and
    ``labels`` (the un-doubled rows), decoded as the server decodes."""
    cfg = run_config(service.train_args, None)
    variables = load_variables(service.result_dir, service.train_args)
    diffusion = create_diffusion(respacing_string(DDPM_STEPS, "ddpm", "uniform"), device="cpu")
    fn = build_sample_fn(cfg, variables, diffusion,
                         cfg_scale=CFG_SCALE, batch_hint=len(z), device="cpu")
    zz, yy = torch.cat([z, z]), torch.cat([labels, torch.full_like(labels, cfg.num_classes)])
    out = fn(zz, yy, gen)[: len(z)].numpy()
    return decode_latents(out, service.train_args, False)


def _data_parallel(exp, case):
    """(2, 1): the healthz mesh; dpm++ on the shard_map layout against the
    one-device server's floats (1e-5); ddpm on the shard_map layout, each
    rank's rows the same bits as the one-device chain on them under its
    ``data_rank_generator`` stream; a bucket the data axis does not divide
    (the one-device chain on every rank, the same bits); a cached request on
    the data axis."""
    service = _service(exp, 1)
    if not service.lead:
        service.follow()
        return
    try:
        info = service.info()
        assert info["devices"] == 2 and info["mesh"] == {"data": 2, "model": 1}, info
        got = service.sample([1, 2, 3, 4], STEPS, "dpm++", CFG_SCALE, seed=5)
        assert service._fns[("dpm++", STEPS, CFG_SCALE, 4, "uniform", 0, None, "hold", None)][1] == "shard_map"
        _close(got, case["dpm_ref"], 1e-5)

        counter = service._request_counter
        ddpm = service.sample([5, 6, 7, 8], DDPM_STEPS, "ddpm", CFG_SCALE, seed=6)
        assert np.isfinite(ddpm).all()
        z = serve.draw(6, (4, 4, 16, 16), CPU)
        labels = torch.tensor([5, 6, 7, 8])
        for r in range(2):
            gen = data_rank_generator(serve.generator(serve.chain_seed(0, counter + 1), CPU), r, CPU)
            want = _one_device_ddpm(service, z[2 * r : 2 * r + 2], labels[2 * r : 2 * r + 2], gen)
            np.testing.assert_array_equal(ddpm[2 * r : 2 * r + 2], want)

        counter = service._request_counter
        one = service.sample([9], DDPM_STEPS, "ddpm", CFG_SCALE, seed=7)  # bucket 1: whole on every rank
        want = _one_device_ddpm(service, serve.draw(7, (1, 4, 16, 16), CPU), torch.tensor([9]),
                                serve.generator(serve.chain_seed(0, counter + 1), CPU))
        np.testing.assert_array_equal(one, want)

        cached = service.sample([1, 2, 3, 4], STEPS, "dpm++", CFG_SCALE, seed=8, cache_interval=2)
        assert cached.shape == (4, 4, 16, 16) and np.isfinite(cached).all()
    finally:
        service.close()


def _tensor_parallel(exp, case):
    """(1, 2): auto resolves to the plain path on the CPU, the weights split;
    dpm++ against the one-device server's floats (1e-4); a cached request is
    refused at admission naming "tensor-parallel"."""
    service = _service(exp, 2)
    if not service.lead:
        service.follow()
        return
    try:
        info = service.info()
        assert info["mesh"] == {"data": 1, "model": 2}, info
        model = service._prepared["model"]
        assert model.cfg.block_kernel == "off" and model.blocks[0].mlp.tp_group is not None
        got = service.sample([1, 2, 3, 4], STEPS, "dpm++", CFG_SCALE, seed=5)
        _close(got, case["dpm_ref"], case["tp_tol"])
        with pytest.raises(ValueError, match="tensor-parallel"):
            service.sample([1], STEPS, "ddpm", CFG_SCALE, seed=1, cache_interval=2)
    finally:
        service.close()


def _refusals(exp):
    """What a world of two refuses before any collective: --n-model without
    --shard, a pinned single-device kernel on a model axis, the fused
    preamble on a mesh."""
    with pytest.raises(ValueError, match="--n-model needs --shard true"):
        _service(exp, 2, shard=False)
    with pytest.raises(ValueError, match="needs block_kernel auto/off"):
        _service(exp, 2, block_kernel="mega")
    with pytest.raises(ValueError, match="single device"):
        _service(exp, 1, preamble="fused")


def run_cases(rank, device, exp, case):
    torch.set_num_threads(1)
    _refusals(exp)
    _data_parallel(exp, case)
    _tensor_parallel(exp, case)
