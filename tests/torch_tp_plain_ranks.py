"""Rank bodies of ``tests/test_torch_tp_plain.py``: tensor parallelism of the
plain path (``build_sample_fn(mesh=)`` resolving to ``off``, the plain
layout of ``parallel.mesh.shard_state_dict``) and the cached chain on a
data axis, on spawned gloo ranks, held against arrays the test process
computed (JAX under GSPMD, and the port on one device).

A spawned rank re-imports the module that defines its target, so this
module imports torch and the port only, never JAX.
"""

import numpy as np
import torch
import torch.distributed as dist

from mapdit_tpu_torch.diffusion import create_diffusion
from mapdit_tpu_torch.models import build_config
from mapdit_tpu_torch.parallel.mesh import Mesh, make_mesh
from mapdit_tpu_torch.runtime import build_cached_sample_fn, build_sample_fn, prepare_weights

CHAIN_STEPS = "4"
CFG_SCALE = 1.5
XS8 = dict(in_channels=4, input_size=16, num_classes=10)
MODEL_TOL = dict(rtol=1e-5, atol=1e-5)
# the cached chains, as tests/test_torch_sample_runtime.py holds the port's
# cached chain to JAX's (here within 5e-5)
CACHED_TOL = dict(rtol=1e-4, atol=2e-4)


def det_noise(t, shape):
    """The goldens' injected step noise, cos(flat_index * 0.01 + t)."""
    idx = torch.arange(int(np.prod(shape)), dtype=torch.float32).reshape(shape)
    return torch.cos(idx * 0.01 + t[0].float())


def chain_bounds(got, want, name):
    """The bounds of ``tests/test_model.py:392-411`` (a jitted 10-step
    chain against the reference): the worst case, the mean and the bulk."""
    err = np.abs(got - want)
    assert np.isfinite(got).all(), name
    assert err.max() < 2e-2, (name, err.max())
    assert err.mean() < 1e-4, (name, err.mean())
    assert (err < 2e-3).mean() > 0.99, (name, (err >= 2e-3).sum())


def _tensors(arrays):
    return {k: torch.from_numpy(v) for k, v in arrays.items()}


def _plain_case(mesh, case):
    """The model call (f32, 1e-5) and, where the case has one, the 4-step
    chain on the injected noise (the chain bounds) against JAX; the
    resolved kernel and the layout."""
    cfg = build_config("DiT-XS/8", **XS8).replace(**case["overrides"])
    sd = _tensors(case["sd"])
    z, y = torch.from_numpy(case["z"]), torch.from_numpy(case["y"])
    t = torch.from_numpy(case["t"])
    prepared = prepare_weights(cfg, sd, device="cpu", mesh=mesh)
    model = prepared["model"]
    assert model.cfg.block_kernel == "off", (case["name"], model.cfg.block_kernel)
    attn_split = cfg.num_heads % mesh.n_model == 0
    qkv = model.blocks[0].attn.qkv_proj.weight
    assert qkv.shape[0] == 3 * cfg.hidden_size // (mesh.n_model if attn_split else 1), (case["name"], qkv.shape)
    assert (model.blocks[0].attn.tp_group is not None) == attn_split
    with torch.no_grad():
        got = model.forward_with_cfg(z, t, y, CFG_SCALE).numpy()
    np.testing.assert_allclose(got, case["model_ref"], err_msg=case["name"], **MODEL_TOL)
    fn = build_sample_fn(cfg, None, create_diffusion(CHAIN_STEPS, device="cpu"), cfg_scale=CFG_SCALE,
                         clip_denoised=True, mesh=mesh, noise_fn=det_noise, prepared=prepared)
    assert fn.run_cfg.block_kernel == "off"
    if case["chain_ref"] is not None:
        chain_bounds(fn(z, y).numpy(), case["chain_ref"], case["name"])


def _cached_case(mesh, case):
    """build_cached_sample_fn(mesh=) on a data axis: a batch the axis
    divides (each rank its rows, the step noise drawn at the global shape)
    and one it does not (whole on every rank). Each against JAX's cached
    chain on its step noise (``noise_fn``), and against the port's
    one-device cached chain under the same generator, both at
    ``CACHED_TOL``."""
    cfg = build_config("DiT-XS/8", **XS8)
    sd = _tensors(case["sd"])
    for run in case["runs"]:
        z, y = torch.from_numpy(run["z"]), torch.from_numpy(run["y"])
        name = f"cached {len(z) // 2} rows"
        draws = run["draws"]

        def jax_noise(t, shape):
            return torch.from_numpy(draws[len(draws) - 1 - int(t[0])])

        for noise_fn, gen, want, what in ((jax_noise, None, run["jax_ref"], "jax"),
                                          (None, torch.Generator().manual_seed(run["seed"]), run["want"], "one-device")):
            fn = build_cached_sample_fn(cfg, sd, create_diffusion(CHAIN_STEPS, device="cpu"), cfg_scale=CFG_SCALE,
                                        cache_interval=2, clip_denoised=True, sampler="ddpm", device="cpu", mesh=mesh,
                                        noise_fn=noise_fn)
            got = fn(z, y, gen).numpy()
            assert np.isfinite(got).all(), name
            np.testing.assert_allclose(got, want, err_msg=f"{name} vs {what}", **CACHED_TOL)


def pair_mesh(device) -> Mesh:
    """A (1, 2) mesh on each pair of ranks {0, 1} and {2, 3} of a world of
    four: both pairs run the same case side by side. Every rank creates
    every group, in the same order."""
    rank = dist.get_rank()
    singles = [dist.new_group([r]) for r in range(4)]
    pairs = [dist.new_group([0, 1]), dist.new_group([2, 3])]
    return Mesh(1, 2, rank % 2, torch.device(device), singles[rank], pairs[rank // 2])


def run_cases(rank, device, plain, cached):
    """Every mesh case of the test file in one process group of four ranks."""
    torch.set_num_threads(1)
    meshes = {(1, 2): pair_mesh(device), (2, 2): make_mesh(2, 2, device=device)}
    for case in plain:
        _plain_case(meshes[case["layout"]], case)
    _cached_case(make_mesh(4, 1, device=device), cached)
