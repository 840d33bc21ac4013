"""Rank bodies of ``tests/test_torch_tp.py``: the port's tensor-parallel
islands and ``build_sample_fn(mesh=)`` on spawned gloo ranks, held against
arrays the test process computed (JAX and the port's unsharded chain).

A spawned rank re-imports the module that defines its target, so this
module imports torch and the port only, never JAX.
"""

import numpy as np
import torch

from mapdit_tpu_torch.diffusion import create_diffusion
from mapdit_tpu_torch.models import build_config
from mapdit_tpu_torch.ops.cuda.dit_block_tp import fused_attn_branch_tp, fused_dit_block_tp
from mapdit_tpu_torch.parallel.mesh import make_mesh, shard_tensor
from mapdit_tpu_torch.runtime import build_sample_fn

# 4 DDPM steps, not the JAX tests' 2: a 2-step chain's first step takes
# x0 = x / sqrt(abar_999) - ..., carrying the model's f32 rounding ~156x into
# the result (1.5e-4 between the sharded and the unsharded chain where 4
# steps leave 2.4e-5)
CHAIN_STEPS = "4"
CFG_SCALE = 1.5
XS8 = dict(in_channels=4, input_size=16, num_classes=10)


def det_noise(t, shape):
    """The goldens' injected step noise, cos(flat_index * 0.01 + t)."""
    idx = torch.arange(int(np.prod(shape)), dtype=torch.float32).reshape(shape)
    return torch.cos(idx * 0.01 + t[0].float())


def _islands(mesh, case):
    """fused_dit_block_tp and fused_attn_branch_tp on this rank's rows and
    weight shards against the JAX references' rows."""
    a = {k: torch.from_numpy(v) for k, v in case["inputs"].items()}
    tp, m = mesh.n_model, mesh.model_index
    n_loc = a["x"].shape[0] // mesh.n_data
    keep = slice(mesh.data_index * n_loc, (mesh.data_index + 1) * n_loc)
    heads = case["heads"]
    w_qkv = shard_tensor(a["w_qkv"], "qkv", tp, m)
    w_out = shard_tensor(a["w_out"], "cols", tp, m)
    with torch.no_grad():
        got = fused_dit_block_tp(
            a["x"][keep], a["a"][keep], a["gains"], a["w_mod"], w_qkv, w_out, shard_tensor(a["w1"], "rows", tp, m),
            shard_tensor(a["w2"], "cols", tp, m), heads_local=heads // tp, hidden_total=a["w1"].shape[0],
            group=mesh.model_group,
        )
        np.testing.assert_allclose(got.numpy(), case["block_ref"][keep], rtol=1e-4, atol=1e-4)
        got = fused_attn_branch_tp(
            a["x"][keep], a["shift"][keep], a["scale"][keep], a["gate"][keep], a["gains"][0], w_qkv, w_out,
            heads_local=heads // tp, group=mesh.model_group,
        )
        np.testing.assert_allclose(got.numpy(), case["attn_ref"][keep], rtol=1e-4, atol=1e-4)


def _chain(mesh, case, sd):
    """build_sample_fn(mesh=) against the port's unsharded chain under the
    same generator (1e-4) and, on the injected noise, against JAX's eager
    chain (2e-3, the runtime chain bound of tests/test_torch_sample.py)
    where the case has one (the ddpm chains)."""
    cfg = build_config("DiT-XS/8", block_kernel=case["kernel"], **XS8)
    z, y = torch.from_numpy(case["z"]), torch.from_numpy(case["y"])
    kwargs = dict(cfg_scale=CFG_SCALE, clip_denoised=True, mesh=mesh, **case["sampler"])
    fn = build_sample_fn(cfg, sd, create_diffusion(CHAIN_STEPS, device="cpu"), **kwargs)
    assert fn.run_cfg.block_kernel == case["kernel"], fn.run_cfg.block_kernel
    got = fn(z, y, torch.Generator().manual_seed(case["seed"])).numpy()
    np.testing.assert_allclose(got, case["port_ref"], rtol=1e-4, atol=1e-4, err_msg=case["name"])
    if case["jax_ref"] is None:
        return
    fn = build_sample_fn(cfg, sd, create_diffusion(CHAIN_STEPS, device="cpu"), noise_fn=det_noise, **kwargs)
    got = fn(z, y).numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, case["jax_ref"], rtol=2e-3, atol=2e-3, err_msg=case["name"])


def run_cases(rank, device, islands, chains, sd):
    """Every mesh case of the test in one process group: ``islands`` on a
    (2, 2) mesh, then each chain case on its layout."""
    torch.set_num_threads(1)
    sd = {k: torch.from_numpy(v) for k, v in sd.items()}
    _islands(make_mesh(2, 2, device=device), islands)
    for case in chains:
        _chain(make_mesh(*case["layout"], device=device), case, sd)


def plain_chain_cases(rank, device, cases, out_dir):
    """The plain path on a (1, 2) mesh where a model axis refused it before
    the cross-rank row norm: unfolded weight-normalized weights, and the
    ``scan_blocks`` layout (plain and on the ``mega_tp`` island). Rank 0
    writes each case's model call and 4-step chain (injected noise) to
    ``out_dir``."""
    torch.set_num_threads(1)
    mesh = make_mesh(1, 2, device=device)
    for case in cases:
        cfg = build_config("DiT-XS/8", **XS8).replace(**case["overrides"])
        sd = {k: torch.from_numpy(v) for k, v in case["sd"].items()}
        z, y = torch.from_numpy(case["z"]), torch.from_numpy(case["y"])
        fn = build_sample_fn(cfg, sd, create_diffusion(CHAIN_STEPS, device="cpu"), cfg_scale=CFG_SCALE,
                             clip_denoised=True, fold=case["fold"], mesh=mesh, noise_fn=det_noise)
        assert fn.run_cfg.block_kernel == case["kernel"], (case["name"], fn.run_cfg.block_kernel)
        model = fn.prepared["model"]
        qkv = model.blocks.attn.qkv_proj.weight if cfg.scan_blocks else model.blocks[0].attn.qkv_proj.weight
        assert qkv.shape[-2] == 3 * cfg.hidden_size // 2, (case["name"], tuple(qkv.shape))
        with torch.no_grad():
            call = model.forward_with_cfg(z, torch.full((z.shape[0],), 500.0), y, CFG_SCALE)
        chain = fn(z, y)
        if rank == 0:
            np.savez(f"{out_dir}/{case['name']}.npz", call=call.numpy(), chain=chain.numpy())

