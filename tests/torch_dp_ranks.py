"""Rank bodies of ``tests/test_torch_dp_sample.py``: the data-parallel
sampling layouts on spawned gloo ranks, held against arrays the test
process computed (JAX and the port's unsharded chains) and against each
rank's own one-device chain.

A spawned rank re-imports the module that defines its target, so this
module imports torch and the port only, never JAX.
"""

import numpy as np
import torch
import torch.distributed as dist

from mapdit_tpu_torch import sample_fid
from mapdit_tpu_torch.diffusion import create_diffusion
from mapdit_tpu_torch.models import build_config
from mapdit_tpu_torch.parallel.mesh import Mesh, make_mesh
from mapdit_tpu_torch.runtime import (
    build_dp_sharded_sample_fn, build_pit_sample_fn, build_sample_fn, data_rank_generator,
)

XS8 = dict(in_channels=4, input_size=16, num_classes=10)
CFG_SCALE = 1.5
TOL = dict(rtol=1e-4, atol=1e-4)


def pair_mesh(rank, device):
    """A (2, 1) mesh of ranks {0, 1} or {2, 3}: every rank creates both
    groups (``dist.new_group`` is collective) and keeps its pair's."""
    groups = [dist.new_group([0, 1]), dist.new_group([2, 3])]
    return Mesh(2, 1, rank % 2, torch.device(device), data_group=groups[rank // 2])


def dp_case(mesh, device, sd, n):
    """build_dp_sharded_sample_fn: the gathered rows of each data rank are
    the bits of the one-device chain on its rows under its stream
    (data_rank_generator), and ranks given the same rows draw apart."""
    cfg = build_config("DiT-XS/8", **XS8)
    d = create_diffusion("4", device=device)
    z = torch.randn(1, 4, 16, 16, generator=torch.Generator().manual_seed(3)).expand(n, -1, -1, -1).contiguous()
    y = torch.full((n,), 3)
    fn = build_dp_sharded_sample_fn(cfg, sd, d, mesh, cfg_scale=CFG_SCALE, clip_denoised=True, batch_hint=n,
                                    device=device)
    out = fn(z, y, torch.Generator().manual_seed(5))
    assert out.shape == z.shape and torch.isfinite(out).all()
    n_loc = n // mesh.n_data
    single = build_sample_fn(cfg, sd, d, cfg_scale=CFG_SCALE, clip_denoised=True, batch_hint=n_loc, device=device)
    for r in range(mesh.n_data):
        rows = slice(r * n_loc, (r + 1) * n_loc)
        stream = data_rank_generator(torch.Generator().manual_seed(5), r, device)
        want = single(torch.cat([z[rows], z[rows]]), torch.cat([y[rows], torch.full_like(y[rows], 10)]), stream)
        assert torch.equal(out[rows], want[:n_loc]), (mesh.n_data, r)
    assert not torch.equal(out[0], out[n_loc]), "two data ranks drew the same stream"


def pit_case(mesh, device, sd, case):
    """build_pit_sample_fn(mesh=) against the arrays of the test process."""
    cfg = build_config("DiT-XS/8", block_kernel=case["kernel"], **XS8)
    fn = build_pit_sample_fn(cfg, sd, create_diffusion(case["spacing"], device=device), clip_denoised=True,
                             mesh=mesh, device=device, **case["pit"])
    assert fn.run_cfg.block_kernel == case["kernel"], fn.run_cfg.block_kernel
    got = fn(torch.from_numpy(case["z"]), torch.from_numpy(case["y"]).long()).numpy()
    for name, want in case["refs"].items():
        np.testing.assert_allclose(got, want, **TOL, err_msg=f"{case['name']} vs {name}")


def fid_case(rank, device, exp, flags, reference):
    """sample_fid.main on the ranks of the group: rank 0 alone returns and
    writes the npz, which holds ``reference``'s chain on the script's draws
    (the seed rule: z, then labels, from one generator seeded 42). Every
    rank runs the reference chain, whose collectives need them all."""
    argv = ["--device", "cpu", "--result-dir", exp, "--use-vae", "false", "--num-classes", "10", "--num-samples", "6",
            "--batch-size", "4", "--num-sampling-steps", "4", "--clip-denoised", "true", "--output-file",
            f"rank_{flags[1]}.npz", *flags]
    args = sample_fid.build_parser().parse_args(argv)
    path = sample_fid.main(args)
    assert (path is None) == (rank != 0), (rank, path)
    fn, doubled = reference(args)
    gen = torch.Generator().manual_seed(42)
    want = []
    for _ in range(2):
        z = torch.randn((4, 4, 16, 16), generator=gen)
        y = torch.randint(0, 10, (4,), generator=gen)
        if doubled:
            z, y = torch.cat([z, z]), torch.cat([y, torch.full_like(y, 10)])
        want.append(fn(z, y, gen)[:4])
    if rank == 0:
        from mapdit_tpu_torch.sample import decode_latents
        from mapdit_tpu_torch.utils.experiment import load_config
        from mapdit_tpu_torch.utils.image import to_uint8

        train_args = load_config(exp)
        want = to_uint8(decode_latents(torch.cat(want).numpy(), train_args, False))[:6]
        with np.load(path) as f:
            got = f["arr_0"]
        assert got.shape == (6, 16, 16, 4) and got.dtype == np.uint8, (flags, got.shape)
        # the reference may tile its products otherwise: one uint8 step
        assert np.abs(got.astype(int) - want.astype(int)).max() <= 1, flags


def run_cases(rank, device, sd, pit_cases, exp):
    """Every mesh case of the test in one process group."""
    torch.set_num_threads(1)
    sd = {k: torch.from_numpy(v) for k, v in sd.items()}
    dp_case(make_mesh(4, 1, device=device), device, sd, n=4)
    dp_case(pair_mesh(rank, device), device, sd, n=4)
    for case in pit_cases:
        pit_case(make_mesh(*case["layout"], device=device), device, sd, case)

    from mapdit_tpu_torch.sample import load_variables, run_config
    from mapdit_tpu_torch.utils.experiment import load_config

    train_args = load_config(exp)
    cfg = run_config(train_args, None)
    exp_sd = load_variables(exp, train_args, None, 0.05)

    def dp_reference(args):
        d = create_diffusion("4", device=device)
        return build_dp_sharded_sample_fn(cfg, exp_sd, d, make_mesh(4, 1, device=device), cfg_scale=CFG_SCALE,
                                          clip_denoised=True, batch_hint=4, device=device), False

    def pit_reference(args):
        d = create_diffusion("ddim4", device=device)
        return build_pit_sample_fn(cfg, exp_sd, d, cfg_scale=CFG_SCALE, window=4, sweeps=2, clip_denoised=True,
                                   device=device), True

    def tp_reference(args):
        d = create_diffusion("4", device=device)
        return build_sample_fn(cfg, exp_sd, d, cfg_scale=CFG_SCALE, clip_denoised=True, batch_hint=4,
                               device=device), True

    fid_case(rank, device, exp, ["--kernel-sharding", "shard_map"], dp_reference)
    fid_case(rank, device, exp, ["--pit-window", "4", "--sampler", "ddim"], pit_reference)
    fid_case(rank, device, exp, ["--n-model", "2", "--block-kernel", "mega_tp"], tp_reference)
