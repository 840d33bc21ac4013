"""The data-parallel sampling layouts of the port on four gloo ranks spawned
on the CPU, in one process group (one spawn for every case; about a
minute, as tests/test_torch_tp.py):

  * ``build_dp_sharded_sample_fn`` on a (4, 1) mesh and on two (2, 1)
    meshes of rank pairs: each data rank's rows are the bits of the
    one-device chain on those rows under that rank's stream;
  * ``build_pit_sample_fn(mesh=)``, the window's rows over the data axis:
    on (4, 1) against the unsharded chains (the twins of
    tests/test_pit.py:90 and :165, whose JAX cases run on an 8-device
    axis), and on (2, 2) with the ``mega_tp`` islands on the model axis
    (the twin of tests/test_pit.py:112), held to JAX at rtol / atol 1e-4;
  * ``sample_fid`` in process on the four ranks: ``--kernel-sharding
    shard_map``, ``--pit-window`` and ``--n-model 2`` (gspmd with the
    islands), rank 0's npz against the layout's chain on the script's draws.

The ranks' bodies live in tests/torch_dp_ranks.py, which imports no JAX.
"""

import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_dp_ranks
from mapdit_tpu.diffusion import create_diffusion as jax_create_diffusion
from mapdit_tpu.models import build_config as jax_build_config
from mapdit_tpu.models import init_model as jax_init_model
from mapdit_tpu.runtime import build_pit_sample_fn as jax_build_pit_sample_fn
from mapdit_tpu.runtime import build_sample_fn as jax_build_sample_fn
from mapdit_tpu_torch import train
from mapdit_tpu_torch.diffusion import create_diffusion
from mapdit_tpu_torch.models import build_config, init_model
from mapdit_tpu_torch.parallel import Mesh, spawn
from mapdit_tpu_torch.runtime import (
    build_dp_sharded_sample_fn, build_pit_sample_fn, build_sample_fn, data_rank_generator,
)
from mapdit_tpu_torch.utils.weights import state_dict_from_jax

XS8 = torch_dp_ranks.XS8
CPU = torch.device("cpu")


def _jax(fn_builder, jcfg, variables, spacing, z, y, **kw):
    with jax.disable_jit():
        fn = fn_builder(jcfg, variables, jax_create_diffusion(spacing), clip_denoised=True, **kw)
        return np.asarray(fn(jnp.asarray(z), jnp.asarray(y), jax.random.PRNGKey(7)))


@pytest.fixture(scope="module")
def exp(tmp_path_factory):
    """A 2-step DiT-XS/8 run of the port's train CLI (10 classes)."""
    results = tmp_path_factory.mktemp("dp_run")
    yield train.main(train.build_parser().parse_args([
        "--device", "cpu", "--data-path", "synthetic:16", "--results-dir", str(results), "--model", "DiT-XS/8",
        "--num-classes", "10", "--batch-size", "8", "--num-steps", "2", "--log-every", "1", "--ckpt-every", "2",
        "--ema-snapshot-every", "1"]))
    shutil.rmtree(results, ignore_errors=True)


def test_mesh_layouts_on_four_ranks(exp):
    jcfg = jax_build_config("DiT-XS/8", **XS8)
    _, variables = jax_init_model(jcfg, seed=0)
    cfg = build_config("DiT-XS/8", **XS8)
    sd = state_dict_from_jax(variables, cfg)
    rng = np.random.default_rng(6)
    pit_cases = []
    # test_pit.py:90: one sample, window 8, full sweeps: the sequential chain
    z1, y1 = rng.normal(size=(1, 4, 16, 16)).astype(np.float32), np.zeros(1, np.int32)
    port_plain = build_pit_sample_fn(cfg, sd, create_diffusion("8", device=CPU), window=8, sweeps=8,
                                     clip_denoised=True, device=CPU)(torch.from_numpy(z1), torch.zeros(1).long())
    pit_cases.append(dict(name="(4,1) window 8 sweeps 8", layout=(4, 1), kernel="auto", spacing="8",
                          pit=dict(window=8, sweeps=8), z=z1, y=y1,
                          refs={"jax-sequential": _jax(jax_build_sample_fn, jcfg, variables, "8", z1, y1,
                                                       sampler="ddim"),
                                "port-unsharded": port_plain.numpy()}))
    # test_pit.py:165: the sliding schedule, window 8, shift 2
    port_plain = build_pit_sample_fn(cfg, sd, create_diffusion("8", device=CPU), window=8, shift=2,
                                     clip_denoised=True, device=CPU)(torch.from_numpy(z1), torch.zeros(1).long())
    pit_cases.append(dict(name="(4,1) window 8 shift 2", layout=(4, 1), kernel="auto", spacing="8",
                          pit=dict(window=8, shift=2), z=z1, y=y1,
                          refs={"jax-unsharded": _jax(jax_build_pit_sample_fn, jcfg, variables, "8", z1, y1,
                                                      window=8, shift=2),
                                "port-unsharded": port_plain.numpy()}))
    # test_pit.py:112: pit rows over 'data' x the islands over 'model'
    z2, y2 = rng.normal(size=(2, 4, 16, 16)).astype(np.float32), np.arange(2, dtype=np.int32)
    pit_cases.append(dict(name="(2,2) mega_tp window 4 sweeps 4", layout=(2, 2), kernel="mega_tp", spacing="4",
                          pit=dict(window=4, sweeps=4), z=z2, y=y2,
                          refs={"jax-sequential": _jax(jax_build_sample_fn, jcfg, variables, "4", z2, y2,
                                                       sampler="ddim")}))
    spawn(torch_dp_ranks.run_cases, 4, args=({k: v.numpy() for k, v in sd.items()}, pit_cases, exp), device="cpu")


def test_dp_sharded_on_one_rank_is_the_one_device_chain():
    """A hand-built one-rank mesh (no process group) runs the one-device
    chain with the rank's stream; a model axis is refused."""
    cfg = build_config("DiT-XS/8", **XS8)
    sd = init_model(cfg, seed=1, device=CPU).state_dict()
    d = create_diffusion("3", device=CPU)
    z, y = torch.randn(2, 4, 16, 16, generator=torch.Generator().manual_seed(0)), torch.tensor([1, 2])
    got = build_dp_sharded_sample_fn(cfg, sd, d, Mesh(1, 1, 0, CPU), cfg_scale=1.5, clip_denoised=True)(
        z, y, torch.Generator().manual_seed(4))
    want = build_sample_fn(cfg, sd, d, cfg_scale=1.5, clip_denoised=True, device=CPU)(
        torch.cat([z, z]), torch.tensor([1, 2, 10, 10]), data_rank_generator(torch.Generator().manual_seed(4), 0, CPU))
    assert got.shape == z.shape and torch.equal(got, want[:2])
    with pytest.raises(ValueError, match="data-parallel only"):
        build_dp_sharded_sample_fn(cfg, sd, d, Mesh(1, 2, 0, CPU))
