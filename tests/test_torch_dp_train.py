"""Data-parallel (DP) and fully-sharded (FSDP) training of the port on four
gloo ranks spawned on the CPU, in one process group (one spawn for every
mesh case), with DiT-XS/8 and the global batch of 16 of JAX
tests/test_parallel.py:29-45:

  * DP (4, 1) against the port's one-device step from one seed (the twin of
    JAX test_parallel.py:68), and with the JAX step's draws against the JAX
    one-device step on carried weights;
  * FSDP (4, 1) against DP and against one device (l.112), its held
    tensors, Adam moments and EMA copies in the shard shapes;
  * grad_accum=2 on (4, 1) (l.186);
  * the loss-history sampler's gathered update against the one-device
    update on the concatenated pairs, and a DP step's history;
  * the forced weight normalization on a column-sharded weight;
  * the checkpoint formats: a torch-sharded checkpoint written by 4 or 2
    ranks resumed on 1, 2 and 4, the gathered .pt beside it;
  * the background writers (the async checkpoint, the gathered EMA
    snapshot) write the step they were handed after a later step has
    changed the live tensors;
  * after three steps every rank holds the same weights, EMA copies and
    generator state.

The tolerances are those of tests/test_torch_train.py
test_grad_accum_matches_jax_and_unaccumulated (the sums run in another
order) and, against JAX, test_train_step_matches_jax's. In the test process:
``fsdp_layout`` against JAX ``param_sharding(..., fsdp=True)`` for every
parameter and Adam moment, per-block and scan_blocks (l.143). The ranks'
bodies live in tests/torch_dp_train_ranks.py, which imports no JAX.
"""

import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_dp_train_ranks as ranks
from mapdit_tpu.diffusion import create_diffusion as jax_create_diffusion
from mapdit_tpu.models import build_config as jax_build_config
from mapdit_tpu.parallel import make_mesh as jax_make_mesh
from mapdit_tpu.parallel import param_sharding
from mapdit_tpu.training import create_optimizer as jax_create_optimizer
from mapdit_tpu.training import create_train_state as jax_create_train_state
from mapdit_tpu.training import make_train_step as jax_make_train_step
from mapdit_tpu.training import warmup_flat_invsqrt as jax_schedule
from mapdit_tpu.training.data import SyntheticLatentDataset as JaxSyntheticLatentDataset
from mapdit_tpu_torch.models import build_config, init_model
from mapdit_tpu_torch.parallel import Mesh, spawn
from mapdit_tpu_torch.parallel.mesh import fsdp_layout
from mapdit_tpu_torch.utils.weights import state_dict_from_jax

torch.set_num_threads(2)
CPU = torch.device("cpu")


def _jax_reference():
    """The JAX one-device step on the global batch (model_train=False, as
    tests/test_torch_train.py's twin): its draws, metrics and parameters,
    and its initial weights by the port's names."""
    jcfg = jax_build_config("DiT-XS/8", **ranks.XS8)
    ds = JaxSyntheticLatentDataset(num_examples=64, num_classes=10)
    tx = jax_create_optimizer(jax_schedule(1e-2, 5, 50))
    jstate = jax_create_train_state(jcfg, tx, seed=0)
    batch = next(ds.batches(batch_size=ranks.BATCH, seed=0))
    _, rng_noise, rng_t, _, rng_post = jax.random.split(jstate.rng, 5)
    mean = jnp.asarray(batch["mean"])
    draws = {
        "posterior_eps": np.asarray(jax.random.normal(rng_post, mean.shape, mean.dtype)),
        "t": np.asarray(jax.random.randint(rng_t, (ranks.BATCH,), 0, 1000)),
        "noise": np.asarray(jax.random.normal(rng_noise, mean.shape, mean.dtype)),
    }
    step = jax.jit(jax_make_train_step(jcfg, jax_create_diffusion(""), tx, stats_mean=jnp.asarray(ds.stats["mean"]),
                                       stats_std=jnp.asarray(ds.stats["std"]), model_train=False))
    sd = state_dict_from_jax({"params": jstate.params, "constants": jstate.constants}, build_config("DiT-XS/8", **ranks.XS8))
    jstate, metrics = step(jstate, batch)
    return {
        "state_dict": {k: v.numpy() for k, v in sd.items()},
        "draws": draws,
        "metrics": {k: float(metrics[k]) for k in ("loss", "mse", "vb", "grad_norm")},
        "params": {k: v.numpy() for k, v in state_dict_from_jax({"params": jstate.params}).items()},
    }


def test_dp_and_fsdp_training_on_four_ranks(tmp_path):
    try:
        spawn(ranks.run_cases, 4, args=(_jax_reference(), str(tmp_path)), device="cpu")
    finally:
        shutil.rmtree(tmp_path, ignore_errors=True)


def _data_dim(spec):
    return next((i for i, axis in enumerate(spec) if axis == "data"), -1)


@pytest.mark.parametrize("scan_blocks", [False, True], ids=["per-block", "scan_blocks"])
@pytest.mark.parametrize("n_data", [3, 4, 8])
def test_fsdp_layout_matches_jax(scan_blocks, n_data):
    """fsdp_layout against JAX param_sharding(..., fsdp=True) on an n-device
    data axis, for every parameter and both Adam moments (the twin of JAX
    test_parallel.py:143); the dims that n does not divide stay whole."""
    jcfg = jax_build_config("DiT-XS/8", scan_blocks=scan_blocks, **ranks.XS8)
    jstate = jax_create_train_state(jcfg, jax_create_optimizer(jax_schedule(1e-2, 5, 50)), seed=0)
    jmesh = jax_make_mesh(n_data=n_data, devices=jax.devices()[:n_data])

    def dims(shardings):
        return {k: (None if d < 0 else int(d)) for k, d in state_dict_from_jax(
            {"params": jax.tree_util.tree_map(lambda s: np.asarray(_data_dim(s.spec)), shardings)}).items()}

    want = dims(param_sharding(jstate.params, jmesh, fsdp=True))
    adam = param_sharding(jstate.opt_state, jmesh, fsdp=True)[0]
    model = init_model(build_config("DiT-XS/8", scan_blocks=scan_blocks, **ranks.XS8), device=CPU)
    got = fsdp_layout(dict(model.named_parameters()), Mesh(n_data, 1, 0, CPU))
    assert got == want
    assert dims(adam.mu) == want and dims(adam.nu) == want
    assert got["y_embedder.embedding.weight"] is None and got["t_embedder.mlp.net.0.weight"] is None
    assert any(d is not None for d in got.values())
    params = dict(model.named_parameters())
    assert all(d is None or params[k].shape[d] % n_data == 0 for k, d in got.items())
