"""Tensor-parallel (TP) and fully-sharded + tensor-parallel (FSDP + TP)
training of the port, the twins of JAX tests/test_parallel.py
test_dp4_tp2_matches_single_device (l.87), test_param_sharding_layout
(l.101), test_fsdp_with_tp_matches_single_device (l.130) and
test_fsdp_with_tp_combined_layout (l.176), with DiT-XS/8 and the global
batch of 16 of l.29-45.

On four gloo ranks spawned on the CPU, one process group, a (2, 2) mesh
(JAX runs these on (4, 2); the port's CPU ranks are processes, so the test
takes four):

  * TP and FSDP + TP against the port's one-device step from one seed:
    metrics, grad_norm, the whole gradients (the replicated modulation head,
    ``y_embedder`` and ``t_embedder`` by name: their gradients reach them
    only through the all-reduce of the column-parallel products' input) and
    every parameter at JAX's rtol 5e-4 / atol 5e-5; and against the JAX
    one-device step on carried weights with the JAX draws;
  * the forced weight normalization on slices split over either axis;
  * the scan_blocks layout against the per-block layout on the mesh;
  * a .pt and a torch-sharded checkpoint from (2, 2), resumed on (2, 2)
    and on one process;
  * after three steps every rank holds the same whole tree, replicated
    tensors and generator state.

In the test process: the port's TP and FSDP + TP layouts against JAX
``param_sharding`` on a (4, 2) mesh for every parameter and both Adam
moments, per-block and scan_blocks. The ranks' bodies live in
tests/torch_tp_train_ranks.py, which imports no JAX.
"""

import shutil

import jax
import numpy as np
import pytest
import torch

import torch_tp_train_ranks as ranks
from mapdit_tpu.models import build_config as jax_build_config
from mapdit_tpu.parallel import make_mesh as jax_make_mesh
from mapdit_tpu.parallel import param_sharding
from mapdit_tpu.training import create_optimizer as jax_create_optimizer
from mapdit_tpu.training import create_train_state as jax_create_train_state
from mapdit_tpu.training import warmup_flat_invsqrt as jax_schedule
from mapdit_tpu_torch.models import build_config, init_model
from mapdit_tpu_torch.parallel import Mesh, spawn
from mapdit_tpu_torch.training import create_optimizer, create_train_state
from mapdit_tpu_torch.parallel.mesh import PLAIN_TP, fsdp_layout, shard_state_dict, tp_dim, tp_layout
from mapdit_tpu_torch.utils.weights import state_dict_from_jax
from test_torch_dp_train import _jax_reference

torch.set_num_threads(2)
CPU = torch.device("cpu")


def test_tp_and_fsdp_tp_training_on_four_ranks(tmp_path):
    try:
        spawn(ranks.run_cases, 4, args=(_jax_reference(), str(tmp_path)), device="cpu")
    finally:
        shutil.rmtree(tmp_path, ignore_errors=True)


def _axis_dim(spec, axis):
    return next((i for i, a in enumerate(spec) if a == axis), -1)


@pytest.mark.parametrize("scan_blocks", [False, True], ids=["per-block", "scan_blocks"])
@pytest.mark.parametrize("fsdp", [False, True], ids=["tp", "fsdp+tp"])
def test_tp_layout_matches_jax(scan_blocks, fsdp):
    """The dim the model axis splits and the dim FSDP shards, for every
    parameter and both Adam moments, against JAX param_sharding on a (4, 2)
    mesh (TP takes qkv and fc1 rows, out-proj and fc2 columns; FSDP the
    free dim of those and the rows of the rest). The port splits qkv by
    whole heads on its (3, D, D) view where JAX splits its flat rows: the
    same dim, grouped otherwise."""
    jcfg = jax_build_config("DiT-XS/8", scan_blocks=scan_blocks, **ranks.XS8)
    jstate = jax_create_train_state(jcfg, jax_create_optimizer(jax_schedule(1e-2, 5, 50)), seed=0)
    jmesh = jax_make_mesh(n_data=4, n_model=2)

    def dims(shardings, axis):
        return {k: (None if d < 0 else int(d)) for k, d in state_dict_from_jax(
            {"params": jax.tree_util.tree_map(lambda s: np.asarray(_axis_dim(s.spec, axis)), shardings)}).items()}

    params_sh = param_sharding(jstate.params, jmesh, fsdp=fsdp)
    adam = param_sharding(jstate.opt_state, jmesh, fsdp=fsdp)[0]
    cfg = build_config("DiT-XS/8", scan_blocks=scan_blocks, **ranks.XS8)
    whole = dict(init_model(cfg, device=CPU).named_parameters())
    mesh = Mesh(4, 2, 0, CPU)
    model_dims = {k: tp_dim(where) for k, where in tp_layout(whole, cfg, 2).items()}
    local = shard_state_dict({k: p.detach() for k, p in whole.items()}, cfg, mesh, PLAIN_TP)
    data_dims = fsdp_layout(local, mesh, model_dims) if fsdp else dict.fromkeys(whole)
    for axis, got in (("model", model_dims), ("data", data_dims)):
        want = dims(params_sh, axis)
        assert got == want, axis
        assert dims(adam.mu, axis) == want and dims(adam.nu, axis) == want, axis
    off = int(scan_blocks)
    blk = "blocks." if scan_blocks else "blocks.0."
    assert model_dims[blk + "attn.qkv_proj.weight"] == off and model_dims[blk + "attn.out_proj.weight"] == off + 1
    assert model_dims[blk + "mlp.net.0.weight"] == off and model_dims[blk + "mlp.net.2.weight"] == off + 1
    assert model_dims[blk + "modulation.1.weight"] is None and model_dims["t_embedder.mlp.net.0.weight"] is None
    if fsdp:  # TP takes the out dim, FSDP lands on the free in dim (JAX l.176)
        assert data_dims[blk + "attn.qkv_proj.weight"] == off + 1 and data_dims[blk + "attn.out_proj.weight"] == off


@pytest.mark.parametrize("kernel, words", [("mega_tp", "inference-only TP layout"),
                                           ("mega_attn_tp", "inference-only TP layout"),
                                           ("mega", "single-device kernel"), ("mega_attn", "single-device kernel"),
                                           ("pallas", "single-device kernel")])
def test_tp_training_refuses_islands_and_single_device_kernels(kernel, words):
    """On a model axis training runs the plain path: the TP islands are
    inference-only (the JAX CLI's words, its train.py:124-129) and a
    single-device kernel cannot be split; both raise before any
    collective. auto and off run (the spawned cases)."""
    cfg = build_config("DiT-XS/8", block_kernel=kernel, **ranks.XS8)
    with pytest.raises(ValueError, match=words):
        create_train_state(cfg, create_optimizer(ranks.SCHEDULE), device=CPU, mesh=Mesh(1, 2, 0, CPU))

