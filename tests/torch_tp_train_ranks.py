"""Rank bodies of ``tests/test_torch_tp_train.py``: tensor-parallel (TP) and
fully-sharded + tensor-parallel (FSDP + TP) training on spawned gloo ranks,
held against the port's one-device step (computed by each rank on the whole
batch) and against the JAX package's one-device step (arrays the test
process computed).

A spawned rank re-imports the module that defines its target, so this
module imports torch and the port only, never JAX.
"""

import os

import numpy as np
import torch
import torch.distributed as dist

from mapdit_tpu_torch.models import build_config
from mapdit_tpu_torch.models.dit import forced_wn, stack_block_params
from mapdit_tpu_torch.ops.mp import normalize
from mapdit_tpu_torch.parallel.mesh import Mesh, check_replicated, make_mesh
from mapdit_tpu_torch.training import checkpoint as ckpt

from torch_dp_train_ranks import GRAD_ATOL, SCHEDULE, XS8, Trainer, assert_step_close, tree_mismatch, whole

# JAX tests/test_parallel.py:87 and :130 (the GSPMD step against the
# one-device step), held on every parameter against the port's one-device
# step and the JAX one, on the elements whose first-step gradient lies above
# the float32 noise of its sums (the rule of tests/torch_dp_train_ranks.py:
# Adam's first step is lr * g / (|g| + eps), so a gradient within that noise
# of 0 may move its element by up to 2 lr either way); every element is held
# within JAX_LR_BOUND learning rates (the JAX twin's bound,
# tests/test_torch_train.py test_train_step_matches_jax)
RTOL, ATOL = 5e-4, 5e-5
JAX_LR_BOUND = 2.1
# the JAX twin's metric tolerance (tests/test_torch_train.py test_train_step_matches_jax)
JAX_METRIC_RTOL = 2e-4
# the tensors every model rank holds whole, whose gradients reach them only
# through the entry all-reduce of the column-parallel products
REPLICATED_PROBES = ("blocks.0.modulation.1.weight", "blocks.5.modulation.1.weight", "y_embedder.embedding.weight",
                     "t_embedder.mlp.net.0.weight", "t_embedder.mlp.net.2.weight", "x_embedder.weight")


def whole_grads(state):
    """The averaged gradients as the one-device tree (gathered over both
    axes)."""
    if state.dp is None:
        return {k: p.grad.clone() for k, p in state.params.items()}
    return whole(state.dp.gather({k: t.grad for k, t in state.held.items()}))


def whole_params(state):
    if state.dp is None:
        return whole(state.params)
    return whole(state.dp.gather_model(state.params))


def run(trainer, steps, mesh=None, fsdp=False, draws=None, state=None):
    """``steps`` steps of ``trainer`` on its batch; returns the state and the
    first step's metrics, whole gradients and whole parameters."""
    state = state or trainer.state(mesh, fsdp)
    step = trainer.step_fn(mesh, fsdp)
    first = None
    for i in range(steps):
        m = step(state, trainer.rows(mesh), draws=draws if i == 0 else None)
        if i == 0:
            first = {"metrics": {k: float(v) for k, v in m.items()}, "grads": whole_grads(state),
                     "params": whole_params(state)}
    return state, first


def assert_params_close(got, want, grads, what, rtol=RTOL, atol=ATOL):
    """Every parameter after one step: at ``rtol`` / ``atol`` where the
    first step's gradient ``grads`` (one device) is settled, within
    JAX_LR_BOUND learning rates everywhere."""
    for name, w in want.items():
        w = torch.as_tensor(w)
        g = grads[name]
        settled = g.abs() > GRAD_ATOL * float(g.abs().max()) + 1e-7
        np.testing.assert_allclose(got[name][settled].numpy(), w[settled].numpy(), rtol=rtol, atol=atol,
                                   err_msg=f"{what}: {name}")
        err = float((got[name] - w).abs().max()) / SCHEDULE(0)
        assert err < JAX_LR_BOUND, (what, name, err)


def assert_replicas(state, device):
    """Every rank holds the same whole weights, EMA copies and generator
    state, and the ranks of a model group the same tensors that the model
    axis does not split."""
    tree = whole_params(state)
    for key, ema in state.ema.items():
        tree.update({f"ema{key}.{name}": t for name, t in state.dp.gather(ema).items()})
    tree["generator"] = state.generator.get_state()
    check_replicated(tree, device)
    split = set(state.dp.tp_split)
    check_replicated({k: v.detach() for k, v in state.params.items() if k not in split}, device)


def step_cases(device, mesh):
    """TP and FSDP + TP on (2, 2) against the port's one-device step from
    one seed: metrics (grad_norm included), the whole gradients, the
    replicated tensors' gradients by name, every parameter after one step;
    three steps on, the replicas agree."""
    t = Trainer(device)
    _, one = run(t, 1)
    for fsdp in (False, True):
        what = f"{'fsdp+tp' if fsdp else 'tp'} (2,2) vs one device"
        state, got = run(t, 3, mesh, fsdp=fsdp)
        assert state.dp.tp_split and (state.dp.sharded if fsdp else not state.dp.sharded), what
        assert_step_close(got, one, what)
        for name in REPLICATED_PROBES:
            g, want = got["grads"][name], one["grads"][name]
            torch.testing.assert_close(g, want, rtol=RTOL, atol=ATOL * float(want.abs().max()),
                                       msg=f"{what}: replicated grad {name}")
        np.testing.assert_allclose(got["metrics"]["grad_norm"], one["metrics"]["grad_norm"], rtol=1e-5,
                                   err_msg=f"{what}: grad_norm")
        assert_params_close(got["params"], one["params"], one["grads"], what)
        assert_replicas(state, device)


def jax_case(device, mesh, ref):
    """TP and FSDP + TP on (2, 2) with the JAX step's draws (the global
    batch's) against the JAX one-device step on carried weights."""
    t = Trainer(device, model_train=False)
    sd = {k: torch.from_numpy(v) for k, v in ref["state_dict"].items()}
    draws = {k: torch.from_numpy(v) for k, v in ref["draws"].items()}
    _, one = run(t, 1, draws=draws, state=t.state(state_dict=sd))  # its gradients say which elements settled
    for fsdp in (False, True):
        what = f"jax twin {'fsdp+tp' if fsdp else 'tp'} (2,2)"
        _, got = run(t, 1, mesh, fsdp=fsdp, draws=draws, state=t.state(mesh, fsdp, state_dict=sd))
        for key, want in ref["metrics"].items():
            np.testing.assert_allclose(got["metrics"][key], want, rtol=JAX_METRIC_RTOL, err_msg=f"{what}: {key}")
        assert_params_close(got["params"], ref["params"], one["grads"], what)


def projection_case(device, mesh):
    """The forced weight normalization on FSDP + TP slices (columns split
    over the model group, the data group, or rows split) equals the slice
    of the whole tree projected on one device."""
    t = Trainer(device)
    state = t.state(mesh, fsdp=True)
    dp = state.dp
    gen = torch.Generator().manual_seed(7)
    whole_tree = {k: torch.randn(dp.whole_shape(k), generator=gen) * 3 for k in dp.held}
    with torch.no_grad():
        for name, held in dp.held.items():
            held.copy_(dp.held_part(whole_tree[name], name))
    dp.project(t.cfg)
    got = dp.gather(dp.held)
    kinds = set()
    for name, w in whole_tree.items():
        if not forced_wn(name, w, t.cfg):
            continue
        kinds.add((dp.layout[name], dp.tp_layout[name] and dp.tp_layout[name][0]))
        torch.testing.assert_close(got[name], normalize(w), rtol=1e-6, atol=1e-6, msg=f"projected {name}")
    assert {(0, "cols"), (1, "rows"), (1, "qkv"), (0, None), (None, None)} <= kinds, kinds


def scan_case(device, mesh):
    """The scan_blocks layout on (2, 2), TP and FSDP + TP, against the
    per-block layout on the same mesh (one seed gives the same weights in
    both): the same metrics and, stacked, the same parameters."""
    per_block, scan = Trainer(device), Trainer(device, cfg=build_config("DiT-XS/8", scan_blocks=True, **XS8))
    depth = per_block.cfg.depth
    for fsdp in (False, True):
        what = f"scan_blocks {'fsdp+tp' if fsdp else 'tp'} (2,2) vs per-block"
        _, want = run(per_block, 1, mesh, fsdp=fsdp)
        state, got = run(scan, 2, mesh, fsdp=fsdp)
        assert any(k.startswith("blocks.") for k in state.dp.tp_split), state.dp.tp_split
        for key, w in want["metrics"].items():
            np.testing.assert_allclose(got["metrics"][key], w, rtol=1e-5, err_msg=f"{what}: {key}")
        assert_params_close(got["params"], stack_block_params(want["params"], depth),
                            stack_block_params(want["grads"], depth), what, rtol=1e-5, atol=1e-6)
        assert_replicas(state, device)


def checkpoint_cases(device, mesh, rank, tmp):
    """A .pt and a torch-sharded checkpoint written on (2, 2) under FSDP +
    TP hold the one-device tree (the same tensors in both files); each
    resumes on (2, 2) (the writer's own next step, bit for bit) and on one
    process (held to the tolerance of a reduction order); a TP-only mesh
    resumes them too."""
    t = Trainer(device)
    state, _ = run(t, 2, mesh, fsdp=True)
    exp = os.path.join(tmp, "tp-ckpt")
    shards = ckpt.save_sharded(exp, 2, state)
    pt = ckpt.save_state(exp, 2, state)
    saver = ckpt.AsyncStateSaver()
    pt_async = saver.save(os.path.join(tmp, "tp-ckpt-async"), 2, state)
    saver.close()
    dist.barrier()
    if rank == 0:
        gathered = torch.load(pt, weights_only=True)
        assert sorted(os.listdir(shards)) == ["index.pt", "rank00000.pt", "rank00001.pt"], os.listdir(shards)
        mismatch = tree_mismatch(ckpt._read_sharded(shards), gathered)
        assert mismatch is None, f"the sharded and the gathered checkpoints differ at {mismatch}"
        mismatch = tree_mismatch(torch.load(pt_async, weights_only=True), gathered)
        assert mismatch is None, f"the background and the synchronous checkpoints differ at {mismatch}"
        one = t.state()
        assert all(tuple(v.shape) == tuple(one.params[k].shape) for k, v in gathered["model"].items() if k in one.params)
    dist.barrier()
    _, ref = run(t, 1, mesh, fsdp=True, state=state)
    for path in (shards, pt):
        _, again = run(t, 1, mesh, fsdp=True, state=ckpt.restore_state(path, t.state(mesh, True, seed=1)))
        assert again["metrics"] == ref["metrics"], (path, again["metrics"], ref["metrics"])
        assert all(torch.equal(again["params"][k], v) for k, v in ref["params"].items()), path
        _, on_tp = run(t, 1, mesh, state=ckpt.restore_state(path, t.state(mesh, seed=1)))
        assert_step_close(on_tp, ref, f"{os.path.basename(path)} resumed on (2,2) TP without FSDP")
        one_state = ckpt.restore_state(path, t.state(seed=1))
        assert one_state.step == 2
        _, on_one = run(t, 1, state=one_state)
        assert_step_close(on_one, ref, f"{os.path.basename(path)} resumed on one process")


def run_cases(rank, device, jax_ref, tmp):
    """Every mesh case of the test in one process group of four ranks."""
    torch.set_num_threads(1)
    mesh = make_mesh(2, 2, device=device)
    assert (mesh.data_index, mesh.model_index) == divmod(rank, 2)
    step_cases(device, mesh)
    jax_case(device, mesh, jax_ref)
    projection_case(device, mesh)
    scan_case(device, mesh)
    checkpoint_cases(device, mesh, rank, tmp)
