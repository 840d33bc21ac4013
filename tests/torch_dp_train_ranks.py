"""Rank bodies of ``tests/test_torch_dp_train.py``: data-parallel and
fully-sharded training on spawned gloo ranks, held against the port's
one-device step (computed by each rank on the whole batch) and against the
JAX package's one-device step (arrays the test process computed).

A spawned rank re-imports the module that defines its target, so this
module imports torch and the port only, never JAX.
"""

import os
import threading

import numpy as np
import torch
import torch.distributed as dist

from mapdit_tpu_torch.diffusion import create_diffusion
from mapdit_tpu_torch.diffusion.timestep_sampler import LossSecondMomentResampler
from mapdit_tpu_torch.models import build_config
from mapdit_tpu_torch.ops.mp import normalize
from mapdit_tpu_torch.parallel.data_parallel import DataParallel
from mapdit_tpu_torch.parallel.mesh import Mesh, check_replicated, make_mesh
from mapdit_tpu_torch.training import (
    SyntheticLatentDataset,
    create_optimizer,
    create_train_state,
    make_train_step,
    warmup_flat_invsqrt,
)
from mapdit_tpu_torch.training import checkpoint as ckpt

XS8 = dict(in_channels=4, input_size=16, num_classes=10)
BATCH = 16  # the global batch of JAX tests/test_parallel.py:29-45
SCHEDULE = warmup_flat_invsqrt(1e-2, 5, 50)
# the tolerances of tests/test_torch_train.py test_grad_accum_matches_jax_and_unaccumulated:
# f32 sums in another order
METRIC_RTOL = 1e-5
GRAD_ATOL = 1e-5  # of each tensor's largest gradient element
PARAM_ATOL = 1e-5  # where the first step's gradient is above that noise floor
# the JAX twin's (tests/test_torch_train.py test_train_step_matches_jax)
JAX_RTOL = 2e-4
JAX_LR_BOUND = 2.1


class Trainer:
    """One configuration's train states and steps on one layout."""

    def __init__(self, device, cfg=None, **step_kw):
        self.device = device
        self.cfg = cfg or build_config("DiT-XS/8", **XS8)
        self.ds = SyntheticLatentDataset(num_examples=64, num_classes=10)
        self.batch = next(self.ds.batches(batch_size=BATCH, seed=0))
        self.tx = create_optimizer(SCHEDULE)
        self.diffusion = create_diffusion("", device=device)
        self.step_kw = step_kw

    def state(self, mesh=None, fsdp=False, seed=0, state_dict=None):
        return create_train_state(self.cfg, self.tx, seed=seed, device=self.device, state_dict=state_dict, mesh=mesh,
                                  fsdp=fsdp, timestep_sampler=self.step_kw.get("timestep_sampler", "uniform"))

    def step_fn(self, mesh=None, fsdp=False):
        return make_train_step(self.cfg, self.diffusion, self.tx, self.ds.stats["mean"], self.ds.stats["std"],
                               mesh=mesh, fsdp=fsdp, **self.step_kw)

    def rows(self, mesh):
        """This rank's rows of the global batch (all of it on one device)."""
        if mesh is None:
            return self.batch
        n = BATCH // mesh.n_data
        return {k: v[mesh.data_index * n : (mesh.data_index + 1) * n] for k, v in self.batch.items()}

    def run(self, steps, mesh=None, fsdp=False, draws=None, state=None):
        """``steps`` steps on the batch; returns the state and the first
        step's metrics, whole gradients and whole parameters."""
        state = state or self.state(mesh, fsdp)
        step = self.step_fn(mesh, fsdp)
        first = None
        for i in range(steps):
            m = step(state, self.rows(mesh), draws=draws if i == 0 else None)
            if i == 0:
                first = {"metrics": {k: float(v) for k, v in m.items()}, "grads": whole_grads(state),
                         "params": whole(state.params)}
        return state, first


def whole(tree):
    return {k: v.detach().clone() for k, v in tree.items()}


def whole_grads(state):
    if state.dp is None:
        return {k: p.grad.clone() for k, p in state.params.items()}
    return whole(state.dp.gather({k: t.grad for k, t in state.held.items()}))


def assert_step_close(got, want, what):
    """One step against another at the tolerances of the grad-accum twin."""
    for key, w in want["metrics"].items():
        np.testing.assert_allclose(got["metrics"][key], w, rtol=METRIC_RTOL, err_msg=f"{what}: {key}")
    for name, g in want["grads"].items():
        scale = float(g.abs().max()) + 1e-12
        np.testing.assert_allclose(got["grads"][name].numpy() / scale, g.numpy() / scale, rtol=0, atol=GRAD_ATOL,
                                   err_msg=f"{what}: grad {name}")
        settled = g.abs() > GRAD_ATOL * scale + 1e-7
        np.testing.assert_allclose(got["params"][name][settled].numpy(), want["params"][name][settled].numpy(),
                                   rtol=0, atol=PARAM_ATOL, err_msg=f"{what}: param {name}")


def assert_replicated(state, device):
    """Every rank holds the same whole weights, EMA copies (gathered under
    FSDP) and generator state."""
    tree = dict(state.params)
    for key, ema in state.ema.items():
        full = ema if state.dp is None else state.dp.gather(ema)
        tree.update({f"ema{key}.{name}": t for name, t in full.items()})
    tree["generator"] = state.generator.get_state()
    check_replicated(tree, device)


def assert_held_layout(state):
    """Under FSDP the held tensors, their Adam moments and the EMA copies
    have the shard shapes of fsdp_layout, by parameter name."""
    dp = state.dp
    params = list(state.optimizer.param_groups[0]["params"])
    for name, t in dp.held.items():
        want = dp.shard_shape(name)
        assert tuple(t.shape) == want, (name, tuple(t.shape), want)
        moments = state.optimizer.state[params[list(dp.held).index(name)]]
        assert tuple(moments["exp_avg"].shape) == want and tuple(moments["exp_avg_sq"].shape) == want, name
        assert all(tuple(ema[name].shape) == want for ema in state.ema.values()), name
    assert dp.sharded and dp.replicated, "XS/8 on 4 ranks shards some parameters and replicates others"


def pair_mesh(rank, device):
    """A (2, 1) mesh of ranks {0, 1} or {2, 3}: every rank creates both
    groups (``dist.new_group`` is collective) and keeps its pair's."""
    groups = [dist.new_group([0, 1]), dist.new_group([2, 3])]
    return Mesh(2, 1, rank % 2, torch.device(device), data_group=groups[rank // 2])


def dp_and_fsdp_cases(device, mesh):
    """DP and FSDP (4, 1) against the one-device step from one seed (no
    injected draws), three steps, replicas identical."""
    t = Trainer(device)
    _, one = t.run(1)
    dp_state, dp = t.run(3, mesh)
    assert_step_close(dp, one, "dp (4,1) vs one device")
    assert_replicated(dp_state, device)
    fsdp_state, fsdp = t.run(3, mesh, fsdp=True)
    assert_held_layout(fsdp_state)
    assert_step_close(fsdp, one, "fsdp (4,1) vs one device")
    assert_step_close(fsdp, dp, "fsdp (4,1) vs dp")
    assert_replicated(fsdp_state, device)
    # three steps on: FSDP against DP (the same draws and the same sums but
    # the reduce-scatter's and the global norm's)
    for name, p in dp_state.params.items():
        np.testing.assert_allclose(fsdp_state.params[name].detach().numpy(), p.detach().numpy(), rtol=0, atol=PARAM_ATOL,
                                   err_msg=f"fsdp vs dp after 3 steps: {name}")


def jax_case(device, mesh, ref):
    """DP (4, 1) with the JAX step's draws (the global batch's) against the
    JAX one-device step on carried weights."""
    t = Trainer(device, model_train=False)
    sd = {k: torch.from_numpy(v) for k, v in ref["state_dict"].items()}
    draws = {k: torch.from_numpy(v) for k, v in ref["draws"].items()}
    for fsdp in (False, True):
        state, got = t.run(1, mesh, fsdp=fsdp, draws=draws, state=t.state(mesh, fsdp, state_dict=sd))
        for key, want in ref["metrics"].items():
            np.testing.assert_allclose(got["metrics"][key], want, rtol=JAX_RTOL, err_msg=f"jax twin fsdp={fsdp}: {key}")
        lr = SCHEDULE(0)
        for name, want in ref["params"].items():
            err = np.abs(state.params[name].detach().numpy() - want).max() / lr
            assert err < JAX_LR_BOUND, (fsdp, name, err)


def grad_accum_case(device, mesh):
    """grad_accum=2 on (4, 1) against the unaccumulated one-device step
    (the twin of JAX test_parallel.py:186)."""
    _, one = Trainer(device).run(1)
    for fsdp in (False, True):
        _, acc = Trainer(device, grad_accum=2).run(1, mesh, fsdp=fsdp)
        assert_step_close(acc, one, f"grad_accum=2 on (4,1) fsdp={fsdp} vs one device")


def sampler_cases(device, mesh, rank):
    """The loss-history sampler: the gathered update against the
    one-device update on the concatenated pairs (bit for bit), and a DP
    step's metrics and history against the one-device step's (the same t
    draws; each rank's per-sample losses come from a batch of its rows)."""
    sampler = LossSecondMomentResampler(1000, history_per_term=3)
    warm = sampler.update_with_local_losses(
        sampler.init_state(device), torch.arange(1000).repeat(2), torch.rand(2000, generator=torch.Generator().manual_seed(9)))

    def pairs(r):
        gen = torch.Generator().manual_seed(100 + r)
        return torch.randint(0, 1000, (600,), generator=gen), torch.rand(600, generator=gen)

    ts, losses = pairs(rank)
    got = sampler.update_with_local_losses(warm, ts, losses, group=mesh.data_group)
    all_pairs = [pairs(r) for r in range(mesh.n_data)]
    want = sampler.update_with_local_losses(warm, torch.cat([p[0] for p in all_pairs]), torch.cat([p[1] for p in all_pairs]))
    assert torch.equal(got.history, want.history) and torch.equal(got.counts, want.counts)

    t = Trainer(device, timestep_sampler="loss-second-moment")
    one_state, one = t.run(1)
    dp_state, dp = t.run(1, mesh)
    for key, want in one["metrics"].items():
        np.testing.assert_allclose(dp["metrics"][key], want, rtol=METRIC_RTOL, err_msg=f"loss-second-moment dp: {key}")
    assert torch.equal(dp_state.sampler_state.counts, one_state.sampler_state.counts)
    torch.testing.assert_close(dp_state.sampler_state.history, one_state.sampler_state.history, rtol=METRIC_RTOL,
                               atol=1e-6)


class _Toy(torch.nn.Module):
    """Two weights named as the model's: a (6, 8) out-projection, whose
    rows 4 ranks do not divide (FSDP falls back to its columns), and an
    (8, 6) qkv whose rows they do."""

    def __init__(self):
        super().__init__()
        self.blocks = torch.nn.ModuleList([torch.nn.Module()])
        self.blocks[0].attn = torch.nn.Module()
        self.blocks[0].attn.out_proj = torch.nn.Linear(8, 6, bias=False)
        self.blocks[0].attn.qkv_proj = torch.nn.Linear(6, 8, bias=False)


def projection_case(device, mesh):
    """project_weights on a column-sharded weight: the squared row sums
    all-reduced, against normalize on the whole weight."""
    toy = _Toy().to(device)
    with torch.no_grad():
        for p in toy.parameters():
            p.copy_(torch.randn(p.shape, generator=torch.Generator().manual_seed(p.numel())) * 3)
    want = {k: normalize(p.detach()) for k, p in toy.named_parameters()}
    dp = DataParallel(toy, mesh, fsdp=True)
    assert dp.layout == {"blocks.0.attn.out_proj.weight": 1, "blocks.0.attn.qkv_proj.weight": 0}, dp.layout
    dp.project(build_config("DiT-XS/8", **XS8))
    got = dp.gather(dp.held)
    assert torch.equal(got["blocks.0.attn.qkv_proj.weight"], want["blocks.0.attn.qkv_proj.weight"])
    torch.testing.assert_close(got["blocks.0.attn.out_proj.weight"], want["blocks.0.attn.out_proj.weight"],
                               rtol=1e-6, atol=1e-7)


def checkpoint_cases(device, mesh, rank, tmp):
    """A torch-sharded checkpoint written by 4 ranks (and the gathered .pt
    beside it, written on the calling thread and from the background
    writer) resumes on 4 ranks (the same bits), on 2 and on 1, and one
    written by 2 ranks resumes on 4; each resumed step is held against the
    writer's own next step."""
    t = Trainer(device)
    state, _ = t.run(2, mesh, fsdp=True)
    exp4 = os.path.join(tmp, "four")
    shards = ckpt.save_sharded(exp4, 2, state)
    pt = ckpt.save_state(exp4, 2, state)  # --checkpointer torch-sync: the lead writes it
    saver = ckpt.AsyncStateSaver()  # --checkpointer torch
    pt_async = saver.save(os.path.join(tmp, "four-async"), 2, state)
    saver.close()
    dist.barrier()
    assert ckpt.latest_checkpoint(exp4) == pt and os.path.isdir(shards)
    if rank == 0:
        gathered = torch.load(pt, weights_only=True)
        mismatch = tree_mismatch(ckpt._read_sharded(shards), gathered)
        assert mismatch is None, f"the sharded and the gathered checkpoints differ at {mismatch}"
        mismatch = tree_mismatch(torch.load(pt_async, weights_only=True), gathered)
        assert mismatch is None, f"the background and the synchronous checkpoints differ at {mismatch}"
    dist.barrier()
    _, ref = t.run(1, mesh, fsdp=True, state=state)

    for path in (shards, pt):
        _, again = t.run(1, mesh, fsdp=True, state=ckpt.restore_state(path, t.state(mesh, True, seed=1)))
        assert again["metrics"] == ref["metrics"], (path, again["metrics"], ref["metrics"])
        assert all(torch.equal(again["params"][k], v) for k, v in ref["params"].items()), path

    pair = pair_mesh(rank, device)
    _, on_two = t.run(1, pair, fsdp=True, state=ckpt.restore_state(shards, t.state(pair, True, seed=1)))
    assert_step_close(on_two, ref, "4-rank shards resumed on 2 ranks")
    one_state = ckpt.restore_state(shards, t.state(seed=1))
    assert one_state.step == 2
    _, on_one = t.run(1, state=one_state)
    assert_step_close(on_one, ref, "4-rank shards resumed on 1 process")

    # both pairs train the same (one seed, one global batch), each into a
    # directory of its own; the four ranks resume the pair {0, 1}'s
    pair_state, _ = t.run(2, pair, fsdp=True)
    ckpt.save_sharded(os.path.join(tmp, f"pair{rank // 2}"), 2, pair_state)
    _, pair_ref = t.run(1, pair, fsdp=True, state=pair_state)
    dist.barrier()
    pair_dir = ckpt.sharded_path(os.path.join(tmp, "pair0"), 2)
    _, on_four = t.run(1, mesh, fsdp=True, state=ckpt.restore_state(pair_dir, t.state(mesh, True, seed=1)))
    assert_step_close(on_four, pair_ref, "2-rank shards resumed on 4 ranks")


def background_write_case(device, mesh, rank, tmp):
    """Under FSDP the background writers write what they were handed: a
    checkpoint of the async saver and the gathered EMA copies, whose writes
    are held until the next train step has changed the live weights, Adam
    moments and EMA copies in place, still hold the step they were taken
    at."""
    t = Trainer(device)
    state, _ = t.run(2, mesh, fsdp=True)
    want = ckpt.save_state(os.path.join(tmp, "held-sync"), 2, state)
    release = threading.Event()
    saver, ema_writer = ckpt.AsyncStateSaver(), ckpt.AsyncTreeWriter()
    for writer in (saver._writer, ema_writer):  # a write that holds the ones behind it
        writer.submit_snapshot({}, lambda host: release.wait())
    got = saver.save(os.path.join(tmp, "held-async"), 2, state)
    snapshots = {key: state.dp.gather(tree) for key, tree in state.ema.items()}
    taken = ckpt.map_tensors(snapshots, torch.clone)
    written = {}
    ema_writer.submit_snapshot(snapshots, lambda host: written.update(ckpt.map_tensors(host, torch.clone)))
    t.run(1, mesh, fsdp=True, state=state)
    release.set()
    saver.close()
    ema_writer.close()
    mismatch = tree_mismatch(written, taken)
    assert mismatch is None, f"the EMA snapshot written in the background changed at {mismatch}"
    dist.barrier()
    if rank == 0:
        mismatch = tree_mismatch(torch.load(got, weights_only=True), torch.load(want, weights_only=True))
        assert mismatch is None, f"the background checkpoint changed after the save at {mismatch}"


def tree_mismatch(a, b, path=""):
    """The path of the first leaf where two trees differ (tensors bit for
    bit), or None."""
    if isinstance(a, torch.Tensor):
        return None if isinstance(b, torch.Tensor) and a.dtype == b.dtype and torch.equal(a, b) else path
    if isinstance(a, dict):
        if not isinstance(b, dict) or a.keys() != b.keys():
            return path + " (keys)"
        return next((m for k in a if (m := tree_mismatch(a[k], b[k], f"{path}/{k}")) is not None), None)
    if isinstance(a, (list, tuple)):
        if len(a) != len(b):
            return path + " (length)"
        return next((m for i, (x, y) in enumerate(zip(a, b)) if (m := tree_mismatch(x, y, f"{path}/{i}")) is not None),
                    None)
    return None if a == b else path


def run_cases(rank, device, jax_ref, tmp):
    """Every mesh case of the test in one process group."""
    torch.set_num_threads(1)
    mesh = make_mesh(4, 1, device=device)
    dp_and_fsdp_cases(device, mesh)
    jax_case(device, mesh, jax_ref)
    grad_accum_case(device, mesh)
    sampler_cases(device, mesh, rank)
    projection_case(device, mesh)
    checkpoint_cases(device, mesh, rank, tmp)
    background_write_case(device, mesh, rank, tmp)
