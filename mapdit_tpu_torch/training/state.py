"""Train state and the train step, port of ``mapdit_tpu/training/state.py``.

One step: the VAE-posterior sample mu + eps*sigma is drawn and normalized on
the device, t ~ U{0..T-1} and the q-sample noise are drawn, the loss
``training_losses`` (LEARNED_RANGE: eps MSE + the VB term on a detached eps
half) is taken and differentiated, Adam(0.9, 0.99) updates the stored
weights with the learning rate of the schedule at the 0-based update count,
each EMA lerps toward the post-Adam, pre-projection parameters, and the
forced weight normalization projects the weight matrices back onto their
norm manifold. All draws come from the state's ``torch.Generator``;
``draws=`` hands them in instead (a test's way to feed the JAX package's
draws). PyTorch updates the parameters, the Adam moments and the EMA
tensors in place where the JAX step returns new trees.

``grad_accum > 1`` runs the batch as that many equal micro-batches: t, the
q-sample noise and the importance weights are drawn for the full batch up
front and sliced, the micro-batch gradients are summed and scaled by
``1/grad_accum``, and one Adam / EMA / projection update follows, so the
trajectory is the unaccumulated one. The JAX package derives the
label-dropout mask per micro-batch; here it too is drawn for the full batch,
where the unaccumulated step draws it, so the two steps see the same masks
and differ only in the order of the gradients' sums.
``timestep_sampler="loss-second-moment"`` draws t by importance and keeps
the loss history in ``TrainState.sampler_state``.

On a (n_data, 1) ``mesh`` (``parallel/mesh.py``) the step is data-parallel,
or fully sharded with ``fsdp=True`` (``parallel/data_parallel.py``): the
batch holds this rank's rows of the global batch (the loader's slice); every
rank draws the global batch's posterior eps, t, noise and label-dropout mask
from its generator (the same seed on every rank) and keeps its own rows, so
a run on N ranks sees the draws of the one-device run from the same seed;
the gradients are averaged over the data group once, after the
micro-batches; grad_norm and clipping use the global norm; Adam, the EMAs
and the projection update what the rank holds (its slices under FSDP, whose
whole parameters one all-gather then refills); the metrics are the means
over the group, equal on every rank. The JAX package gets the same draws for
free: its GSPMD program is the one-device program.

On a mesh with a model axis (n_model > 1) the step is tensor-parallel as
well, alone or with ``fsdp=True``: every rank builds the whole model from
the seed (or weights) and keeps its model rank's shard of the split block
tensors (``parallel/mesh.py`` ``tp_layout``), then, under FSDP, its data
slice of that. The blocks run the plain path (``block_kernel`` ``auto``
resolves to ``off``; the TP islands are inference-only and the
single-device kernels cannot be split, so both are refused), the attention
by ``attention_impl``. The model ranks of one data index draw the same
noise, t and label dropout (one seed, the global batch, their data rows),
compute the same loss and the same whole gradients of the replicated
tensors; the gradients are averaged over the data group only, and
grad_norm counts every element of the whole tree once.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

from mapdit_tpu_torch.diffusion.timestep_sampler import LossSecondMomentResampler
from mapdit_tpu_torch.models.config import TP_KERNELS, DiTConfig
from mapdit_tpu_torch.models.dit import DiT, init_model, project_weights
from mapdit_tpu_torch.parallel.data_parallel import DataParallel, global_norm
from mapdit_tpu_torch.parallel.mesh import PLAIN_TP, Mesh, mean_all_reduce_, shard_state_dict
from mapdit_tpu_torch.training import ema as ema_lib
from mapdit_tpu_torch.utils.device import resolve_device

EMA_STDS = (0.05, 0.1)  # reference default


def ema_key(std: float) -> str:
    return f"{std:.3f}"


@dataclasses.dataclass(frozen=True)
class AdamSpec:
    """Adam(b1, b2, eps) under a learning-rate schedule; ``build`` makes the
    optimizer for a parameter list. torch's Adam takes the same update as
    ``optax.adam``: m/(1-b1^k) / (sqrt(v/(1-b2^k)) + eps). ``grad_clip``
    scales the gradients by clip / max(global norm, clip) before Adam (the
    arithmetic of ``optax.clip_by_global_norm``); None or 0 is off."""

    lr_schedule: Callable[[int], float]
    b1: float = 0.9
    b2: float = 0.99
    eps: float = 1e-8
    grad_clip: Optional[float] = None

    def build(self, params) -> torch.optim.Adam:
        return torch.optim.Adam(params, lr=self.lr_schedule(0), betas=(self.b1, self.b2), eps=self.eps)


def create_optimizer(
    lr_schedule: Callable[[int], float], b1: float = 0.9, b2: float = 0.99, grad_clip: Optional[float] = None
) -> AdamSpec:
    """Adam(0.9, 0.99) + schedule (the reference's optimizer); optional
    global-norm gradient clipping, off by default."""
    return AdamSpec(lr_schedule, b1, b2, grad_clip=grad_clip if grad_clip is not None and grad_clip > 0 else None)


@dataclasses.dataclass
class TrainState:
    step: int
    model: DiT
    optimizer: torch.optim.Adam
    ema: Dict[str, Dict[str, torch.Tensor]]  # "0.050" -> {parameter name: tensor}
    generator: torch.Generator
    # the loss history of timestep_sampler="loss-second-moment"; () under the
    # uniform sampler
    sampler_state: Any = ()
    # on a mesh: what this data rank holds and its collectives (DP / FSDP)
    dp: Optional[DataParallel] = None

    @property
    def params(self) -> Dict[str, torch.Tensor]:
        """The model's parameters: whole over the data axis (under FSDP
        refilled after every step); on a model axis the rank's TP shards
        (``dp.gather_model`` makes them whole)."""
        return dict(self.model.named_parameters())

    @property
    def held(self) -> Dict[str, torch.Tensor]:
        """The tensors that Adam, the EMAs and the projection update: the
        parameters, or under FSDP this rank's slices of the sharded ones."""
        return self.params if self.dp is None else self.dp.held


def _resampler(timestep_sampler: str, num_timesteps: int) -> Optional[LossSecondMomentResampler]:
    if timestep_sampler == "loss-second-moment":
        return LossSecondMomentResampler(num_timesteps)
    if timestep_sampler != "uniform":
        raise ValueError(f"unknown timestep sampler {timestep_sampler!r}")
    return None


def tp_train_config(cfg: DiTConfig) -> DiTConfig:
    """The config a tensor-parallel train step runs: the plain path
    (``block_kernel`` ``auto`` and ``off`` both run ``off``). The TP islands
    are inference-only, as in the JAX package (its ``train.py:124-129``),
    and a single-device kernel cannot be split over model ranks."""
    if cfg.block_kernel in TP_KERNELS:
        raise ValueError(
            f"--block-kernel {cfg.block_kernel} is an inference-only TP layout; training uses the XLA path "
            "(leave --block-kernel auto)")
    if cfg.block_kernel not in ("auto", "off"):
        raise ValueError(
            f"block_kernel={cfg.block_kernel!r} is a single-device kernel and cannot run on a model axis; "
            "tensor-parallel training runs the plain path (leave --block-kernel auto, or 'off')")
    return cfg.replace(block_kernel="off")


def create_train_state(
    cfg: DiTConfig,
    tx: AdamSpec,
    seed: int = 0,
    ema_stds: Tuple[float, ...] = EMA_STDS,
    timestep_sampler: str = "uniform",
    num_timesteps: int = 1000,
    device=None,
    state_dict: Optional[Dict[str, torch.Tensor]] = None,
    mesh: Optional[Mesh] = None,
    fsdp: bool = False,
) -> TrainState:
    """A model drawn from ``seed`` (or loaded from ``state_dict``, which
    then holds every parameter and buffer, with no draw) on ``device``
    (default: the mesh's, else CUDA), its optimizer, one EMA copy of the
    parameters per std, and a generator seeded with ``seed`` on the device.
    On a ``mesh`` every rank builds it from the same seed (or weights); on
    a model axis the model keeps this rank's TP shards and runs the plain
    path (:func:`tp_train_config`); with ``fsdp=True`` the optimizer and the
    EMA copies hold this rank's slices (``parallel/data_parallel.py``)."""
    resampler = _resampler(timestep_sampler, num_timesteps)
    if fsdp and mesh is None:
        raise ValueError("fsdp=True shards over a mesh's data axis; give the mesh")
    tensor_parallel = mesh is not None and mesh.n_model > 1
    if tensor_parallel:
        cfg = tp_train_config(cfg)
    device = resolve_device(mesh.device if device is None and mesh is not None else device)
    if state_dict is None:
        model = init_model(cfg, seed=seed, device=device)
    else:
        model = DiT(cfg).to(device).eval()
        model.load_state_dict(state_dict)
    if tensor_parallel:
        model.load_tensor_parallel(shard_state_dict(model.state_dict(), cfg, mesh, PLAIN_TP), mesh)
    dp = None if mesh is None else DataParallel(model, mesh, fsdp)
    held = dict(model.named_parameters()) if dp is None else dp.held
    return TrainState(
        step=0,
        model=model,
        optimizer=tx.build(list(held.values())),
        ema={ema_key(s): {k: p.detach().clone() for k, p in held.items()} for s in ema_stds},
        generator=torch.Generator(device=device).manual_seed(seed),
        sampler_state=() if resampler is None else resampler.init_state(device),
        dp=dp,
    )


def _device_tensor(v, device, dtype=None) -> torch.Tensor:
    if not isinstance(v, torch.Tensor):
        v = torch.from_numpy(np.array(v))
    return v.to(device=device, dtype=dtype)


def make_train_step(
    cfg: DiTConfig,
    diffusion,
    tx: AdamSpec,
    stats_mean=None,
    stats_std=None,
    ema_stds: Tuple[float, ...] = EMA_STDS,
    timestep_sampler: str = "uniform",
    grad_accum: int = 1,
    model_train: bool = True,
    losses_fn: Optional[Callable] = None,
    mesh: Optional[Mesh] = None,
    fsdp: bool = False,
):
    """``train_step(state, batch, draws=None) -> metrics``, updating
    ``state`` in place.

    ``batch`` is {"x", "y"} (latents) or {"mean", "std", "y"} (VAE
    posterior parameters; a latent is drawn and normalized by
    ``stats_mean``/``stats_std`` every step), numpy arrays or tensors.
    ``draws`` may hold "posterior_eps", "t", "noise" and "drop" (1 where a
    label is dropped) to use instead of the generator's draws.
    ``grad_accum`` must divide the batch. ``model_train=False`` runs the
    model without label dropout. ``losses_fn`` replaces
    ``diffusion.training_losses``: any callable of its signature
    ``(model_fn, x_start, t, model_kwargs, noise) -> {"loss": per sample,
    ...}`` (progressive distillation's, ``diffusion/distill.py``);
    ``diffusion`` then only sets ``num_timesteps`` for the t draw. Metrics
    are 0-d device tensors: loss, mse (the loss where ``losses_fn`` gives
    none), vb (0 where it gives none), grad_norm (the global L2 norm of the
    averaged gradients, before any clipping).

    On a ``mesh`` (the one ``state`` was built on, with the same ``fsdp``)
    ``batch`` holds this rank's rows and ``draws`` the global batch's; see
    the module docstring."""
    if grad_accum < 1:
        raise ValueError(f"grad_accum must be at least 1, got {grad_accum}")
    if fsdp and mesh is None:
        raise ValueError("fsdp=True shards over a mesh's data axis; give the mesh")
    resampler = _resampler(timestep_sampler, diffusion.num_timesteps)
    beta_fns = {ema_key(s): ema_lib.make_beta_fn(s) for s in ema_stds}
    losses_fn = losses_fn or diffusion.training_losses
    stats = None

    def train_step(state: TrainState, batch: Dict, draws: Optional[Dict] = None) -> Dict[str, torch.Tensor]:
        nonlocal stats
        draws = draws or {}
        model, gen = state.model, state.generator
        dev = gen.device
        if (state.dp is None) != (mesh is None) or (state.dp is not None and state.dp.fsdp != fsdp):
            raise ValueError("the train state was built for another layout (mesh, fsdp) than this step")
        y = _device_tensor(batch["y"], dev, torch.int64)
        n = y.shape[0]
        # on a mesh: the draws are the global batch's, and this rank keeps
        # its rows of them
        n_data = 1 if mesh is None else mesh.n_data
        rows_here = slice(None) if mesh is None else slice(mesh.data_index * n, (mesh.data_index + 1) * n)
        if "x" in batch:
            x = _device_tensor(batch["x"], dev, torch.float32)
        else:
            if stats is None:
                stats = tuple(_device_tensor(s, dev, torch.float32).reshape(1, -1, 1, 1) for s in (stats_mean, stats_std))
            mean = _device_tensor(batch["mean"], dev, torch.float32)
            eps = draws.get("posterior_eps")
            if eps is None:
                eps = torch.randn((n_data * n, *mean.shape[1:]), generator=gen, device=dev)
            eps = _device_tensor(eps, dev, torch.float32)[rows_here]
            x = mean + eps * _device_tensor(batch["std"], dev, torch.float32)
            x = (x - stats[0]) / stats[1]
        if n % grad_accum:
            raise ValueError(f"grad_accum={grad_accum} does not divide the batch of {n}")
        t = draws.get("t")
        t = None if t is None else _device_tensor(t, dev, torch.int64)
        t_weights = None
        if resampler is not None:
            t, t_weights = resampler.sample(state.sampler_state, gen, n_data * n, t=t)
            t_weights = t_weights[rows_here]
        elif t is None:
            t = torch.randint(0, diffusion.num_timesteps, (n_data * n,), generator=gen, device=dev)
        t = t[rows_here]
        noise = draws.get("noise")
        noise = torch.randn((n_data * n, *x.shape[1:]), generator=gen, device=dev) if noise is None else (
            _device_tensor(noise, dev, torch.float32))
        noise = noise[rows_here]
        drop = draws.get("drop")
        drop = None if drop is None else _device_tensor(drop, dev, torch.int64)
        if drop is None and (grad_accum > 1 or mesh is not None) and model_train and cfg.class_dropout_prob > 0:
            # the label embedder's own draw, made here for the global batch
            # at the point of the stream where the unaccumulated one-device
            # step makes it
            drop = (torch.rand((n_data * n,), generator=gen, device=dev) < cfg.class_dropout_prob).long()
        drop = None if drop is None else drop[rows_here]

        model.zero_grad(set_to_none=True)
        m = n // grad_accum
        sums = {"loss": 0.0, "mse": 0.0, "vb": 0.0}
        per_sample = []
        for i in range(grad_accum):
            rows = slice(i * m, (i + 1) * m)
            drop_i = None if drop is None else drop[rows]

            def model_fn(xt, tt, y):
                return model(xt, tt, y, force_drop_ids=drop_i, train=model_train, generator=gen)

            terms = losses_fn(model_fn, x[rows], t[rows], model_kwargs={"y": y[rows]}, noise=noise[rows])
            losses = terms["loss"] if t_weights is None else terms["loss"] * t_weights[rows]
            loss = losses.mean()
            loss.backward()  # sums into .grad across the micro-batches
            per_sample.append(terms["loss"].detach())
            with torch.no_grad():
                sums["loss"] = sums["loss"] + loss.detach()
                sums["mse"] = sums["mse"] + (terms["mse"].mean() if "mse" in terms else loss.detach())
                sums["vb"] = sums["vb"] + (terms["vb"].mean() if "vb" in terms else torch.zeros((), device=dev))

        if resampler is not None:
            state.sampler_state = resampler.update_with_local_losses(
                state.sampler_state, t, torch.cat(per_sample), group=None if mesh is None else mesh.data_group)
        if state.dp is not None:
            state.dp.reduce_grads()
        held = state.held
        grads = [p.grad for p in held.values() if p.grad is not None]
        with torch.no_grad():
            if grad_accum > 1:
                torch._foreach_mul_(grads, 1.0 / grad_accum)
            grad_norm = global_norm(grads) if state.dp is None else state.dp.grad_norm()
            if tx.grad_clip is not None:
                torch._foreach_mul_(grads, tx.grad_clip / torch.clamp(grad_norm, min=tx.grad_clip))
        for group in state.optimizer.param_groups:
            group["lr"] = tx.lr_schedule(state.step)
        state.optimizer.step()
        state.step += 1
        for key, tree in state.ema.items():
            ema_lib.ema_update(tree, held, beta_fns[key](state.step))
        metrics = {key: v / grad_accum for key, v in sums.items()}
        if state.dp is None:
            project_weights(model, cfg)
        else:
            state.dp.project(cfg)
            state.dp.gather_params()
            with torch.no_grad():
                means = torch.stack([torch.as_tensor(v, device=dev, dtype=torch.float32) for v in metrics.values()])
                mean_all_reduce_([means], mesh.data_group)
            metrics = dict(zip(metrics, means.unbind()))
        return {**metrics, "grad_norm": grad_norm}

    return train_step
