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
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

from mapdit_tpu_torch.diffusion.timestep_sampler import LossSecondMomentResampler
from mapdit_tpu_torch.models.config import DiTConfig
from mapdit_tpu_torch.models.dit import DiT, init_model, project_weights
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

    @property
    def params(self) -> Dict[str, torch.Tensor]:
        return dict(self.model.named_parameters())


def _resampler(timestep_sampler: str, num_timesteps: int) -> Optional[LossSecondMomentResampler]:
    if timestep_sampler == "loss-second-moment":
        return LossSecondMomentResampler(num_timesteps)
    if timestep_sampler != "uniform":
        raise ValueError(f"unknown timestep sampler {timestep_sampler!r}")
    return None


def create_train_state(
    cfg: DiTConfig,
    tx: AdamSpec,
    seed: int = 0,
    ema_stds: Tuple[float, ...] = EMA_STDS,
    timestep_sampler: str = "uniform",
    num_timesteps: int = 1000,
    device=None,
    state_dict: Optional[Dict[str, torch.Tensor]] = None,
) -> TrainState:
    """A model drawn from ``seed`` (or loaded from ``state_dict``, which
    then holds every parameter and buffer, with no draw) on ``device``
    (default CUDA), its optimizer, one EMA copy of the parameters per std,
    and a generator seeded with ``seed`` on the device."""
    resampler = _resampler(timestep_sampler, num_timesteps)
    device = resolve_device(device)
    if state_dict is None:
        model = init_model(cfg, seed=seed, device=device)
    else:
        model = DiT(cfg).to(device).eval()
        model.load_state_dict(state_dict)
    params = dict(model.named_parameters())
    return TrainState(
        step=0,
        model=model,
        optimizer=tx.build(list(params.values())),
        ema={ema_key(s): {k: p.detach().clone() for k, p in params.items()} for s in ema_stds},
        generator=torch.Generator(device=device).manual_seed(seed),
        sampler_state=() if resampler is None else resampler.init_state(device),
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
    averaged gradients, before any clipping)."""
    if grad_accum < 1:
        raise ValueError(f"grad_accum must be at least 1, got {grad_accum}")
    resampler = _resampler(timestep_sampler, diffusion.num_timesteps)
    beta_fns = {ema_key(s): ema_lib.make_beta_fn(s) for s in ema_stds}
    losses_fn = losses_fn or diffusion.training_losses
    stats = None

    def train_step(state: TrainState, batch: Dict, draws: Optional[Dict] = None) -> Dict[str, torch.Tensor]:
        nonlocal stats
        draws = draws or {}
        model, gen = state.model, state.generator
        dev = gen.device
        y = _device_tensor(batch["y"], dev, torch.int64)
        if "x" in batch:
            x = _device_tensor(batch["x"], dev, torch.float32)
        else:
            if stats is None:
                stats = tuple(_device_tensor(s, dev, torch.float32).reshape(1, -1, 1, 1) for s in (stats_mean, stats_std))
            mean = _device_tensor(batch["mean"], dev, torch.float32)
            eps = draws.get("posterior_eps")
            if eps is None:
                eps = torch.randn(mean.shape, generator=gen, device=dev)
            x = mean + _device_tensor(eps, dev, torch.float32) * _device_tensor(batch["std"], dev, torch.float32)
            x = (x - stats[0]) / stats[1]
        n = x.shape[0]
        if n % grad_accum:
            raise ValueError(f"grad_accum={grad_accum} does not divide the batch of {n}")
        t = draws.get("t")
        t = None if t is None else _device_tensor(t, dev, torch.int64)
        t_weights = None
        if resampler is not None:
            t, t_weights = resampler.sample(state.sampler_state, gen, n, t=t)
        elif t is None:
            t = torch.randint(0, diffusion.num_timesteps, (n,), generator=gen, device=dev)
        noise = draws.get("noise")
        noise = torch.randn(x.shape, generator=gen, device=dev) if noise is None else (
            _device_tensor(noise, dev, torch.float32))
        drop = draws.get("drop")
        drop = None if drop is None else _device_tensor(drop, dev, torch.int64)
        if drop is None and grad_accum > 1 and model_train and cfg.class_dropout_prob > 0:
            # the label embedder's own draw, made here for the full batch at
            # the point of the stream where the unaccumulated step makes it
            drop = (torch.rand((n,), generator=gen, device=dev) < cfg.class_dropout_prob).long()

        state.optimizer.zero_grad(set_to_none=True)
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
            state.sampler_state = resampler.update_with_local_losses(state.sampler_state, t, torch.cat(per_sample))
        params = state.params
        grads = [p.grad for p in params.values() if p.grad is not None]
        with torch.no_grad():
            if grad_accum > 1:
                torch._foreach_mul_(grads, 1.0 / grad_accum)
            grad_norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
            if tx.grad_clip is not None:
                torch._foreach_mul_(grads, tx.grad_clip / torch.clamp(grad_norm, min=tx.grad_clip))
        for group in state.optimizer.param_groups:
            group["lr"] = tx.lr_schedule(state.step)
        state.optimizer.step()
        state.step += 1
        for key, tree in state.ema.items():
            ema_lib.ema_update(tree, params, beta_fns[key](state.step))
        project_weights(model, cfg)
        return {**{key: v / grad_accum for key, v in sums.items()}, "grad_norm": grad_norm}

    return train_step
