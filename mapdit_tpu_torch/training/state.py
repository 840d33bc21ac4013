"""Train state and the train step, port of ``mapdit_tpu/training/state.py``
for ``grad_accum=1`` and the uniform timestep sampler.

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
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

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
    ``optax.adam``: m/(1-b1^k) / (sqrt(v/(1-b2^k)) + eps)."""

    lr_schedule: Callable[[int], float]
    b1: float = 0.9
    b2: float = 0.99
    eps: float = 1e-8

    def build(self, params) -> torch.optim.Adam:
        return torch.optim.Adam(params, lr=self.lr_schedule(0), betas=(self.b1, self.b2), eps=self.eps)


def create_optimizer(lr_schedule: Callable[[int], float], b1: float = 0.9, b2: float = 0.99) -> AdamSpec:
    """Adam(0.9, 0.99) + schedule (the reference's optimizer)."""
    return AdamSpec(lr_schedule, b1, b2)


@dataclasses.dataclass
class TrainState:
    step: int
    model: DiT
    optimizer: torch.optim.Adam
    ema: Dict[str, Dict[str, torch.Tensor]]  # "0.050" -> {parameter name: tensor}
    generator: torch.Generator

    @property
    def params(self) -> Dict[str, torch.Tensor]:
        return dict(self.model.named_parameters())


def _check_sampler(timestep_sampler: str) -> None:
    if timestep_sampler == "loss-second-moment":
        raise NotImplementedError("the loss-second-moment timestep sampler is ROADMAP A.10")
    if timestep_sampler != "uniform":
        raise ValueError(f"unknown timestep sampler {timestep_sampler!r}")


def create_train_state(
    cfg: DiTConfig,
    tx: AdamSpec,
    seed: int = 0,
    ema_stds: Tuple[float, ...] = EMA_STDS,
    timestep_sampler: str = "uniform",
    device=None,
    state_dict: Optional[Dict[str, torch.Tensor]] = None,
) -> TrainState:
    """A model drawn from ``seed`` (or loaded from ``state_dict``) on
    ``device`` (default CUDA), its optimizer, one EMA copy of the
    parameters per std, and a generator seeded with ``seed`` on the device."""
    _check_sampler(timestep_sampler)
    device = resolve_device(device)
    model = init_model(cfg, seed=seed, device=device)
    if state_dict is not None:
        model.load_state_dict(state_dict)
    params = dict(model.named_parameters())
    return TrainState(
        step=0,
        model=model,
        optimizer=tx.build(list(params.values())),
        ema={ema_key(s): {k: p.detach().clone() for k, p in params.items()} for s in ema_stds},
        generator=torch.Generator(device=device).manual_seed(seed),
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
):
    """``train_step(state, batch, draws=None) -> metrics``, updating
    ``state`` in place.

    ``batch`` is {"x", "y"} (latents) or {"mean", "std", "y"} (VAE
    posterior parameters; a latent is drawn and normalized by
    ``stats_mean``/``stats_std`` every step), numpy arrays or tensors.
    ``draws`` may hold "posterior_eps", "t", "noise" and "drop" (1 where a
    label is dropped) to use instead of the generator's draws.
    ``model_train=False`` runs the model without label dropout. Metrics are
    0-d device tensors: loss, mse, vb, grad_norm (the global L2 norm of the
    gradients)."""
    if grad_accum != 1:
        raise NotImplementedError("gradient accumulation (grad_accum > 1) is a later item of training (ROADMAP A.6)")
    _check_sampler(timestep_sampler)
    beta_fns = {ema_key(s): ema_lib.make_beta_fn(s) for s in ema_stds}
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
        t = draws.get("t")
        t = torch.randint(0, diffusion.num_timesteps, (n,), generator=gen, device=dev) if t is None else (
            _device_tensor(t, dev, torch.int64))
        noise = draws.get("noise")
        noise = torch.randn(x.shape, generator=gen, device=dev) if noise is None else (
            _device_tensor(noise, dev, torch.float32))
        drop = draws.get("drop")
        drop = None if drop is None else _device_tensor(drop, dev, torch.int64)

        def model_fn(xt, tt, y):
            return model(xt, tt, y, force_drop_ids=drop, train=model_train, generator=gen)

        terms = diffusion.training_losses(model_fn, x, t, model_kwargs={"y": y}, noise=noise)
        loss = terms["loss"].mean()
        state.optimizer.zero_grad(set_to_none=True)
        loss.backward()

        params = state.params
        grads = [p.grad for p in params.values() if p.grad is not None]
        grad_norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
        for group in state.optimizer.param_groups:
            group["lr"] = tx.lr_schedule(state.step)
        state.optimizer.step()
        state.step += 1
        for key, tree in state.ema.items():
            ema_lib.ema_update(tree, params, beta_fns[key](state.step))
        project_weights(model, cfg)
        with torch.no_grad():
            return {
                "loss": loss.detach(),
                "mse": terms["mse"].mean() if "mse" in terms else loss.detach(),
                "vb": terms["vb"].mean() if "vb" in terms else torch.zeros((), device=dev),
                "grad_norm": grad_norm,
            }

    return train_step
