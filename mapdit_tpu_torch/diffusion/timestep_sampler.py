"""Importance sampling over diffusion timesteps, port of
``mapdit_tpu/diffusion/timestep_sampler.py``; under data parallelism every
rank's (t, loss) pairs are all-gathered before the fold, so that every
rank's history evolves the same.

``UniformSampler`` and ``LossSecondMomentResampler``; the resampler's state
(a ring of the last losses seen at each timestep) is two tensors on the
train step's device, updated without a host sync.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from mapdit_tpu_torch.parallel.mesh import all_gather_rows


def create_named_schedule_sampler(name: str, num_timesteps: int):
    if name == "uniform":
        return UniformSampler(num_timesteps)
    if name == "loss-second-moment":
        return LossSecondMomentResampler(num_timesteps)
    raise NotImplementedError(f"unknown schedule sampler: {name}")


class UniformSampler:
    """Uniform t ~ U{0, T-1}, unit weights."""

    def __init__(self, num_timesteps: int):
        self.num_timesteps = num_timesteps

    def weights(self, device=None) -> torch.Tensor:
        return torch.ones(self.num_timesteps, device=device)

    def sample(self, generator: torch.Generator, batch_size: int) -> Tuple[torch.Tensor, torch.Tensor]:
        dev = generator.device
        t = torch.randint(0, self.num_timesteps, (batch_size,), generator=generator, device=dev)
        return t, torch.ones(batch_size, device=dev)


@dataclasses.dataclass
class LossHistoryState:
    """Rolling per-timestep loss history: (T, H) ring buffer + counts."""

    history: torch.Tensor  # (T, H) float32
    counts: torch.Tensor  # (T,) int32

    @classmethod
    def create(cls, num_timesteps: int, history_per_term: int = 10, device=None) -> "LossHistoryState":
        return cls(
            history=torch.zeros(num_timesteps, history_per_term, device=device),
            counts=torch.zeros(num_timesteps, dtype=torch.int32, device=device),
        )


class LossSecondMomentResampler:
    """p(t) proportional to sqrt(E[loss_t^2]) once every timestep has a full
    history, uniform before."""

    def __init__(self, num_timesteps: int, history_per_term: int = 10, uniform_prob: float = 0.001):
        self.num_timesteps = num_timesteps
        self.history_per_term = history_per_term
        self.uniform_prob = uniform_prob

    def init_state(self, device=None) -> LossHistoryState:
        return LossHistoryState.create(self.num_timesteps, self.history_per_term, device=device)

    def weights(self, state: LossHistoryState) -> torch.Tensor:
        warmed = (state.counts == self.history_per_term).all()
        w = state.history.square().mean(dim=-1).sqrt()
        w = w / w.sum()
        w = w * (1.0 - self.uniform_prob) + self.uniform_prob / self.num_timesteps
        return torch.where(warmed, w, torch.full_like(w, 1.0 / self.num_timesteps))

    def sample(
        self, state: LossHistoryState, generator: torch.Generator, batch_size: int, t: Optional[torch.Tensor] = None
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """``batch_size`` timesteps drawn from p and their importance
        weights 1 / (T p[t]); a given ``t`` is weighted instead of drawn."""
        p = self.weights(state)
        p = p / p.sum()
        if t is None:
            t = torch.multinomial(p, batch_size, replacement=True, generator=generator)
        return t, (1.0 / (self.num_timesteps * p[t])).float()

    def update_with_local_losses(
        self, state: LossHistoryState, ts: torch.Tensor, losses: torch.Tensor, group=None
    ) -> LossHistoryState:
        """Fold a batch of (t, loss) pairs into the ring buffer, in batch
        order: a timestep's row takes the new losses at its end and, once
        full, drops its oldest. The sequential fold of the JAX package,
        computed for all rows at once: a row holding ``cnt`` losses that gets
        ``c`` new ones shifts left by max(0, cnt + c - H), and its j-th new
        loss lands at column cnt + j - shift (dropped where that is
        negative). With a process ``group`` (the data group), every rank's
        pairs are all-gathered in rank order first (JAX l.103-109), which
        every rank of the group must call."""
        if group is not None:
            ts, losses = all_gather_rows(ts, group), all_gather_rows(losses.detach().float(), group)
        hist, counts = state.history, state.counts.long()
        num_t, cap = hist.shape
        ts = ts.long()
        losses = losses.detach().float()
        n = ts.shape[0]
        new = torch.zeros(num_t, dtype=torch.int64, device=ts.device).scatter_add_(0, ts, torch.ones_like(ts))
        shift = (counts + new - cap).clamp_(min=0)
        # the kept old losses move left by the row's shift
        src = torch.arange(cap, device=ts.device)[None, :] + shift[:, None]
        moved = torch.gather(hist, 1, src.clamp(max=cap - 1))
        hist = torch.where(src < cap, moved, torch.zeros_like(moved))
        # rank of each pair among the pairs of its timestep, in batch order
        order = torch.sort(ts, stable=True).indices
        starts = torch.cumsum(new, 0) - new
        rank = torch.empty_like(ts)
        rank[order] = torch.arange(n, device=ts.device) - starts[ts[order]]
        col = counts[ts] + rank - shift[ts]
        # dropped pairs go to one spare slot past the end (no masked gather,
        # which would wait for the device)
        flat = torch.where(col >= 0, ts * cap + col, torch.full_like(col, num_t * cap))
        hist = torch.cat([hist.reshape(-1), hist.new_zeros(1)]).index_put((flat,), losses)[:-1].reshape(num_t, cap)
        return LossHistoryState(history=hist, counts=(counts + new).clamp_(max=cap).to(torch.int32))
