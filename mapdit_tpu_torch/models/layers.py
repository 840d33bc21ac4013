"""Basic layers: MP linear / embedding, attention, MLP.

Port of ``mapdit_tpu/models/layers.py`` (default MaP family). Weights keep
the reference's (out, in) layout and names. The in-graph weight
normalization is applied unless the weights are folded
(``cfg.fold_weights``, see ``runtime.fold_weights_for_inference``).
Parameters are created empty; ``reset_parameters(generator)`` draws them.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
from torch import nn

from mapdit_tpu_torch.models.config import DiTConfig
from mapdit_tpu_torch.ops.attention import dot_product_attention
from mapdit_tpu_torch.ops.mp import mp_silu, normalize


class MPSiLU(nn.Module):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return mp_silu(x)


class MPLinear(nn.Module):
    """Bias-free weight-normalized linear: ``x @ normalize(W).T / sqrt(in)``."""

    def __init__(self, in_dim: int, out_dim: int, cfg: DiTConfig):
        super().__init__()
        self.in_dim, self.out_dim = in_dim, out_dim
        self.dtype, self.folded = cfg.dtype, cfg.fold_weights
        self.weight = nn.Parameter(torch.empty(out_dim, in_dim))

    def reset_parameters(self, generator: torch.Generator) -> None:
        with torch.no_grad():
            self.weight.normal_(0.0, 1.0, generator=generator)

    def effective_weight(self) -> torch.Tensor:
        """The (out, in) matrix multiplied against inputs, without the
        1/sqrt(in) factor, which fused kernels take as a scalar."""
        return self.weight if self.folded else normalize(self.weight)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = self.effective_weight() * (1.0 / math.sqrt(self.in_dim))
        return x.to(self.dtype) @ w.t().to(self.dtype)


class MPLinearSplit(MPLinear):
    """One weight of concatenated rows whose output splits into chunks
    (the reference's ``MPLinearChunk``)."""

    def __init__(self, in_dim: int, out_dims: Tuple[int, ...], cfg: DiTConfig):
        super().__init__(in_dim, sum(out_dims), cfg)
        self.out_dims = tuple(out_dims)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        w = self.effective_weight() / math.sqrt(self.in_dim)
        return torch.split(x.to(self.dtype) @ w.t().to(self.dtype), self.out_dims, dim=-1)


class MPEmbedding(nn.Module):
    """Weight-normalized embedding table."""

    def __init__(self, num_embeddings: int, embedding_dim: int, cfg: DiTConfig):
        super().__init__()
        self.dtype, self.folded = cfg.dtype, cfg.fold_weights
        self.weight = nn.Parameter(torch.empty(num_embeddings, embedding_dim))

    def reset_parameters(self, generator: torch.Generator) -> None:
        with torch.no_grad():
            self.weight.normal_(0.0, 1.0, generator=generator)

    def forward(self, idx: torch.Tensor) -> torch.Tensor:
        w = self.weight if self.folded else normalize(self.weight)
        return w.to(self.dtype)[idx]


class Attention(nn.Module):
    """Multi-head cosine attention: fused qkv projection, q/k rows
    normalized, 1/sqrt(head_dim) scale, bias-free output projection."""

    def __init__(self, cfg: DiTConfig, in_dim: int):
        super().__init__()
        self.num_heads = cfg.num_heads
        self.qkv_proj = MPLinearSplit(in_dim, (in_dim,) * 3, cfg)
        self.out_proj = MPLinear(in_dim, in_dim, cfg)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, t, d = x.shape
        h = self.num_heads
        hd = d // h
        q, k, v = self.qkv_proj(x)

        def to_heads(z):
            return z.reshape(b, t, h, hd).transpose(1, 2)

        out = dot_product_attention(to_heads(q), to_heads(k), to_heads(v), 1.0 / math.sqrt(hd), cosine=True)
        return self.out_proj(out.transpose(1, 2).reshape(b, t, d))


class MLP(nn.Module):
    """fc1 -> MP-SiLU -> fc2, held as ``net`` = (fc1, act, fc2) so the
    parameter names are the reference's ``net.0`` / ``net.2``."""

    def __init__(self, cfg: DiTConfig, in_dim: int, out_dim: int, hidden_dim: Optional[int] = None):
        super().__init__()
        hidden = int(in_dim * cfg.mlp_ratio) if hidden_dim is None else hidden_dim
        self.net = nn.Sequential(MPLinear(in_dim, hidden, cfg), MPSiLU(), MPLinear(hidden, out_dim, cfg))

    @property
    def fc1(self) -> MPLinear:
        return self.net[0]

    @property
    def fc2(self) -> MPLinear:
        return self.net[2]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.net(x)
