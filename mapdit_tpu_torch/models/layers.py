"""Basic layers: MP linear / embedding, attention, MLP.

Port of ``mapdit_tpu/models/layers.py``. Weights keep the reference's
(out, in) layout and names. The in-graph weight normalization is applied
unless the weights are folded (``cfg.fold_weights``, see
``runtime.fold_weights_for_inference``). With the flags off the layers are
vanilla DiT's: a standard linear with bias and xavier-uniform init, plain
SiLU, attention without the q/k normalization. Parameters are created
empty; ``reset_parameters(generator)`` draws them.

Tensor parallelism of the plain path (``DiT.load_tensor_parallel``): the
attention and MLP halves hold a model rank's shard of their weights and
run three small autograd functions over the model group, the collectives
that GSPMD inserts into the JAX package's program:

  * :func:`copy_to_model_ranks`, the entry of a column-parallel product
    (qkv, fc1): the identity forward, an all-reduce of dx backward (every
    rank's product sees only its own rows);
  * :func:`sum_partials`, the exit of a row-parallel product (out-proj,
    fc2): the f32 partials summed forward; the identity backward (every
    rank computes the same thing downstream and holds the whole dy);
  * :func:`split_row_normalize`, the weight normalization of a column
    slice: each row's sum of squares is summed over the group forward (and
    its gradient backward), then ``normalize`` divides by the whole row's
    norm at the full fan-in.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from mapdit_tpu_torch.models.config import DiTConfig
from mapdit_tpu_torch.ops.attention import dot_product_attention
from mapdit_tpu_torch.ops.mp import mp_silu, normalize


class _CopyToModelRanks(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _SumOverModelRanks(torch.autograd.Function):
    """All-reduce forward; ``reduce_grad``: all-reduce backward too, else
    the identity."""

    @staticmethod
    def forward(ctx, x, group, reduce_grad):
        ctx.group, ctx.reduce_grad = group, reduce_grad
        out = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        if ctx.reduce_grad:
            g = g.clone(memory_format=torch.contiguous_format)
            dist.all_reduce(g, group=ctx.group)
        return g, None, None


def copy_to_model_ranks(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` as it is; its gradient summed over ``group`` (the input of a
    column-parallel product)."""
    return _CopyToModelRanks.apply(x, group)


def sum_partials(partial: torch.Tensor, group) -> torch.Tensor:
    """The sum over ``group`` of every rank's ``partial``; the gradient
    passes through as it is (the output of a row-parallel product)."""
    return _SumOverModelRanks.apply(partial, group, False)


def split_row_normalize(w: torch.Tensor, group, dim: int) -> torch.Tensor:
    """``normalize`` of the rows of a weight whose input columns are split
    over ``group``: ``w`` is this rank's slice, ``dim`` the whole row
    length. Each row's sum of squares is summed over the group (and so is
    its gradient: every rank's slice uses the shared sum)."""
    sq = _SumOverModelRanks.apply(w.square().sum(dim=-1, keepdim=True), group, True)
    return normalize(w, norm=sq.sqrt(), dim=dim)


class MPSiLU(nn.Module):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return mp_silu(x)


def activation(x: torch.Tensor, cfg: DiTConfig) -> torch.Tensor:
    return mp_silu(x) if cfg.use_mp_silu else F.silu(x)


def activation_module(cfg: DiTConfig) -> nn.Module:
    return MPSiLU() if cfg.use_mp_silu else nn.SiLU()


class MPLinear(nn.Module):
    """Bias-free weight-normalized linear ``x @ normalize(W).T * gain /
    sqrt(in)``, with a learned scalar ``gain`` under ``learn_gain``.

    ``use_wn`` defaults to ``cfg.use_weight_normalization``. Without it this
    is a standard linear with bias, xavier-uniform init and zero bias;
    ``zero_init`` zeroes the weight (adaLN-Zero heads) or, with ``use_wn``
    and ``learn_gain``, starts the gain at 0."""

    def __init__(
        self, in_dim: int, out_dim: int, cfg: DiTConfig, use_wn: Optional[bool] = None,
        zero_init: bool = False, learn_gain: bool = False,
    ):
        super().__init__()
        self.in_dim, self.out_dim = in_dim, out_dim
        self.dtype, self.folded = cfg.dtype, cfg.fold_weights
        self.use_wn = cfg.use_weight_normalization if use_wn is None else use_wn
        self.zero_init, self.learn_gain = zero_init, learn_gain and self.use_wn
        self.weight = nn.Parameter(torch.empty(out_dim, in_dim))
        if self.learn_gain:
            self.gain = nn.Parameter(torch.empty(()))
        if not self.use_wn:
            self.bias = nn.Parameter(torch.empty(out_dim))

    def reset_parameters(self, generator: torch.Generator) -> None:
        with torch.no_grad():
            if self.use_wn:
                self.weight.normal_(0.0, 1.0, generator=generator)
                if self.learn_gain:
                    self.gain.fill_(0.0 if self.zero_init else 1.0)
                return
            self.bias.zero_()
            if self.zero_init:
                self.weight.zero_()
            else:
                limit = math.sqrt(6.0 / (self.in_dim + self.out_dim))
                self.weight.uniform_(-limit, limit, generator=generator)

    def effective_weight(self) -> torch.Tensor:
        """The (out, in) matrix multiplied against inputs, without the
        1/sqrt(in) factor, which fused kernels take as a scalar (weight
        normalization without a learned gain only)."""
        assert self.use_wn and not self.learn_gain
        return self.weight if self.folded else normalize(self.weight)

    def product(self, x: torch.Tensor, bias: bool = True, group=None) -> torch.Tensor:
        """``x`` against the weight (``bias=False``: without the bias).
        ``group``: the weight is this rank's slice of input columns split
        over the group, whose unfolded rows :func:`split_row_normalize`
        normalizes."""
        dt = self.dtype
        if not self.use_wn:
            y = x.to(dt) @ self.weight.t().to(dt)
            return y + self.bias.to(dt) if bias else y
        if self.folded:
            w = self.weight
        else:
            w = normalize(self.weight) if group is None else split_row_normalize(self.weight, group, self.in_dim)
        gain = self.gain if self.learn_gain else 1.0
        return x.to(dt) @ (w * (gain / math.sqrt(self.in_dim))).t().to(dt)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.product(x)

    def row_parallel(self, x: torch.Tensor, group) -> torch.Tensor:
        """The product of a weight split on its input columns over the ranks
        of ``group`` (tensor parallelism of the plain path): this rank's
        partial product on its slice ``x`` of the input, summed over the
        group in float32, rounded to the compute type, then the bias once.
        ``in_dim`` stays the full fan-in, so the MP scale is the unsplit
        one. Under autograd the sum is :func:`sum_partials`; with gradients
        off, an all-reduce in place and no graph."""
        partial = self.product(x, bias=False, group=group).float()
        if torch.is_grad_enabled() and partial.requires_grad:
            partial = sum_partials(partial, group)
        else:
            dist.all_reduce(partial, group=group)
        y = partial.to(self.dtype)
        return y if self.use_wn else y + self.bias.to(self.dtype)


class MPLinearSplit(MPLinear):
    """One weight of concatenated rows whose output splits into chunks of
    uneven sizes (the reference's ``MPLinearChunk``; rotation modulation
    emits D/2 angles beside D-wide gates)."""

    def __init__(
        self, in_dim: int, out_dims: Tuple[int, ...], cfg: DiTConfig, use_wn: Optional[bool] = None,
        zero_init: bool = False,
    ):
        super().__init__(in_dim, sum(out_dims), cfg, use_wn=use_wn, zero_init=zero_init)
        self.out_dims = tuple(out_dims)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        return torch.split(self.product(x), self.out_dims, dim=-1)


class MPEmbedding(nn.Module):
    """Weight-normalized embedding table; without ``use_wn`` a standard
    table with N(0, 0.02) init."""

    def __init__(self, num_embeddings: int, embedding_dim: int, cfg: DiTConfig, use_wn: bool = True):
        super().__init__()
        self.dtype, self.folded, self.use_wn = cfg.dtype, cfg.fold_weights, use_wn
        self.weight = nn.Parameter(torch.empty(num_embeddings, embedding_dim))

    def reset_parameters(self, generator: torch.Generator) -> None:
        with torch.no_grad():
            self.weight.normal_(0.0, 1.0 if self.use_wn else 0.02, generator=generator)

    def forward(self, idx: torch.Tensor) -> torch.Tensor:
        w = self.weight if (self.folded or not self.use_wn) else normalize(self.weight)
        return w.to(self.dtype)[idx]


class Attention(nn.Module):
    """Multi-head attention: fused qkv projection, q/k rows normalized
    under ``use_cosine_attention``, 1/sqrt(head_dim) scale, output
    projection; the attention itself by ``cfg.attention_impl``
    (``ops/attention.py``).

    Under tensor parallelism (``tp_group`` set by
    ``DiT.load_tensor_parallel``) the rank holds the qkv rows of a block of
    whole heads and the matching input columns of the out-projection: it
    attends over its heads and the out-projection's partials are summed over
    the group (:meth:`MPLinear.row_parallel`); under autograd the input
    enters through :func:`copy_to_model_ranks`."""

    def __init__(self, cfg: DiTConfig, in_dim: int):
        super().__init__()
        self.num_heads = cfg.num_heads
        self.head_dim = in_dim // cfg.num_heads
        self.cosine, self.impl = cfg.use_cosine_attention, cfg.attention_impl
        self.qkv_proj = MPLinearSplit(in_dim, (in_dim,) * 3, cfg)
        self.out_proj = MPLinear(in_dim, in_dim, cfg)
        self.tp_group = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, t, _ = x.shape
        hd = self.head_dim
        if self.tp_group is not None and torch.is_grad_enabled():
            x = copy_to_model_ranks(x, self.tp_group)
        q, k, v = self.qkv_proj.product(x).chunk(3, dim=-1)
        h = q.shape[-1] // hd  # this rank's heads

        def to_heads(z):
            return z.reshape(b, t, h, hd).transpose(1, 2)

        out = dot_product_attention(
            to_heads(q), to_heads(k), to_heads(v), 1.0 / math.sqrt(hd), cosine=self.cosine, impl=self.impl
        )
        out = out.transpose(1, 2).reshape(b, t, h * hd)
        return self.out_proj(out) if self.tp_group is None else self.out_proj.row_parallel(out, self.tp_group)


class MLP(nn.Module):
    """fc1 -> (MP-)SiLU -> fc2, held as ``net`` = (fc1, act, fc2) so the
    parameter names are the reference's ``net.0`` / ``net.2``. Under tensor
    parallelism (``tp_group`` set) the rank holds a block of fc1's rows and
    the matching input columns of fc2, whose partials are summed over the
    group; under autograd the input enters through
    :func:`copy_to_model_ranks`."""

    def __init__(self, cfg: DiTConfig, in_dim: int, out_dim: int, hidden_dim: Optional[int] = None):
        super().__init__()
        self.dtype = cfg.dtype
        hidden = int(in_dim * cfg.mlp_ratio) if hidden_dim is None else hidden_dim
        self.net = nn.Sequential(MPLinear(in_dim, hidden, cfg), activation_module(cfg), MPLinear(hidden, out_dim, cfg))
        self.tp_group = None

    @property
    def fc1(self) -> MPLinear:
        return self.net[0]

    @property
    def fc2(self) -> MPLinear:
        return self.net[2]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.tp_group is None:
            return self.net(x)
        if torch.is_grad_enabled():
            x = copy_to_model_ranks(x, self.tp_group)
        return self.fc2.row_parallel(self.net[1](self.fc1(x)), self.tp_group)

    def fused_branch(self, x, shift, scale, gate, gain) -> torch.Tensor:
        """The whole MP-MLP half-block (modulate -> MLP -> gate -> mp_sum
        residual) through ``fused_mlp_branch`` (``ops/cuda/mlp_block.py``).
        MP + adaln family only."""
        from mapdit_tpu_torch.ops.cuda.mlp_block import fused_mlp_branch

        dt = self.dtype
        return fused_mlp_branch(
            x, shift.to(x.dtype), scale.to(x.dtype), gate.to(x.dtype), gain,
            self.fc1.effective_weight().to(dt), self.fc2.effective_weight().to(dt),
        )
