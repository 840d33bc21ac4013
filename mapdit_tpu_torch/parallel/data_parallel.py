"""What one data rank holds of a model's parameters in data-parallel (DP)
and fully-sharded (FSDP, ZeRO-3 over the data axis) training, and the
collectives of a train step.

The JAX package trains on one GSPMD program over its ('data', 'model')
mesh, and XLA inserts the gradient reduction and, under ``--fsdp``, the
gathers and reduce-scatters. Here each data rank is a process of its own
(``parallel/mesh.py``), and :class:`DataParallel` makes the collectives:

  * **DP**: every rank holds every parameter whole. After the local
    backward the gradients are averaged over the data group with one
    all-reduce of a flat buffer.
  * **FSDP**: :func:`~mapdit_tpu_torch.parallel.mesh.fsdp_layout` picks a
    sharded dim per parameter. A rank holds its slice of each sharded
    parameter, as a view of one flat buffer (``flat``); Adam, the EMAs and
    the forced weight normalization update those slices. The model's
    parameters of the sharded names are views of a second flat buffer, which
    one all-gather of ``flat`` refills after every update: the whole tree at
    once (gathering block by block is ROADMAP A.0). The gradients of the
    whole parameters are packed rank-major into one flat buffer and
    reduce-scattered, so that the held slices' gradients are views of one
    buffer too. Replicated parameters (the rule's gains, embedding table,
    ``t_embedder``) are the model's own tensors, their gradients averaged by
    one all-reduce.

A sharded parameter's slice: the parameter viewed as (pre, n, cp), where
``pre`` is the product of the dims before the sharded one and ``cp`` the
rest of a slice, has rank r's slice at ``[:, r]``.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional

import torch
import torch.distributed as dist

from mapdit_tpu_torch.models.dit import forced_wn, project_weights
from mapdit_tpu_torch.ops.mp import normalize
from mapdit_tpu_torch.parallel.mesh import Mesh, fsdp_layout, mean_all_reduce_


def global_norm(tensors: List[torch.Tensor]) -> torch.Tensor:
    """The L2 norm of all of ``tensors`` together."""
    return torch.linalg.vector_norm(torch.stack(torch._foreach_norm(tensors)))


class DataParallel:
    """One data rank's part of ``model``'s parameters on ``mesh`` (DP, or
    FSDP with ``fsdp=True``). Every rank of the data group must build it at
    the same point, on the same weights. Under FSDP it makes the model's
    parameters of the sharded names views of its own buffer."""

    def __init__(self, model: torch.nn.Module, mesh: Mesh, fsdp: bool):
        if mesh.n_model != 1:
            raise ValueError(f"DataParallel takes a (n_data, 1) mesh, got ({mesh.n_data}, {mesh.n_model})")
        self.mesh, self.fsdp = mesh, fsdp
        self.group, self.n, self.index = mesh.data_group, mesh.n_data, mesh.data_index
        self.model = model
        params = dict(model.named_parameters())
        self.layout: Dict[str, Optional[int]] = fsdp_layout(params, mesh) if fsdp else dict.fromkeys(params)
        self.sharded = [k for k, dim in self.layout.items() if dim is not None]
        self.replicated = [k for k, dim in self.layout.items() if dim is None]
        self.shapes = {k: tuple(p.shape) for k, p in params.items()}
        self._spec = {}  # name -> (offset in a rank's flat slice, its numel, pre, cp)
        offset = 0
        for name in self.sharded:
            dim, numel = self.layout[name], params[name].numel()
            pre = math.prod(self.shapes[name][:dim])
            self._spec[name] = (offset, numel // self.n, pre, numel // self.n // pre)
            offset += numel // self.n
        self.shard_numel = offset
        self.held: Dict[str, torch.Tensor] = {}
        if not self.sharded:
            self.held = params
            return
        like = params[self.sharded[0]]
        self.flat = torch.empty(offset, dtype=like.dtype, device=like.device)
        self.grad_flat = torch.zeros_like(self.flat)
        full = torch.empty(sum(params[k].numel() for k in self.sharded), dtype=like.dtype, device=like.device)
        at = 0
        with torch.no_grad():
            for name, p in params.items():
                if self.layout[name] is None:
                    self.held[name] = p
                    continue
                view = full[at : at + p.numel()].view_as(p)
                view.copy_(p)
                p.data = view
                at += p.numel()
                o, k, _, _ = self._spec[name]
                shard = self.flat[o : o + k].view(self.shard_shape(name))
                shard.copy_(self.local(p, name))
                self.held[name] = shard
        self._attach_grads()

    # -- layout --------------------------------------------------------------

    def shard_shape(self, name: str) -> tuple:
        shape, dim = list(self.shapes[name]), self.layout[name]
        if dim is not None:
            shape[dim] //= self.n
        return tuple(shape)

    def local(self, full: torch.Tensor, name: str) -> torch.Tensor:
        """This rank's slice of the whole tensor ``full`` of parameter
        ``name`` (a copy; ``full`` itself where it is replicated)."""
        if self.layout[name] is None:
            return full
        _, _, pre, cp = self._spec[name]
        return full.reshape(pre, self.n, cp)[:, self.index].reshape(self.shard_shape(name)).clone()

    def gather(self, tree: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """A tree in the held layout as whole tensors. Under FSDP: one
        all-gather over the data group, which every rank of the group must
        call, and every tensor a new one (the replicated ones cloned), so
        that a background writer may hold the tree while training goes on.
        Under DP: the tree itself, its live tensors."""
        if not self.sharded:
            return dict(tree)
        part = torch.cat([tree[name].reshape(-1) for name in self.sharded])
        stage = part.new_empty(self.n * self.shard_numel)
        dist.all_gather_into_tensor(stage, part, group=self.group)
        with torch.no_grad():
            out = {name: t.detach().clone() if self.layout[name] is None else stage.new_empty(self.shapes[name])
                   for name, t in tree.items()}
        self._unpack(stage, {name: out[name] for name in self.sharded})
        return out

    def _unpack(self, stage: torch.Tensor, targets: Dict[str, torch.Tensor]) -> None:
        rows = stage.view(self.n, self.shard_numel)
        for name, t in targets.items():
            o, k, pre, cp = self._spec[name]
            t.view(pre, self.n, cp).copy_(rows[:, o : o + k].view(self.n, pre, cp).transpose(0, 1))

    # -- the train step ------------------------------------------------------

    @torch.no_grad()
    def gather_params(self) -> None:
        """Refill the model's whole parameters from the held slices (one
        all-gather under FSDP; nothing under DP)."""
        if not self.sharded:
            return
        stage = self.flat.new_empty(self.n * self.shard_numel)
        dist.all_gather_into_tensor(stage, self.flat, group=self.group)
        params = dict(self.model.named_parameters())
        self._unpack(stage, {name: params[name] for name in self.sharded})

    def _attach_grads(self) -> None:
        for name in self.sharded:
            o, k, _, _ = self._spec[name]
            self.held[name].grad = self.grad_flat[o : o + k].view(self.shard_shape(name))

    @torch.no_grad()
    def reduce_grads(self) -> None:
        """After the local backward: the held tensors' gradients become the
        mean over the data group of every rank's gradients. Under FSDP the
        whole gradients of the sharded names are reduce-scattered into the
        held slices' and then dropped."""
        params = dict(self.model.named_parameters())
        if self.sharded:
            stage = self.flat.new_empty(self.n * self.shard_numel)
            rows = stage.view(self.n, self.shard_numel)
            for name in self.sharded:
                o, k, pre, cp = self._spec[name]
                p = params[name]
                rows[:, o : o + k].view(self.n, pre, cp).copy_(p.grad.view(pre, self.n, cp).transpose(0, 1))
                p.grad = None
            dist.reduce_scatter_tensor(self.grad_flat, stage, group=self.group)
            self.grad_flat.div_(self.n)
            self._attach_grads()
        mean_all_reduce_([params[k].grad for k in self.replicated if params[k].grad is not None], self.group)

    def grads(self) -> List[torch.Tensor]:
        return [t.grad for t in self.held.values() if t.grad is not None]

    @torch.no_grad()
    def grad_norm(self) -> torch.Tensor:
        """The global L2 norm of the averaged gradients: under FSDP the
        slices' squares summed over the group, the replicated tensors'
        counted once."""
        if not self.sharded:
            return global_norm(self.grads())
        sq = torch.stack(torch._foreach_norm([self.held[k].grad for k in self.sharded])).square().sum()
        dist.all_reduce(sq, group=self.group)
        rep = [self.held[k].grad for k in self.replicated if self.held[k].grad is not None]
        if rep:
            sq = sq + torch.stack(torch._foreach_norm(rep)).square().sum()
        return sq.sqrt()

    @torch.no_grad()
    def project(self, cfg) -> None:
        """The forced weight normalization on the held tensors: a slice of
        out-rows is normalized where it lies; a slice of in-columns divides
        by the norm of its whole rows, whose squares are summed over the
        data group."""
        if not self.sharded:
            project_weights(self.model, cfg)
            return
        cols = []
        for name, t in self.held.items():
            if not forced_wn(name, t, cfg):
                continue
            if self.layout[name] == t.ndim - 1:
                cols.append(t)
            else:
                t.copy_(normalize(t))
        if cols:
            sq = torch.cat([t.square().sum(dim=-1).reshape(-1) for t in cols])
            dist.all_reduce(sq, group=self.group)
            for t, s in zip(cols, sq.split([t[..., 0].numel() for t in cols])):
                t.copy_(normalize(t, norm=s.sqrt().view(t.shape[:-1] + (1,)), dim=t.shape[-1] * self.n))
