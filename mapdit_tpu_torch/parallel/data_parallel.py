"""What one rank holds of a model's parameters in data-parallel (DP),
fully-sharded (FSDP, ZeRO-3 over the data axis) and tensor-parallel (TP)
training, and the collectives of a train step.

The JAX package trains on one GSPMD program over its ('data', 'model')
mesh, and XLA inserts the gradient reduction, the TP collectives and, under
``--fsdp``, the gathers and reduce-scatters. Here each rank is a process of
its own (``parallel/mesh.py``), and :class:`DataParallel` makes the
collectives:

  * **TP** (a model axis of two or more ranks): the model holds the rank's
    shard of each split block tensor (``parallel.mesh.tp_layout``: qkv and
    fc1 rows, out-proj and fc2 input columns), and its forward and backward
    make the model group's collectives (``models/layers.py``). Every model
    rank of a data index computes the same loss and the same whole
    gradients of the replicated tensors; nothing is reduced over the model
    group after the backward.
  * **DP**: every data rank holds its model's parameters whole. After the
    local backward the gradients are averaged over the data group with one
    all-reduce of a flat buffer.
  * **FSDP**: :func:`~mapdit_tpu_torch.parallel.mesh.fsdp_layout` picks a
    sharded dim per parameter (the free dim of a TP-split one). A rank holds
    its slice of each sharded parameter, as a view of one flat buffer
    (``flat``); Adam, the EMAs and the forced weight normalization update
    those slices. The model's parameters of the sharded names are views of
    a second flat buffer, which one all-gather of ``flat`` refills after
    every update: the whole tree at once (gathering block by block is
    ROADMAP A.0). The gradients of the whole parameters are packed
    rank-major into one flat buffer and reduce-scattered, so that the held
    slices' gradients are views of one buffer too. Replicated parameters
    (the rule's gains, embedding table, ``t_embedder``) are the model's own
    tensors, their gradients averaged by one all-reduce.

A sharded parameter's slice: the parameter viewed as (pre, n, cp), where
``pre`` is the product of the dims before the sharded one and ``cp`` the
rest of a slice, has rank r's slice at ``[:, r]``. "Whole" below means a
tensor of the one-device model: gathered over both axes.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional

import torch
import torch.distributed as dist

from mapdit_tpu_torch.models.dit import forced_wn, project_weights
from mapdit_tpu_torch.ops.mp import normalize
from mapdit_tpu_torch.parallel.mesh import (
    Mesh,
    fsdp_layout,
    mean_all_reduce_,
    shard_tensor,
    tp_dim,
    tp_layout,
    unshard_tensor,
)


def global_norm(tensors: List[torch.Tensor]) -> torch.Tensor:
    """The L2 norm of all of ``tensors`` together."""
    return torch.linalg.vector_norm(torch.stack(torch._foreach_norm(tensors)))


class DataParallel:
    """One rank's part of ``model``'s parameters on ``mesh`` (DP, or FSDP
    with ``fsdp=True``; TP where the mesh has a model axis, the model then
    already holding this rank's TP shards, ``DiT.load_tensor_parallel``).
    Every rank of the mesh must build it at the same point, on the same
    weights. Under FSDP it makes the model's parameters of the sharded
    names views of its own buffer."""

    def __init__(self, model: torch.nn.Module, mesh: Mesh, fsdp: bool):
        self.mesh, self.fsdp = mesh, fsdp
        self.group, self.n, self.index = mesh.data_group, mesh.n_data, mesh.data_index
        self.model_group, self.tp, self.model_index = mesh.model_group, mesh.n_model, mesh.model_index
        self.model = model
        params = dict(model.named_parameters())
        # the model axis: name -> (split, axis offset) of the whole tensor
        self.tp_layout = tp_layout(params, model.cfg, mesh.n_model) if mesh.n_model > 1 else dict.fromkeys(params)
        self.tp_split = [k for k, where in self.tp_layout.items() if where is not None]
        tp_dims = {k: tp_dim(where) for k, where in self.tp_layout.items()}
        self.layout: Dict[str, Optional[int]] = fsdp_layout(params, mesh, tp_dims) if fsdp else dict.fromkeys(params)
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

    @property
    def splits(self) -> bool:
        """Whether any tensor is split over an axis: then :meth:`gather`
        is a collective that gives new tensors."""
        return bool(self.sharded or self.tp_split)

    def whole_shape(self, name: str) -> tuple:
        shape, where = list(self.shapes[name]), self.tp_layout[name]
        if where is not None:
            dim = tp_dim(where)
            shape[dim] *= self.tp
        return tuple(shape)

    def tp_part(self, whole: torch.Tensor, name: str) -> torch.Tensor:
        """This rank's TP shard of the whole tensor ``whole`` of parameter
        ``name``, the shape the model holds (``whole`` itself where the
        model axis does not split it)."""
        where = self.tp_layout[name]
        return whole if where is None else shard_tensor(whole, where[0], self.tp, self.model_index, where[1])

    def held_part(self, whole: torch.Tensor, name: str) -> torch.Tensor:
        """What this rank holds of the whole tensor ``whole``: its TP shard,
        then its FSDP slice of that."""
        return self.local(self.tp_part(whole, name), name)

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
        """A tree in the held layout as whole tensors. Where a tensor is
        split (:attr:`splits`): one all-gather over the data group under
        FSDP, then one over the model group under TP, which every rank of
        the mesh must call, and every tensor a new one (the replicated ones
        cloned), so that a background writer may hold the tree while
        training goes on. Under DP alone: the tree itself, its live
        tensors."""
        if not self.splits:
            return dict(tree)
        split = set(self.sharded) | set(self.tp_split)  # the gathers below give these new tensors
        with torch.no_grad():
            out = {name: t.detach() if name in split else t.detach().clone() for name, t in tree.items()}
            if self.sharded:
                part = torch.cat([tree[name].reshape(-1) for name in self.sharded])
                stage = part.new_empty(self.n * self.shard_numel)
                dist.all_gather_into_tensor(stage, part, group=self.group)
                out.update({name: stage.new_empty(self.shapes[name]) for name in self.sharded})
                self._unpack(stage, {name: out[name] for name in self.sharded})
        return self.gather_model(out, fresh=True)

    def gather_model(self, tree: Dict[str, torch.Tensor], fresh: bool = False) -> Dict[str, torch.Tensor]:
        """``tree`` (by parameter name, in the model's layout or its FSDP
        slices of it) with each TP-split tensor gathered over the model
        group: one all-gather, which every rank of the model group must
        call. The other tensors as they are (cloned unless ``fresh``, so
        that the tree holds no live tensor)."""
        with torch.no_grad():
            out = {name: t.detach() if fresh else t.detach().clone() for name, t in tree.items()}
            if not self.tp_split:
                return out
            names = [k for k in self.tp_split if k in tree]
            part = torch.cat([tree[k].detach().reshape(-1) for k in names])
            stage = part.new_empty(self.tp * part.numel())
            dist.all_gather_into_tensor(stage, part, group=self.model_group)
            rows = stage.view(self.tp, part.numel())
            at = 0
            for k in names:
                t = tree[k]
                split, off = self.tp_layout[k]
                out[k] = unshard_tensor([r[at : at + t.numel()].view(t.shape) for r in rows], split, off)
                at += t.numel()
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
        """The global L2 norm of the averaged gradients, every element of
        the whole tree counted once: the squares of FSDP slices summed over
        the data group, those of TP shards over the model group, the
        replicated tensors' counted once."""
        if not self.splits:
            return global_norm(self.grads())
        tp_split = set(self.tp_split)
        # by (FSDP-sharded, TP-split): the sums of squares of each kind
        kinds = {(d, m): [] for d in (False, True) for m in (False, True)}
        for name, t in self.held.items():
            if t.grad is not None:
                kinds[(self.layout[name] is not None, name in tp_split)].append(t.grad)
        like = next(iter(self.held.values()))
        sq = {kind: torch.stack(torch._foreach_norm(g)).square().sum() if g else like.new_zeros(())
              for kind, g in kinds.items()}
        if self.sharded:
            data = torch.stack([sq[(True, False)], sq[(True, True)]])
            dist.all_reduce(data, group=self.group)
            sq[(True, False)], sq[(True, True)] = data.unbind()
        if self.tp_split:
            model = torch.stack([sq[(False, True)], sq[(True, True)]])
            dist.all_reduce(model, group=self.model_group)
            sq[(False, True)], sq[(True, True)] = model.unbind()
        return (sq[(False, False)] + sq[(True, False)] + sq[(False, True)] + sq[(True, True)]).sqrt()

    @torch.no_grad()
    def project(self, cfg) -> None:
        """The forced weight normalization on the held tensors: a tensor
        whose rows it holds whole is normalized where it lies; one whose
        input columns are split (an FSDP slice of in-columns over the data
        group, a TP shard of out-proj or fc2 over the model group) divides
        by the norm of its whole rows, whose squares are summed over the
        group(s) that split them."""
        if not self.splits:
            project_weights(self.model, cfg)
            return
        tp_cols = {k for k in self.tp_split if self.tp_layout[k][0] == "cols"}
        cols = []  # (tensor, split over data, split over model)
        for name, t in self.held.items():
            if not forced_wn(name, t, cfg):
                continue
            on_data, on_model = self.layout[name] == t.ndim - 1, name in tp_cols
            if on_data or on_model:
                cols.append((t, on_data, on_model))
            else:
                t.copy_(normalize(t))
        if not cols:
            return
        sq = [t.square().sum(dim=-1).reshape(-1) for t, _, _ in cols]
        for axis, group in ((1, self.group), (2, self.model_group)):
            picked = [i for i, c in enumerate(cols) if c[axis]]
            if picked:
                flat = torch.cat([sq[i] for i in picked])
                dist.all_reduce(flat, group=group)
                for i, s in zip(picked, flat.split([sq[i].numel() for i in picked])):
                    sq[i] = s
        for (t, on_data, on_model), s in zip(cols, sq):
            dim = t.shape[-1] * (self.n if on_data else 1) * (self.tp if on_model else 1)
            t.copy_(normalize(t, norm=s.sqrt().view(t.shape[:-1] + (1,)), dim=dim))
