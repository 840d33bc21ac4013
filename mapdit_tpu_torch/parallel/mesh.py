"""A ('data', 'model') grid of ranks over torch.distributed, the weight
layouts of tensor parallelism (TP: the sampling islands, and the plain path
that samples and trains), and the fully-sharded (FSDP) layout of training
over the data axis.

Port of ``mapdit_tpu/parallel/mesh.py``. The JAX
package lays its devices out as a (n_data, n_model) ``jax.sharding.Mesh``;
here the ranks of one process group form the same grid, data outermost:
rank = data_index * n_model + model_index.

  * **data**: the batch is split; a rank's data group holds the ranks with
    its model index, and the sampling runtime all-gathers its rows over it.
  * **model**: the weights of each block are split (:func:`tp_layout`,
    :func:`shard_state_dict`); a rank's model group holds the ranks with
    its data index, and the islands and the plain path all-reduce their
    partial branch outputs over it (the plain path's gradients too).
  * **fsdp** (:func:`fsdp_layout`): training's parameters, Adam moments and
    EMA copies sharded (ZeRO-3) over the data axis, on the free dim of a
    TP-split matrix; the data axis plays both roles, as in the JAX
    package.

Backend: NCCL when every rank has a card of its own, gloo when ranks share
a card (NCCL refuses two ranks on one device) or run on the CPU. The choice
is printed. Nothing moves a rank to the CPU unless the caller asks for it.
Gloo takes ``all_reduce``, ``all_gather``, ``all_gather_into_tensor``,
``reduce_scatter_tensor`` and ``broadcast`` on CPU tensors and (torch 2.11
and later) on CUDA tensors, which it stages through host memory itself.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
import tempfile
from typing import Callable, Dict, Optional, Tuple

import torch
import torch.distributed as dist

from mapdit_tpu_torch.models.config import TP_KERNELS

DATA_AXIS = "data"
MODEL_AXIS = "model"


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This rank's place in the (n_data, n_model) grid and its two groups
    (None on a mesh built by hand, for the sharding rules alone)."""

    n_data: int
    n_model: int
    rank: int
    device: torch.device
    data_group: Optional[object] = None
    model_group: Optional[object] = None

    @property
    def size(self) -> int:
        return self.n_data * self.n_model

    @property
    def data_index(self) -> int:
        return self.rank // self.n_model

    @property
    def model_index(self) -> int:
        return self.rank % self.n_model

    @property
    def lead(self) -> bool:
        """Whether this rank writes the files of a run (rank 0)."""
        return self.rank == 0


def choose_backend(device: torch.device, ranks_on_host: int) -> str:
    """NCCL when every rank of the host has a card of its own, else gloo."""
    if torch.device(device).type == "cuda" and ranks_on_host <= torch.cuda.device_count():
        return "nccl"
    return "gloo"


def _announce(rank: int, world: int, backend: str, device: torch.device) -> None:
    why = "one card per rank" if backend == "nccl" else (
        "ranks share a card" if torch.device(device).type == "cuda" else "CPU ranks")
    print(f"[dist] rank={rank} world={world} backend={backend} device={device} ({why})", flush=True)


def _rank_device(device, local_rank: int) -> torch.device:
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "mapdit_tpu_torch ranks run on CUDA by default and no CUDA device is available; "
            "pass device='cpu' to run the ranks on the CPU"
        )
    return torch.device("cuda", local_rank % torch.cuda.device_count())


def init_distributed(device=None, timeout_s: Optional[float] = None) -> torch.device:
    """Join the process group that ``torchrun`` describes in the environment
    (RANK, WORLD_SIZE, LOCAL_RANK, LOCAL_WORLD_SIZE, MASTER_ADDR,
    MASTER_PORT): the counterpart of ``jax.distributed.initialize``. Returns
    this rank's device: ``cuda:LOCAL_RANK % cards`` unless ``device`` is
    given. The backend follows :func:`choose_backend`. ``timeout_s`` bounds
    every collective's wait (torch's default, 10 or 30 minutes by backend,
    when None)."""
    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    local_rank = int(os.environ.get("LOCAL_RANK", rank))
    dev = _rank_device(device, local_rank)
    backend = choose_backend(dev, int(os.environ.get("LOCAL_WORLD_SIZE", world)))
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    kw = {} if timeout_s is None else {"timeout": datetime.timedelta(seconds=timeout_s)}
    dist.init_process_group(backend, init_method="env://", rank=rank, world_size=world, **kw)
    _announce(rank, world, backend, dev)
    return dev


def _spawned(rank, fn, world, store, device, args):
    dev = _rank_device(device, rank)
    backend = choose_backend(dev, world)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, init_method=f"file://{store}", rank=rank, world_size=world)
    _announce(rank, world, backend, dev)
    try:
        fn(rank, dev, *args)
    finally:
        dist.destroy_process_group()


def spawn(fn: Callable, nprocs: int, args=(), device=None) -> None:
    """Run ``fn(rank, device, *args)`` in ``nprocs`` new processes that form
    one process group over a ``file://`` store in a temporary directory (no
    TCP port to collide with another group's). Raises if a rank fails.
    ``device=None`` puts rank r on ``cuda:r % cards``; ``"cpu"`` keeps every
    rank on the CPU. The backend follows :func:`choose_backend`. ``fn`` must
    be importable by the new processes."""
    import torch.multiprocessing as mp

    with tempfile.TemporaryDirectory(prefix="mapdit_dist_") as tmp:
        mp.spawn(_spawned, args=(fn, nprocs, os.path.join(tmp, "store"), device, tuple(args)),
                 nprocs=nprocs, join=True)


def make_mesh(n_data: Optional[int] = None, n_model: int = 1, device=None) -> Mesh:
    """This rank's mesh over the initialised default group. Every rank
    creates every subgroup (``dist.new_group`` must be called by all ranks
    in the same order) and keeps its own two. ``device`` (where the rank's
    model and batch live) defaults to the current CUDA device; pass "cpu"
    for CPU ranks."""
    world, rank = dist.get_world_size(), dist.get_rank()
    if n_data is None:
        n_data = world // n_model
    if n_data * n_model != world:
        raise ValueError(f"a ({n_data}, {n_model}) mesh needs {n_data * n_model} ranks, the group has {world}")
    groups = {}
    for m in range(n_model):
        ranks = [d * n_model + m for d in range(n_data)]
        group = dist.new_group(ranks)
        if rank in ranks:
            groups[DATA_AXIS] = group
    for d in range(n_data):
        ranks = [d * n_model + m for m in range(n_model)]
        group = dist.new_group(ranks)
        if rank in ranks:
            groups[MODEL_AXIS] = group
    if device is None:
        device = _rank_device(None, torch.cuda.current_device() if torch.cuda.is_available() else 0)
    return Mesh(n_data, n_model, rank, torch.device(device), groups[DATA_AXIS], groups[MODEL_AXIS])


def mean_all_reduce_(tensors, group) -> None:
    """Replace each tensor of ``tensors`` (one dtype and device) by its mean
    over the ranks of ``group``, in place, with one all-reduce of a flat
    buffer (none over a group of one rank, the data group of a mesh that is
    all model axis)."""
    tensors = list(tensors)
    if not tensors or dist.get_world_size(group) == 1:
        return
    flat = torch.cat([t.reshape(-1) for t in tensors])
    dist.all_reduce(flat, group=group)
    flat.div_(dist.get_world_size(group))
    torch._foreach_copy_(tensors, [f.view_as(t) for f, t in zip(flat.split([t.numel() for t in tensors]), tensors)])


def any_rank(flag: bool, device, group=None) -> bool:
    """Whether ``flag`` is set on any rank of ``group`` (default: the
    world): the agreement every rank reaches at the same point, so that all
    of them leave a loop of collectives at the same step."""
    t = torch.tensor([1.0 if flag else 0.0], device=device)
    dist.all_reduce(t, op=dist.ReduceOp.MAX, group=group)
    return bool(t.item())


def broadcast_str(text: Optional[str], src: int = 0) -> str:
    """``text`` of rank ``src`` on every rank of the world."""
    box = [text]
    dist.broadcast_object_list(box, src=src)
    return box[0]


def all_gather_rows(x: torch.Tensor, group) -> torch.Tensor:
    """Concatenate every rank's ``x`` along dim 0 in rank order. Gloo cannot
    all-gather CUDA tensors; under gloo they pass through host memory."""
    through_host = x.is_cuda and dist.get_backend(group) == "gloo"
    part = x.cpu() if through_host else x.contiguous()
    parts = [torch.empty_like(part) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, part, group=group)
    return torch.cat(parts).to(x.device)


def check_replicated(state_dict: Dict[str, torch.Tensor], device) -> None:
    """Raise unless every rank of the default group holds the same tensors:
    per-tensor float64 sums all-reduced by min and by max must agree."""
    keys = sorted(state_dict)
    sums = torch.stack([state_dict[k].detach().double().sum().to(device) for k in keys])
    lo, hi = sums.clone(), sums.clone()
    dist.all_reduce(lo, op=dist.ReduceOp.MIN)
    dist.all_reduce(hi, op=dist.ReduceOp.MAX)
    differ = [k for k, a, b in zip(keys, lo.tolist(), hi.tolist()) if a != b]
    if differ:
        raise RuntimeError(f"ranks hold different tensors: {differ[:5]}")


# ---------------------------------------------------------------------------
# the FSDP layout of training


def fsdp_layout(named_params: Dict[str, torch.Tensor], mesh: Mesh,
                tp_dims: Optional[Dict[str, Optional[int]]] = None) -> Dict[str, Optional[int]]:
    """The dim of each parameter that FSDP shards over the data ranks, or
    None where it stays replicated: the data-axis rule of JAX
    ``param_sharding(..., fsdp=True)`` (``mapdit_tpu/parallel/mesh.py:61-122``).

      * a ``weight`` matrix (2-D, or 3-D stacked on a depth axis under
        ``scan_blocks``: the same rule one axis later) shards its out-rows,
        where the forced weight normalization stays shard-local, and falls
        back to its in-columns;
      * a matrix that the model axis splits (``tp_dims``, name -> the dim it
        splits, :func:`tp_layout`) takes the data axis on its free dim;
      * a dim that the data size does not divide is never sharded;
      * gather-indexed tables (``*.embedding.weight``), everything under
        ``t_embedder``, gains, biases and other tensors stay replicated.

    Applied by parameter name, the same rule lays out the Adam moments and
    the EMA copies."""
    tp_dims = tp_dims or {}
    out = {}
    for name, p in named_params.items():
        names = name.split(".")
        out[name] = None
        if mesh.n_data == 1 or names[-1] != "weight" or p.ndim not in (2, 3):
            continue
        if (len(names) >= 2 and names[-2] == "embedding") or "t_embedder" in names:
            continue
        off = p.ndim - 2
        free = [dim for dim in (off, off + 1) if dim != tp_dims.get(name)]
        out[name] = next((dim for dim in free if p.shape[dim] % mesh.n_data == 0), None)
    return out


# ---------------------------------------------------------------------------
# weight layouts of tensor parallelism: the islands and the plain path

PLAIN_TP = "off"  # the layout of the plain path, named by its block kernel


def plain_tp_splits(cfg, tp: int):
    """(attention split, MLP split) of the plain path's layout on ``tp``
    model ranks: each half splits where its heads (its hidden width)
    divide over the ranks and stays whole on every rank otherwise, as JAX
    ``param_sharding`` leaves a dim the model axis does not divide."""
    return cfg.num_heads % tp == 0, int(cfg.hidden_size * cfg.mlp_ratio) % tp == 0


def _block_module(name: str):
    """(module path inside a block, attribute, axis offset) of a block
    tensor: ``blocks.{i}.<module>.<attr>`` (offset 0) or, in the
    ``scan_blocks`` layout, ``blocks.<module>.<attr>`` stacked on a leading
    depth axis (offset 1); None for any other tensor."""
    parts = name.split(".")
    if len(parts) < 3 or parts[0] != "blocks":
        return None
    stacked = not parts[1].isdigit()
    inner = parts[1:-1] if stacked else parts[2:-1]
    return ".".join(inner), parts[-1], int(stacked)


def _tp_split(name: str, kernel: str, splits=(True, True)) -> Optional[str]:
    """How a block tensor splits over the model axis: "qkv" (viewed
    (3, D, ...), split on axis 1), "rows" or "cols"; None: replicated.
    ``splits`` is the plain layout's (attention, MLP) of
    :func:`plain_tp_splits`. A ``scan_blocks`` tensor splits the same way,
    one axis later (:func:`_block_module`)."""
    where = _block_module(name)
    if where is None or where[1] not in ("weight", "bias"):
        return None
    module, attr, _ = where
    if kernel == PLAIN_TP:
        attn, mlp = splits
        split = {
            ("attn.qkv_proj", "weight"): "qkv" if attn else None,
            ("attn.qkv_proj", "bias"): "qkv" if attn else None,
            ("attn.out_proj", "weight"): "cols" if attn else None,
            ("mlp.net.0", "weight"): "rows" if mlp else None,
            ("mlp.net.0", "bias"): "rows" if mlp else None,
            ("mlp.net.2", "weight"): "cols" if mlp else None,
        }
        return split.get((module, attr))
    if attr != "weight":
        return None
    if module == "attn.qkv_proj":
        return "qkv"
    if module == "attn.out_proj":
        return "cols"
    if kernel == "mega_tp" and module == "mlp.net.0":
        return "rows"
    if kernel == "mega_tp" and module == "mlp.net.2":
        return "cols"
    return None


def tp_layout(names, cfg, tp: int, kernel: str = PLAIN_TP) -> Dict[str, Optional[Tuple[str, int]]]:
    """(split, axis offset) of each tensor name over ``tp`` model ranks
    (:func:`_tp_split`; offset 1 for a ``scan_blocks`` stack), None where
    it is replicated. Everything is replicated on a model axis of 1."""
    splits = plain_tp_splits(cfg, tp)
    out = {}
    for name in names:
        split = _tp_split(name, kernel, splits) if tp > 1 else None
        out[name] = None if split is None else (split, _block_module(name)[2])
    return out


def tp_dim(where: Optional[Tuple[str, int]]) -> Optional[int]:
    """The dim of the whole tensor that a :func:`tp_layout` entry splits."""
    if where is None:
        return None
    split, off = where
    return off + 1 if split == "cols" else off


def shard_tensor(value: torch.Tensor, split: str, tp: int, index: int, off: int = 0) -> torch.Tensor:
    """Shard ``index`` of ``tp`` of one weight or bias by ``split`` (see
    _tp_split), as a tensor of its own; ``off`` leading axes (the depth axis
    of a ``scan_blocks`` stack) stay whole."""
    lead = value.shape[:off]
    if split == "qkv":
        rows = value.shape[off] // 3
        d_l = rows // tp
        three = value.reshape(*lead, 3, rows, *value.shape[off + 1 :])
        part = three.narrow(off + 1, index * d_l, d_l)
        return part.reshape(*lead, 3 * d_l, *value.shape[off + 1 :]).clone()
    dim = off if split == "rows" else off + 1
    size = value.shape[dim] // tp
    return value.narrow(dim, index * size, size).clone()


def unshard_tensor(parts, split: str, off: int = 0) -> torch.Tensor:
    """The inverse of :func:`shard_tensor`: the whole tensor from every
    rank's shard, in model-rank order. Dims other than the split one may be
    sliced (an FSDP slice), as long as every part is sliced alike."""
    if split == "qkv":
        like = parts[0]
        lead, d_l = like.shape[:off], like.shape[off] // 3
        views = [p.reshape(*lead, 3, d_l, *like.shape[off + 1 :]) for p in parts]
        whole = torch.cat(views, dim=off + 1)
        return whole.reshape(*lead, 3 * d_l * len(parts), *like.shape[off + 1 :])
    return torch.cat(list(parts), dim=off if split == "rows" else off + 1)


def shard_state_dict(state_dict: Dict[str, torch.Tensor], cfg, mesh: Mesh, kernel: str) -> Dict[str, torch.Tensor]:
    """This rank's tensors of the tensor-parallel layout ``kernel``: an
    island (``blocks.py:395-398, 468-471`` of the JAX package) over a
    folded state dict, or the plain path (``PLAIN_TP``, the twin of JAX
    ``param_sharding``'s model axis, ``mapdit_tpu/parallel/mesh.py:61-119``)
    over folded or raw weights:

      * qkv (3D, D) is viewed (3, D, D) and split on axis 1, so each rank
        holds the same whole heads of q, k and v, stacked (3*D_l, D);
      * the out-projection is split on its input columns (D, D_l);
      * under ``mega_tp`` and the plain path fc1 is split on its rows
        (H_l, D), fc2 on its columns (D, H_l);
      * on the plain path a column-parallel bias (qkv, fc1; the vanilla
        family has biases) is split with its rows; a row-parallel bias
        (out-proj, fc2) stays whole and is added once, after the sum;
        a half whose heads (hidden width) do not divide stays whole;
      * the 3-D stacks of ``scan_blocks`` split the same way, one axis
        later;
      * everything else is replicated.

    The islands take folded weights, sharded after folding. The plain path
    also takes raw weight-normalized ones: a column slice of out-proj or fc2
    is then normalized by its whole rows' norm, whose squares the model
    ranks sum (``layers.MPLinear.product`` with a group), and a folded one
    is never normalized again."""
    if kernel not in (*TP_KERNELS, PLAIN_TP):
        raise ValueError(f"shard_state_dict shards for {TP_KERNELS} and the plain path {PLAIN_TP!r}, got {kernel!r}")
    if kernel != PLAIN_TP and cfg.use_weight_normalization and not cfg.fold_weights:
        raise ValueError(f"{kernel} takes folded weights: fold the full state dict, then shard it")
    tp, index = mesh.n_model, mesh.model_index
    if kernel != PLAIN_TP:
        hidden = int(cfg.hidden_size * cfg.mlp_ratio)
        if cfg.num_heads % tp or (kernel == "mega_tp" and hidden % tp):
            raise ValueError(f"{cfg.num_heads} heads and hidden width {hidden} do not split over {tp} model ranks")
    layout = tp_layout(state_dict, cfg, tp, kernel)
    out = {}
    for name, value in state_dict.items():
        where = layout[name]
        out[name] = value if where is None else shard_tensor(value, where[0], tp, index, where[1])
    return out
