"""Checkpointing and resume, port of ``mapdit_tpu/training/checkpoint.py``.

A checkpoint is one ``torch.save`` file, ``checkpoints/<step:07d>.pt``, of
the whole ``TrainState``: the model's state dict (reference names), the
optimizer's state dict (Adam moments and step counts), every EMA tree, the
step, the generator's state and the timestep sampler's state.
``restore_state`` loads it into a freshly built ``TrainState``, so a resumed
run continues the exact trajectory. Writes are atomic (a ``.tmp`` file, then
``os.replace``), and the default saver writes from a background thread after
one clone of the state on the device.

On a mesh (``TrainState.dp``) every rank calls the savers and the lead
(rank 0) writes; under FSDP and TP the state is first gathered whole, a
collective of the data group and then of the model group, so a file written
on any mesh holds the one-device tree. (The JAX package refuses its msgpack
file under multi-host FSDP because one process cannot address the shards of
other hosts; the port gathers them.)

The sharded format, ``checkpoints/<step:07d>.shards/`` (``--checkpointer
torch-sharded``, the counterpart of the JAX package's orbax directories):
each data rank writes its slices of the parameters, the Adam moments and
the EMA copies to ``rank<r:05d>.pt`` (rank 0 the replicated tensors too),
and the lead writes ``index.pt`` (the step, each parameter's sharded dim
and whole shape, the buffers, Adam's step counts and hyper-parameters, the
generator's and the timestep sampler's state, once). On a model axis the
slices are first gathered over the model group (the FSDP dim is never the
TP one, so they are the data slices of the whole tensors) and model rank 0
of each data index writes them. The ranks write into
``<step:07d>.shards.tmp/``, which the lead renames when all are done.
``restore_state`` reads either format into any mesh, one process
included: it loads the whole tree and takes the rank's part of it.
"""

from __future__ import annotations

import dataclasses
import os
import re
import shutil
import threading
from typing import Callable, Dict, Optional

import torch
import torch.distributed as dist

from mapdit_tpu_torch.diffusion.timestep_sampler import LossHistoryState

MAX_IN_FLIGHT = 2  # snapshots a background writer may hold at once


def checkpoint_path(exp_dir: str, step: int) -> str:
    return os.path.join(exp_dir, "checkpoints", f"{step:07d}.pt")


def sharded_path(exp_dir: str, step: int) -> str:
    return os.path.join(exp_dir, "checkpoints", f"{step:07d}.shards")


def is_lead(state) -> bool:
    """Whether this rank writes the files of the run: the mesh's lead, or
    the one process."""
    return state.dp is None or state.dp.mesh.lead


def map_tensors(tree, fn: Callable[[torch.Tensor], torch.Tensor]):
    """``tree`` (nested dicts, lists and tuples) with ``fn`` applied to
    every tensor leaf; other leaves as they are."""
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: map_tensors(v, fn) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_tensors(v, fn) for v in tree)
    return tree


def state_tree(state) -> dict:
    """The ``TrainState`` as a tree of tensors and plain values, the
    one-device tree. The tensors are the live ones: clone or copy them
    before the next train step. Where the mesh splits a tensor (FSDP, TP)
    the weights, the Adam moments and the EMA copies are gathered whole, a
    collective that every rank of the mesh must call, and the tree is on
    the host and holds no live tensor: a background writer may hold it
    while training goes on."""
    sampler = state.sampler_state
    tree = {
        "step": int(state.step),
        "model": state.model.state_dict(),
        "optimizer": state.optimizer.state_dict(),
        "ema": {key: dict(tree) for key, tree in state.ema.items()},
        "generator": state.generator.get_state(),
        "sampler_state": dataclasses.asdict(sampler) if isinstance(sampler, LossHistoryState) else None,
    }
    dp = state.dp
    if dp is None or not dp.splits:
        return tree
    names = list(dp.held)
    moments = ("exp_avg", "exp_avg_sq")
    opt = tree["optimizer"]
    live = opt["state"]
    # copies of the live tensors (the weights, Adam's step counts); the
    # gathers below give new ones
    whole = dp.gather_model(state.params, fresh=True)  # _host_copy copies them
    tree["model"] = _host_copy({k: whole.get(k, v) for k, v in tree["model"].items()})
    opt["state"] = {i: {k: v if k in moments else _host_copy(v) for k, v in st.items()} for i, st in live.items()}
    for slot in moments:
        whole = _to_host(dp.gather({names[i]: st[slot] for i, st in live.items()}))
        for i, st in opt["state"].items():
            st[slot] = whole[names[i]]
    tree["ema"] = {key: _to_host(dp.gather(ema)) for key, ema in tree["ema"].items()}
    return tree


def _to_host(tree):
    return map_tensors(tree, lambda t: t.detach().cpu())


def _host_copy(tree):
    """``tree`` on the host, every tensor a copy (``.cpu()`` copies no CPU
    tensor)."""
    return map_tensors(tree, lambda t: t.detach().to("cpu", copy=True))


def _cuda_device(tree) -> Optional[torch.device]:
    """The device of the first CUDA tensor in ``tree``, if any."""
    found = []
    map_tensors(tree, lambda t: found.append(t.device) if t.is_cuda and not found else None)
    return found[0] if found else None


def _write(path: str, host_tree) -> None:
    os.makedirs(os.path.dirname(path), exist_ok=True)
    # Atomic: a process killed mid-write must never leave a truncated
    # checkpoint behind. The .tmp name does not match _CKPT_RE, so a dead
    # partial write is invisible to latest_checkpoint.
    tmp = path + ".tmp"
    torch.save(host_tree, tmp)
    os.replace(tmp, path)


def save_state(exp_dir: str, step: int, state) -> str:
    """Write the checkpoint of ``state`` now, on the calling thread. On a
    mesh every rank calls it and the lead writes."""
    path = checkpoint_path(exp_dir, step)
    if is_lead(state) or (state.dp is not None and state.dp.splits):
        tree = _to_host(state_tree(state))
        if is_lead(state):
            _write(path, tree)
    return path


def _barrier(state) -> None:
    """A barrier of every rank of the mesh: its data group, then its model
    group."""
    if state.dp is not None:
        dist.barrier(group=state.dp.group)
        if state.dp.tp > 1:
            dist.barrier(group=state.dp.model_group)


def save_sharded(exp_dir: str, step: int, state) -> str:
    """Write the sharded checkpoint of ``state`` (see the module docstring)
    on the calling thread: a collective that every rank of the mesh must
    call; on one process, the same files for one rank."""
    final = sharded_path(exp_dir, step)
    tmp = final + ".tmp"
    dp = state.dp
    lead, index = is_lead(state), (0 if dp is None else dp.index)
    if lead:
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
    _barrier(state)
    held = state.held
    names = list(held)
    layout = dict.fromkeys(names) if dp is None else dp.layout
    mine = {k for k in names if layout[k] is not None or lead}
    opt = state.optimizer.state_dict()

    def slices(tree):
        """What this data rank writes of ``tree``: on a model axis gathered
        over the model group first, the data slices of the whole tensors."""
        if dp is not None:
            tree = dp.gather_model(tree, fresh=True)
        return {k: t for k, t in tree.items() if k in mine}

    moments = {slot: slices({names[i]: st[slot] for i, st in opt["state"].items()})
               for slot in ("exp_avg", "exp_avg_sq")}
    part = {"params": slices(held), **moments, "ema": {key: slices(ema) for key, ema in state.ema.items()}}
    if dp is None or dp.model_index == 0:
        _write(os.path.join(tmp, f"rank{index:05d}.pt"), _to_host(part))
    _barrier(state)
    if lead:
        params = state.params
        sampler = state.sampler_state
        _write(os.path.join(tmp, "index.pt"), _to_host({
            "step": int(state.step),
            "n_data": 1 if dp is None else dp.n,
            "layout": layout,
            "shapes": {k: (tuple(p.shape) if dp is None else dp.whole_shape(k)) for k, p in params.items()},
            "buffers": {k: v for k, v in state.model.state_dict().items() if k not in params},
            "adam_steps": {names[i]: st["step"] for i, st in opt["state"].items()},
            "param_groups": opt["param_groups"],
            "ema_keys": list(state.ema),
            "generator": state.generator.get_state(),
            "sampler_state": dataclasses.asdict(sampler) if isinstance(sampler, LossHistoryState) else None,
        }))
        shutil.rmtree(final, ignore_errors=True)
        os.replace(tmp, final)
    _barrier(state)
    return final


def _read_sharded(path: str) -> dict:
    """A sharded checkpoint as the tree of a ``.pt`` one: each sharded
    tensor concatenated from the ranks' slices along its dim."""
    def load(name):
        return torch.load(os.path.join(path, name), map_location="cpu", weights_only=True)

    index = load("index.pt")
    parts = [load(f"rank{r:05d}.pt") for r in range(index["n_data"])]
    layout = index["layout"]

    def whole(slot: Callable[[dict], Dict[str, torch.Tensor]], name: str) -> torch.Tensor:
        if layout[name] is None:
            return slot(parts[0])[name]
        out = torch.cat([slot(p)[name] for p in parts], dim=layout[name])
        if tuple(out.shape) != tuple(index["shapes"][name]):
            raise ValueError(f"{path}: the slices of {name} make {tuple(out.shape)}, not {index['shapes'][name]}")
        return out

    names = list(layout)
    state = {
        i: {"step": index["adam_steps"][k], "exp_avg": whole(lambda p: p["exp_avg"], k),
            "exp_avg_sq": whole(lambda p: p["exp_avg_sq"], k)}
        for i, k in enumerate(names) if k in index["adam_steps"]
    }
    return {
        "step": index["step"],
        "model": {**{k: whole(lambda p: p["params"], k) for k in names}, **index["buffers"]},
        "optimizer": {"state": state, "param_groups": index["param_groups"]},
        "ema": {key: {k: whole(lambda p, key=key: p["ema"][key], k) for k in names} for key in index["ema_keys"]},
        "generator": index["generator"],
        "sampler_state": index["sampler_state"],
    }


class AsyncTreeWriter:
    """Background host copy + write for trees of tensors.

    ``submit(tree, write_fn)`` snapshots ``tree`` on its device with one
    clone per tensor (so the caller may go on updating the live tensors in
    place) and queues ``write_fn(host_tree)`` on a worker thread that does
    the copy to the host and the write. Shared engine of
    :class:`AsyncStateSaver` and the train loop's EMA snapshots.

    One worker at a time, each waiting for the one before it; at most
    ``MAX_IN_FLIGHT`` snapshots are held (a further submit waits for the
    writes in flight). An error in a background write surfaces at the next
    ``submit()`` / ``check()`` / ``close()``.
    """

    def __init__(self):
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        self._outstanding = 0
        self._lock = threading.Lock()

    @staticmethod
    def snapshot(tree):
        with torch.no_grad():
            return map_tensors(tree, lambda t: t.detach().clone())

    def check(self) -> None:
        """Raise a previous background write's failure now."""
        with self._lock:
            err, self._error = self._error, None
        if err is not None:
            raise err

    def submit(self, tree, write_fn: Callable) -> None:
        self.check()
        self.submit_snapshot(self.snapshot(tree), write_fn)

    def submit_snapshot(self, snap, write_fn: Callable) -> None:
        with self._lock:
            backlog = self._outstanding
        if backlog >= MAX_IN_FLIGHT:
            self.wait()  # bound the memory the held snapshots take
        with self._lock:
            self._outstanding += 1
        # The copy to the host runs on a stream of its own, after the clones
        # (made on the caller's stream) are done: on the caller's stream it
        # would hold the train steps behind it.
        dev = _cuda_device(snap)
        ready = None
        if dev is not None:
            ready = torch.cuda.Event()
            ready.record(torch.cuda.current_stream(dev))

        def fetch():
            if dev is None:
                return _to_host(snap)
            side = torch.cuda.Stream(dev)
            side.wait_event(ready)
            with torch.cuda.stream(side):
                return _to_host(snap)

        def run(prev: Optional[threading.Thread]) -> None:
            if prev is not None:
                prev.join()
            try:
                write_fn(fetch())
            except BaseException as e:  # re-raised by check() on the caller's thread
                with self._lock:
                    self._error = e
            finally:
                with self._lock:
                    self._outstanding -= 1

        self._thread = threading.Thread(target=run, args=(self._thread,), daemon=True, name="tree-writer")
        self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        self.check()

    def close(self) -> None:
        self.wait()


class AsyncStateSaver:
    """Non-blocking checkpointing: ``save()`` clones the state on the device
    and returns; the copy to the host and the atomic write run on a
    background thread (:class:`AsyncTreeWriter`). Same file as
    :func:`save_state`. The clone doubles the state's device memory for the
    time of the write; where it does not fit, the save is made on the
    calling thread instead."""

    def __init__(self):
        self._writer = AsyncTreeWriter()

    def save(self, exp_dir: str, step: int, state) -> str:
        """On a mesh every rank calls it and the lead writes; under FSDP
        the state is gathered to the host first (a collective)."""
        # a failed earlier write surfaces here, before this step's own
        # handling could hide it
        self._writer.check()
        path = checkpoint_path(exp_dir, step)
        if state.dp is not None and state.dp.splits:
            tree = state_tree(state)  # on the host, holding no live tensor: no clone needed
            if is_lead(state):
                self._writer.submit_snapshot(tree, lambda host: _write(path, host))
            return path
        if not is_lead(state):
            return path
        try:
            snap = self._writer.snapshot(state_tree(state))
        except torch.cuda.OutOfMemoryError:
            return save_state(exp_dir, step, state)
        self._writer.submit_snapshot(snap, lambda host: _write(path, host))
        return path

    def wait(self) -> None:
        self._writer.wait()

    def close(self) -> None:
        self._writer.close()


_CKPT_RE = re.compile(r"^(\d+)\.(pt|shards)$")


def latest_checkpoint(exp_dir: str) -> Optional[str]:
    """The newest checkpoint of either format (a ``.pt`` file or a
    ``.shards`` directory; the file where a step has both), like the JAX
    package's ``latest_checkpoint_any``."""
    ckpt_dir = os.path.join(exp_dir, "checkpoints")
    if not os.path.isdir(ckpt_dir):
        return None
    found = [(int(m.group(1)), m.group(2) == "pt", f) for f in os.listdir(ckpt_dir) if (m := _CKPT_RE.match(f))]
    return os.path.join(ckpt_dir, max(found)[2]) if found else None


def restore_state(path: str, state):
    """Load the checkpoint at ``path`` (a ``.pt`` file or a ``.shards``
    directory) into ``state`` (a freshly built ``TrainState`` of the same
    configuration, on any mesh or none), in place, and return it: the whole
    tree, of which each rank takes its TP shards and FSDP slices. Names and
    shapes are checked by the strict ``load_state_dict``s."""
    dev = state.generator.device
    if os.path.isdir(path):
        tree = _read_sharded(path)
    else:
        tree = torch.load(path, map_location="cpu", weights_only=True)
    dp = state.dp
    model_sd = tree["model"]
    if dp is not None and dp.tp_split:
        model_sd = {k: dp.tp_part(v, k) if k in dp.tp_layout else v for k, v in model_sd.items()}
    state.model.load_state_dict(model_sd)
    local = (lambda t, name: t) if dp is None else dp.held_part
    names = list(state.held)
    optimizer = tree["optimizer"]
    if dp is not None and dp.splits:
        with torch.no_grad():
            for name in dp.sharded:
                state.held[name].copy_(dp.local(state.params[name], name))
        optimizer = {"param_groups": optimizer["param_groups"], "state": {
            i: {**st, **{slot: dp.held_part(st[slot], names[i]) for slot in ("exp_avg", "exp_avg_sq")}}
            for i, st in optimizer["state"].items()}}
    state.optimizer.load_state_dict(optimizer)
    if set(tree["ema"]) != set(state.ema):
        raise ValueError(f"checkpoint tracks EMA stds {sorted(tree['ema'])}, the run {sorted(state.ema)}")
    with torch.no_grad():
        for key, ema in state.ema.items():
            saved = tree["ema"][key]
            if set(saved) != set(ema):
                raise ValueError(f"checkpoint EMA {key} holds other parameters than the model")
            for name, tensor in ema.items():
                tensor.copy_(local(saved[name], name))
    state.step = int(tree["step"])
    state.generator.set_state(tree["generator"])
    sampler = tree["sampler_state"]
    if (sampler is None) != (not isinstance(state.sampler_state, LossHistoryState)):
        raise ValueError("checkpoint and run differ in their timestep sampler")
    if sampler is not None:
        state.sampler_state = LossHistoryState(**{k: v.to(dev) for k, v in sampler.items()})
    return state
