"""Checkpointing and resume, port of ``mapdit_tpu/training/checkpoint.py``.

A checkpoint is one ``torch.save`` file, ``checkpoints/<step:07d>.pt``, of
the whole ``TrainState``: the model's state dict (reference names), the
optimizer's state dict (Adam moments and step counts), every EMA tree, the
step, the generator's state and the timestep sampler's state.
``restore_state`` loads it into a freshly built ``TrainState``, so a resumed
run continues the exact trajectory. Writes are atomic (a ``.tmp`` file, then
``os.replace``), and the default saver writes from a background thread after
one clone of the state on the device.
"""

from __future__ import annotations

import dataclasses
import os
import re
import threading
from typing import Callable, Optional

import torch

from mapdit_tpu_torch.diffusion.timestep_sampler import LossHistoryState

MAX_IN_FLIGHT = 2  # snapshots a background writer may hold at once


def checkpoint_path(exp_dir: str, step: int) -> str:
    return os.path.join(exp_dir, "checkpoints", f"{step:07d}.pt")


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
    """The ``TrainState`` as a tree of tensors and plain values. The tensors
    are the live ones: clone or copy them before the next train step."""
    sampler = state.sampler_state
    return {
        "step": int(state.step),
        "model": state.model.state_dict(),
        "optimizer": state.optimizer.state_dict(),
        "ema": {key: dict(tree) for key, tree in state.ema.items()},
        "generator": state.generator.get_state(),
        "sampler_state": dataclasses.asdict(sampler) if isinstance(sampler, LossHistoryState) else None,
    }


def _to_host(tree):
    return map_tensors(tree, lambda t: t.detach().cpu())


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
    """Write the checkpoint of ``state`` now, on the calling thread."""
    path = checkpoint_path(exp_dir, step)
    _write(path, _to_host(state_tree(state)))
    return path


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
        # a failed earlier write surfaces here, before this step's own
        # handling could hide it
        self._writer.check()
        path = checkpoint_path(exp_dir, step)
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


_CKPT_RE = re.compile(r"^(\d+)\.pt$")


def latest_checkpoint(exp_dir: str) -> Optional[str]:
    ckpt_dir = os.path.join(exp_dir, "checkpoints")
    if not os.path.isdir(ckpt_dir):
        return None
    steps = [int(m.group(1)) for f in os.listdir(ckpt_dir) if (m := _CKPT_RE.match(f))]
    return checkpoint_path(exp_dir, max(steps)) if steps else None


def restore_state(path: str, state):
    """Load the checkpoint at ``path`` into ``state`` (a freshly built
    ``TrainState`` of the same configuration), in place, and return it.
    Names and shapes are checked by the strict ``load_state_dict``s."""
    dev = state.generator.device
    tree = torch.load(path, map_location="cpu", weights_only=True)
    state.model.load_state_dict(tree["model"])
    state.optimizer.load_state_dict(tree["optimizer"])
    if set(tree["ema"]) != set(state.ema):
        raise ValueError(f"checkpoint tracks EMA stds {sorted(tree['ema'])}, the run {sorted(state.ema)}")
    with torch.no_grad():
        for key, ema in state.ema.items():
            saved = tree["ema"][key]
            if set(saved) != set(ema):
                raise ValueError(f"checkpoint EMA {key} holds other parameters than the model")
            for name, tensor in ema.items():
                tensor.copy_(saved[name])
    state.step = int(tree["step"])
    state.generator.set_state(tree["generator"])
    sampler = tree["sampler_state"]
    if (sampler is None) != (not isinstance(state.sampler_state, LossHistoryState)):
        raise ValueError("checkpoint and run differ in their timestep sampler")
    if sampler is not None:
        state.sampler_state = LossHistoryState(**{k: v.to(dev) for k, v in sampler.items()})
    return state
