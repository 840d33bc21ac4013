"""ctypes binding for the native (C++) latent-batch prefetcher, port of
``mapdit_tpu/training/native_loader.py``.

``native/latent_loader.cc`` (at the root of the checkout) mmaps the .npy
posterior arrays and gathers shuffled batches on background threads, so the
train loop never waits on IO. The port builds its own library from that
source with the host's ``g++`` at first use, into
``build/mapdit_tpu_torch/`` under the checkout root.
``NativeLatentLoader.available()`` gates usage: where there is no compiler,
no source or no .npy dataset it is false, and ``LatentDataset`` serves with
the same batch semantics (epoch shuffle, drop_last).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading
from typing import Dict, Iterator, Optional

import numpy as np

_ROOT = pathlib.Path(__file__).resolve().parents[2]
SOURCE = _ROOT / "native" / "latent_loader.cc"
BUILD_DIR = _ROOT / "build" / "mapdit_tpu_torch"
_LOCK = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def _build() -> Optional[pathlib.Path]:
    """The library's path, compiled if missing; None without g++ or source."""
    gxx = shutil.which("g++")
    if gxx is None or not SOURCE.exists():
        return None
    digest = hashlib.sha256(SOURCE.read_bytes()).hexdigest()[:16]
    target = BUILD_DIR / f"liblatent_loader-{digest}.so"
    if not target.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = target.with_suffix(f".{os.getpid()}.tmp")
        subprocess.run([gxx, "-O3", "-std=c++17", "-shared", "-fPIC", "-pthread", str(SOURCE), "-o", str(tmp)],
                       check=True, capture_output=True)
        os.replace(tmp, target)
    return target


def _load_lib() -> Optional[ctypes.CDLL]:
    global _lib
    with _LOCK:
        if _lib is None:
            path = _build()
            if path is None:
                return None
            lib = ctypes.CDLL(str(path))
            lib.ll_open.restype = ctypes.c_void_p
            lib.ll_open.argtypes = [ctypes.c_char_p] + [ctypes.c_uint64] * 7
            lib.ll_next.restype = ctypes.c_int
            lib.ll_next.argtypes = [ctypes.c_void_p] + [ctypes.c_void_p] * 3
            lib.ll_feature_size.restype = ctypes.c_uint64
            lib.ll_feature_size.argtypes = [ctypes.c_void_p]
            lib.ll_num_examples.restype = ctypes.c_uint64
            lib.ll_num_examples.argtypes = [ctypes.c_void_p]
            lib.ll_close.argtypes = [ctypes.c_void_p]
            _lib = lib
        return _lib


class NativeLatentLoader:
    """Prefetching batch stream over a .npy latent dataset directory."""

    @staticmethod
    def available(data_path: str) -> bool:
        if data_path.startswith("synthetic"):
            return False
        if not os.path.exists(os.path.join(data_path, "posterior_means.npy")):
            return False
        return _load_lib() is not None

    def __init__(
        self,
        data_path: str,
        batch_size: int,
        seed: int = 0,
        queue_depth: int = 4,
        num_threads: int = 2,
        shape=None,
        process_index: int = 0,
        process_count: int = 1,
        start_step: int = 0,
    ):
        """``batch_size`` is the global batch; each loader yields the
        ``batch_size // process_count`` rows its process owns.
        ``start_step`` fast-forwards the shuffle stream (resume)."""
        lib = _load_lib()
        if lib is None:
            raise RuntimeError("the native loader cannot be built here (no g++ or no native/latent_loader.cc)")
        self._lib = lib
        self._handle = lib.ll_open(
            data_path.encode(), batch_size, seed, queue_depth, num_threads, process_index, process_count, start_step,
        )
        if not self._handle:
            raise RuntimeError(f"ll_open failed for {data_path}")
        self.batch_size = batch_size // process_count  # local rows per yield
        self.feat = int(lib.ll_feature_size(self._handle))
        self.num_examples = int(lib.ll_num_examples(self._handle))
        if shape is None:
            # infer (C, H, W) from the npy on disk
            shape = np.load(os.path.join(data_path, "posterior_means.npy"), mmap_mode="r").shape[1:]
        self.row_shape = tuple(shape)

    def batches(self) -> Iterator[Dict[str, np.ndarray]]:
        b, feat = self.batch_size, self.feat
        while self._handle:
            mean = np.empty((b, feat), np.float32)
            std = np.empty((b, feat), np.float32)
            labels = np.empty((b,), np.int32)
            rc = self._lib.ll_next(
                self._handle,
                mean.ctypes.data_as(ctypes.c_void_p),
                std.ctypes.data_as(ctypes.c_void_p),
                labels.ctypes.data_as(ctypes.c_void_p),
            )
            if rc != 0:
                return
            yield {"mean": mean.reshape(b, *self.row_shape), "std": std.reshape(b, *self.row_shape), "y": labels}

    def close(self) -> None:
        if self._handle:
            self._lib.ll_close(self._handle)
            self._handle = None
