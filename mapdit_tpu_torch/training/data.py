"""Latent dataset pipeline, numpy copy of ``mapdit_tpu/training/data.py``.

The host only shuffles indices and gathers raw (mean, std, label) slices of
the VAE posterior from memory-mapped arrays; the posterior draw and the
normalization happen inside the train step on the device
(``training/state.py``). Native artifacts: posterior_means.npy /
posterior_stds.npy / labels.npy (memmap) + stats.npz {mean, std}; reference
``.pt`` artifacts load through torch; :func:`save_dataset` writes the
native family, which the JAX package's loader reads too. For a seed the
arrays are bit-identical to the JAX package's.
"""

from __future__ import annotations

import os
from typing import Dict, Iterator

import numpy as np


def _load_array(data_path: str, stem: str):
    npy = os.path.join(data_path, f"{stem}.npy")
    if os.path.exists(npy):
        return np.load(npy, mmap_mode="r")
    pt = os.path.join(data_path, f"{stem}.pt")
    if os.path.exists(pt):
        import torch

        return torch.load(pt, map_location="cpu", weights_only=True).numpy()
    raise FileNotFoundError(f"{stem}.npy / {stem}.pt not found in {data_path}")


def _load_stats(data_path: str) -> Dict[str, np.ndarray]:
    npz = os.path.join(data_path, "stats.npz")
    if os.path.exists(npz):
        with np.load(npz) as f:
            return {"mean": f["mean"], "std": f["std"]}
    pt = os.path.join(data_path, "stats.pt")
    if os.path.exists(pt):
        import torch

        d = torch.load(pt, map_location="cpu", weights_only=True)
        return {"mean": d["mean"].numpy(), "std": d["std"].numpy()}
    raise FileNotFoundError(f"stats.npz / stats.pt not found in {data_path}")


def batch_index_stream(
    n: int,
    batch_size: int,
    seed: int = 0,
    process_index: int = 0,
    process_count: int = 1,
    start_step: int = 0,
    drop_last: bool = True,
) -> Iterator[np.ndarray]:
    """Infinite stream of per-process batch index arrays.

    ``batch_size`` is the global batch: every process draws the same epoch
    permutation and owns rows ``[p*local : (p+1)*local]`` of each global
    batch (sorted for memmap locality). ``start_step`` fast-forwards the
    stream deterministically (re-drawing the skipped epochs'
    permutations)."""
    assert batch_size % process_count == 0, (batch_size, process_count)
    assert 0 <= process_index < process_count
    assert drop_last or process_count == 1, "multi-process requires drop_last"
    local = batch_size // process_count
    lo, hi = process_index * local, (process_index + 1) * local
    rng = np.random.default_rng(seed)
    steps_per_epoch = n // batch_size if drop_last else -(-n // batch_size)
    assert steps_per_epoch > 0, f"batch_size {batch_size} > dataset size {n}"
    for _ in range(start_step // steps_per_epoch):
        rng.permutation(n)
    step_in_epoch = start_step % steps_per_epoch
    while True:
        perm = rng.permutation(n)
        end = n - (n % batch_size) if drop_last else n
        for i in range(step_in_epoch * batch_size, end, batch_size):
            yield np.sort(perm[i : i + batch_size][lo:hi])
        step_in_epoch = 0


class LatentDataset:
    """VAE-posterior latent dataset (the reference's ``CustomDataset``)."""

    def __init__(self, data_path: str):
        self.means = _load_array(data_path, "posterior_means")
        self.stds = _load_array(data_path, "posterior_stds")
        self.labels = np.asarray(_load_array(data_path, "labels"))
        self.stats = _load_stats(data_path)
        assert self.means.shape[0] == self.stds.shape[0] == self.labels.shape[0]

    @property
    def data_size(self) -> int:
        return self.means.shape[2]

    @property
    def channels(self) -> int:
        return self.means.shape[1]

    def __len__(self) -> int:
        return self.means.shape[0]

    def batches(
        self,
        batch_size: int,
        seed: int = 0,
        drop_last: bool = True,
        process_index: int = 0,
        process_count: int = 1,
        start_step: int = 0,
    ) -> Iterator[Dict[str, np.ndarray]]:
        """Infinite epoch-shuffled stream of posterior-parameter batches
        (see :func:`batch_index_stream`)."""
        stream = batch_index_stream(
            len(self), batch_size, seed,
            process_index=process_index, process_count=process_count,
            start_step=start_step, drop_last=drop_last,
        )
        for idx in stream:
            yield {
                "mean": np.ascontiguousarray(self.means[idx], dtype=np.float32),
                "std": np.ascontiguousarray(self.stds[idx], dtype=np.float32),
                "y": self.labels[idx].astype(np.int32),
            }


class SyntheticLatentDataset(LatentDataset):
    """Synthetic class-structured posterior dataset for tests and benchmarks
    (stands in for the ImageNet-128 latents offline)."""

    def __init__(
        self,
        num_examples: int = 1024,
        channels: int = 4,
        size: int = 16,
        num_classes: int = 10,
        seed: int = 0,
    ):
        rng = np.random.default_rng(seed)
        self.labels = rng.integers(0, num_classes, num_examples).astype(np.int64)
        centers = rng.normal(size=(num_classes, channels, 1, 1)).astype(np.float32)
        self.means = (centers[self.labels] + 0.3 * rng.normal(size=(num_examples, channels, size, size))).astype(
            np.float32
        )
        self.stds = (0.1 + 0.05 * rng.random((num_examples, channels, size, size))).astype(np.float32)
        mean = self.means.mean(axis=(0, 2, 3))
        var = (self.stds**2).mean(axis=(0, 2, 3)) + ((self.means - mean[None, :, None, None]) ** 2).mean(
            axis=(0, 2, 3)
        )
        self.stats = {"mean": mean, "std": np.sqrt(var)}


def save_dataset(
    out_dir: str,
    means: np.ndarray,
    stds: np.ndarray,
    labels: np.ndarray,
    stats: Dict[str, np.ndarray],
) -> None:
    """Write the native artifact family (memmap-friendly .npy + stats.npz)."""
    os.makedirs(out_dir, exist_ok=True)
    np.save(os.path.join(out_dir, "posterior_means.npy"), means)
    np.save(os.path.join(out_dir, "posterior_stds.npy"), stds)
    np.save(os.path.join(out_dir, "labels.npy"), labels)
    np.savez(os.path.join(out_dir, "stats.npz"), mean=stats["mean"], std=stats["std"])
