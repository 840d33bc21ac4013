"""Build the VAE-latent dataset, port of the JAX package's ``download_data.py``.

    python -m mapdit_tpu_torch.download_data --output-dir data/latents --vae-path vae.safetensors \\
        [--dataset benjamin-paine/imagenet-1k-128x128 | imagefolder:<dir>] [--batch-size 128] \\
        [--image-size 128] [--seed 0] [--device cpu]

Reads the image dataset through the ``datasets`` package, flips each image
horizontally with probability 1/2 (drawn from a numpy generator seeded with
``--seed``, one draw an image in dataset order), scales it to [-1, 1],
encodes it through the SD-VAE (``models/vae.py``, weights from
``--vae-path``) on ``--device`` (CUDA unless given), and stores the
**posterior** (means, stds), the labels and the channel-wise
mixture-of-Gaussians statistics ``var = E[sigma^2] + E[(mu - mu_bar)^2]``
in the native artifact family (``training/data.py`` ``save_dataset``),
which both packages' loaders read.

:func:`encode_batches` takes uint8 NHWC arrays directly, so an in-memory
image set needs neither ``datasets`` nor a download. ``datasets`` is
imported by :func:`main` only; where it is missing, or the dataset cannot
be loaded (no network, no cache), the run ends with a ``SystemExit`` that
says so, as the JAX script does.
"""

from __future__ import annotations

import argparse
from typing import Dict, Iterable, Tuple

import numpy as np
import torch

from mapdit_tpu_torch.training.data import save_dataset
from mapdit_tpu_torch.utils.device import resolve_device
from mapdit_tpu_torch.utils.logging import create_logger


def preprocess(images: np.ndarray, rng: np.random.Generator) -> np.ndarray:
    """uint8 (N, H, W, 3) images -> float32 (N, 3, H, W) in [-1, 1]: the
    reference's RandomHorizontalFlip + ToTensor + Normalize(0.5, 0.5), the
    flips drawn from ``rng`` (one draw an image), in the JAX script's order
    of operations."""
    imgs = images.astype(np.float32)
    flip = rng.random(len(imgs)) < 0.5
    imgs[flip] = imgs[flip][:, :, ::-1]
    imgs = imgs / 127.5 - 1.0
    return np.ascontiguousarray(imgs.transpose(0, 3, 1, 2))


def encode_batch(encoder, images: np.ndarray, rng: np.random.Generator, device) -> Tuple[np.ndarray, np.ndarray]:
    """One batch of uint8 NHWC images -> the posterior (mean, std) as
    float32 numpy arrays, each (N, 4, H/8, W/8)."""
    x = torch.from_numpy(preprocess(images, rng)).to(device)
    mean, std = encoder(x)
    return mean.float().cpu().numpy(), std.float().cpu().numpy()


def mog_stats(means: np.ndarray, stds: np.ndarray) -> Dict[str, np.ndarray]:
    """The channel-wise statistics of the latent law, a mixture of the
    posteriors: mean mu_bar and std sqrt(E[sigma^2] + E[(mu - mu_bar)^2])."""
    mu_bar = means.mean(axis=(0, 2, 3))
    var = (stds**2).mean(axis=(0, 2, 3)) + ((means - mu_bar[None, :, None, None]) ** 2).mean(axis=(0, 2, 3))
    return {"mean": mu_bar, "std": np.sqrt(var)}


def encode_batches(
    encoder, batches: Iterable[Tuple[np.ndarray, np.ndarray]], total: int, image_size: int, seed: int = 0,
    device=None, log=None,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Encode ``batches`` of (uint8 NHWC images, labels), ``total`` images
    of side ``image_size`` in all, in order; returns (means, stds, labels).
    The flips come from one generator seeded with ``seed`` across the
    batches, as in the JAX script."""
    rng = np.random.default_rng(seed)
    side = image_size // 8
    means = np.zeros((total, 4, side, side), np.float32)
    stds = np.zeros_like(means)
    labels = np.zeros((total,), np.int64)
    pos = 0
    for i, (images, batch_labels) in enumerate(batches):
        tail = pos + len(images)
        means[pos:tail], stds[pos:tail] = encode_batch(encoder, images, rng, device)
        labels[pos:tail] = np.asarray(batch_labels)
        pos = tail
        if log is not None:
            log(f"encoded {pos}/{total} images (batch {i + 1})")
    if pos != total:
        raise ValueError(f"the batches held {pos} images, not {total}")
    return means, stds, labels


def _hf_batches(ds, batch_size: int):
    """(uint8 NHWC images, labels) batches of a ``datasets`` split."""
    for idx in range(0, len(ds), batch_size):
        rows = ds[idx : min(idx + batch_size, len(ds))]
        yield np.stack([np.asarray(img.convert("RGB"), np.uint8) for img in rows["image"]]), rows["label"]


def main(args) -> str:
    """Build the dataset the parsed ``args`` describe; returns its
    directory."""
    from mapdit_tpu_torch.models.vae import load_encoder

    logger = create_logger()
    device = resolve_device(args.device)
    encoder = load_encoder(args.vae_path, device)
    if encoder is None:
        raise SystemExit(
            "SD-VAE weights not found. Pass --vae-path pointing at a local diffusers AutoencoderKL checkpoint "
            "(diffusion_pytorch_model.safetensors of stabilityai/sd-vae-ft-mse)."
        )

    logger.info("loading data...")
    try:
        from datasets import load_dataset

        if args.dataset.startswith("imagefolder:"):
            # a local class-per-subdirectory image tree: the pipeline without egress
            ds = load_dataset("imagefolder", data_dir=args.dataset.split(":", 1)[1], split="train")
        else:
            ds = load_dataset(args.dataset)["train"]
    except Exception as e:  # noqa: BLE001 - any failure to get the data ends the run with its reason
        raise SystemExit(
            f"could not load HF dataset {args.dataset!r} ({type(e).__name__}: {e}); this step needs the datasets "
            "package and network access or a pre-populated HF cache (offline: --dataset imagefolder:<dir> "
            "with class subdirectories)"
        )

    means, stds, labels = encode_batches(
        encoder, _hf_batches(ds, args.batch_size), len(ds), args.image_size, args.seed, device,
        log=logger.info,
    )
    logger.info("computing mean and std of MoG...")
    stats = mog_stats(means, stds)
    logger.info(f"saving data to {args.output_dir}...")
    save_dataset(args.output_dir, means, stds, labels, stats)
    return args.output_dir


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--output-dir", type=str, required=True)
    parser.add_argument("--batch-size", type=int, default=128)
    parser.add_argument("--vae-path", type=str, required=True, help="local SD-VAE (diffusers AutoencoderKL) weights")
    parser.add_argument("--dataset", type=str, default="benjamin-paine/imagenet-1k-128x128",
                        help="HF dataset name, or 'imagefolder:<dir>' for a local class-per-subdirectory image tree "
                             "(offline)")
    parser.add_argument("--image-size", type=int, default=128)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--device", type=str, default="cuda",
                        help="the device the VAE encodes on; 'cpu' runs it on the CPU")
    return parser


if __name__ == "__main__":
    main(build_parser().parse_args())
