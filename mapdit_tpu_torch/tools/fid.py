"""Sample-quality metrics (FID / KID / precision-recall) of ``sample_fid``
outputs, port of the JAX package's ``tools/fid.py``.

    python -m mapdit_tpu_torch.tools.fid --samples A.npz --ref-stats ref_stats.npz
    python -m mapdit_tpu_torch.tools.fid --samples A.npz --ref-samples B.npz --metric all
    python -m mapdit_tpu_torch.tools.fid --make-stats A.npz --out stats.npz

``--metric kid`` (unbiased in N, arXiv 1801.01401) and ``--metric pr``
(improved precision/recall, arXiv 1904.06991: fidelity against diversity,
the axes guidance trades) suit small sample sets, where FID's covariance
estimate is biased.

Feature extractors (``--features``):
  * ``inception``: torchvision's InceptionV3 pool features (2048-d), run on
    ``--device`` (CUDA unless given). It needs torchvision and the
    ``IMAGENET1K_V1`` weights already in the torch hub cache; the weights
    are read from there, never fetched, and where either is missing it
    raises saying so. It is torchvision's extractor (pytorch-fid style), not
    the TF1 "pool_3" graph of the ADM evaluator: scores are consistent
    between runs of this tool and differ slightly from published
    ADM-protocol numbers.
  * ``random-proj``: a fixed random projection of the raw pixels (64-d),
    not a perceptual metric: it runs the sample_fid -> statistics ->
    Frechet pipeline without Inception weights.

A statistics file records its extractor, and a comparison refuses to mix
extractors; no extractor ever stands in for another.
"""

from __future__ import annotations

import argparse
import os

import numpy as np

FEATURES = ("inception", "random-proj")


def frechet_distance(mu1, sigma1, mu2, sigma2, eps: float = 1e-6) -> float:
    """FID = ||mu1-mu2||^2 + Tr(S1 + S2 - 2 (S1 S2)^(1/2))."""
    from scipy import linalg

    mu1, mu2 = np.atleast_1d(mu1), np.atleast_1d(mu2)
    sigma1, sigma2 = np.atleast_2d(sigma1), np.atleast_2d(sigma2)
    diff = mu1 - mu2

    covmean = linalg.sqrtm(sigma1.dot(sigma2))
    if not np.isfinite(covmean).all():
        offset = np.eye(sigma1.shape[0]) * eps
        covmean = linalg.sqrtm((sigma1 + offset).dot(sigma2 + offset))
    if np.iscomplexobj(covmean):
        covmean = covmean.real
    return float(diff.dot(diff) + np.trace(sigma1) + np.trace(sigma2) - 2 * np.trace(covmean))


def activation_stats(features: np.ndarray):
    """(N, D) features -> (mu, sigma)."""
    return features.mean(axis=0), np.cov(features, rowvar=False)


def kid_score(feats1: np.ndarray, feats2: np.ndarray, subset_size: int = 1000, n_subsets: int = 100, seed: int = 0):
    """Kernel Inception Distance: the unbiased MMD^2 with the polynomial
    kernel k(x, y) = (x.y/d + 1)^3, over ``n_subsets`` random subsets of
    ``subset_size`` of each set. Returns (mean, std) over the subsets."""
    d = feats1.shape[1]
    m = min(subset_size, len(feats1), len(feats2))
    if m < 2:
        raise ValueError("KID needs at least 2 samples per set")
    rng = np.random.default_rng(seed)
    x64, y64 = feats1.astype(np.float64), feats2.astype(np.float64)
    vals = []
    for _ in range(n_subsets):
        x = x64[rng.choice(len(x64), m, replace=False)]
        y = y64[rng.choice(len(y64), m, replace=False)]
        kxx = (x @ x.T / d + 1.0) ** 3
        kyy = (y @ y.T / d + 1.0) ** 3
        kxy = (x @ y.T / d + 1.0) ** 3
        # the unbiased within-set terms leave the diagonal out
        t_xx = (kxx.sum() - np.trace(kxx)) / (m * (m - 1))
        t_yy = (kyy.sum() - np.trace(kyy)) / (m * (m - 1))
        vals.append(t_xx + t_yy - 2.0 * kxy.mean())
    return float(np.mean(vals)), float(np.std(vals))


def precision_recall(real_feats: np.ndarray, fake_feats: np.ndarray, nhood_size: int = 3):
    """Improved precision and recall: each set's manifold is the union of
    balls reaching each member's k-th nearest in-set neighbour; precision
    is the share of fakes inside the real manifold, recall the share of
    reals inside the fake one. O(N^2) distances."""

    def sq_dists(a, b):
        return (a**2).sum(1)[:, None] + (b**2).sum(1)[None, :] - 2.0 * (a @ b.T)

    def k_radii(feats, k):
        d2 = sq_dists(feats, feats)
        np.fill_diagonal(d2, np.inf)
        return np.sqrt(np.maximum(np.partition(d2, k - 1, axis=1)[:, k - 1], 0.0))

    def fraction_inside(candidates, manifold, radii):
        d = np.sqrt(np.maximum(sq_dists(candidates, manifold), 0.0))
        return float((d <= radii[None, :]).any(axis=1).mean())

    real, fake = real_feats.astype(np.float64), fake_feats.astype(np.float64)
    if not (len(real) > nhood_size and len(fake) > nhood_size):
        raise ValueError(f"precision/recall needs more than {nhood_size} samples per set")
    return (fraction_inside(fake, real, k_radii(real, nhood_size)),
            fraction_inside(real, fake, k_radii(fake, nhood_size)))


def inception_features(images_u8: np.ndarray, batch_size: int = 64, device=None) -> np.ndarray:
    """(N, H, W, 3) uint8 -> (N, 2048) InceptionV3 pool features, on
    ``device`` (default CUDA). The weights come from the torch hub cache
    only; raises ``RuntimeError`` where torchvision or the weights are
    missing."""
    import torch

    from mapdit_tpu_torch.utils.device import resolve_device

    try:
        from torchvision import models
        from torchvision.transforms import functional as TF
    except ImportError as e:
        raise RuntimeError(
            "--features inception needs torchvision and the InceptionV3 IMAGENET1K_V1 weights in the torch hub "
            "cache; use --features random-proj to run the pipeline without them"
        ) from e
    weights = models.Inception_V3_Weights.IMAGENET1K_V1
    path = os.path.join(torch.hub.get_dir(), "checkpoints", os.path.basename(weights.url))
    if not os.path.exists(path):
        raise RuntimeError(
            f"--features inception: the InceptionV3 weights are not at {path} (this tool never downloads them); "
            "place them there, or use --features random-proj to run the pipeline without them"
        )
    device = resolve_device(device)
    # what models.inception_v3(weights=IMAGENET1K_V1) builds, from the cached file
    net = models.inception_v3(weights=None, aux_logits=True, transform_input=True, init_weights=False)
    net.load_state_dict(torch.load(path, map_location="cpu", weights_only=True))
    net.fc = torch.nn.Identity()
    net = net.to(device).eval()
    feats = []
    with torch.no_grad():
        for i in range(0, len(images_u8), batch_size):
            x = torch.from_numpy(np.ascontiguousarray(images_u8[i : i + batch_size])).to(device)
            x = x.permute(0, 3, 1, 2).float() / 255.0
            x = TF.resize(x, [299, 299], antialias=True)
            x = TF.normalize(x, [0.485, 0.456, 0.406], [0.229, 0.224, 0.225])
            feats.append(net(x).float().cpu().numpy())
    return np.concatenate(feats, axis=0)


def random_projection_features(images_u8: np.ndarray, dim: int = 64, seed: int = 0) -> np.ndarray:
    """(N, H, W, C) uint8 -> (N, dim) by a fixed Gaussian random projection
    of the centred pixels, deterministic in (image shape, dim, seed). A
    pipeline stand-in, not a perceptual metric."""
    n = images_u8.shape[0]
    flat = images_u8.reshape(n, -1).astype(np.float32) / 127.5 - 1.0
    rng = np.random.default_rng(seed)
    proj = rng.standard_normal((flat.shape[1], dim)).astype(np.float32)
    proj /= np.sqrt(flat.shape[1])
    return flat @ proj


def extract_features(images_u8: np.ndarray, kind: str, device=None) -> np.ndarray:
    if kind == "inception":
        return inception_features(images_u8, device=device)
    if kind == "random-proj":
        return random_projection_features(images_u8)
    raise ValueError(f"unknown feature extractor: {kind}")


def load_samples(path: str) -> np.ndarray:
    with np.load(path) as f:
        return f["arr_0"]


def save_stats(path: str, features: np.ndarray, kind: str) -> None:
    """(mu, sigma) of ``features`` with the extractor's name beside them."""
    mu, sigma = activation_stats(features)
    np.savez(path, mu=mu, sigma=sigma, features=kind)


def load_stats(path: str, expected_kind: str):
    """(mu, sigma) of a statistics file; ``SystemExit`` where it was built
    with another extractor (a file without the field is Inception's)."""
    with np.load(path, allow_pickle=False) as f:
        kind = str(f["features"]) if "features" in f.files else "inception"
        if kind != expected_kind:
            raise SystemExit(
                f"stats file {path} was built with --features {kind}; refusing to compare against --features "
                f"{expected_kind}"
            )
        return f["mu"], f["sigma"]


def main(argv=None) -> dict:
    """Run the CLI; returns the scores it printed (name -> value)."""
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--samples", type=str, help="ADM-format npz (arr_0 uint8 NHWC)")
    p.add_argument("--ref-samples", type=str, default=None)
    p.add_argument("--ref-stats", type=str, default=None, help="npz with mu, sigma")
    p.add_argument("--make-stats", type=str, default=None, help="samples npz -> stats")
    p.add_argument("--out", type=str, default="stats.npz")
    p.add_argument("--features", choices=FEATURES, default="inception",
                   help="feature extractor; random-proj is the weights-free pipeline stand-in (module docstring)")
    p.add_argument("--metric", choices=["fid", "kid", "pr", "all"], default="fid",
                   help="kid and pr need --ref-samples (raw reference features), not --ref-stats")
    p.add_argument("--kid-subset-size", type=int, default=1000)
    p.add_argument("--kid-subsets", type=int, default=100)
    p.add_argument("--pr-nhood", type=int, default=3, help="k of the precision/recall manifold radii")
    p.add_argument("--device", type=str, default="cuda",
                   help="where --features inception runs; 'cpu' runs it on the CPU")
    args = p.parse_args(argv)

    if args.make_stats:
        save_stats(args.out, extract_features(load_samples(args.make_stats), args.features, args.device),
                   args.features)
        print(f"wrote {args.out}")
        return {}

    if not (args.samples and (args.ref_samples or args.ref_stats)):
        raise SystemExit("error: --samples and one of --ref-samples / --ref-stats are needed")
    if args.metric in ("kid", "pr", "all") and not args.ref_samples:
        raise SystemExit(
            f"error: --metric {args.metric} needs raw reference features (--ref-samples); a (mu, sigma) stats file "
            "cannot feed it"
        )
    # the extractors are checked before any features are paid for
    ref = load_stats(args.ref_stats, args.features) if args.ref_stats else None
    f1 = extract_features(load_samples(args.samples), args.features, args.device)
    f2 = extract_features(load_samples(args.ref_samples), args.features, args.device) if args.ref_samples else None
    scores = {}
    if args.metric in ("fid", "all"):
        mu1, s1 = activation_stats(f1)
        mu2, s2 = ref if ref is not None else activation_stats(f2)
        scores["fid"] = frechet_distance(mu1, s1, mu2, s2)
        print(f"FID: {scores['fid']:.4f}")
    if args.metric in ("kid", "all"):
        scores["kid"], scores["kid_std"] = kid_score(f1, f2, subset_size=args.kid_subset_size,
                                                     n_subsets=args.kid_subsets)
        print(f"KID: {scores['kid']:.6f} +/- {scores['kid_std']:.6f}")
    if args.metric in ("pr", "all"):
        # --ref-samples is the real set, --samples the generated one
        scores["precision"], scores["recall"] = precision_recall(f2, f1, nhood_size=args.pr_nhood)
        print(f"precision: {scores['precision']:.4f}  recall: {scores['recall']:.4f}")
    return scores


if __name__ == "__main__":
    main()
