"""Guidance sweep: sample a grid of (cfg_scale, cfg_interval) protocols and
score each against a reference set, port of the JAX package's
``tools/guidance_sweep.py``.

    python -m mapdit_tpu_torch.tools.guidance_sweep --result-dir results/000-DiT-S-2 \\
        --ref-samples ref.npz --cfg-scales 1.5,4.0 --cfg-intervals none,0.3:3.0 \\
        --num-samples 512 --steps 20 --sampler dpm++ --time-schedule karras \\
        --features inception --out sweep.jsonl

Each grid point runs ``python -m mapdit_tpu_torch.sample_fid`` in a
subprocess (the path users run, on ``--device``, through ``--block-kernel``
where given) and is scored with ``mapdit_tpu_torch.tools.fid``'s functions.
One JSON line a point: {"cfg_scale", "cfg_interval", "fid", "kid",
"kid_std", "precision", "recall", "sample_npz"}. With ``--features
random-proj`` the sweep runs without Inception weights (a pipeline check,
not a perceptual ranking). Limited-interval guidance (arXiv 2404.07724)
and the fidelity / diversity split of precision and recall are what the
sweep ranks.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

import numpy as np

from mapdit_tpu_torch.tools import fid

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def parse_intervals(spec: str):
    """"none,0.3:3.0,0.5:2.0" -> [None, (0.3, 3.0), (0.5, 2.0)]."""
    out = []
    for item in spec.split(","):
        item = item.strip()
        if item in ("none", ""):
            out.append(None)
        else:
            lo, hi = item.split(":")
            out.append((float(lo), float(hi)))
    return out


def sample_fid_argv(args, cfg_scale, interval, out_npz) -> list:
    """``mapdit_tpu_torch.sample_fid``'s arguments for one grid point."""
    argv = [
        "--result-dir", args.result_dir,
        "--use-vae", "false",
        "--num-samples", str(args.num_samples),
        "--batch-size", str(args.batch_size),
        "--num-sampling-steps", str(args.steps),
        "--sampler", args.sampler,
        "--time-schedule", args.time_schedule,
        "--cfg-scale", str(cfg_scale),
        "--seed", str(args.seed),
        "--device", args.device,
        "--output-file", out_npz,
    ]
    if args.block_kernel is not None:
        argv += ["--block-kernel", args.block_kernel]
    if interval is not None:
        argv += ["--cfg-interval", str(interval[0]), str(interval[1])]
    return argv


def run_grid_point(args, cfg_scale, interval, out_npz) -> None:
    """Sample one grid point in a subprocess."""
    cmd = [sys.executable, "-m", "mapdit_tpu_torch.sample_fid", *sample_fid_argv(args, cfg_scale, interval, out_npz)]
    subprocess.run(cmd, check=True, cwd=REPO)


def build_parser() -> argparse.ArgumentParser:
    from mapdit_tpu_torch.models.config import BLOCK_KERNELS

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--result-dir", required=True)
    p.add_argument("--ref-samples", required=True,
                   help="ADM-format npz (arr_0 uint8 NHWC) of the reference set every point is scored against")
    p.add_argument("--cfg-scales", default="1.5,4.0")
    p.add_argument("--cfg-intervals", default="none,0.3:3.0", help="comma list of none or lo:hi sigma intervals")
    p.add_argument("--num-samples", type=int, default=512)
    p.add_argument("--batch-size", type=int, default=64)
    p.add_argument("--steps", type=int, default=20)
    p.add_argument("--sampler", choices=["ddpm", "ddim", "dpm++", "unipc"], default="dpm++")
    p.add_argument("--time-schedule", choices=["uniform", "karras"], default="karras")
    p.add_argument("--features", choices=fid.FEATURES, default="inception")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", type=str, default="cuda", help="sample_fid's and the features' device")
    p.add_argument("--block-kernel", choices=list(BLOCK_KERNELS), default=None,
                   help="sample_fid's --block-kernel (default: the training config's)")
    p.add_argument("--work-dir", default=None, help="where the points' sample npz files go (default: beside --out)")
    p.add_argument("--out", default="sweep.jsonl")
    return p


def main(argv=None) -> list:
    """Run the sweep; returns its rows."""
    args = build_parser().parse_args(argv)
    work = args.work_dir or (os.path.dirname(os.path.abspath(args.out)) or ".")
    os.makedirs(work, exist_ok=True)

    ref_feats = fid.extract_features(fid.load_samples(args.ref_samples), args.features, args.device)
    ref_mu, ref_sigma = fid.activation_stats(ref_feats)

    rows = []
    with open(args.out, "w") as out_f:
        for cfg_scale in (float(s) for s in args.cfg_scales.split(",")):
            for interval in parse_intervals(args.cfg_intervals):
                if interval is not None and cfg_scale <= 1.0:
                    continue  # an interval needs CFG
                tag = f"s{cfg_scale:g}" + (f"_i{interval[0]:g}-{interval[1]:g}" if interval else "")
                npz = os.path.join(os.path.abspath(work), f"samples_{tag}.npz")
                run_grid_point(args, cfg_scale, interval, npz)
                feats = fid.extract_features(fid.load_samples(npz), args.features, args.device)
                mu, sigma = fid.activation_stats(feats)
                kid_m, kid_s = fid.kid_score(feats, ref_feats, subset_size=min(1000, len(feats), len(ref_feats)),
                                             n_subsets=20)
                prec, rec = fid.precision_recall(ref_feats, feats)
                row = {
                    "cfg_scale": cfg_scale,
                    "cfg_interval": list(interval) if interval else None,
                    "fid": round(fid.frechet_distance(mu, sigma, ref_mu, ref_sigma), 4),
                    "kid": round(kid_m, 6),
                    "kid_std": round(kid_s, 6),
                    "precision": round(prec, 4),
                    "recall": round(rec, 4),
                    "sample_npz": npz,
                }
                rows.append(row)
                out_f.write(json.dumps(row) + "\n")
                out_f.flush()
                print(json.dumps(row), flush=True)
    best = min(rows, key=lambda r: r["fid"] if np.isfinite(r["fid"]) else np.inf)
    print(f"best by FID: cfg_scale={best['cfg_scale']} cfg_interval={best['cfg_interval']} (fid {best['fid']})")
    return rows


if __name__ == "__main__":
    main()
