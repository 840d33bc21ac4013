"""Distribution-recovery probe: end-to-end learning validation without gated
weights, port of the JAX package's ``tools/distribution_probe.py``.

Train a DiT on a class-conditional Gaussian latent law whose moments are
known, sample from the trained checkpoint, and check that the samples
recover the per-class moments. It validates the whole learning loop (data
pipeline -> q_sample / losses -> Adam / EMA / weight projection ->
checkpoint -> sampling chain -> label conditioning) against ground truth,
with the untrained initialisation as the null baseline.

    python -m mapdit_tpu_torch.tools.distribution_probe --work-dir runs/dprobe \\
        --model DiT-XS/4 --input-size 8 --classes 8 --examples 4096 --train-steps 600 \\
        --batch-size 64 --sampler dpm++ --num-sampling-steps 25 \\
        --compute-dtype bfloat16 --train-args "--block-kernel mega_attn" --block-kernel auto

prints one JSON line: per-class mean error (relative L2 of the sampled
class-mean channel vectors against the truth), total-std ratio and
nearest-centre label accuracy (chance 1/K), for the trained and the
initial weights. Training runs ``python -m mapdit_tpu_torch.train`` in a
subprocess, on CUDA unless ``--train-args`` passes ``--device cpu``; the
evaluation runs in this process on ``--device`` (CUDA unless given),
through ``--block-kernel`` (default: the training config's; ``auto`` takes
the whole-stack kernel on a bf16 run). ``--grid`` also scores the lossy and
few-step accelerators on the trained weights (span caching, few-step
dpm++, limited-interval guidance, parallel-in-time ddim).
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


# ----------------------------------------------------------------- dataset


def make_data(
    out_dir: str,
    classes: int,
    examples: int,
    input_size: int,
    channels: int = 4,
    center_scale: float = 1.0,
    within_std: float = 0.3,
    seed: int = 0,
) -> dict:
    """Write a MoG posterior dataset (the native artifact family the train
    CLI reads) and ``ground_truth.npz``; the arrays are the JAX tool's for
    the same arguments.

    Per class c: centre m_c ~ center_scale * N(0, I) per channel (constant
    over space, so the class signal survives spatial averaging); posterior
    mean m_c + within_std * N(0, I) per pixel; posterior std ~ U[0.1, 0.15]
    per pixel. The latent law of a class is N(m_c, (within_std^2 +
    E[std^2]) I)."""
    from mapdit_tpu_torch.training.data import save_dataset

    rng = np.random.default_rng(seed)
    labels = rng.integers(0, classes, examples).astype(np.int64)
    counts = np.bincount(labels, minlength=classes)
    if not (counts > 0).all():
        raise ValueError(
            f"class(es) {np.nonzero(counts == 0)[0].tolist()} drew zero examples ({examples} examples over {classes} "
            "classes): their ground-truth means would be NaN; raise --examples"
        )
    centers = (center_scale * rng.normal(size=(classes, channels, 1, 1))).astype(np.float32)
    means = (centers[labels] + within_std * rng.normal(size=(examples, channels, input_size, input_size))).astype(
        np.float32)
    stds = (0.1 + 0.05 * rng.random(means.shape)).astype(np.float32)

    mean = means.mean(axis=(0, 2, 3))
    var = (stds**2).mean(axis=(0, 2, 3)) + ((means - mean[None, :, None, None]) ** 2).mean(axis=(0, 2, 3))
    save_dataset(out_dir, means, stds, labels, {"mean": mean, "std": np.sqrt(var)})

    # the finite-sample truth the model saw: per-class channel means of the
    # posterior means (the posterior draw has mean 0) and the total std
    gt = {
        "class_means": np.stack([means[labels == c].mean(axis=(0, 2, 3)) for c in range(classes)]),  # (K, C)
        "total_std": np.float32(np.sqrt(within_std**2 + float((stds**2).mean()))),
        "centers": centers[:, :, 0, 0],  # (K, C), analytic
    }
    np.savez(os.path.join(out_dir, "ground_truth.npz"), **gt)
    return gt


# ------------------------------------------------------------------- train


def train_argv(args, data_dir: str, results_dir: str) -> list:
    """The train CLI's arguments for the probe's run."""
    argv = [
        "--data-path", data_dir,
        "--results-dir", results_dir,
        "--model", args.model,
        "--num-classes", str(args.classes),
        "--num-steps", str(args.train_steps),
        "--batch-size", str(args.batch_size),
        "--seed", str(args.seed),
        "--log-every", str(max(1, args.train_steps // 10)),
        "--ckpt-every", str(args.train_steps),
        # the CLI's default (num_steps // 250) would snapshot every 2 steps
        # at probe budgets and dominate the run
        "--ema-snapshot-every", str(max(1, args.train_steps // 20)),
        "--compute-dtype", args.compute_dtype,
    ]
    return argv + (args.train_args.split() if args.train_args else [])


def run_train(args, data_dir: str, results_dir: str) -> str:
    """Train in a subprocess (``python -m mapdit_tpu_torch.train``); returns
    the experiment directory."""
    cmd = [sys.executable, "-m", "mapdit_tpu_torch.train", *train_argv(args, data_dir, results_dir)]
    proc = subprocess.run(cmd, capture_output=True, text=True, cwd=REPO, timeout=args.train_timeout)
    if proc.returncode != 0:
        raise SystemExit(f"mapdit_tpu_torch.train failed:\n{proc.stdout}\n{proc.stderr}")
    return latest_run(results_dir)


def latest_run(results_dir: str) -> str:
    return os.path.join(results_dir, sorted(os.listdir(results_dir))[-1])


# ---------------------------------------------------------------- evaluate


def draw_samples(
    state_dict,
    train_args: dict,
    samples_per_class: int,
    sampler: str,
    num_sampling_steps: int,
    time_schedule: str,
    seed: int,
    batch_hint_cap: int = 1024,
    cache_interval: int = 0,
    # "hold" on purpose (the server defaults to "forecast"): the grid passes
    # the mode on every row, so the default never decides a measurement
    cache_mode: str = "hold",
    cfg_scale=None,
    cfg_interval=None,
    dynamic_threshold=None,
    block_kernel=None,
    device=None,
    pit=None,
) -> np.ndarray:
    """Run the sampling chain on ``state_dict``; returns denormalized,
    unclipped latents (K, M, C, S, S). z, labels and the chain's noise come
    from one generator seeded with ``seed``, so every config of a family
    sees the same draws. ``pit=(window, sweeps or None, shift or None)``
    runs the parallel-in-time ddim chain (``runtime.build_pit_sample_fn``)."""
    import torch

    from mapdit_tpu_torch.diffusion import create_diffusion, respacing_string
    from mapdit_tpu_torch.runtime import build_cached_sample_fn, build_pit_sample_fn, build_sample_fn
    from mapdit_tpu_torch.sample import decode_latents, run_config
    from mapdit_tpu_torch.utils.device import resolve_device

    device = resolve_device(device)
    cfg = run_config(train_args, block_kernel)
    k, m = int(train_args["num_classes"]), samples_per_class
    n = k * m
    if train_args.get("distill_rounds"):
        # a distilled student: valid only on its own nested DDIM grid, with
        # any guidance baked in (no CFG doubling)
        from mapdit_tpu_torch.diffusion.distill import student_diffusion_from_config

        if cache_interval > 1 or cfg_interval is not None or pit is not None:
            raise ValueError("the accelerator grid does not apply to distilled students")
        diffusion = student_diffusion_from_config(train_args, device=device)
        sampler = "ddim"
        if train_args.get("distill_cfg_scale", 1.0) > 1.0:
            cfg_scale = None
    else:
        diffusion = create_diffusion(respacing_string(num_sampling_steps, sampler, time_schedule), device=device)
    if pit is not None:
        window, sweeps, shift = pit
        sample_fn = build_pit_sample_fn(
            cfg, state_dict, diffusion, cfg_scale=cfg_scale, window=window, sweeps=sweeps or 2, shift=shift,
            dynamic_threshold=dynamic_threshold, device=device,
        )
    elif cache_interval > 1:
        sample_fn = build_cached_sample_fn(
            cfg, state_dict, diffusion, cfg_scale=cfg_scale, sampler=sampler, cache_interval=cache_interval,
            cache_mode=cache_mode, cfg_interval=cfg_interval, dynamic_threshold=dynamic_threshold, device=device,
        )
    else:
        sample_fn = build_sample_fn(
            cfg, state_dict, diffusion, cfg_scale=cfg_scale, sampler=sampler, batch_hint=min(n, batch_hint_cap),
            cfg_interval=cfg_interval, dynamic_threshold=dynamic_threshold, device=device,
        )
    gen = torch.Generator(device=device).manual_seed(seed)
    c, s = int(train_args["in_channels"]), int(train_args["input_size"])
    z = torch.randn((n, c, s, s), generator=gen, device=device)
    y = torch.arange(k, device=device).repeat_interleave(m)
    if cfg_scale is not None:
        # the reference's CFG batch [z; z] / [y; null]
        z = torch.cat([z, z])
        y = torch.cat([y, torch.full((n,), cfg.num_classes, device=device)])
    samples = sample_fn(z, y, gen)[:n].float().cpu().numpy()
    # clip=False: the metrics read raw latents; the [-1, 1] image clamp
    # would cut any law with mass outside the box
    latents = decode_latents(samples, train_args, use_vae=False, clip=False)
    return latents.reshape(k, m, c, s, s)


def dist_metrics(latents: np.ndarray, gt: dict) -> dict:
    """Moment-recovery metrics of (K, M, C, S, S) latents against the
    ground truth."""
    finite_frac = float(np.isfinite(latents).all(axis=(2, 3, 4)).mean())
    true_means = np.asarray(gt["class_means"], np.float32)  # (K, C)
    true_std = float(gt["total_std"])
    got_means = latents.mean(axis=(1, 3, 4))  # (K, C)
    mean_err = float(
        np.linalg.norm(got_means - true_means, axis=1).mean() / np.linalg.norm(true_means, axis=1).mean()
    )
    # the total std around the class mean, pooled over the classes
    centered = latents - got_means[:, None, :, None, None]
    std_ratio = float(centered.std() / true_std)
    # nearest-centre assignment of each sample's channel-mean vector
    feats = latents.mean(axis=(3, 4))  # (K, M, C)
    d2 = ((feats[:, :, None, :] - true_means[None, None, :, :]) ** 2).sum(-1)
    assigned = d2.argmin(-1)  # (K, M)
    label_acc = float((assigned == np.arange(latents.shape[0])[:, None]).mean())
    out = {"mean_err": mean_err, "std_ratio": std_ratio, "label_acc": label_acc}
    if finite_frac < 1.0:
        out["finite_frac"] = finite_frac
    return out


def evaluate(state_dict, train_args: dict, gt: dict, **draw_kwargs) -> dict:
    return dist_metrics(draw_samples(state_dict, train_args, **draw_kwargs), gt)


# ----------------------------------------------------------- law analysis


def conditioning_signal(
    gt: dict,
    within_std: float,
    input_size: int,
    n: int = 512,
    t_stride: int = 50,
    seed: int = 7,
) -> dict:
    """Monte-Carlo the largest label-conditioning signal the law holds: the
    eps-MSE gap between the optimal conditional and the optimal marginal
    denoiser, per timestep (its uniform-t mean is its weight in the training
    loss). Capped by the label information I(x0; y) <= ln K spread over
    C * S^2 per-dimension loss units, so it is ~0.13-0.19 x ln(K) / D for
    every MoG law of this family: at S = 16, K = 8 about 3e-4 of the O(1)
    loss, where label_acc near chance is the expected outcome of a correct
    run; a smaller ``input_size`` raises the ceiling (the S = 8 positive
    control)."""
    from mapdit_tpu_torch.diffusion import create_diffusion

    acp_tab = create_diffusion("", device="cpu").alphas_cumprod.numpy()
    # the normalized law, as the training pipeline sees it
    m = np.asarray(gt["class_means"], np.float64)
    k, c = m.shape
    pooled = np.sqrt(within_std**2 + m.var(axis=0).mean())
    # within_std here is the total per-class std (with the posterior draw)
    m = m / pooled
    s = within_std / pooled
    rng = np.random.default_rng(seed)
    size = input_size
    tg = np.arange(0, 1000, t_stride)
    gaps = []
    for t in tg:
        acp = float(acp_tab[t])
        y = rng.integers(0, k, n)
        x0 = m[y][:, :, None, None] + s * rng.normal(size=(n, c, size, size))
        xt = np.sqrt(acp) * x0 + np.sqrt(1 - acp) * rng.normal(size=(n, c, size, size))
        v = acp * s**2 + (1 - acp)
        post_c = (np.sqrt(acp) * s**2 * xt + (1 - acp) * m[y][:, :, None, None]) / v
        mm = m[:, None, :, None, None]
        d = xt[None] - np.sqrt(acp) * mm
        ll = -0.5 * (d**2).sum(axis=(2, 3, 4)) / v
        ll -= ll.max(axis=0, keepdims=True)
        w = np.exp(ll)
        w /= w.sum(axis=0, keepdims=True)
        post_m = (w[:, :, None, None, None] * (np.sqrt(acp) * s**2 * xt[None] + (1 - acp) * mm) / v).sum(axis=0)
        gaps.append(acp / (1 - acp) * float(((post_c - post_m) ** 2).mean()))
    gaps = np.asarray(gaps)
    i = int(gaps.argmax())
    return {"uniform_t_mean": float(gaps.mean()), "max": float(gaps.max()), "argmax_t": int(tg[i])}


# -------------------------------------------------------- accelerator grid


def rel_l2(a: np.ndarray, b: np.ndarray) -> float:
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def finite_json(obj):
    """NaN and Infinity are not JSON, and divergent chains (the runs this
    probe diagnoses) produce them: map them to None, so the one-line output
    parses under strict readers (``json.loads``, jq)."""
    if isinstance(obj, float):
        return obj if np.isfinite(obj) else None
    if isinstance(obj, dict):
        return {k: finite_json(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [finite_json(v) for v in obj]
    return obj


# (family, label, sampler, steps, schedule, cache interval, mode, cfg_scale,
# cfg_interval[, pit]); a family's exact chain (interval 0, no cfg interval,
# no pit) comes before its variants. pit = (window, sweeps, shift): the
# parallel-in-time family, scored against the sequential ddim chain.
GRID = [
    ("ddpm250", "ddpm:250", "ddpm", 250, "uniform", 0, "hold", None, None),
    ("ddpm250", "ddpm:250:k2-hold", "ddpm", 250, "uniform", 2, "hold", None, None),
    ("ddpm250", "ddpm:250:k2-forecast", "ddpm", 250, "uniform", 2, "forecast", None, None),
    ("ddpm250", "ddpm:250:k5-hold", "ddpm", 250, "uniform", 5, "hold", None, None),
    ("ddpm250", "ddpm:250:k5-forecast", "ddpm", 250, "uniform", 5, "forecast", None, None),
    ("dpm20", "dpm++:20:karras", "dpm++", 20, "karras", 0, "hold", None, None),
    ("dpm20", "dpm++:20:karras:k2-hold", "dpm++", 20, "karras", 2, "hold", None, None),
    ("dpm20", "dpm++:20:karras:k2-forecast", "dpm++", 20, "karras", 2, "forecast", None, None),
    ("dpm10", "dpm++:10:karras", "dpm++", 10, "karras", 0, "hold", None, None),
    # guidance sharpens (std_ratio < 1, label_acc up) on purpose; a cfg
    # interval is scored against the full-CFG chain of its scale
    ("cfg4", "dpm++:20:karras:cfg4", "dpm++", 20, "karras", 0, "hold", 4.0, None),
    ("cfg4", "dpm++:20:karras:cfg4:interval", "dpm++", 20, "karras", 0, "hold", 4.0, (0.3, 3.0)),
    ("cfg1.5", "ddpm:250:cfg1.5", "ddpm", 250, "uniform", 0, "hold", 1.5, None),
    ("cfg1.5", "ddpm:250:cfg1.5:interval", "ddpm", 250, "uniform", 0, "hold", 1.5, (0.3, 3.0)),
    ("ddim50", "ddim:50", "ddim", 50, "uniform", 0, "hold", None, None),
    ("ddim50", "ddim:50:pit-slide-K10-S2", "ddim", 50, "uniform", 0, "hold", None, None, (10, None, 2)),
    ("ddim50", "ddim:50:pit-block-K10-J5", "ddim", 50, "uniform", 0, "hold", None, None, (10, 5, None)),
]


def run_grid(state_dict, train_args: dict, gt: dict, args) -> list:
    """Score the lossy and few-step accelerators on trained weights: per
    config the distribution-recovery metrics and the final samples' rel L2
    against the exact chain of its family on the same draws."""
    rows, exact_by_family = [], {}
    for family, label, sampler, steps, schedule, k, mode, scale, interval, *pit in GRID:
        pit = pit[0] if pit else None
        latents = draw_samples(
            state_dict, train_args, samples_per_class=args.samples_per_class, sampler=sampler,
            num_sampling_steps=steps, time_schedule=schedule, seed=args.seed + 1, cache_interval=k,
            cache_mode=mode, cfg_scale=scale, cfg_interval=interval, dynamic_threshold=args.dynamic_threshold,
            block_kernel=args.block_kernel, device=args.device, pit=pit,
        )
        row = {"config": label, **dist_metrics(latents, gt)}
        if k == 0 and interval is None and pit is None:
            exact_by_family[family] = latents
        else:
            row["rel_l2_vs_exact"] = rel_l2(latents, exact_by_family[family])
        rows.append(row)
        print(json.dumps(finite_json(row)), flush=True)
    return rows


def build_parser() -> argparse.ArgumentParser:
    from mapdit_tpu_torch.models.config import BLOCK_KERNELS
    from mapdit_tpu_torch.utils.experiment import percentile_arg

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--work-dir", required=True, help="holds data/ and results/; reused across stages")
    p.add_argument("--model", default="DiT-XS/8")
    p.add_argument("--classes", type=int, default=8)
    p.add_argument("--examples", type=int, default=4096)
    p.add_argument("--input-size", type=int, default=16)
    p.add_argument("--center-scale", type=float, default=1.0)
    p.add_argument("--within-std", type=float, default=0.3)
    p.add_argument("--train-steps", type=int, default=600)
    p.add_argument("--batch-size", type=int, default=64)
    p.add_argument("--compute-dtype", default="float32", choices=["float32", "bfloat16"])
    p.add_argument("--train-args", default=None, help="extra flags for the train CLI, one string")
    p.add_argument("--train-timeout", type=int, default=3600)
    p.add_argument("--sampler", default="dpm++", choices=["ddpm", "ddim", "dpm++", "unipc"])
    p.add_argument("--num-sampling-steps", type=int, default=25)
    p.add_argument("--time-schedule", default="karras", choices=["uniform", "karras"])
    p.add_argument("--samples-per-class", type=int, default=128)
    p.add_argument("--ema-std", type=float, default=None,
                   help="evaluate the post-hoc EMA at this std instead of the raw final checkpoint")
    p.add_argument("--dynamic-threshold", type=percentile_arg, default=None,
                   help="dynamic thresholding percentile for every evaluation chain")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--skip-train", action="store_true", help="reuse the existing run in work-dir/results")
    p.add_argument("--eval-dir", type=str, default=None,
                   help="evaluate this experiment directory (a distill stage, say) against work-dir's ground "
                        "truth instead of the probe's own run (implies --skip-train)")
    p.add_argument("--skip-init-baseline", action="store_true")
    p.add_argument("--grid", action="store_true",
                   help="also score the accelerator grid (span cache hold / forecast, few-step dpm++, "
                        "limited-interval guidance, parallel-in-time ddim) on the trained weights, one JSON row per config")
    p.add_argument("--device", type=str, default="cuda", help="where the evaluation samples; cuda unless given")
    p.add_argument("--block-kernel", choices=list(BLOCK_KERNELS), default=None,
                   help="the evaluation chains' block kernel (default: the training config's)")
    return p


def main(argv=None) -> dict:
    """Run the probe; prints its JSON line and returns it as a dict."""
    args = build_parser().parse_args(argv)
    from mapdit_tpu_torch.models.dit import init_model
    from mapdit_tpu_torch.sample import load_variables
    from mapdit_tpu_torch.training.checkpoint import latest_checkpoint
    from mapdit_tpu_torch.utils.experiment import config_from_args, load_config

    data_dir = os.path.join(args.work_dir, "data")
    results_dir = os.path.join(args.work_dir, "results")
    gt_path = os.path.join(data_dir, "ground_truth.npz")
    if args.eval_dir:
        args.skip_train = True
    if os.path.exists(gt_path) and args.skip_train:
        with np.load(gt_path) as f:
            gt = dict(f)
    else:
        gt = make_data(data_dir, args.classes, args.examples, args.input_size, center_scale=args.center_scale,
                       within_std=args.within_std, seed=args.seed)

    if args.eval_dir:
        run_dir = args.eval_dir
    elif args.skip_train:
        run_dir = latest_run(results_dir)
    else:
        run_dir = run_train(args, data_dir, results_dir)

    train_args = load_config(run_dir)
    if args.ema_std is not None:
        state_dict = load_variables(run_dir, train_args, ema_std=args.ema_std)
    else:
        # the run's own final checkpoint (under --skip-train it may differ
        # from this invocation's --train-steps)
        ckpt_path = latest_checkpoint(run_dir)
        if not ckpt_path:
            raise SystemExit(f"no checkpoint under {run_dir}")
        state_dict = load_variables(run_dir, train_args, ckpt=os.path.splitext(os.path.basename(ckpt_path))[0])

    eval_kwargs = dict(
        samples_per_class=args.samples_per_class, sampler=args.sampler, num_sampling_steps=args.num_sampling_steps,
        time_schedule=args.time_schedule, seed=args.seed + 1, dynamic_threshold=args.dynamic_threshold,
        block_kernel=args.block_kernel, device=args.device,
    )
    trained = evaluate(state_dict, train_args, gt, **eval_kwargs)

    init = {}
    if not args.skip_init_baseline:
        init_sd = init_model(config_from_args(train_args), seed=args.seed + 2, device="cpu").state_dict()
        init = evaluate(init_sd, train_args, gt, **eval_kwargs)

    out = {
        "metric": "distribution_recovery",
        "model": args.model,
        "classes": args.classes,
        "train_steps": args.train_steps,
        "batch_size": args.batch_size,
        "sampler": (
            f"distilled-ddim:{train_args['distill_num_steps']}" if train_args.get("distill_rounds")
            else f"{args.sampler}:{args.num_sampling_steps}:{args.time_schedule}"
        ),
        "samples_per_class": args.samples_per_class,
        "chance_acc": 1.0 / args.classes,
        "mean_err_trained": trained["mean_err"],
        "std_ratio_trained": trained["std_ratio"],
        "label_acc_trained": trained["label_acc"],
        **{f"{k}_init": v for k, v in init.items()},
        # how much conditioning the law can express at all (conditioning_signal)
        "conditioning_signal": conditioning_signal(gt, float(gt["total_std"]), args.input_size),
        "run_dir": run_dir,
    }
    if args.grid:
        out["grid"] = run_grid(state_dict, train_args, gt, args)
    out = finite_json(out)
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
