"""Train a (MaP-)DiT on VAE-latent data, port of the JAX package's ``train.py``.

    python -m mapdit_tpu_torch.train --data-path synthetic:1024 --results-dir results \\
        --model DiT-S/2 --batch-size 256 --compute-dtype bfloat16 \\
        --block-kernel mega_attn --attn-bwd pallas
    python -m mapdit_tpu_torch.train --device cpu --data-path synthetic:64 ...   # plain PyTorch on the CPU

The flags, the config.yaml round trip, the experiment / checkpoint /
EMA-snapshot layout, the log format and ``--resume`` are the JAX CLI's; the
run is on one CUDA device unless ``--device`` says otherwise. One step
(``training/state.py``): posterior draw and normalization, loss, backward,
Adam under the schedule, both power EMAs, the forced weight normalization.
The host shuffles indices and stages (mean, std, label) slices.

``--remat true`` recomputes each block in the backward instead of keeping
its activations (the memory of DiT-XL/2 at batch 256); ``--scan-blocks
true`` keeps the block parameters stacked on a depth axis, as a JAX
``--scan-blocks`` run saves them, and its checkpoints and EMA snapshots
hold that layout.

Not ported yet, and raising with their ROADMAP item: ``--n-model > 1``,
``--fsdp``, ``--multihost`` and ``--checkpointer orbax`` ("Multi-GPU layouts, the
rest").
"""

from __future__ import annotations

import argparse
import json
import os
import signal
import time

import torch

from mapdit_tpu_torch.diffusion import create_diffusion
from mapdit_tpu_torch.models.config import ATTENTION_IMPLS, MODULATION_KINDS
from mapdit_tpu_torch.models.registry import DIT_MODELS
from mapdit_tpu_torch.training import (
    EMA_STDS,
    create_optimizer,
    create_train_state,
    ema_key,
    make_train_step,
    warmup_flat_invsqrt,
)
from mapdit_tpu_torch.training import ema as ema_lib
from mapdit_tpu_torch.training.checkpoint import (
    AsyncStateSaver,
    AsyncTreeWriter,
    latest_checkpoint,
    restore_state,
    save_state,
)
from mapdit_tpu_torch.training.data import LatentDataset, SyntheticLatentDataset
from mapdit_tpu_torch.training.device_prefetch import DevicePrefetcher, make_stage_fn
from mapdit_tpu_torch.training.lr import default_schedule_steps
from mapdit_tpu_torch.training.native_loader import NativeLatentLoader
from mapdit_tpu_torch.utils.device import resolve_device
from mapdit_tpu_torch.utils.experiment import config_from_args, save_config, setup_experiment
from mapdit_tpu_torch.utils.logging import create_logger


def build_dataset(data_path: str):
    if data_path.startswith("synthetic"):
        n = int(data_path.split(":")[1]) if ":" in data_path else 1024
        return SyntheticLatentDataset(num_examples=n)
    return LatentDataset(data_path)


def _check_ported(args) -> None:
    if args.n_model != 1 or args.fsdp or args.multihost:
        raise NotImplementedError(
            "--n-model > 1, --fsdp and --multihost are the ROADMAP item 'Multi-GPU layouts, the rest'; "
            "the port trains on one device"
        )
    if args.checkpointer == "orbax":
        raise NotImplementedError(
            "--checkpointer orbax is the multi-host sharded format (ROADMAP item 'Multi-GPU layouts, the rest'); "
            "use torch or torch-sync"
        )


def _write_profile(prof, out_dir: str, steps: int, seconds: float) -> None:
    """The trace of the loop: a chrome trace, the table of device time by
    kernel, and a summary with the device-busy time per step."""
    from torch.autograd import DeviceType

    os.makedirs(out_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(out_dir, "trace.json"))
    events = prof.key_averages()
    with open(os.path.join(out_dir, "key_averages.txt"), "w") as f:
        f.write(events.table(sort_by="self_device_time_total", row_limit=60))
    kernels = sorted(
        ((e.key, e.self_device_time_total) for e in events
         if e.device_type == DeviceType.CUDA and not getattr(e, "is_user_annotation", False)
         and e.self_device_time_total > 0),
        key=lambda kv: -kv[1],
    )
    summary = {
        "steps": steps,
        "traced_wall_ms_per_step": 1e3 * seconds / max(steps, 1),
        "device_busy_ms_per_step": sum(us for _, us in kernels) / 1e3 / max(steps, 1),
        "top_kernels_ms_per_step": {name[:120]: us / 1e3 / max(steps, 1) for name, us in kernels[:15]},
    }
    with open(os.path.join(out_dir, "summary.json"), "w") as f:
        json.dump(summary, f, indent=1)


def main(args) -> str:
    """Run the training the parsed ``args`` describe; returns the experiment
    directory."""
    _check_ported(args)
    device = resolve_device(args.device)
    if args.matmul_precision != "default":  # "default" leaves PyTorch's own setting ("highest")
        torch.set_float32_matmul_precision(args.matmul_precision)

    exp_dir = setup_experiment(args.model, args.results_dir)
    logger = create_logger(exp_dir, verbose=args.verbose)
    kind = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    logger.info(f"devices: 1x {kind}")
    logger.info(f"experiment directory created at {exp_dir}")

    dataset = build_dataset(args.data_path)
    logger.info(
        f"dataset contains {len(dataset):,} data points "
        f"({args.data_path}, {dataset.channels}x{dataset.data_size}x{dataset.data_size})"
    )

    # Persist the full config (argparse + dataset-derived fields): the
    # model-construction source of truth for every later script.
    args.in_channels = dataset.channels
    args.input_size = dataset.data_size
    args.stats_std = [float(x) for x in dataset.stats["std"]]
    args.stats_mean = [float(x) for x in dataset.stats["mean"]]
    save_config(exp_dir, vars(args))

    diffusion = create_diffusion("", device=device)
    cfg = config_from_args(vars(args))

    if args.ema_snapshot_every is None:
        args.ema_snapshot_every = args.num_steps // 250
    num_lin_warmup, start_decay = default_schedule_steps(args.num_steps, args.num_lin_warmup, args.start_decay)
    schedule = warmup_flat_invsqrt(args.lr, num_lin_warmup, start_decay)
    tx = create_optimizer(schedule, grad_clip=args.grad_clip)
    ema_stds = tuple(args.ema_stds)
    state = create_train_state(
        cfg, tx, seed=args.seed, ema_stds=ema_stds, timestep_sampler=args.timestep_sampler,
        num_timesteps=diffusion.num_timesteps, device=device,
    )
    logger.info(f"model parameters: {sum(p.numel() for p in state.model.parameters()):,}")

    if args.resume:
        path = args.resume if os.path.isfile(args.resume) else latest_checkpoint(args.resume)
        if not path:
            raise FileNotFoundError(f"--resume: no checkpoint found at {args.resume}")
        state = restore_state(path, state)
        logger.info(f"resumed from {path} at step {state.step}")

    # The buffers (Fourier constants, positional table) once, so that
    # sampling from EMA snapshots alone does not need a full checkpoint.
    torch.save({k: v.detach().cpu() for k, v in state.model.named_buffers()}, os.path.join(exp_dir, "constants.pt"))

    if args.batch_size % args.grad_accum:
        raise ValueError("--grad-accum must divide --batch-size")
    step_fn = make_train_step(
        cfg, diffusion, tx, stats_mean=dataset.stats["mean"], stats_std=dataset.stats["std"], ema_stds=ema_stds,
        timestep_sampler=args.timestep_sampler, grad_accum=args.grad_accum,
    )

    mag_probe = None
    if args.log_magnitudes:
        from mapdit_tpu_torch.training.telemetry import make_activation_probe, weight_magnitudes

        act_probe = make_activation_probe(cfg, diffusion, stats_mean=dataset.stats["mean"], stats_std=dataset.stats["std"])

        def mag_probe(st, probe_batch, step):
            row = {k: float(v) for k, v in weight_magnitudes(st.params).items()}
            act = act_probe(st.model, probe_batch, torch.Generator(device=device).manual_seed(step))
            row["block_rms"] = [round(float(v), 4) for v in act["block_rms"]]
            row["out_rms"] = round(float(act["out_rms"]), 4)
            return row

    # start_step resumes the shuffle stream at the checkpointed step
    data_start_step = state.step
    native = None
    if NativeLatentLoader.available(args.data_path):
        native = NativeLatentLoader(args.data_path, args.batch_size, seed=args.seed,
                                    num_threads=max(2, args.num_workers), start_step=data_start_step)
        batches = native.batches()
        logger.info("using native latent loader (prefetch threads)")
    else:
        batches = dataset.batches(batch_size=args.batch_size, seed=args.seed, start_step=data_start_step)

    stage_batch = make_stage_fn(device)
    dev_prefetch = None
    if args.device_prefetch == "thread":
        dev_prefetch = DevicePrefetcher(batches, stage_batch, depth=2)
        logger.info("device prefetch: double-buffered batch staging on")

    def next_staged():
        return next(dev_prefetch) if dev_prefetch is not None else stage_batch(next(batches))

    metrics_sink = None
    if args.metrics_jsonl:
        path = args.metrics_jsonl if args.metrics_jsonl != "auto" else os.path.join(exp_dir, "metrics.jsonl")
        metrics_sink = open(path, "a")

    state_saver = None  # lazy background checkpoint writer (--checkpointer torch)
    ema_writer = None  # lazy background EMA snapshot writer

    def save_checkpoint(step, st):
        nonlocal state_saver
        if args.checkpointer == "torch-sync":
            path = save_state(exp_dir, step, st)
            logger.info(f"saving checkpoint to {path} at step {step}...")
        else:
            if state_saver is None:
                state_saver = AsyncStateSaver()
            path = state_saver.save(exp_dir, step, st)
            logger.info(f"saving checkpoint to {path} at step {step} (async write)...")

    def save_ema_snapshots(step, st):
        nonlocal ema_writer
        ema_dir = os.path.join(exp_dir, "ema")
        if ema_writer is None:
            ema_writer = AsyncTreeWriter()
        for std in ema_stds:
            ema_writer.submit(
                st.ema[ema_key(std)],
                lambda host, _std=std, _step=step: ema_lib.save_snapshot(ema_dir, _std, _step, host),
            )
        logger.info(f"saving ema snapshot to {ema_dir} at step {step}...")

    # Graceful preemption: SIGTERM / SIGINT finish the step in flight, save a
    # checkpoint and the EMA snapshots, and exit 0, so that --resume
    # continues the exact trajectory.
    preempt = {"sig": None}

    def _request_stop(signum, frame):
        preempt["sig"] = signal.Signals(signum).name

    old_handlers = {sig: signal.signal(sig, _request_stop) for sig in (signal.SIGTERM, signal.SIGINT)}

    prof = None
    if args.profile_dir:
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device.type == "cuda" else [])
        prof = profile(activities=activities)
        prof.start()

    logger.info(f"training for {args.num_steps} steps...")
    train_steps = state.step
    first_step = train_steps
    log_steps = 0
    loss_buf, norm_buf = [], []  # on-device scalars; fetched once per log interval
    loop_start = start_time = time.time()
    try:
        while train_steps < args.num_steps:
            batch = next_staged()
            metrics = step_fn(state, batch)
            train_steps += 1
            log_steps += 1
            loss_buf.append(metrics["loss"])
            norm_buf.append(metrics["grad_norm"])

            if train_steps % args.log_every == 0:
                # Interval-averaged loss with one host sync per interval
                avg_loss, avg_norm = torch.stack([torch.stack(loss_buf).mean(), torch.stack(norm_buf).mean()]).tolist()
                steps_per_sec = log_steps / (time.time() - start_time)
                logger.info(
                    f"(step={train_steps:07d}) train loss: {avg_loss:.4f}, "
                    f"train steps/sec: {steps_per_sec:.2f}"
                )
                mag_row = None
                if mag_probe is not None:
                    mag_row = mag_probe(state, batch, train_steps)
                    br = mag_row["block_rms"]
                    logger.info(
                        "(magnitudes) "
                        f"w_rms_dev mean {mag_row.get('w_rms_dev_mean', 0.0):.2e} "
                        f"max {mag_row.get('w_rms_dev_max', 0.0):.2e}, "
                        f"gain |.| max {mag_row.get('gain_abs_max', 0.0):.3f}, "
                        f"block_rms {br[0]:.3f}..{br[-1]:.3f}, "
                        f"out_rms {mag_row['out_rms']:.3f}"
                    )
                if metrics_sink is not None:
                    # the JAX CLI's keys, and grad_norm (the interval's mean
                    # of the unclipped global gradient norm)
                    row = {
                        "step": train_steps,
                        "loss": round(avg_loss, 6),
                        "steps_per_sec": round(steps_per_sec, 3),
                        "lr": float(schedule(train_steps)),
                        "samples_seen": train_steps * args.batch_size,
                        "wall_time": round(time.time(), 3),
                        "grad_norm": round(avg_norm, 6),
                    }
                    if mag_row is not None:
                        row["magnitudes"] = mag_row
                    metrics_sink.write(json.dumps(row) + "\n")
                    metrics_sink.flush()
                loss_buf, norm_buf = [], []
                if device.type == "cuda":
                    logger.debug(
                        f"(memory) current={torch.cuda.memory_allocated(device) / 1e9:.2f}GB, "
                        f"peak={torch.cuda.max_memory_allocated(device) / 1e9:.2f}GB"
                    )
                log_steps, start_time = 0, time.time()

            ckpt_now = train_steps % args.ckpt_every == 0 and train_steps > 0
            if ckpt_now:
                save_checkpoint(train_steps, state)

            ema_now = bool(args.ema_snapshot_every) and train_steps % args.ema_snapshot_every == 0 and train_steps > 0
            if ema_now:
                save_ema_snapshots(train_steps, state)

            if preempt["sig"] is not None:
                if not ckpt_now:
                    save_checkpoint(train_steps, state)
                if args.ema_snapshot_every and not ema_now:
                    save_ema_snapshots(train_steps, state)
                logger.info(
                    f"({preempt['sig']}) graceful stop at step {train_steps}: state saved; "
                    f"continue with --resume {exp_dir}"
                )
                break
    finally:
        # Also on an exception mid-run: the writer threads hold saves that
        # the log already announced, and must drain before the process
        # exits, or --resume would start from an older step than logged.
        for sig, handler in old_handlers.items():
            signal.signal(sig, handler)
        if dev_prefetch is not None:
            dev_prefetch.close()
        if native is not None:
            native.close()
        if ema_writer is not None:
            ema_writer.close()
        if state_saver is not None:
            state_saver.close()
        if prof is not None:
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            seconds = time.time() - loop_start
            prof.stop()
            _write_profile(prof, args.profile_dir, train_steps - first_step, seconds)
        if metrics_sink is not None:
            metrics_sink.close()
    logger.info("done!")
    return exp_dir


def _bool(s: str) -> bool:
    return s.lower() in ("1", "true", "yes")


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])

    # Training loop
    parser.add_argument("--data-path", type=str, required=True,
                        help="latent dataset dir, or 'synthetic[:N]' for generated data")
    parser.add_argument("--results-dir", type=str, required=True)
    parser.add_argument("--model", type=str, choices=list(DIT_MODELS.keys()), default="DiT-XS/2")
    parser.add_argument("--num-classes", type=int, default=1000)
    parser.add_argument("--num-steps", type=int, default=400_000)
    parser.add_argument("--batch-size", type=int, default=256)
    parser.add_argument("--lr", type=float, default=1e-2)
    parser.add_argument("--grad-clip", type=float, default=None,
                        help="global-norm gradient clipping (off by default, like the reference)")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--verbose", type=int, choices=[0, 1, 2], default=1, help="0: warning, 1: info, 2: debug")
    parser.add_argument("--num-workers", type=int, default=4,
                        help="threads of the native latent loader (at least 2 are used); the Python loader "
                             "gathers by index and needs none")
    parser.add_argument("--device-prefetch", choices=["off", "thread"], default="off",
                        help="'thread' stages batch k+1 (pinned memory, a side stream) in a background thread "
                             "while step k runs; the default stages inline")
    parser.add_argument("--log-every", type=int, default=100)
    parser.add_argument("--ckpt-every", type=int, default=50_000)

    # LR schedule (defaults num_steps//150 and num_steps//10)
    parser.add_argument("--num-lin-warmup", type=int, default=None)
    parser.add_argument("--start-decay", type=int, default=None)

    # EMA
    parser.add_argument("--ema-snapshot-every", type=int, default=None)
    parser.add_argument("--ema-stds", type=float, nargs="*", default=list(EMA_STDS),
                        help="tracked power-EMA stds (reference: 0.05 0.1)")

    # MaP feature flags (all default ON = reference behavior)
    for name in ("use-cosine-attention", "use-weight-normalization", "use-forced-weight-normalization",
                 "use-mp-residual", "use-mp-silu"):
        parser.add_argument(f"--{name}", type=_bool, default=True, metavar="BOOL")
    parser.add_argument(
        "--use-no-layernorm", type=_bool, default=True, metavar="BOOL",
        help="ON (reference) drops LayerNorm AND selects the MP conditioning arithmetic "
             "mp_sum(x*scale, shift, gain) everywhere; OFF restores pre-modulation LayerNorm AND the classic "
             "x*(1+scale)+shift arithmetic (vanilla DiT)")
    for name in ("use-mp-pos-enc", "use-mp-embedding"):
        parser.add_argument(f"--{name}", type=_bool, default=True, metavar="BOOL")
    parser.add_argument("--modulation", choices=list(MODULATION_KINDS), default="adaln")
    parser.add_argument("--timestep-sampler", choices=["uniform", "loss-second-moment"], default="uniform",
                        help="t importance sampling")

    # Execution
    parser.add_argument("--device", type=str, default="cuda",
                        help="the device to train on; 'cpu' runs the plain PyTorch path")
    parser.add_argument("--n-model", type=int, default=1,
                        help="tensor-parallel axis size (only 1 until the multi-GPU layouts are ported)")
    parser.add_argument("--fsdp", type=_bool, default=False, metavar="BOOL",
                        help="fully-sharded params/optimizer/EMA (not ported yet)")
    parser.add_argument("--grad-accum", type=int, default=1,
                        help="micro-batch gradient accumulation: batch-size/N slices, one optimizer update, "
                             "the same trajectory, 1/N activation memory")
    parser.add_argument("--compute-dtype", choices=["float32", "bfloat16"], default="float32")
    parser.add_argument("--matmul-precision", choices=["default", "high", "highest"], default="default",
                        help="float32 matrix products: 'default' leaves PyTorch's setting (full float32), "
                             "'high' sets torch.set_float32_matmul_precision('high') (TF32 passes), "
                             "'highest' sets 'highest' (full float32)")
    parser.add_argument("--remat", type=_bool, default=False, metavar="BOOL",
                        help="per-block activation rematerialization (XL-scale train memory)")
    parser.add_argument("--scan-blocks", type=_bool, default=False, metavar="BOOL",
                        help="block parameters stacked on a leading depth axis (the JAX --scan-blocks layout)")
    parser.add_argument("--attention-impl", choices=list(ATTENTION_IMPLS), default="auto")
    parser.add_argument("--block-kernel", choices=["auto", "pallas", "mega", "mega_attn", "off"], default="auto",
                        help="block kernels: mega = whole-block kernel, mega_attn = attention half-block kernels "
                             "with a fused backward, pallas = MLP half-block kernel, auto/off = plain PyTorch "
                             "when training")
    parser.add_argument("--attn-bwd", choices=["pallas", "residual", "reference"], default="pallas",
                        help="VJP for --block-kernel mega_attn: pallas = fused backward kernels (recompute), "
                             "residual = residual-emitting forward kernel + plain backward, reference = "
                             "autograd through the plain math")
    parser.add_argument("--checkpointer", choices=["torch", "torch-sync", "orbax"], default="torch",
                        help="torch (default) clones the state on the device and writes from a background "
                             "thread; torch-sync writes on the train loop's thread; orbax (multi-host sharded) "
                             "is not ported yet")
    parser.add_argument("--resume", type=str, default=None, help="checkpoint file or experiment dir to resume from")
    parser.add_argument("--profile-dir", type=str, default=None, help="write a torch.profiler trace of the loop here")
    parser.add_argument("--metrics-jsonl", type=str, default=None,
                        help="append one JSON metrics object per log interval ('auto' = <exp_dir>/metrics.jsonl)")
    parser.add_argument("--log-magnitudes", action="store_true",
                        help="per log interval, record magnitude-preservation telemetry: weight-row RMS "
                             "deviation, gain magnitudes, and per-block residual-stream RMS at t=T/2")
    parser.add_argument("--multihost", type=_bool, default=False, metavar="BOOL",
                        help="one process per host (not ported yet)")
    return parser


if __name__ == "__main__":
    main(build_parser().parse_args())
