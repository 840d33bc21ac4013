"""Benchmarks of the port on one GPU: denoise steps/s (sample) or train steps/s.

    python -m mapdit_tpu_torch.bench [--mode sample] [--model DiT-S/2] [--batch 32] [--steps 250]
                                     [--dtype bfloat16] [--block-kernel auto] [--input-size 16]
    python -m mapdit_tpu_torch.bench --sampler dpm++ --steps 20 --time-schedule karras
    python -m mapdit_tpu_torch.bench --cfg-interval 0.3 3.0 [--cache-interval 2 --cache-mode hold]
    python -m mapdit_tpu_torch.bench --mode train [--batch 32] [--steps 250] [--resident-data] [--grad-accum 4]
                                     [--block-kernel mega_attn] [--attn-bwd pallas] [--remat] [--scan-blocks]
    python -m mapdit_tpu_torch.bench --model DiT-B/2 --block-kernel pallas --attention-impl pallas
    python -m mapdit_tpu_torch.bench --model DiT-B/2 --modulation rotation_scale --attention-impl pallas \
                                     --block-kernel off [--no-use-cosine-attention ...]
    torchrun --nproc-per-node 2 -m mapdit_tpu_torch.bench --model DiT-XL/2 --batch 4 --n-model 2

``--modulation``, ``--attention-impl`` and one ``--no-use-<flag>`` switch per
``use_*`` flag of the config select the model family in both modes;
``--remat`` (train mode: each block recomputed in the backward) and
``--scan-blocks`` (the depth-stacked parameter layout) the execution. Under
``torchrun`` sample mode runs ``build_sample_fn(mesh=)`` on a mesh of every
rank with ``--n-model`` ranks on its model axis (the tensor-parallel
islands; ``auto`` resolves to ``mega_tp`` where the widths split); rank 0
prints the line. Ranks that share a card talk over gloo, through host
memory.

Sample mode is the protocol of the JAX package's ``bench.py`` sample mode:
4x16x16 latents, 1000 classes, random weights drawn from seed 0 and folded,
batched CFG at scale 1.5 over batch x 2 rows through the half-CFG chain, the
respaced DDPM chain of ``--steps`` steps, ``block_kernel`` resolved with the
batch as hint; ``value`` is the best of ``--repeats`` timed chains after one
warm-up chain. Train mode is its ``bench_train``: synthetic VAE-posterior
latents (1000 classes), Adam(0.9, 0.99) under warmup_flat_invsqrt(1e-2,
100, 1000), two EMAs, one warm-up step, then max(``--steps``, 10) timed
steps (``peak_allocated_gb``: the card's allocation peak over them, state
included, in the caching allocator's blocks; ``peak_requested_gb``: the
peak of the bytes the tensors asked for, without the blocks' rounding);
``--resident-data`` reuses one device-resident batch;
``--grad-accum`` splits each step's batch into that many micro-batches;
``--profile-dir`` then traces a few more steps (in sample mode: one 10-step
chain) with ``torch.profiler`` and writes the device-time table there (the
timed steps and chains run untraced); the JSON's ``profile`` gives device
busy ms, launches and the top kernels a step, and the host's CUDA runtime
calls a step (launches, allocations, synchronizations). Each mode
prints one JSON line with ``metric``, ``value``, ``unit`` and ``mfu_pct``
against the H100's 989 TFLOP/s dense bf16 peak (train: 3x the forward's
matrix-product FLOPs; the backward's recompute is not counted as useful
work; sample: one CFG model call a step, an unguided step of
``--cfg-interval`` counting half; null under a cache, whose skipped spans
the count would overstate).
"""

from __future__ import annotations

import argparse
import dataclasses
import itertools
import json
import os
import subprocess
import time

import torch

from mapdit_tpu_torch.diffusion import create_diffusion, respacing_string
from mapdit_tpu_torch.models import build_config, init_model
from mapdit_tpu_torch.models.blocks import kernel_policy, modulation_dims
from mapdit_tpu_torch.models.config import ATTENTION_IMPLS, BLOCK_KERNELS, MODULATION_KINDS, DiTConfig
from mapdit_tpu_torch.runtime import (
    SAMPLERS, build_cached_sample_fn, build_sample_fn, cfg_interval_segments, resolve_run_config,
)

H100_BF16_FLOPS = 989e12  # dense, H100 SXM data sheet
CFG_SCALE = 1.5
USE_FLAGS = [f.name for f in dataclasses.fields(DiTConfig) if f.name.startswith("use_")]


def model_call_flops(cfg, rows: int) -> int:
    """Matrix-product FLOPs of one model call on ``rows`` samples: the block
    stack (the count of ``mapdit_tpu/ops/pallas/dit_block.py:2024-2029``)
    plus the layers outside it. The modulation heads follow
    ``modulation_dims`` (6D rows a block for adaln, 5D for rotation_scale,
    3D for rotation, its angles being D/2 wide); the ones column
    of ``x_embedder`` and the output scales exist only in their families."""
    d, t, depth = cfg.hidden_size, cfg.num_patches, cfg.depth
    h = int(d * cfg.mlp_ratio)
    hd = d // cfg.num_heads
    p2c = cfg.patch_size**2 * cfg.in_channels
    mod_rows = 2 * sum(modulation_dims(cfg, with_gate=True))
    blocks = depth * (2 * rows * d * mod_rows + 2 * rows * t * d * (3 * d + d + 2 * h) + 4 * rows * cfg.num_heads * t * t * hd)
    x_embed = 2 * rows * t * (p2c + int(cfg.use_weight_normalization)) * d
    t_embed = 2 * rows * (256 * d + d * d)
    n_out = 2 if cfg.learn_sigma else 1
    final = 2 * rows * d * sum(modulation_dims(cfg, with_gate=False)) + 2 * rows * t * d * n_out * p2c
    if cfg.mp_style:
        final += n_out * 2 * rows * d * 8
    return blocks + x_embed + t_embed + final


def _smi() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60).stdout.strip()


def _device_info() -> dict:
    return {"kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(), "nvidia_smi": _smi()}


def build_train(args, cfg, device):
    """``(step_fn, state, batches)`` of train mode: synthetic VAE-posterior
    latents at ``--input-size``, Adam under warmup_flat_invsqrt(1e-2, 100,
    1000), ``--grad-accum`` micro-batches a step, the state from seed 0;
    ``--resident-data`` repeats one batch on the device."""
    from mapdit_tpu_torch.training import (
        SyntheticLatentDataset,
        create_optimizer,
        create_train_state,
        make_train_step,
        warmup_flat_invsqrt,
    )

    diffusion = create_diffusion("", device=device)
    ds = SyntheticLatentDataset(num_examples=max(1024, 2 * args.batch), num_classes=1000, size=args.input_size)
    tx = create_optimizer(warmup_flat_invsqrt(1e-2, 100, 1000))
    step_fn = make_train_step(cfg, diffusion, tx, stats_mean=ds.stats["mean"], stats_std=ds.stats["std"],
                              grad_accum=args.grad_accum)
    state = create_train_state(cfg, tx, seed=0, device=device)
    batches = ds.batches(batch_size=args.batch, seed=0)
    if args.resident_data:
        fixed = {k: torch.as_tensor(v).to(device) for k, v in next(batches).items()}
        batches = itertools.repeat(fixed)
    return step_fn, state, batches


def bench_train(args, cfg, device) -> dict:
    """Train steps/s at ``args.batch`` (the JAX package's ``bench_train``)."""
    step_fn, state, batches = build_train(args, cfg, device)
    metrics = step_fn(state, next(batches))  # warm-up: builds the kernels
    torch.cuda.synchronize()
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    n_steps = max(args.steps, 10)
    start = time.perf_counter()
    for _ in range(n_steps):
        metrics = step_fn(state, next(batches))
    loss = float(metrics["loss"])
    elapsed = time.perf_counter() - start
    value = n_steps / elapsed
    peak = requested = None
    if device.type == "cuda":
        peak = torch.cuda.max_memory_allocated(device) / 1e9
        requested = torch.cuda.memory_stats(device).get("requested_bytes.all.peak", 0) / 1e9
    profile = None
    if args.profile_dir:
        profile = _profile(args.profile_dir, lambda: step_fn(state, next(batches)), "train_key_averages.txt")
        profile["device_idle_share"] = 1.0 - profile["device_busy_ms_per_step"] / (1e3 / value)
    return {
        "metric": "train_steps_per_sec",
        "value": value,
        "unit": f"steps/s ({args.model}, batch {args.batch}" + (f" accum {args.grad_accum}" if args.grad_accum > 1 else "")
                + _latents(args) + (", resident-data" if args.resident_data else "")
                + f", {args.dtype}, block_kernel {args.block_kernel}"
                + (f", attn_bwd {args.attn_bwd}" if args.block_kernel == "mega_attn" else "")
                + (", remat" if cfg.remat else "") + (", scan_blocks" if cfg.scan_blocks else "") + _family(cfg) + ")",
        "mfu_pct": 100.0 * 3 * model_call_flops(cfg, args.batch) * value / H100_BF16_FLOPS,
        "seconds": elapsed,
        "last_loss": loss,
        "peak_allocated_gb": peak,
        "peak_requested_gb": requested,
        "profile": profile,
        "device": _device_info(),
    }


def _latents(args) -> str:
    """The latent size for a result's unit, where it is not the default 16."""
    return "" if args.input_size == 16 else f", {args.input_size}x{args.input_size} latents"


def _family(cfg) -> str:
    """The non-default family switches of ``cfg``, for a result's unit."""
    off = [name for name, value in cfg.flags_dict().items() if value is False]
    parts = ([f"modulation {cfg.modulation}"] if cfg.modulation != "adaln" else []) + (
        [f"attention_impl {cfg.attention_impl}"] if cfg.attention_impl != "auto" else []) + (
        ["off: " + " ".join(off)] if off else [])
    return "".join(", " + part for part in parts)


def _profile(out_dir: str, call, table: str, calls: int = 3, steps_per_call: int = 1) -> dict:
    """Trace ``calls`` calls of ``call`` (a train step, or a chain of
    ``steps_per_call`` denoise steps) with torch.profiler (CPU + CUDA):
    write the table of device time by op and kernel to ``out_dir/<table>``
    and return the traced wall ms per step, the device-busy ms per step (the
    kernels' and copies' own time; one stream, so they do not overlap), the
    device launches per step (kernels, copies and fills) and the kernels
    with the most device time. The caller sets the idle share against the
    untraced step time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(out_dir, exist_ok=True)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        # idle trace on either side: the profiler drops a device event that a
        # skew of the card's clock moves out of the trace's window
        time.sleep(0.1)
        start = time.perf_counter()
        for _ in range(calls):
            call()
        torch.cuda.synchronize()
        wall = time.perf_counter() - start
        time.sleep(0.1)
    steps = calls * steps_per_call
    events = prof.key_averages()
    with open(os.path.join(out_dir, table), "w") as f:
        f.write(events.table(sort_by="self_device_time_total", row_limit=60))
    # device-side events only: a CPU op's row repeats its kernels' time
    device = [e for e in events if e.device_type == DeviceType.CUDA and not getattr(e, "is_user_annotation", False)
              and e.self_device_time_total > 0]
    kernels = sorted(((e.key, e.self_device_time_total) for e in device), key=lambda kv: -kv[1])
    busy_us = sum(us for _, us in kernels)
    # the host's CUDA runtime calls (launches, allocations, synchronizations)
    api = sorted((e for e in events if e.device_type == DeviceType.CPU and e.key.startswith("cuda")),
                 key=lambda e: -e.self_cpu_time_total)
    return {
        "steps": steps,
        "traced_wall_ms_per_step": 1e3 * wall / steps,
        "device_busy_ms_per_step": busy_us / 1e3 / steps,
        "device_launches_per_step": sum(e.count for e in device) / steps,
        "top_kernels_ms_per_step": {name[:120]: us / 1e3 / steps for name, us in kernels[:15]},
        "cuda_api_per_step": {e.key: {"calls": e.count / steps, "host_ms": e.self_cpu_time_total / 1e3 / steps}
                              for e in api[:8]},
    }


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--mode", choices=["sample", "train"], default="sample")
    p.add_argument("--model", default="DiT-S/2")
    p.add_argument("--batch", type=int, default=32, help="pre-CFG samples (sample) or the train batch")
    p.add_argument("--steps", type=int, default=250)
    p.add_argument("--dtype", choices=["float32", "bfloat16"], default="bfloat16")
    p.add_argument("--input-size", type=int, default=16,
                   help="latent side (16: the ImageNet-128 latents, T=64 tokens at patch 2; 32: ImageNet-256, "
                        "T=256, past the auto policy's T <= 64, so auto runs the plain path and --block-kernel "
                        "mega_stack or mega the kernels)")
    p.add_argument("--block-kernel", choices=list(BLOCK_KERNELS), default="auto")
    p.add_argument("--modulation", choices=list(MODULATION_KINDS), default="adaln")
    p.add_argument("--attention-impl", choices=list(ATTENTION_IMPLS), default="auto")
    for name in USE_FLAGS:
        p.add_argument("--no-" + name.replace("_", "-"), dest=name, action="store_false",
                       help=f"turn {name} off (default on)")
    p.add_argument("--attn-bwd", choices=["pallas", "residual", "reference"], default="pallas",
                   help="train mode with --block-kernel mega_attn: the attention half-block's VJP")
    p.add_argument("--remat", action="store_true",
                   help="per-block activation rematerialization (XL-scale train memory)")
    p.add_argument("--scan-blocks", action="store_true",
                   help="block parameters stacked on a leading depth axis (the JAX --scan-blocks layout)")
    p.add_argument("--grad-accum", type=int, default=1,
                   help="train mode: micro-batch gradient accumulation factor")
    p.add_argument("--resident-data", action="store_true",
                   help="train mode: reuse one device-resident batch (no per-step host upload)")
    p.add_argument("--sampler", choices=list(SAMPLERS), default="ddpm",
                   help="sample mode: the chain's sampler (ddim at eta 0)")
    p.add_argument("--time-schedule", choices=["uniform", "karras"], default="uniform")
    p.add_argument("--cfg-interval", type=float, nargs=2, default=None, metavar=("SIGMA_LO", "SIGMA_HI"),
                   help="sample mode: limited-interval guidance (arXiv 2404.07724), CFG only where sigma(t) is in "
                        "[LO, HI]; the unguided steps run cond-only on half the rows (ddpm, dpm++, unipc)")
    p.add_argument("--cache-interval", type=int, default=0,
                   help="sample mode: block-span caching, the span recomputed every N steps (0: the exact chain; "
                        "ddpm and dpm++); lossy")
    p.add_argument("--cache-span", type=str, default=None, help="lo,hi block span to cache (default the middle half)")
    p.add_argument("--cache-mode", choices=["hold", "forecast"], default="forecast",
                   help="the skipped steps' span delta: held (Delta-DiT) or linearly forecast")
    p.add_argument("--scan-unroll", type=int, default=1, help="taken for the JAX flag and ignored")
    p.add_argument("--profile-dir", default=None,
                   help="trace a few train steps (or one 10-step chain) with torch.profiler after the timed "
                        "ones and write the table here")
    p.add_argument("--repeats", type=int, default=3)
    p.add_argument("--n-model", type=int, default=1,
                   help="sample mode under torchrun: ranks on the mesh's model axis (the data axis takes the rest)")
    return p


def bench_config(args) -> DiTConfig:
    """The model config of both modes."""
    return build_config(args.model, in_channels=4, input_size=args.input_size, num_classes=1000,
                        compute_dtype=args.dtype, block_kernel=args.block_kernel, attn_bwd=args.attn_bwd,
                        modulation=args.modulation, attention_impl=args.attention_impl, remat=args.remat,
                        scan_blocks=args.scan_blocks, **{name: getattr(args, name) for name in USE_FLAGS})


def bench_diffusion(args, device, steps=None):
    """The respaced diffusion of ``--steps`` (or ``steps``) on the sampler's
    and schedule's grid."""
    return create_diffusion(respacing_string(steps or args.steps, args.sampler, args.time_schedule), device=device)


def build_chain(args, cfg: DiTConfig, state_dict, diffusion, device, mesh=None):
    """The chain sample mode times (JAX ``bench.py:279-305``): the
    block-span cached chain under ``--cache-interval`` > 1 (ddpm or dpm++;
    one device), else ``build_sample_fn`` with the batch as hint. CFG at
    scale 1.5, unclipped, ddim at eta 0; ``--cfg-interval`` composes with
    both."""
    interval = tuple(args.cfg_interval) if args.cfg_interval else None
    if args.cache_interval > 1:
        if args.sampler not in ("ddpm", "dpm++"):
            raise SystemExit("--cache-interval composes with --sampler ddpm or dpm++")
        if mesh is not None:
            raise SystemExit("--cache-interval runs on one device")
        span = tuple(int(v) for v in args.cache_span.split(",")) if args.cache_span else None
        return build_cached_sample_fn(cfg, state_dict, diffusion, cfg_scale=CFG_SCALE, fold=True, span=span,
                                      cache_interval=args.cache_interval, sampler=args.sampler, cfg_interval=interval,
                                      cache_mode=args.cache_mode, device=device)
    return build_sample_fn(cfg, state_dict, diffusion, cfg_scale=CFG_SCALE, sampler=args.sampler,
                           scan_unroll=args.scan_unroll, cfg_interval=interval, batch_hint=args.batch, device=device,
                           mesh=mesh)


def resolved_kernel(cfg: DiTConfig, chain, device) -> str:
    """What the chain's blocks run: its run config's kernel, ``auto`` read
    through the per-block policy (``mega`` or ``off``; the cached chain runs
    per block)."""
    run_cfg = getattr(chain, "run_cfg", None) or resolve_run_config(cfg, True, None, device)
    if run_cfg.block_kernel == "auto":
        return kernel_policy(run_cfg, run_cfg.num_patches, device)
    return run_cfg.block_kernel


def effective_steps(args, diffusion):
    """The steps ``mfu_pct`` counts (JAX ``bench.py:395-412``): None under a
    cache; an unguided step of ``--cfg-interval`` counts half (the
    cond-only call runs half the rows)."""
    if args.cache_interval > 1:
        return None
    if not args.cfg_interval:
        return args.steps
    g0, g1 = cfg_interval_segments(diffusion, *args.cfg_interval)
    return (g1 - g0) + (args.steps - (g1 - g0)) * 0.5


def sample_unit(args, kernel: str) -> str:
    """The unit of sample mode's line: the sampler, the steps, the schedule,
    the cache and the interval (JAX ``bench.py:418-431``)."""
    return (
        f"{args.sampler.upper()} steps/s ({args.model}, batch {args.batch}x2 CFG, {args.steps} respaced steps"
        + _latents(args)
        + (f", {args.time_schedule}" if args.time_schedule != "uniform" else "")
        + (f", cache-interval {args.cache_interval}, cache-mode {args.cache_mode}" if args.cache_interval > 1 else "")
        + (f", cfg-interval {args.cfg_interval[0]:g}-{args.cfg_interval[1]:g}" if args.cfg_interval else "")
        + f", {args.dtype}, block_kernel {kernel}"
    )


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    device = torch.device("cuda")
    if not torch.cuda.is_available():
        raise SystemExit("the benchmark measures a GPU and none is available")
    mesh, rank = None, 0
    if "RANK" in os.environ and args.mode == "sample":
        from mapdit_tpu_torch.parallel import init_distributed, make_mesh

        device = init_distributed()
        mesh = make_mesh(n_model=args.n_model, device=device)
        rank = mesh.rank
    elif args.n_model > 1:
        raise SystemExit("--n-model > 1 runs in sample mode under torchrun --nproc-per-node N")
    cfg = bench_config(args)
    if args.mode == "train":
        print(json.dumps(bench_train(args, cfg, device)))
        return 0
    model = init_model(cfg, seed=0, device=device)
    diffusion = bench_diffusion(args, device)
    sample = build_chain(args, cfg, model.state_dict(), diffusion, device, mesh)
    kernel = resolved_kernel(cfg, sample, device)
    n, side = args.batch, args.input_size
    gen = torch.Generator(device=device).manual_seed(0)
    z = torch.randn(2 * n, 4, side, side, generator=gen, device=device)
    y = torch.cat([torch.randint(0, 1000, (n,), generator=gen, device=device), torch.full((n,), 1000, device=device)])

    sample(z, y, torch.Generator(device=device).manual_seed(1))
    torch.cuda.synchronize()
    times = []
    for i in range(args.repeats):
        start = time.perf_counter()
        sample(z, y, torch.Generator(device=device).manual_seed(2 + i))
        torch.cuda.synchronize()
        times.append(time.perf_counter() - start)
    best = min(times)
    value = args.steps / best
    profile = None
    if args.profile_dir:
        # a short chain of the same kind; a cache's interval must divide it
        k = max(args.cache_interval, 1)
        short = build_chain(args, cfg, model.state_dict(), bench_diffusion(args, device, k * -(-10 // k)), device,
                            mesh)
        short(z, y, torch.Generator(device=device).manual_seed(1))
        if rank == 0:
            profile = _profile(args.profile_dir, lambda: short(z, y, torch.Generator(device=device).manual_seed(1)),
                               "sample_key_averages.txt", calls=1, steps_per_call=k * -(-10 // k))
            profile["device_idle_share"] = 1.0 - profile["device_busy_ms_per_step"] / (1e3 / value)
        else:  # the other ranks run the traced chain's collectives
            short(z, y, torch.Generator(device=device).manual_seed(1))
    # a mesh's ranks may share cards: the peak is that of the cards they use
    cards = 1 if mesh is None else min(mesh.size, torch.cuda.device_count())
    eff_steps = effective_steps(args, diffusion)
    mfu = None if eff_steps is None else (
        100.0 * model_call_flops(cfg, 2 * n) * eff_steps / best / (cards * H100_BF16_FLOPS))
    if mesh is not None:
        torch.distributed.destroy_process_group()
    if rank != 0:
        return 0
    print(json.dumps({
        "metric": "denoise_steps_per_sec_per_gpu",
        "value": value,
        "unit": sample_unit(args, kernel) + (", scan_blocks" if cfg.scan_blocks else "") + _family(cfg)
                + ("" if mesh is None else f", mesh ({mesh.n_data}, {mesh.n_model}) over {cards} card(s)") + ")",
        "mfu_pct": mfu,
        "block_kernel": kernel,
        "chain_seconds": times,
        "profile": profile,
        "device": _device_info(),
    }))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
