#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (mapdit_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one line each; any failure exits non-zero before the final line:
  1. device: the card's name and power limit (nvidia-smi);
  2. build: nvcc for sm_90a of every CUDA source, from this checkout;
  3. kernels: every kernel wrapper against its plain PyTorch version at the
     DiT-S/2 sampling shapes in bf16 (64 CFG rows x 64 tokens, D=384,
     6 heads, H=1536, depth 12), with times, bounds and a library yardstick;
     then the attention half-block's wrappers and sub-kernels (forward,
     residual forward, fused backward with its seven cotangents, the A.W
     products, the residual-mode attention, the backward's three kernels)
     and fused_dit_block's gradient at the DiT-S/2 training shapes (256
     samples x 64 tokens, bf16);
  4. forward: DiT-S/2 forward_with_cfg, kernel paths against the plain path;
  5. chain: a short CFG chain, kernel path against the plain path; then the
     headline chain (build_sample_fn, block_kernel="auto" with a batch hint,
     250 DDPM steps, batch 32 x 2, CFG 1.5), launch counts read around it;
     then the per-block path (no batch hint) with its own counts;
  6. train: DiT-S/2 train steps at batch 256 on synthetic latents, the plain
     path and block_kernel="mega_attn" with attn_bwd "pallas" and
     "residual": the first step's loss and gradients against the float32
     plain path, then timed steps with the launch counts read around them;
  7. the kernels JSON line, the device line again, and the ok line.
Weights are random, drawn from a seed. Needs no network and one card.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time

SEED = 0
MODEL = "DiT-S/2"
BATCH = 32  # pre-CFG samples; 64 rows per model call
STEPS = 250
CFG_SCALE = 1.5
TRAIN_BATCH = 256
TRAIN_STEPS = 10  # timed train steps per path, after the checked first step
H100_BF16_FLOPS = 989e12  # dense tensor-core peak, H100 SXM data sheet
H100_BYTES_PER_S = 3.35e12  # HBM3 rate, H100 SXM data sheet
PALLAS = "mapdit_tpu/ops/pallas/dit_block.py"


def phase(name: str, **fields) -> None:
    print(f"[{name}] " + " ".join(f"{k}={v}" for k, v in fields.items()), flush=True)


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def time_ms(torch, fn, iters: int = 20, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound_ms(flops: float, nbytes: float):
    t_ops, t_bytes = flops / H100_BF16_FLOPS, nbytes / H100_BYTES_PER_S
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def compare(torch, got, want, atol: float, rtol: float, what: str):
    """Max/mean abs error; fails unless |got - want| <= atol + rtol*|want|."""
    got, want = got.float(), want.float()
    if not torch.isfinite(got).all():
        raise AssertionError(f"{what}: non-finite kernel output")
    err = (got - want).abs()
    ok = bool((err <= atol + rtol * want.abs()).all())
    max_err, mean_err = float(err.max()), float(err.mean())
    phase("check", what=what, max_abs_err=f"{max_err:.3e}", mean_abs_err=f"{mean_err:.3e}",
          tol=f"atol{atol:g}+rtol{rtol:g}", ok=ok)
    if not ok:
        raise AssertionError(f"{what}: kernel disagrees with its plain version (max abs err {max_err})")
    return max_err


def compare_scalar(torch, got, want, rtol: float, what: str):
    """One value (dgain, a sum over the whole batch) within ``rtol`` of
    |want|; both values are printed. Returns the abs error."""
    g, w = float(got.reshape(())), float(want.reshape(()))
    err = abs(g - w)
    ok = math.isfinite(g) and err <= rtol * abs(w)
    phase("check", what=what, got=f"{g:.6e}", want=f"{w:.6e}", abs_err=f"{err:.3e}", tol=f"rtol{rtol:g}*|want|",
          ok=ok)
    if not ok:
        raise AssertionError(f"{what}: {g} is off its plain version {w}")
    return err


def rel_l2(got, want) -> float:
    return float((got.float() - want.float()).norm() / want.float().norm())


def compare_rel(torch, got, want, tol: float, what: str):
    """Relative L2 error at most ``tol`` (for outputs that several bf16
    roundings upstream separate from the plain version); returns the max
    abs error."""
    if not torch.isfinite(got.float()).all():
        raise AssertionError(f"{what}: non-finite kernel output")
    err, max_err = rel_l2(got, want), float((got.float() - want.float()).abs().max())
    phase("check", what=what, rel_l2_err=f"{err:.3e}", max_abs_err=f"{max_err:.3e}", tol=f"rel_l2<={tol:g}",
          ok=err <= tol)
    if err > tol:
        raise AssertionError(f"{what}: kernel disagrees with its plain version (rel L2 err {err})")
    return max_err


def check_paths(torch, what: str, outs: dict, kernel_paths) -> None:
    """Hold each kernel path against the float32 plain path ``outs['f32']``:
    its relative L2 error may be at most twice that of the bf16 plain path
    ``outs['off']`` (floor 1e-2). Both paths round to bf16 at other places,
    so they are compared through the f32 reference, not with each other."""
    ref = outs["f32"]

    def rel(v):
        return rel_l2(v, ref)

    limit = max(2 * rel(outs["off"]), 1e-2)
    phase(what, path="off", rel_l2_err_vs_f32=f"{rel(outs['off']):.3e}")
    for name in kernel_paths:
        got = outs[name]
        err = rel(got)
        phase(what, path=name, shape=tuple(got.shape), rel_l2_err_vs_f32=f"{err:.3e}", tol=f"{limit:.3e}",
              max_abs_err_vs_off=f"{float((got - outs['off']).abs().max()):.3e}")
        if not bool(torch.isfinite(got).all()) or err > limit:
            raise AssertionError(f"{what}/{name}: kernel path off the f32 reference (rel err {err} > {limit})")


def train_kernel_rows(torch, F, k, gen, dev, t, d, heads, x_s, a_s, gains_s, w0):
    """Phase 3, second part: the attention half-block's wrappers and
    sub-kernels at the DiT-S/2 training shapes (TRAIN_BATCH samples x t
    tokens, bf16) against their plain versions, and fused_dit_block's
    gradient at the sampling shapes; returns the kernels' report rows (each
    names the train path whose launch counts it reports)."""
    from mapdit_tpu_torch.ops.cuda import attn_branch as ab
    from mapdit_tpu_torch.ops.mp import normalize

    bf, f32 = torch.bfloat16, torch.float32
    n, hd = TRAIN_BATCH, d // heads
    mt, inv_d = n * t, 1 / math.sqrt(d)

    def randn(*shape, dtype=f32):
        return torch.randn(*shape, generator=gen, device=dev).to(dtype)

    x = randn(n, t, d, dtype=bf)
    shift, scale, gate = (randn(n, d, dtype=bf) for _ in range(3))
    gain = torch.tensor(0.37, device=dev)
    wq, wo = (normalize(randn(*s)).to(bf).contiguous() for s in ((3 * d, d), (d, d)))
    dy = randn(n, t, d, dtype=bf)
    args = (x, shift, scale, gate, gain, wq, wo, heads)
    attn_flops = 4 * n * heads * t * t * hd
    gemm_flops = 2 * mt * d * 4 * d  # the qkv and out products together
    in_bytes = mt * d * 2 + 3 * n * d * 2 + 4 * d * d * 2 + 4
    out_rows = {}

    def row(name, source, replaces, err, fn, plain, flops, nbytes, path="mega_attn+pallas", library=None):
        b, by = bound_ms(flops, nbytes)
        out_rows[name] = dict(
            source=source, replaces=f"{PALLAS}:{replaces}", max_abs_err=err, ms=time_ms(torch, fn),
            plain_ms=time_ms(torch, plain), bound_ms=b, bound_by=by,
            library_ms=None if library is None else time_ms(torch, library), path=path,
        )

    branch_src = "mapdit_tpu_torch/ops/cuda/attn_branch.py"
    bwd_src = "mapdit_tpu_torch/csrc/attn_branch_bwd.cu"
    # composite outputs: several bf16 roundings upstream can each land an
    # element one bf16 ulp apart from the plain version, so they are held
    # by relative L2 error (1e-2, ~2.5 bf16 ulps) with the max reported
    err = compare_rel(torch, ab.attn_fwd(*args), ab.attn_fwd_plain(*args), 1e-2, "attn_branch/fwd")
    row("attn_branch/fwd", branch_src, 1007, err, lambda: ab.attn_fwd(*args), lambda: ab.attn_fwd_plain(*args),
        gemm_flops + attn_flops, in_bytes + mt * d * 2)
    got, want = ab.attn_res_fwd(*args), ab.attn_res_fwd_plain(*args)
    err = max(compare_rel(torch, g_, w_, 1e-2, f"attn_branch/res_fwd:{nm}")
              for nm, g_, w_ in zip(("y", "p", "attn"), got, want))
    row("attn_branch/res_fwd", branch_src, 1152, err, lambda: ab.attn_res_fwd(*args),
        lambda: ab.attn_res_fwd_plain(*args), gemm_flops + attn_flops,
        in_bytes + 2 * mt * d * 2 + n * heads * t * t * 4, path="mega_attn+residual")

    # the backward's intermediates, from the plain versions, as inputs of the
    # sub-kernel checks (the order of attn_branch._bwd_sequence)
    rows_ = torch.cat([shift, scale, gate], dim=1).float().contiguous()
    g1 = gain.reshape(1).float().contiguous()
    xf = x.reshape(mt, d)
    h = ab.modulate_fwd_plain(xf, rows_, g1, t, bf)
    qkv = k.mp_gemm_plain(h, wq, alpha=inv_d, out_dtype=f32)
    attn = k.cosine_attention_plain(qkv, t, heads, bf, normalize_first=True)
    out = k.mp_gemm_plain(attn, wo, alpha=inv_d, out_dtype=f32)
    dx0, dout, _ = ab.gate_residual_bwd_plain(dy, out, rows_, 2 * d, t, bf)
    dattn = k.mp_gemm_plain(dout, wo, alpha=inv_d, out_dtype=f32, w_kn=True)
    dqkv = ab.attention_bwd_plain(qkv, dattn, t, heads, bf)
    dh = k.mp_gemm_plain(dqkv, wq, alpha=inv_d, out_dtype=f32, w_kn=True)

    got, want = ab.attn_bwd(dy, *args), ab.attn_bwd_plain(dy, *args)
    names = ("dx", "dshift", "dscale", "dgate", "dgain", "dw_qkv", "dw_out")
    errs = []
    for nm, g_, w_ in zip(names, got, want):
        if nm == "dgain":
            # one scalar behind several bf16 roundings (h, dqkv, dout); the
            # limit is a few times what sound runs read (PERF.md)
            errs.append(compare_scalar(torch, g_, w_, 1e-3, "attn_branch/bwd:dgain"))
        else:
            errs.append(compare_rel(torch, g_, w_, 1e-2, f"attn_branch/bwd:{nm}"))
    row("attn_branch/bwd", branch_src, 918, max(errs), lambda: ab.attn_bwd(dy, *args),
        lambda: ab.attn_bwd_plain(dy, *args), 3 * gemm_flops + 14 * n * heads * t * t * hd,
        in_bytes + mt * d * 2 + mt * d * 2 + 3 * n * d * 4 + 4 + 4 * d * d * 4)

    # the A.W products of the backward, on identical inputs
    for site, a_, w_, line in (("dattn", dout, wo, 636), ("dh", dqkv, wq, 683)):
        kk, nn = w_.shape
        err = compare(torch, k.mp_gemm(a_, w_, alpha=inv_d, out_dtype=f32, w_kn=True, site=site),
                      k.mp_gemm_plain(a_, w_, alpha=inv_d, out_dtype=f32, w_kn=True), 1e-2, 1e-2, f"mp_gemm/{site}")
        row(f"mp_gemm/{site}", "mapdit_tpu_torch/csrc/mp_gemm.cu", line, err,
            lambda a_=a_, w_=w_, site=site: k.mp_gemm(a_, w_, alpha=inv_d, out_dtype=f32, w_kn=True, site=site),
            lambda a_=a_, w_=w_: k.mp_gemm_plain(a_, w_, alpha=inv_d, out_dtype=f32, w_kn=True),
            2 * mt * kk * nn, mt * kk * 2 + kk * nn * 2 + mt * nn * 4,
            library=lambda a_=a_, w_=w_: torch.matmul(a_, w_))

    # residual-mode attention, on identical inputs
    probs, probs_p = (torch.empty(n, heads, t, t, device=dev) for _ in range(2))
    err = max(
        compare(torch, k.cosine_attention(qkv, t, heads, bf, normalize_first=True, probs=probs),
                k.cosine_attention_plain(qkv, t, heads, bf, normalize_first=True, probs=probs_p), 1e-2, 1e-2,
                "cosine_attention/residual"),
        compare(torch, probs, probs_p, 1e-3, 1e-2, "cosine_attention/residual:p"),
    )
    q4, k4, v4 = qkv.reshape(n, t, 3, heads, hd).permute(2, 0, 3, 1, 4)
    qn, kn, vb = normalize(q4).to(bf), normalize(k4).to(bf), v4.to(bf)
    row("cosine_attention/residual", "mapdit_tpu_torch/csrc/cosine_attention.cu", 1083, err,
        lambda: k.cosine_attention(qkv, t, heads, bf, normalize_first=True, probs=probs),
        lambda: k.cosine_attention_plain(qkv, t, heads, bf, normalize_first=True, probs=probs_p),
        attn_flops, mt * 3 * d * 4 + mt * d * 2 + n * heads * t * t * 4,
        library=lambda: F.scaled_dot_product_attention(qn, kn, vb, scale=1 / math.sqrt(hd)))

    # the backward's three kernels, on identical inputs
    got, want = ab.gate_residual_bwd(dy, out, rows_, 2 * d, t, bf), ab.gate_residual_bwd_plain(
        dy, out, rows_, 2 * d, t, bf)
    err = max(compare(torch, g_, w_, 1e-2, 1e-2, f"attn_bwd/gate_residual:{nm}")
              for nm, g_, w_ in zip(("dx0", "dout", "dgate"), got, want))
    row("attn_bwd/gate_residual", bwd_src, 630, err, lambda: ab.gate_residual_bwd(dy, out, rows_, 2 * d, t, bf),
        lambda: ab.gate_residual_bwd_plain(dy, out, rows_, 2 * d, t, bf), 5 * mt * d,
        mt * d * (2 + 4 + 4 + 2) + n * d * 4 + n * d * 4)

    err = compare_rel(torch, ab.attention_bwd(qkv, dattn, t, heads, bf),
                      ab.attention_bwd_plain(qkv, dattn, t, heads, bf), 1e-2, "attn_bwd/attention")
    qs, ks, vs = (z.detach().requires_grad_() for z in (qn, kn, vb))
    do4 = dattn.reshape(n, t, heads, hd).transpose(1, 2).to(bf)

    def sdpa_fwd_bwd():
        o = F.scaled_dot_product_attention(qs, ks, vs, scale=1 / math.sqrt(hd))
        return torch.autograd.grad(o, (qs, ks, vs), do4)

    row("attn_bwd/attention", bwd_src, 643, err, lambda: ab.attention_bwd(qkv, dattn, t, heads, bf),
        lambda: ab.attention_bwd_plain(qkv, dattn, t, heads, bf), 10 * n * heads * t * t * hd,
        mt * 3 * d * 4 + mt * d * 4 + mt * 3 * d * 2, library=sdpa_fwd_bwd)

    err = compare(torch, ab.modulate_fwd(xf, rows_, g1, t, bf), ab.modulate_fwd_plain(xf, rows_, g1, t, bf),
                  1e-2, 1e-2, "attn_bwd/modulate_fwd")
    row("attn_bwd/modulate_fwd", bwd_src, 588, err, lambda: ab.modulate_fwd(xf, rows_, g1, t, bf),
        lambda: ab.modulate_fwd_plain(xf, rows_, g1, t, bf), 5 * mt * d, mt * d * 2 + 2 * n * d * 4 + mt * d * 2)

    got, want = ab.modulate_bwd(dh, xf, rows_, g1, dx0, t), ab.modulate_bwd_plain(dh, xf, rows_, g1, dx0, t)
    errs = [compare(torch, g_, w_, 1e-2, 1e-2, f"attn_bwd/modulate_bwd:{nm}")
            for nm, g_, w_ in zip(("dx", "dshift", "dscale"), got[:3], want[:3])]
    # identical f32 inputs: only the order of the sum differs
    e = compare_scalar(torch, got[3], want[3], 1e-4, "attn_bwd/modulate_bwd:dgain")
    row("attn_bwd/modulate_bwd", bwd_src, 690, max(errs + [e]), lambda: ab.modulate_bwd(dh, xf, rows_, g1, dx0, t),
        lambda: ab.modulate_bwd_plain(dh, xf, rows_, g1, dx0, t), 8 * mt * d,
        mt * d * (4 + 2 + 4 + 2) + 2 * n * d * 4 + 2 * n * d * 4 + 8)

    # fused_dit_block's gradient: kernel forward, backward through the
    # reference math, against autograd of that reference in f32
    inputs = [v.detach().requires_grad_() for v in (x_s, a_s, gains_s, *w0)]
    cot = torch.randn(x_s.shape, generator=gen, device=dev).to(bf)
    n_s = x_s.shape[0]

    def block_grad():
        return torch.autograd.grad(k.fused_dit_block(*inputs, heads), inputs, cot)

    def reference_grad():
        ref_in = [v.detach().float().requires_grad_() for v in inputs]
        return torch.autograd.grad(k.block_reference(*ref_in, heads), ref_in, cot.float())

    for i, (g_, w_) in enumerate(zip(block_grad(), reference_grad())):
        compare_rel(torch, g_, w_, 1e-2, f"fused_dit_block/grad:{i}")
    phase("time", kernel="fused_dit_block/grad", ms=f"{time_ms(torch, block_grad, iters=5):.4f}",
          plain_ms=f"{time_ms(torch, reference_grad, iters=5):.4f}", note="forward+backward, rows=" + str(n_s))
    return out_rows


def train_phase(torch, dev, cfg) -> dict:
    """Phase 6: DiT-S/2 training at TRAIN_BATCH on synthetic latents. The
    first step (same weights, same injected draws on every path) is held
    against the float32 plain path by check_paths' rule, on the loss and on
    all gradients; then TRAIN_STEPS timed steps per path with the launch
    counts read around them. Returns {path: launch counts}."""
    from mapdit_tpu_torch.diffusion import create_diffusion
    from mapdit_tpu_torch.models import init_model
    from mapdit_tpu_torch.ops.cuda import attn_branch as ab
    from mapdit_tpu_torch.ops.cuda import dit_block as k
    from mapdit_tpu_torch.training import (
        SyntheticLatentDataset,
        create_optimizer,
        create_train_state,
        make_train_step,
        warmup_flat_invsqrt,
    )

    init = init_model(cfg, seed=SEED, device="cpu")
    with torch.no_grad():
        # gains start at 0, which zeroes the shift's gradient; draw them
        g_cpu = torch.Generator().manual_seed(SEED)
        for blk in init.blocks:
            blk.gain_msa.uniform_(0.2, 0.8, generator=g_cpu)
            blk.gain_mlp.uniform_(0.2, 0.8, generator=g_cpu)
    sd0 = init.state_dict()
    ds = SyntheticLatentDataset(num_examples=max(1024, 2 * TRAIN_BATCH), num_classes=1000, size=16, seed=SEED)
    batch = {key: torch.as_tensor(v).to(dev) for key, v in next(ds.batches(TRAIN_BATCH, seed=SEED)).items()}
    gen = torch.Generator(device=dev).manual_seed(SEED + 5)
    shape = batch["mean"].shape
    draws = {
        "posterior_eps": torch.randn(shape, generator=gen, device=dev),
        "t": torch.randint(0, 1000, (TRAIN_BATCH,), generator=gen, device=dev),
        "noise": torch.randn(shape, generator=gen, device=dev),
        "drop": (torch.rand(TRAIN_BATCH, generator=gen, device=dev) < cfg.class_dropout_prob).long(),
    }
    diffusion = create_diffusion("", device=dev)
    tx = create_optimizer(warmup_flat_invsqrt(1e-2, 100, 1000))
    paths = {
        "f32": cfg.replace(compute_dtype="float32"),
        "off": cfg,
        "mega_attn+pallas": cfg.replace(block_kernel="mega_attn", attn_bwd="pallas"),
        "mega_attn+residual": cfg.replace(block_kernel="mega_attn", attn_bwd="residual"),
    }
    per_step = cfg.depth * TRAIN_STEPS
    must_launch = {
        "off": {},
        "mega_attn+pallas": {"attn_branch/fwd": per_step, "attn_branch/bwd": per_step, "attn_branch/res_fwd": 0},
        "mega_attn+residual": {"attn_branch/res_fwd": per_step, "attn_branch/fwd": 0, "attn_branch/bwd": 0},
    }
    path_kernels = {
        "off": (),
        "mega_attn+pallas": ("mp_gemm/qkv", "mp_gemm/out", "mp_gemm/dattn", "mp_gemm/dh", "cosine_attention",
                             "cosine_attention/residual", *(key for key in ab.LAUNCHES if key.startswith("attn_bwd/"))),
        "mega_attn+residual": ("mp_gemm/qkv", "mp_gemm/out", "cosine_attention/residual"),
    }
    losses, grads, counts = {}, {}, {}
    for name, c in paths.items():
        state = create_train_state(c, tx, seed=SEED, device=dev, state_dict=sd0)
        step = make_train_step(c, diffusion, tx, stats_mean=ds.stats["mean"], stats_std=ds.stats["std"])
        losses[name] = step(state, batch, draws=draws)["loss"].reshape(1)
        grads[name] = torch.cat([p.grad.float().reshape(-1) for p in state.model.parameters()])
        if name == "f32":
            continue
        torch.cuda.synchronize()
        k.reset_launch_counts()
        ab.reset_launch_counts()
        t0 = time.perf_counter()
        for _ in range(TRAIN_STEPS):
            metrics = step(state, batch)
        last = float(metrics["loss"])
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        counts[name] = {**k.LAUNCHES, **ab.LAUNCHES}
        phase("train", path=name, batch=TRAIN_BATCH, steps=TRAIN_STEPS, seconds=f"{seconds:.4f}",
              steps_per_s=f"{TRAIN_STEPS / seconds:.3f}", ms_per_step=f"{1e3 * seconds / TRAIN_STEPS:.4f}",
              first_loss=f"{float(losses[name]):.6f}", last_loss=f"{last:.6f}",
              launches=json.dumps({key: v for key, v in counts[name].items() if v}))
        if not math.isfinite(last):
            raise AssertionError(f"train/{name}: non-finite loss")
        wrong = {key: counts[name][key] for key, want in must_launch[name].items() if counts[name][key] != want}
        unused = [key for key in path_kernels[name] if counts[name][key] == 0]
        if wrong or unused or (name == "off" and any(counts[name].values())):
            raise AssertionError(f"train/{name}: launch counts {counts[name]} (wrong {wrong}, not launched {unused})")
    kernel_paths = ("mega_attn+pallas", "mega_attn+residual")
    check_paths(torch, "train-loss", losses, kernel_paths)
    check_paths(torch, "train-grads", grads, kernel_paths)
    return counts


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke runs only on a GPU", file=sys.stderr)
        return 2
    repo = os.path.dirname(os.path.abspath(__file__))
    if not os.path.isdir(os.path.join(repo, "mapdit_tpu_torch")):
        print("chip_smoke: run from a checkout that holds mapdit_tpu_torch/", file=sys.stderr)
        return 2
    sys.path.insert(0, repo)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    import torch.nn.functional as F

    from mapdit_tpu_torch.diffusion import create_diffusion
    from mapdit_tpu_torch.models import build_config, init_model
    from mapdit_tpu_torch.ops.cuda import build
    from mapdit_tpu_torch.ops.cuda import dit_block as k
    from mapdit_tpu_torch.ops.mp import mp_silu, normalize
    from mapdit_tpu_torch.runtime import build_block_stack, build_sample_fn, fold_weights_for_inference

    # 1. device
    smi = smi_line()
    print(smi, flush=True)
    phase("device", kind=json.dumps(torch.cuda.get_device_name(0)), count=torch.cuda.device_count(),
          torch=torch.__version__, cuda=torch.version.cuda)

    # 2. build
    t0 = time.perf_counter()
    built = build.build_all()
    phase("build", seconds=f"{time.perf_counter() - t0:.2f}", sources=",".join(build.SOURCES),
          compiled=json.dumps({n: round(s, 2) for n, s in built.items()}))

    # 3. kernels at the S/2 sampling shapes
    dev = torch.device("cuda")
    cfg = build_config(MODEL, in_channels=4, input_size=16, num_classes=1000, compute_dtype="bfloat16")
    n, t, d, heads, depth = 2 * BATCH, cfg.num_patches, cfg.hidden_size, cfg.num_heads, cfg.depth
    hid = int(d * cfg.mlp_ratio)
    hd = d // heads
    gen = torch.Generator(device=dev).manual_seed(SEED)
    bf, f32 = torch.bfloat16, torch.float32

    def randn(*shape, dtype=f32):
        return torch.randn(*shape, generator=gen, device=dev).to(dtype)

    def weight(*shape):
        return normalize(randn(*shape)).to(bf).contiguous()

    x = randn(n, t, d, dtype=bf)
    a = mp_silu(randn(n, d)).to(bf)
    gains = torch.rand(depth, 2, generator=gen, device=dev) * 0.6 + 0.2
    ws = [weight(depth, 6 * d, d), weight(depth, 3 * d, d), weight(depth, d, d), weight(depth, hid, d), weight(depth, d, hid)]
    w0 = [w[0].contiguous() for w in ws]
    mods = k.mp_gemm_plain(a, w0[0], alpha=1 / math.sqrt(d), out_dtype=f32)
    xf = x.reshape(n * t, d)
    x1 = randn(n * t, d)
    attn_in = randn(n * t, d, dtype=bf)
    h_in = mp_silu(randn(n * t, hid)).to(bf)
    g0 = gains[0]
    gemm_cases = {
        # site: (kwargs, M, N, K, bytes of the extra operands)
        "modulation": (dict(a=a, w=w0[0], alpha=1 / math.sqrt(d), out_dtype=f32), n, 6 * d, d, 0),
        "qkv": (dict(a=xf, w=w0[1], alpha=1 / math.sqrt(d), out_dtype=f32, modulate=(mods, 0, d, g0[0:1]), tokens=t),
                n * t, 3 * d, d, n * 2 * d * 4),
        "out": (dict(a=attn_in, w=w0[2], alpha=1 / math.sqrt(d), out_dtype=f32, residual=(xf, mods, 2 * d), tokens=t),
                n * t, d, d, n * d * 4 + n * t * d * 2),
        "fc1": (dict(a=x1, w=w0[3], alpha=1 / math.sqrt(d), out_dtype=bf, modulate=(mods, 3 * d, 4 * d, g0[1:2]),
                     silu=True, tokens=t), n * t, hid, d, n * 2 * d * 4),
        "fc2": (dict(a=h_in, w=w0[4], alpha=1 / math.sqrt(hid), out_dtype=bf, residual=(x1, mods, 5 * d), tokens=t),
                n * t, d, hid, n * d * 4 + n * t * d * 4),
    }
    rows = {}
    # bf16 results: 1e-2 relative is ~2.5 bf16 ulps; the sums differ only in
    # order (f32), and a prologue value can round to the neighbouring bf16
    for site, (kw, m_, n_, k_, extra) in gemm_cases.items():
        got = k.mp_gemm(**kw, site=site)
        want = k.mp_gemm_plain(**kw)
        err = compare(torch, got, want, 1e-2, 1e-2, f"mp_gemm/{site}")
        a_bytes = kw["a"].numel() * kw["a"].element_size()
        out_bytes = m_ * n_ * (4 if kw["out_dtype"] == f32 else 2)
        b, by = bound_ms(2 * m_ * n_ * k_, a_bytes + n_ * k_ * 2 + out_bytes + extra)
        a_bf = kw["a"].to(bf)
        rows[f"mp_gemm/{site}"] = dict(
            source="mapdit_tpu_torch/csrc/mp_gemm.cu", replaces=f"{PALLAS}:279", max_abs_err=err,
            ms=time_ms(torch, lambda: k.mp_gemm(**kw, site=site)),
            plain_ms=time_ms(torch, lambda: k.mp_gemm_plain(**kw)),
            bound_ms=b, bound_by=by,
            library_ms=time_ms(torch, lambda: torch.matmul(a_bf, kw["w"].t())),
        )

    qkv = randn(n * t, 3 * d)
    got = k.cosine_attention(qkv, t, heads, bf)
    err = compare(torch, got, k.cosine_attention_plain(qkv, t, heads, bf), 1e-2, 1e-2, "cosine_attention")
    q4, k4, v4 = qkv.reshape(n, t, 3, heads, hd).permute(2, 0, 3, 1, 4)
    qn, kn, vb = normalize(q4).to(bf), normalize(k4).to(bf), v4.to(bf)
    b, by = bound_ms(4 * n * heads * t * t * hd, n * t * 3 * d * 4 + n * t * d * 2)
    rows["cosine_attention"] = dict(
        source="mapdit_tpu_torch/csrc/cosine_attention.cu", replaces=f"{PALLAS}:129", max_abs_err=err,
        ms=time_ms(torch, lambda: k.cosine_attention(qkv, t, heads, bf)),
        plain_ms=time_ms(torch, lambda: k.cosine_attention_plain(qkv, t, heads, bf)),
        bound_ms=b, bound_by=by,
        library_ms=time_ms(torch, lambda: F.scaled_dot_product_attention(qn, kn, vb, scale=1 / math.sqrt(hd))),
    )

    block_flops = 2 * n * d * 6 * d + 2 * n * t * d * (3 * d + d + 2 * hid) + 4 * n * heads * t * t * hd
    weight_bytes = (10 * d * d + 2 * d * hid) * 2
    io_bytes = 2 * n * t * d * 2 + n * d * 2
    # block and stack: errors of single bf16 roundings compound through the
    # six launches (and twelve blocks); hold the max at 5e-2 + 5e-2 relative
    # and report the mean beside it
    got = k.fused_dit_block(x, a, gains[0], *w0, heads)
    err = compare(torch, got, k.fused_dit_block_plain(x, a, gains[0], *w0, heads), 5e-2, 5e-2, "fused_dit_block")
    b, by = bound_ms(block_flops, io_bytes + weight_bytes + 8)
    rows["fused_dit_block"] = dict(
        source="mapdit_tpu_torch/ops/cuda/dit_block.py", replaces=f"{PALLAS}:476", max_abs_err=err,
        ms=time_ms(torch, lambda: k.fused_dit_block(x, a, gains[0], *w0, heads)),
        plain_ms=time_ms(torch, lambda: k.fused_dit_block_plain(x, a, gains[0], *w0, heads)),
        bound_ms=b, bound_by=by, library_ms=None,
    )
    got = k.fused_dit_stack(x, a, gains, *ws, heads)
    err = compare(torch, got, k.fused_dit_stack_plain(x, a, gains, *ws, heads), 5e-2, 5e-2, "fused_dit_stack")
    b, by = bound_ms(depth * block_flops, io_bytes + depth * weight_bytes + depth * 8)
    rows["fused_dit_stack"] = dict(
        source="mapdit_tpu_torch/ops/cuda/dit_block.py", replaces=f"{PALLAS}:1980", max_abs_err=err,
        ms=time_ms(torch, lambda: k.fused_dit_stack(x, a, gains, *ws, heads), iters=5),
        plain_ms=time_ms(torch, lambda: k.fused_dit_stack_plain(x, a, gains, *ws, heads), iters=5),
        bound_ms=b, bound_by=by, library_ms=None,
    )
    rows.update(train_kernel_rows(torch, F, k, gen, dev, t, d, heads, x, a, gains[0], w0))
    for name, row in rows.items():
        phase("time", kernel=name, ms=f"{row['ms']:.4f}", plain_ms=f"{row['plain_ms']:.4f}",
              bound_ms=f"{row['bound_ms']:.4f}", bound_by=row["bound_by"], library_ms=row["library_ms"])

    # 4. full DiT-S/2 forward_with_cfg: kernel paths against the plain path
    model = init_model(cfg, seed=SEED, device=dev)
    with torch.no_grad():
        # gains start at 0 in the reference; draw them so the modulate and
        # residual mixing the kernels fuse is exercised
        for blk in model.blocks:
            blk.gain_msa.uniform_(0.2, 0.8, generator=gen)
            blk.gain_mlp.uniform_(0.2, 0.8, generator=gen)
    sd = model.state_dict()
    folded_cfg = cfg.replace(fold_weights=True)
    fsd = fold_weights_for_inference(sd, folded_cfg)
    ref_cfg = folded_cfg.replace(compute_dtype="float32")
    paths = {}
    for name, c in (("f32", ref_cfg), ("off", folded_cfg), ("mega", folded_cfg.replace(block_kernel="mega"))):
        m = init_model(c, seed=SEED, device=dev)
        m.load_state_dict(fsd)
        paths[name] = m
    zf = randn(n, 4, 16, 16)
    tf = torch.full((n,), 500.0, device=dev)
    yf = torch.cat([torch.randint(0, 1000, (BATCH,), generator=gen, device=dev), torch.full((BATCH,), 1000, device=dev)])
    with torch.no_grad():
        outs = {name: m.forward_with_cfg(zf, tf, yf, CFG_SCALE) for name, m in paths.items()}
        outs["mega_stack"] = paths["off"].forward_with_cfg(
            zf, tf, yf, CFG_SCALE, block_stack=build_block_stack(fsd, folded_cfg))
    check_paths(torch, "forward", outs, ("mega", "mega_stack"))

    # 5. chains: a short clipped chain on every path, then the headline
    z = randn(2 * BATCH, 4, 16, 16)
    short = create_diffusion("10", device=dev)
    outs = {}
    for name, c, hint in (("f32", cfg.replace(compute_dtype="float32"), None), ("off", cfg, None),
                          ("auto+hint", cfg.replace(block_kernel="auto"), BATCH)):
        fn = build_sample_fn(c, sd, short, cfg_scale=CFG_SCALE, clip_denoised=True, batch_hint=hint, device=dev)
        outs[name] = fn(z, yf, torch.Generator(device=dev).manual_seed(SEED + 1))
    check_paths(torch, "chain-10", outs, ("auto+hint",))

    diffusion = create_diffusion(str(STEPS), device=dev)
    sample = build_sample_fn(cfg.replace(block_kernel="auto"), sd, diffusion, cfg_scale=CFG_SCALE, batch_hint=BATCH,
                             device=dev)
    if sample.run_cfg.block_kernel != "mega_stack":
        raise AssertionError(f"auto with a batch hint resolved to {sample.run_cfg.block_kernel}, not mega_stack")
    sample(z, yf, torch.Generator(device=dev).manual_seed(SEED + 2))  # warm-up
    torch.cuda.synchronize()
    k.reset_launch_counts()
    t0 = time.perf_counter()
    out = sample(z, yf, torch.Generator(device=dev).manual_seed(SEED + 3))
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = dict(k.LAUNCHES)
    finite = bool(torch.isfinite(out).all())
    phase("chain", model=MODEL, batch=f"{BATCH}x2", steps=STEPS, seconds=f"{seconds:.4f}",
          steps_per_s=f"{STEPS / seconds:.3f}", ms_per_model_call=f"{1e3 * seconds / STEPS:.4f}",
          finite=finite, shape=tuple(out.shape), launches=json.dumps(launches))
    if not finite:
        # untrained weights at clip_denoised=False can leave the data range;
        # the finiteness check then runs on a clipped short chain
        fn = build_sample_fn(cfg.replace(block_kernel="auto"), sd, short, cfg_scale=CFG_SCALE, clip_denoised=True,
                             batch_hint=BATCH, device=dev)
        finite = bool(torch.isfinite(fn(z, yf, torch.Generator(device=dev).manual_seed(SEED))).all())
        phase("chain", note="non-finite at clip_denoised=False; 10-step clip_denoised=True chain", finite=finite)
        if not finite:
            raise AssertionError("the sampling chain gives non-finite latents")
    sampling_keys = [f"mp_gemm/{site}" for site in ("modulation", "qkv", "out", "fc1", "fc2")]
    per_stack = {key: launches[key] for key in sampling_keys + ["cosine_attention", "fused_dit_stack"]}
    if launches["fused_dit_stack"] != STEPS or any(v == 0 for v in per_stack.values()):
        raise AssertionError(f"the headline chain did not run through the stack kernels: {launches}")

    block_chain = build_sample_fn(cfg.replace(block_kernel="auto"), sd, short, cfg_scale=CFG_SCALE, device=dev)
    if block_chain.run_cfg.block_kernel != "auto":
        raise AssertionError("without a batch hint auto must stay per-block")
    k.reset_launch_counts()
    out_b = block_chain(z, yf, torch.Generator(device=dev).manual_seed(SEED + 4))
    torch.cuda.synchronize()
    block_launches = dict(k.LAUNCHES)
    phase("chain-per-block", steps=10, finite=bool(torch.isfinite(out_b).all()), launches=json.dumps(block_launches))
    if block_launches["fused_dit_block"] != 10 * depth or block_launches["fused_dit_stack"] != 0:
        raise AssertionError(f"the per-block chain did not run through fused_dit_block: {block_launches}")

    # 6. train
    train_launches = train_phase(torch, dev, cfg)

    # 7. report
    kernels = []
    for name, row in rows.items():
        path = row.pop("path", None)
        if path is not None:
            count = train_launches[path][name]
        else:
            count = block_launches[name] if name == "fused_dit_block" else launches[name]
        kernels.append(dict(name=name, route="cuda", source=row.pop("source"), replaces=row.pop("replaces"),
                            launches=count, **row))
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi_line(), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                            "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
