"""Check and time the attention half-block's one-launch training kernels
(``mapdit_tpu_torch/csrc/attn_branch.cu``: ``attn_branch_fwd``, row 3;
``attn_branch_bwd``, row 4 without its dW products; ``attn_branch_res_fwd``,
row 5) on one NVIDIA GPU, and hold the cases ``chip_smoke.py`` phase 3
checks them on.

    python -m mapdit_tpu_torch.tools.bench_attn_branch [--check-only] [--ptxas] [--trace] \\
        [--out results/bench_attn_branch.json]

``--check-only`` builds and runs the three kernels against their plain
versions at every case of CASES (rel L2 1e-2, row 5's y, p and attn each;
dgain within 2^-8 of its terms' root-sum-square, the same bits twice;
whether the bits equal the launch sequence's is printed) and times nothing:
the first call after a change.
Otherwise the report rows (S/2 and XL/2 training shapes) are timed beside
the launch sequences they replaced: device ms of CUDA-graph replays, host
ms a call and eager ms (a host-launched loop, as training runs them), the
plain versions' graph ms, and the dW pair as one bf16 product each against
the f32 pair. ``--ptxas`` first prints the registers, shared memory and
spills nvcc reports for the source (both kernels a head width: rows 3 and
4's, row 5's). ``--trace`` prints where one launch's time goes at each
report row (the kernel's own clock: ms a CTA spends on each stage's items,
mean and max over CTAs, the pre items' bodies, product mainloops and
epilogues an item, the last dgain sum, the attention units' waits, staging
and computing, the launch's span); row 5's attention stage is row 4's
recompute with the f32 p store added, so their ``attention_compute`` ms
differ by what the store costs. Prints one line a check and a timing and the
card's name and power limit; writes the rows to ``--out``.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys

import torch

from mapdit_tpu_torch.ops.cuda import attn_branch as ab
from mapdit_tpu_torch.utils import timing

# name -> (N, T, D, heads): the report rows (the DiT-S/2 and DiT-XL/2
# training shapes at batch 256), then an odd N, the B/2 width at T = 16, the
# XL/2 head at T = 4 and T = 2
REPORT = ("s2", "xl")
CASES = {
    "s2": (256, 64, 384, 6),
    "xl": (256, 64, 1152, 16),
    "n3": (3, 64, 384, 6),
    "b2-t16": (8, 16, 768, 12),
    "xl-t4": (8, 4, 1152, 16),
    "t2": (5, 2, 384, 6),
}
GRAD_NAMES = ("dx", "dshift", "dscale", "dgate", "dgain", "dw_qkv", "dw_out")
RES_NAMES = ("y", "p", "attn")
KINDS = ("fwd", "bwd", "res_fwd")
H100_BF16_FLOPS = 989e12  # dense tensor-core peak, H100 SXM data sheet
H100_BYTES_PER_S = 3.35e12  # HBM3 rate, H100 SXM data sheet


def branch_inputs(gen, dev, n, t, d, heads):
    """The half-block's inputs drawn from ``gen``, bf16 but the gain:
    ((x, shift, scale, gate, gain, W_qkv, W_out, heads), dy)."""
    from mapdit_tpu_torch.ops.mp import normalize

    bf = torch.bfloat16

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device=dev).to(bf)

    x = randn(n, t, d)
    shift, scale, gate = (randn(n, d) for _ in range(3))
    gain = torch.tensor(0.37, device=dev)
    wq, wo = (normalize(torch.randn(*s, generator=gen, device=dev)).to(bf).contiguous() for s in ((3 * d, d), (d, d)))
    return (x, shift, scale, gate, gain, wq, wo, heads), randn(n, t, d)


def plain_dh(args, dy):
    """dh of the plain backward (the stages of ab.attn_bwd_plain) with the
    flat x and rows: what dgain's terms are formed from."""
    from mapdit_tpu_torch.ops.cuda import dit_block as k

    x, shift, scale, gate, gain, wq, wo, heads = args
    n, t, d = x.shape
    bf, f32, inv_d = torch.bfloat16, torch.float32, 1 / math.sqrt(d)
    rows, g1 = ab._pack(shift, scale, gate, gain)
    xf = x.reshape(n * t, d)
    h = ab.modulate_fwd_plain(xf, rows, g1, t, bf)
    qkv = k.mp_gemm_plain(h, wq, alpha=inv_d, out_dtype=f32)
    attn = k.cosine_attention_plain(qkv, t, heads, bf, normalize_first=True)
    dout, _ = ab.out_gate_residual_bwd_plain(attn, wo, dy.reshape(n * t, d), rows, 2 * d, t)
    dattn = k.mp_gemm_plain(dout, wo, alpha=inv_d, out_dtype=f32, w_kn=True)
    dqkv = ab.attention_bwd_plain(qkv, dattn, t, heads, bf)
    dh = k.mp_gemm_plain(dqkv, wq, alpha=inv_d, out_dtype=f32, w_kn=True)
    return dh, xf, rows, g1


def dgain_terms(args, dy):
    """The terms of dgain's sum over the batch, divided by den (its limit's
    scale: chip_smoke.compare_sum)."""
    dh, xf, rows, g1 = plain_dh(args, dy)
    g = g1.reshape(())
    return ab.dgain_terms(dh, xf, rows, g1, args[0].shape[1]) / torch.sqrt((1 - g) ** 2 + g**2)


def rel_l2(got, want) -> float:
    return float((got.float() - want.float()).norm() / want.float().norm())


def check_res(name, args) -> dict:
    """Row 5's kernel at one case against its plain version (rel L2 1e-2 for
    y, p and attn each), the same bits on two runs, and whether each output
    equals the launch sequence's bits. Raises on a disagreement."""
    got, again = ab.attn_branch_res_fwd(*args), ab.attn_branch_res_fwd(*args)
    want, seq = ab.attn_res_fwd_plain(*args), ab.res_fwd_launch_sequence(*args)
    errs, max_abs, all_ok = {}, 0.0, True
    for nm, g_, w_ in zip(RES_NAMES, got, want):
        e, m = rel_l2(g_, w_), float((g_.float() - w_.float()).abs().max())
        ok = g_.shape == w_.shape and g_.dtype == w_.dtype and bool(torch.isfinite(g_.float()).all()) and e <= 1e-2
        errs[nm], max_abs, all_ok = e, max(max_abs, m), all_ok and ok
        print(f"[check] what=attn_branch/res_fwd:{name}:{nm} rel_l2_err={e:.3e} max_abs_err={m:.3e} ok={ok}",
              flush=True)
    same = all(torch.equal(a, b) for a, b in zip(got, again))
    seq_bits = {nm: torch.equal(a, b) for nm, a, b in zip(RES_NAMES, got, seq)}
    print(f"[check] what=attn_branch/res_fwd:{name}:same-bits-twice ok={same} same_bits_as_sequence="
          f"{json.dumps(seq_bits)}", flush=True)
    if not (all_ok and same):
        raise AssertionError(f"attn_branch/res_fwd:{name}: the kernel disagrees with its plain version or itself")
    return dict(errs=errs, max_abs_err=max_abs, same_bits_twice=same, same_bits_as_sequence=seq_bits)


def check(name, args, dy, kinds=KINDS) -> dict:
    """The kernels of ``kinds`` at one case against their plain versions
    (rel L2 1e-2; dgain within 2^-8 of its terms' root-sum-square), the same
    bits on two runs, and whether the bits equal the launch sequences'.
    Raises on a disagreement."""
    checks = {"fwd": lambda: check_fwd(name, args), "bwd": lambda: check_bwd(name, args, dy),
              "res_fwd": lambda: check_res(name, args)}
    return {kind: checks[kind]() for kind in kinds}


def check_fwd(name, args) -> dict:
    """Row 3's kernel at one case (check)."""
    fwd = ab.attn_branch_fwd(*args)
    want = ab.attn_fwd_plain(*args)
    err, max_abs = rel_l2(fwd, want), float((fwd.float() - want.float()).abs().max())
    same = torch.equal(fwd, ab.attn_branch_fwd(*args))
    seq_bits = torch.equal(fwd, ab.fwd_launch_sequence(*args))
    ok = bool(torch.isfinite(fwd.float()).all()) and err <= 1e-2 and same
    print(f"[check] what=attn_branch/fwd:{name} rel_l2_err={err:.3e} max_abs_err={max_abs:.3e} same_bits_twice={same} "
          f"same_bits_as_sequence={seq_bits} ok={ok}", flush=True)
    if not ok:
        raise AssertionError(f"attn_branch/fwd:{name}: the kernel disagrees with its plain version")
    return dict(rel_l2_err=err, max_abs_err=max_abs, same_bits_twice=same, same_bits_as_sequence=seq_bits)


def check_bwd(name, args, dy) -> dict:
    """Row 4's kernel and the dW pair at one case (check)."""
    got, again = ab.attn_bwd(dy, *args), ab.attn_bwd(dy, *args)
    want, seq = ab.attn_bwd_plain(dy, *args), ab.bwd_launch_sequence(dy, *args)
    terms = dgain_terms(args, dy)
    errs, max_abs, all_ok = {}, 0.0, True
    for nm, g_, w_ in zip(GRAD_NAMES, got, want):
        max_abs = max(max_abs, float((g_.float() - w_.float()).abs().max()))
        if nm == "dgain":
            e, limit = abs(float(g_) - float(w_)), 2.0**-8 * float(terms.double().square().sum().sqrt())
            ok = math.isfinite(float(g_)) and e <= limit
            errs[nm] = e
            print(f"[check] what=attn_branch/bwd:{name}:dgain got={float(g_):.6e} want={float(w_):.6e} "
                  f"abs_err={e:.3e} tol={limit:.3e}=2^-8*rss(terms) ok={ok}", flush=True)
        else:
            e = rel_l2(g_, w_)
            ok = bool(torch.isfinite(g_.float()).all()) and e <= 1e-2
            errs[nm] = e
            print(f"[check] what=attn_branch/bwd:{name}:{nm} rel_l2_err={e:.3e} max_abs_err="
                  f"{float((g_.float() - w_.float()).abs().max()):.3e} ok={ok}", flush=True)
        all_ok = all_ok and ok
    same = all(torch.equal(a, b) for a, b in zip(got, again))
    seq_bits = {nm: torch.equal(a, b) for nm, a, b in zip(GRAD_NAMES, got, seq)}
    print(f"[check] what=attn_branch/bwd:{name}:same-bits-twice ok={same} same_bits_as_sequence="
          f"{json.dumps(seq_bits)}", flush=True)
    if not (all_ok and same):
        raise AssertionError(f"attn_branch/bwd:{name}: the kernel disagrees with its plain version or itself")
    return dict(errs=errs, max_abs_err=max_abs, same_bits_twice=same, same_bits_as_sequence=seq_bits)


def bounds(n, t, d, heads) -> dict:
    """Each kernel's least time on the card (ms): the larger of its bytes
    (inputs read once, outputs written once) over the memory rate and its
    products' FLOPs over the bf16 tensor-core peak. Row 4's counts its own
    work, the dW pair apart; row 5's is row 3's work with p (f32) and attn
    (bf16) written besides y."""
    m, hd = n * t, d // heads
    attn = 4 * n * heads * t * t * hd  # QK^T and P.V
    gemm = 2 * m * d * 4 * d  # qkv and out
    inputs = m * d * 2 + 3 * n * d * 2 + 4 * d * d * 2 + 4
    fwd = (gemm + attn, inputs + m * d * 2)
    # the recompute, then dattn, dh (4D x D) and the attention backward's
    # five T x T x hd products
    bwd = (2 * gemm + 10 * n * heads * t * t * hd + attn,
           inputs + m * d * 2 + m * d * 2 + 3 * n * d * 4 + 4)
    res_fwd = (fwd[0], fwd[1] + m * d * 2 + n * heads * t * t * 4)
    out = {}
    for kind, (flops, nbytes) in (("fwd", fwd), ("bwd", bwd), ("res_fwd", res_fwd)):
        t_ops, t_bytes = flops / H100_BF16_FLOPS, nbytes / H100_BYTES_PER_S
        out[kind] = (1e3 * max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes", flops, nbytes)
    return out


def times(fn, seq, plain) -> dict:
    """A call's graph, host and eager ms, its launch sequence's beside, and
    the plain version's graph ms."""
    return dict(ms=timing.graph_ms(fn), host_ms=timing.host_ms(fn), eager_ms=timing.eager_ms(fn),
                sequence_ms=timing.graph_ms(seq), sequence_host_ms=timing.host_ms(seq),
                sequence_eager_ms=timing.eager_ms(seq), plain_ms=timing.graph_ms(plain))


def dw_pair(args, dy) -> dict:
    """The dW pair on the backward's own operands: one bf16 product each
    with f32 sums (as the path runs it) against the f32 pair it replaced
    (relative L2 error at most 1e-5; the largest |diff| over the largest
    |f32 pair| is printed beside), both timed."""
    x = args[0]
    d = x.shape[-1]
    inv_d = 1 / math.sqrt(d)
    *_, (h, attn, dout, dqkv) = ab.attn_branch_bwd(dy, *args)
    pairs = ((dqkv, h), (dout, attn))
    got = [ab._dw_product(a, b, inv_d) for a, b in pairs]
    want = [(a.t().float() @ b.float()) * inv_d for a, b in pairs]
    err = max(rel_l2(g, w) for g, w in zip(got, want))
    max_rel = max(float((g - w).abs().max() / w.abs().max()) for g, w in zip(got, want))
    ok = err <= 1e-5
    m = h.shape[0]
    flops = 2 * m * (3 * d * d + d * d)
    nbytes = sum((a.numel() + b.numel()) * 2 + a.shape[1] * b.shape[1] * 4 for a, b in pairs)
    row = dict(rel_l2_err=err, max_rel_err=max_rel, ms=timing.graph_ms(lambda: [ab._dw_product(a, b, inv_d) for a, b in pairs]),
               f32_ms=timing.graph_ms(lambda: [(a.t().float() @ b.float()) * inv_d for a, b in pairs]),
               bound_ms=1e3 * max(flops / H100_BF16_FLOPS, nbytes / H100_BYTES_PER_S))
    print(f"[check] what=attn_branch/dw-pair rel_l2_err={err:.3e} tol=1e-5 max_rel_err={max_rel:.3e} ok={ok}",
          flush=True)
    if not ok:
        raise AssertionError("the bf16 dW pair is off the f32 pair")
    return row


def timeline(kind, args, dy) -> dict:
    """One launch with the kernel's trace on: the span from the first CTA's
    start to the last CTA's end, and per stage the ms a CTA spent on its
    items (mean and max over CTAs; an item's time includes its waits)."""
    x = args[0]
    n, t, d = x.shape
    heads = args[-1]
    plan = ab.branch_plan(kind, n, t, d, heads, ab._branch_ctas(x.get_device(), d // heads))
    trace = torch.zeros(plan.ctas * ab.BRANCH_TRACE_WORDS, dtype=torch.int64, device=x.device)
    if kind == "fwd":
        ab.attn_branch_fwd(*args, trace=trace)
    elif kind == "res_fwd":
        ab.attn_branch_res_fwd(*args, trace=trace)
    else:
        ab.attn_branch_bwd(dy, *args, trace=trace)
    torch.cuda.synchronize()
    tr = trace.view(plan.ctas, ab.BRANCH_TRACE_WORDS).double().cpu()
    out = {"span_ms": float(tr[:, 9].max() - tr[:, 8].min()) / 1e6,
           "last_cta_start_ms": float(tr[:, 8].max() - tr[:, 8].min()) / 1e6}
    for i, stage in enumerate(ab.BRANCH_STAGES[kind]):
        out[f"{stage}_mean_ms"] = float(tr[:, i].mean()) / 1e6
        out[f"{stage}_max_ms"] = float(tr[:, i].max()) / 1e6
    out["pre_body_mean_ms"] = float(tr[:, 7].mean()) / 1e6
    items = max(float(tr[:, 12].sum()), 1.0)
    out["mainloop_ms_an_item"] = float(tr[:, 10].sum()) / 1e6 / items
    out["epilogue_ms_an_item"] = float(tr[:, 11].sum()) / 1e6 / items
    out["dgain_sum_ms"] = float(tr[:, 13].max()) / 1e6
    out["attention_bwd_wait_mean_ms"] = float(tr[:, 14].mean()) / 1e6
    out["store_warp_mean_ms"] = float(tr[:, 15].mean()) / 1e6
    # a CTA's first group of four warps, over its forward attention units
    for i, part in enumerate(("wait", "stage", "compute")):
        out[f"attention_{part}_mean_ms"] = float(tr[:, 16 + i].mean()) / 1e6
    out["attention_bwd_body_mean_ms"] = float(tr[:, 19].mean()) / 1e6
    for i, part in enumerate(("stage", "query_rows", "key_rows", "store")):
        out[f"attention_bwd_{part}_mean_ms"] = float(tr[:, 20 + i].mean()) / 1e6
    return out


def smi_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def ptxas() -> None:
    from mapdit_tpu_torch.ops.cuda import build

    src = build.CSRC / "attn_branch.cu"
    cmd = [build._nvcc(), *build.NVCC_FLAGS, "-Xptxas", "-v", "-o", os.devnull, str(src)]
    out = subprocess.run(cmd, capture_output=True, text=True, check=True)
    for line in (out.stdout + out.stderr).splitlines():
        if "registers" in line or "spill" in line or "Function properties" in line or "C7511" in line:
            # attn_branch_kernel<HD, RES>: the mangled name ends in its template arguments
            print("[ptxas]", line.strip(), flush=True)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--check-only", action="store_true")
    p.add_argument("--ptxas", action="store_true")
    p.add_argument("--trace", action="store_true")
    p.add_argument("--cases", default=None, help="comma-separated names of CASES to run (all by default)")
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("bench_attn_branch: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    from mapdit_tpu_torch.ops.cuda import build

    smi = smi_line()
    print(smi, flush=True)
    print(f"[torch] version={torch.__version__} cuda={torch.version.cuda}", flush=True)
    print("[build] compiled=" + json.dumps({n: round(s, 2) for n, s in build.build_all().items()}), flush=True)
    if args.ptxas:
        ptxas()
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    report = {"card": smi, "checks": {}, "times": {}, "trace": {}}
    for name, shape in CASES.items():
        if args.cases and name not in args.cases.split(","):
            continue
        fargs, dy = branch_inputs(gen, dev, *shape)
        report["checks"][name] = check(name, fargs, dy)
        if name not in REPORT:
            continue
        if not args.check_only:
            b = bounds(*shape)
            for kind in KINDS:
                if kind == "fwd":
                    fn, seq, plain = (lambda: ab.attn_branch_fwd(*fargs), lambda: ab.fwd_launch_sequence(*fargs),
                                      lambda: ab.attn_fwd_plain(*fargs))
                elif kind == "res_fwd":
                    fn, seq, plain = (lambda: ab.attn_branch_res_fwd(*fargs),
                                      lambda: ab.res_fwd_launch_sequence(*fargs), lambda: ab.attn_res_fwd_plain(*fargs))
                else:
                    fn, seq, plain = (lambda: ab.attn_branch_bwd(dy, *fargs),
                                      lambda: ab.bwd_launch_sequence(dy, *fargs),
                                      lambda: ab.attn_bwd_plain(dy, *fargs))
                row = dict(times(fn, seq, plain), bound_ms=b[kind][0], bound_by=b[kind][1])
                if kind == "bwd":
                    row["with_dw_ms"] = timing.graph_ms(lambda: ab.attn_bwd(dy, *fargs))
                    row["with_dw_eager_ms"] = timing.eager_ms(lambda: ab.attn_bwd(dy, *fargs))
                report["times"][f"{kind}:{name}"] = row
                print(f"[time] kernel=attn_branch/{kind}:{name} "
                      + " ".join(f"{k}={v:.4f}" if isinstance(v, float) else f"{k}={v}" for k, v in row.items()),
                      flush=True)
            row = dw_pair(fargs, dy)
            report["times"][f"dw:{name}"] = row
            print(f"[time] kernel=attn_branch/dw-pair:{name} " + " ".join(f"{k}={v:.4e}" for k, v in row.items()),
                  flush=True)
        if args.trace:
            for kind in KINDS:
                row = timeline(kind, fargs, dy)
                report["trace"][f"{kind}:{name}"] = row
                print(f"[trace] kernel=attn_branch/{kind}:{name} " + " ".join(f"{k}={v:.4f}" for k, v in row.items()),
                      flush=True)
        del fargs, dy
        torch.cuda.empty_cache()
    print(smi, flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(report, f, indent=1, default=str)
    return 0


if __name__ == "__main__":
    sys.exit(main())
