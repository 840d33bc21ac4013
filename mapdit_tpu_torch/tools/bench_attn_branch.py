"""Check and time the attention half-block's one-launch training kernels
(``mapdit_tpu_torch/csrc/attn_branch.cu``: ``attn_branch_fwd``, row 3;
``attn_branch_bwd``, row 4 without its dW products; ``attn_branch_res_fwd``,
row 5) on one NVIDIA GPU, and hold the cases ``chip_smoke.py`` phase 3
checks them on.

    python -m mapdit_tpu_torch.tools.bench_attn_branch [--check-only] [--ptxas] [--trace] \\
        [--out results/bench_attn_branch.json]

``--check-only`` builds and runs the three kernels and their launch
sequences against their plain versions at every case of CASES (the
``BF16`` rule: rel L2 1e-2, row 5's y, p and attn each, row 4's dW operands
too; dgain within 2^-8 of its terms' root-sum-square; the same bits twice;
whether the bits equal the launch sequence's is printed) and times nothing:
the first call after a change. ``chip_smoke.py`` holds the f32 instances
to the same checks under the ``F32`` rule.
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
from typing import NamedTuple

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
OPERAND_NAMES = ("h", "attn", "dout", "dqkv")  # attn_branch_bwd's operands of the dW pair
RES_NAMES = ("y", "p", "attn")
KINDS = ("fwd", "bwd", "res_fwd")
H100_BF16_FLOPS = 989e12  # dense tensor-core peak, H100 SXM data sheet
H100_F32_FLOPS = 67e12  # float32 outside the tensor cores, H100 SXM data sheet
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
    """dh of the plain backward (the stages of ab.attn_bwd_plain, rounding
    to the weights' type) with the flat x and rows: what dgain's terms are
    formed from."""
    from mapdit_tpu_torch.ops.cuda import dit_block as k

    x, shift, scale, gate, gain, wq, wo, heads = args
    n, t, d = x.shape
    bf, f32, inv_d = wq.dtype, torch.float32, 1 / math.sqrt(d)
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


class Rule(NamedTuple):
    """How a kernel's output is held to its plain version: with ``f32``
    elementwise, |got - want| <= tol + tol |want| (the f32 instances, at the
    JAX package's f32 kernel tolerance), else relative L2 at most ``tol``
    (bf16); dgain, a sum whose terms cancel, within ``sum_tol`` of its
    terms' root-sum-square."""

    f32: bool
    tol: float
    sum_tol: float


BF16 = Rule(False, 1e-2, 2.0**-8)
F32 = Rule(True, 2e-4, 2e-4)


def held(rule: Rule, what: str, got, want) -> tuple:
    """One output against its plain version under ``rule`` (one check line
    printed): (err, max abs err, ok); err is the max abs err at f32, the
    relative L2 error in bf16."""
    g, w = got.float().reshape(want.shape), want.float()
    diff = (g - w).abs()
    max_abs = float(diff.max()) if diff.numel() else 0.0
    ok = got.dtype == want.dtype and bool(torch.isfinite(g).all())
    if rule.f32:
        err, within = max_abs, bool((diff <= rule.tol + rule.tol * w.abs()).all())
        limit = f"tol=atol{rule.tol:g}+rtol{rule.tol:g}"
    else:
        err = rel_l2(got, want)
        within, limit = err <= rule.tol, f"rel_l2_err={err:.3e}"
    ok = ok and within
    print(f"[check] what={what} {limit} max_abs_err={max_abs:.3e} ok={ok}", flush=True)
    return err, max_abs, ok


def held_sum(rule: Rule, what: str, got, want, terms) -> tuple:
    """dgain against its plain version under ``rule``: (abs err, ok)."""
    g, w = float(got.reshape(())), float(want.reshape(()))
    err, limit = abs(g - w), rule.sum_tol * float(terms.double().square().sum().sqrt())
    ok = math.isfinite(g) and err <= limit
    print(f"[check] what={what} got={g:.6e} want={w:.6e} abs_err={err:.3e} "
          f"tol={limit:.3e}={rule.sum_tol:g}*rss(terms) ok={ok}", flush=True)
    return err, ok


def held_all(rule: Rule, what: str, names, got, want, terms=None) -> tuple:
    """Each named output against its plain version (dgain by
    :func:`held_sum`): ({name: err}, max abs err, ok)."""
    errs, max_abs, all_ok = {}, 0.0, True
    for nm, g_, w_ in zip(names, got, want):
        if nm == "dgain":
            e, ok = held_sum(rule, f"{what}:dgain", g_, w_, terms)
            m = e
        else:
            e, m, ok = held(rule, f"{what}:{nm}", g_, w_)
        errs[nm], max_abs, all_ok = e, max(max_abs, m), all_ok and ok
    return errs, max_abs, all_ok


def _tag(rule: Rule) -> str:
    return ":f32" if rule.f32 else ""


def check_res(name, args, rule: Rule = BF16) -> dict:
    """Row 5's kernel at one case against its plain version (y, p and attn
    each, under ``rule``), its launch sequence against the same, the same
    bits on two runs, and whether each output equals the launch sequence's
    bits. Raises on a disagreement."""
    what = f"attn_branch/res_fwd{_tag(rule)}:{name}"
    got, again = ab.attn_branch_res_fwd(*args), ab.attn_branch_res_fwd(*args)
    want, seq = ab.attn_res_fwd_plain(*args), ab.res_fwd_launch_sequence(*args)
    errs, max_abs, ok = held_all(rule, what, RES_NAMES, got, want)
    ok = held_all(rule, f"{what}:launch-sequence", RES_NAMES, seq, want)[2] and ok
    same = all(torch.equal(a, b) for a, b in zip(got, again))
    seq_bits = {nm: torch.equal(a, b) for nm, a, b in zip(RES_NAMES, got, seq)}
    print(f"[check] what={what}:same-bits-twice ok={same} same_bits_as_sequence={json.dumps(seq_bits)}", flush=True)
    if not (ok and same):
        raise AssertionError(f"{what}: the kernel disagrees with its plain version or itself")
    return dict(errs=errs, max_abs_err=max_abs, same_bits_twice=same, same_bits_as_sequence=seq_bits)


def check(name, args, dy, kinds=KINDS, rule: Rule = BF16) -> dict:
    """The kernels of ``kinds`` at one case against their plain versions
    under ``rule``, their launch sequences against the same, the same bits
    on two runs, and whether the bits equal the launch sequences'. Raises
    on a disagreement."""
    checks = {"fwd": lambda: check_fwd(name, args, rule), "bwd": lambda: check_bwd(name, args, dy, rule),
              "res_fwd": lambda: check_res(name, args, rule)}
    return {kind: checks[kind]() for kind in kinds}


def check_fwd(name, args, rule: Rule = BF16) -> dict:
    """Row 3's kernel at one case (check)."""
    what = f"attn_branch/fwd{_tag(rule)}:{name}"
    fwd = ab.attn_branch_fwd(*args)
    want, seq = ab.attn_fwd_plain(*args), ab.fwd_launch_sequence(*args)
    err, max_abs, ok = held(rule, what, fwd, want)
    ok = held(rule, f"{what}:launch-sequence", seq, want)[2] and ok
    same = torch.equal(fwd, ab.attn_branch_fwd(*args))
    seq_bits = torch.equal(fwd, seq)
    print(f"[check] what={what}:same-bits-twice ok={same} same_bits_as_sequence={seq_bits}", flush=True)
    if not (ok and same):
        raise AssertionError(f"{what}: the kernel disagrees with its plain version or itself")
    return dict(err=err, max_abs_err=max_abs, same_bits_twice=same, same_bits_as_sequence=seq_bits)


def check_bwd(name, args, dy, rule: Rule = BF16) -> dict:
    """Row 4's kernel and the dW pair at one case (check); where
    :func:`ab.branch_route` takes the call, also the dW pair's operands
    (h, attn, dout, dqkv) of ``attn_branch_bwd``."""
    what = f"attn_branch/bwd{_tag(rule)}:{name}"
    got, again = ab.attn_bwd(dy, *args), ab.attn_bwd(dy, *args)
    want, seq = ab.attn_bwd_plain(dy, *args), ab.bwd_launch_sequence(dy, *args)
    terms = dgain_terms(args, dy)
    errs, max_abs, ok = held_all(rule, what, GRAD_NAMES, got, want, terms)
    ok = held_all(rule, f"{what}:launch-sequence", GRAD_NAMES, seq, want, terms)[2] and ok
    x, *_, wq, wo, heads = args
    if ab.branch_route(x, wq, wo, heads, dy) == "kernel":
        ops = ab.attn_branch_bwd(dy, *args)[5]
        ops_errs, ops_max, ops_ok = held_all(rule, what, OPERAND_NAMES, ops, ab.attn_branch_bwd_plain(dy, *args)[5])
        errs.update(ops_errs)
        max_abs, ok = max(max_abs, ops_max), ok and ops_ok
    same = all(torch.equal(a, b) for a, b in zip(got, again))
    seq_bits = {nm: torch.equal(a, b) for nm, a, b in zip(GRAD_NAMES, got, seq)}
    print(f"[check] what={what}:same-bits-twice ok={same} same_bits_as_sequence={json.dumps(seq_bits)}", flush=True)
    if not (ok and same):
        raise AssertionError(f"{what}: the kernel disagrees with its plain version or itself")
    return dict(errs=errs, max_abs_err=max_abs, same_bits_twice=same, same_bits_as_sequence=seq_bits)


def bounds(n, t, d, heads, f32: bool = False) -> dict:
    """Each kernel's least time on the card (ms): the larger of its bytes
    (inputs read once, outputs written once) over the memory rate and its
    products' FLOPs over the bf16 tensor-core peak (``f32``: the f32
    instances, every tensor f32 and the products on the f32 pipes). Row 4's
    counts its own work, the dW pair apart; row 5's is row 3's work with p
    (f32) and attn written besides y."""
    m, hd, e = n * t, d // heads, 4 if f32 else 2
    attn = 4 * n * heads * t * t * hd  # QK^T and P.V
    gemm = 2 * m * d * 4 * d  # qkv and out
    inputs = m * d * e + 3 * n * d * e + 4 * d * d * e + 4
    fwd = (gemm + attn, inputs + m * d * e)
    # the recompute (qkv, S, P.V, out), then dattn, dh (4D x D) and the
    # attention backward's four T x T x hd products (dP, dV, dQ, dK; S is
    # the recompute's)
    bwd = (2 * gemm + 8 * n * heads * t * t * hd + attn,
           inputs + m * d * e + m * d * e + 3 * n * d * 4 + 4)
    res_fwd = (fwd[0], fwd[1] + m * d * e + n * heads * t * t * 4)
    peak = H100_F32_FLOPS if f32 else H100_BF16_FLOPS
    out = {}
    for kind, (flops, nbytes) in (("fwd", fwd), ("bwd", bwd), ("res_fwd", res_fwd)):
        t_ops, t_bytes = flops / peak, nbytes / H100_BYTES_PER_S
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

    for name in ("attn_branch", "attn_branch_f32"):
        cmd = [build._nvcc(), *build.NVCC_FLAGS, "-Xptxas", "-v", "-o", os.devnull, str(build.CSRC / f"{name}.cu")]
        out = subprocess.run(cmd, capture_output=True, text=True, check=True)
        for line in (out.stdout + out.stderr).splitlines():
            if "registers" in line or "spill" in line or "Function properties" in line or "C7511" in line:
                # attn_branch_kernel<HD, RES, F32, FWD>: the mangled name ends in its template arguments
                print(f"[ptxas] source={name}", line.strip(), flush=True)


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
