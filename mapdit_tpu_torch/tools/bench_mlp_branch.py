"""Check and time row 9, ``fused_mlp_branch`` (``mapdit_tpu_torch/ops/cuda/
mlp_block.py``: one launch of ``mlp_branch`` in ``csrc/dit_block_tp.cu``),
on one NVIDIA GPU at the DiT-B/2 shapes phase 3 of ``chip_smoke.py`` runs
(64 and 256 samples of 64 tokens, D=768, H=3072, bf16), and measure the k
step of its tile pipeline.

    python -m mapdit_tpu_torch.tools.bench_mlp_branch [--check-only] [--ptxas] [--sass FILE] [--trace] \\
        [--kstep] [--out results/bench_mlp.json]

``--check-only`` builds and runs the kernel against its plain version (rel
L2 1e-2, the same bits twice) at N=64 and 256, at the ragged cases
(:data:`RAGGED`: T = 4, 16, 256, the S/2 and XL/2 widths, an odd count of
row tiles) and with fc1 pre-activations far below -88 (:data:`DEEP`, where
e^-c overflows f32; also against the former route), and times nothing: the
first call after a change. Otherwise each B/2 shape is timed three ways: the kernel,
its former route (``mlp_launch_sequence``, two ``mp_gemm`` launches) and the
library pair (two bf16 ``torch.matmul``), each as device ms of CUDA-graph
replays, host ms a call and eager ms (a host-launched loop), with the
kernel's device operations a call (a captured CUDA graph's nodes). ``--ptxas`` first
prints the registers, shared memory, spills and wgmma serialization nvcc
reports for the kernel's source and the probe's; ``--sass FILE`` writes
the SASS of row 9's kernel there and counts each tile kernel's spills and
wgmma waits. ``--trace`` prints where one launch's time goes (the kernel's
own clock: ms a CTA in each stage, mean and max over CTAs, the launch's
span, ms an item in the mainloop and the epilogues, us a k step, the TMA
thread's waits for rows). ``--kstep`` runs ``csrc/kstep_probe.cu`` at row
9's fc1 and fc2 shapes (N=64): one SM's k step, every SM busy, as loads
and wgmma, loads only and wgmma only, on the 128 x 128 ring (four 32 KB
stages) and on the 128 x 256 ring (three 48 KB stages), alone and with W
multicast across 2-CTA clusters. Prints one line a check and a timing and
the card's name and power limit; writes the rows to ``--out``.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys

import torch

from mapdit_tpu_torch.ops.cuda import dit_block_tp as tpk
from mapdit_tpu_torch.ops.cuda import mlp_block as mb
from mapdit_tpu_torch.tools.bench_tp_kernels import device_ops, rel_l2, smi_line, times

B2_D, B2_HIDDEN, TOKENS = 768, 3072, 64
SAMPLES = (64, 256)  # 32 x 2 CFG rows of a B/2 chain; a P1 train step's batch
# (name, samples, tokens, D, H): the other token counts of the registry's
# models, the S/2 and XL/2 widths (D not a multiple of 256), and row counts
# that leave a ragged row tile and an odd count of them
RAGGED = (("t4", 64, 4, 768, 3072), ("t16", 64, 16, 768, 3072), ("t256", 8, 256, 768, 3072),
          ("s2", 64, 64, 384, 1536), ("xl2", 8, 64, 1152, 4608), ("rows320", 5, 64, 768, 3072))
# B/2 at N=64 with every 16th row of w1 scaled by 300: fc1 pre-activations
# c of spread ~300, a third of them below -88, where e^-c overflows f32 and
# the MP-SiLU must still give -0 (name, samples, tokens, D, H, scale)
DEEP = ("fc1-below-88", 64, TOKENS, B2_D, B2_HIDDEN, 300.0)
KSTEP_FORMS = ((128, 1), (256, 1), (256, 2))  # (tile columns, CTAs a cluster)
KSTEP_MODES = ("loads+wgmma", "loads", "wgmma")


def mlp_case(gen, dev, n: int, t: int = TOKENS, d: int = B2_D, hid: int = B2_HIDDEN, deep: float = 0.0,
             dtype=torch.bfloat16) -> dict:
    """Row 9's inputs as the model hands them in (x (N, T, D), shift, scale
    and gate (N, D) in x's type, one f32 gain, weights of x's type: bf16,
    or f32 for the f32 form): the arguments, FLOPs, bytes and the library
    pair in that type. ``deep``: scale every 16th row of w1 by it
    (:data:`DEEP`)."""
    from mapdit_tpu_torch.ops.mp import normalize

    bf = dtype
    e = torch.empty((), dtype=dtype).element_size()

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device=dev)

    w1, w2 = (normalize(randn(*s)) for s in ((hid, d), (d, hid)))
    if deep:
        w1[::16] *= deep
    w1, w2 = (w.to(bf).contiguous() for w in (w1, w2))
    x = randn(n, t, d).to(bf)
    shift, scale, gate = (randn(n, d).to(bf) for _ in range(3))
    gain = torch.tensor(0.37, device=dev)
    xf = x.reshape(n * t, d)
    return dict(args=(x, shift, scale, gate, gain, w1, w2), flops=4 * n * t * d * hid,
                bytes=2 * n * t * d * e + 3 * n * d * e + 4 + 2 * d * hid * e,
                library=lambda: torch.matmul(torch.matmul(xf, w1.t()), w2.t()))


def fc1_below(args, level: float = -88.0) -> int:
    """How many fc1 pre-activations (modulate(x) . w1^T / sqrt(D), in f32)
    lie below ``level``."""
    from mapdit_tpu_torch.ops.cuda.dit_block import modulate_reference

    x, shift, scale, _, gain, w1, _ = args
    mod = modulate_reference(x.float(), shift.float(), scale.float(), gain.reshape(()).float())
    return int(((mod @ w1.float().t()) / math.sqrt(x.shape[-1]) < level).sum())


def f64_witness(args) -> tuple:
    """Row 9 on ``args`` in float64 (the plain reference math), and each
    output's scale: the sum of the absolute values of the terms that reach
    it, through fc1, the MP-SiLU's slope at the pre-activation, fc2, the
    gate and the residual. An f32 sum of terms lies within a few units of
    f32 rounding of that scale from the float64 value, in any order; where
    a pre-activation lies far below -88, the slope is ~0, and so is what
    that unit's f32 rounding may add. Returns (y, scale), both float64."""
    from mapdit_tpu_torch.ops.cuda.dit_block import RES_T, modulate_reference

    x, shift, scale, gate, gain, w1, w2 = (z.double() for z in args)
    d, hidden = x.shape[-1], w1.shape[0]
    mod = modulate_reference(x, shift, scale, gain.reshape(()))
    c = mod @ w1.t() / math.sqrt(d)
    c_abs = mod.abs() @ w1.abs().t() / math.sqrt(d)
    sig = torch.sigmoid(c)
    h = c * sig / 0.596  # mp_silu
    slope = (sig * (1 + c * (1 - sig))).abs() / 0.596
    f = h @ w2.t() / math.sqrt(hidden)
    f_abs = (slope * c_abs + h.abs()) @ w2.abs().t() / math.sqrt(hidden)
    norm = math.hypot(1 - RES_T, RES_T)
    g = gate[:, None, :]
    return ((1 - RES_T) * x + RES_T * g * f) / norm, ((1 - RES_T) * x.abs() + RES_T * g.abs() * f_abs) / norm


def ptxas() -> None:
    from mapdit_tpu_torch.ops.cuda import build

    for name in ("dit_block_tp", "kstep_probe"):
        cmd = [build._nvcc(), *build.NVCC_FLAGS, "-Xptxas", "-v", "-o", os.devnull, str(build.CSRC / f"{name}.cu")]
        out = subprocess.run(cmd, capture_output=True, text=True, check=True)
        for line in (out.stdout + out.stderr).splitlines():
            if any(w in line for w in ("registers", "spill", "Function properties", "Performance", "serializ")):
                print(f"[ptxas] {name}:", line.strip(), flush=True)


def sass(path: str) -> None:
    """The SASS of the built tile-pipeline kernels (cuobjdump) into
    ``path``, and for each kernel its instructions, local-memory loads and
    stores (spills), wgmma instructions (HGMMA) and waits for all of them
    to finish (WARPGROUP.DEPBAR.LE gsb0, 0x0: one after every HGMMA means
    ptxas serialized them)."""
    from mapdit_tpu_torch.ops.cuda import build

    tool = os.path.join(os.path.dirname(build._nvcc()), "cuobjdump")
    kept = []
    for lib in ("dit_block_tp", "kstep_probe", "mp_gemm", "dit_stack"):
        if not build._target(lib).exists():  # the probe, unless --kstep built it
            continue
        text = subprocess.run([tool, "-sass", str(build._target(lib))], capture_output=True, text=True,
                              check=True).stdout
        for part in text.split("Function : ")[1:]:
            name = part.split("\n", 1)[0].strip()
            lines = [ln for ln in part.splitlines() if "/*" in ln and ";" in ln]
            hgmma = sum("HGMMA" in ln for ln in lines)
            if not hgmma:
                continue
            local = sum("LDL" in ln or "STL" in ln for ln in lines)
            waits = sum("DEPBAR.LE gsb0, 0x0" in ln for ln in lines)
            print(f"[sass] {lib}:{name} instructions={len(lines)} local_ops={local} hgmma={hgmma} "
                  f"wait_all={waits}", flush=True)
            if "mlp_branch_kernel" in name or "kstep_kernelILi256ELi3ELi49152ELi1ELi0" in name:
                kept.append("Function : " + part)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        f.write("".join(kept))


def check(what, fn, plain, args, route=None) -> dict:
    """The kernel against its plain version (and ``route``, if given): rel
    L2 1e-2, finite, and the same bits on two runs."""
    got, again, want = fn(*args), fn(*args), plain(*args)
    torch.cuda.synchronize()
    err, same = rel_l2(got, want), torch.equal(got, again)
    route_err = rel_l2(got, route(*args)) if route is not None else 0.0
    finite = bool(torch.isfinite(got.float()).all())
    ok = finite and math.isfinite(err) and err <= 1e-2 and same and route_err <= 1e-2
    print(f"[check] what={what} rel_l2_err={err:.3e} route_rel_l2={route_err:.3e} same_bits_twice={same} "
          f"finite={finite} ok={ok}", flush=True)
    if not ok:
        raise AssertionError(f"{what}: the kernel disagrees with its plain version")
    return {"rel_l2_err": err, "route_rel_l2": route_err, "same_bits_twice": same}


def check_deep(gen, dev) -> dict:
    """:data:`DEEP`: the kernel against its plain version and its former
    route where fc1's pre-activations fall below -88."""
    name, n, t, d, hid, deep = DEEP
    args = mlp_case(gen, dev, n, t, d, hid, deep=deep)["args"]
    below = fc1_below(args)
    print(f"[check] what=fused_mlp_branch:{name}:inputs fc1_below_-88={below} ok={below > 0}", flush=True)
    if not below:
        raise AssertionError(f"{name}: no fc1 pre-activation below -88")
    row = check(f"fused_mlp_branch:{name}", mb.fused_mlp_branch, mb.fused_mlp_branch_plain, args,
                route=mb.mlp_launch_sequence)
    return dict(row, fc1_below=below)


def timeline(args) -> dict:
    """One launch with the kernel's trace on: the span from the first CTA's
    start to the last CTA's end; for each stage the ms a CTA spent on its
    items (mean and max over CTAs; an item's time includes its waits); ms
    an item in the mainloop (waits for the ring included) and in fc1's and
    fc2's epilogues; us a k step of the mainloop (128 x 256 x 64); the TMA
    thread's ms waiting for rows."""
    x = args[0]
    n, t, d = x.shape
    plan = mb.mlp_plan(n, t, d, args[5].shape[0], ctas=mb.resident_ctas(x.get_device()))
    trace = torch.zeros(plan.trace_words, dtype=torch.int64, device=x.device)
    mb.fused_mlp_branch(*args)  # warm
    mb.mlp_branch(*args[:4], args[4].reshape(1).float(), *args[5:], trace=trace)
    torch.cuda.synchronize()
    tr = trace.view(plan.ctas, tpk.TP_TRACE_WORDS).double().cpu()
    out = {"span_ms": float(tr[:, 7].max() - tr[:, 6].min()) / 1e6,
           "last_cta_start_ms": float(tr[:, 6].max() - tr[:, 6].min()) / 1e6}
    for i, kind in enumerate(s.name for s in plan.stages):
        out[f"{kind}_mean_ms"] = float(tr[:, 1 + i].mean()) / 1e6
        out[f"{kind}_max_ms"] = float(tr[:, 1 + i].max()) / 1e6
    out["pre_body_mean_ms"] = float(tr[:, 5].mean()) / 1e6
    items = float(tr[:, 12].sum())
    for w, part in ((8, "mainloop"), (15, "first_stage_wait"), (10, "partial_ticket"), (11, "split_sum")):
        out[f"{part}_ms_an_item"] = float(tr[:, w].sum()) / 1e6 / max(items, 1.0)
    for w, p in zip((9, 14), plan.products):
        out[f"{p.name}_epilogue_ms_an_item"] = float(tr[:, w].sum()) / 1e6 / p.items
    steps = sum(what[4] - what[3] for cta in plan.walk() for name, _, what in cta if name != "pre")
    out["mainloop_us_a_wide_k_step"] = float(tr[:, 8].sum()) / 1e3 / max(steps, 1.0)
    # the same without the waits for each item's first stage (its rows)
    out["steady_us_a_wide_k_step"] = float(tr[:, 8].sum() - tr[:, 15].sum()) / 1e3 / max(steps, 1.0)
    out["row_wait_mean_ms"] = float(tr[:, 13].mean()) / 1e6
    out["row_wait_max_ms"] = float(tr[:, 13].max()) / 1e6
    return out


def kstep(dev) -> dict:
    """csrc/kstep_probe.cu (built here, on demand) at row 9's fc1 and fc2 shapes (N=64): us a k step
    of one SM (mean and max over the CTAs that ran one), every SM busy, and
    the L2 bytes a second the busy SMs' loads take (loads of A and W; with
    multicast, each W tile once a cluster)."""
    from mapdit_tpu_torch.ops.cuda import build
    from mapdit_tpu_torch.ops.cuda.dit_block import _raise_on

    lib = build.library("kstep_probe")
    bf = torch.bfloat16
    gen = torch.Generator(device=dev).manual_seed(5)
    m = 64 * TOKENS
    shapes = {"fc1": (m, B2_HIDDEN, B2_D), "fc2": (m, B2_D, B2_HIDDEN)}
    rows = {}
    for product, (m_, n_, k_) in shapes.items():
        a = (torch.randn(m_, k_, generator=gen, device=dev) * 0.1).to(bf)
        w = (torch.randn(n_, k_, generator=gen, device=dev) * 0.1).to(bf)
        for nb, c in KSTEP_FORMS:
            ctas = torch.cuda.get_device_properties(dev).multi_processor_count
            for mode, mode_name in enumerate(KSTEP_MODES):
                out = torch.zeros(ctas, 4, dtype=torch.int64, device=dev)
                for _ in range(2):  # the first launch warms the code and L2
                    code = lib.kstep_probe(mode, nb, c, a.data_ptr(), w.data_ptr(), m_, n_, k_, ctas, out.data_ptr(),
                                           torch.cuda.current_stream(dev).cuda_stream)
                    _raise_on(code, lib, "kstep_probe")
                    torch.cuda.synchronize()
                o = out.double().cpu()
                busy = o[:, 2] > 0
                us = o[busy, 1] / o[busy, 2] / 1e3
                cycles = o[busy, 0] / o[busy, 2]
                step_bytes = 128 * 64 * 2 + nb * 64 * 2 / c
                span_s = float(o[busy, 1].max()) / 1e9
                row = {"ctas": int(busy.sum()), "us_a_k_step_mean": float(us.mean()), "us_a_k_step_max": float(us.max()),
                       "cycles_a_k_step_mean": float(cycles.mean()), "k_steps": int(o[busy, 2].sum())}
                if mode != 2:
                    row["l2_tb_s"] = float(o[busy, 2].sum()) * step_bytes / span_s / 1e12
                key = f"{product}:{nb}x{c}:{mode_name}"
                rows[key] = row
                print(f"[kstep] {key} " + " ".join(f"{k}={v:.4f}" if isinstance(v, float) else f"{k}={v}"
                                                   for k, v in row.items()), flush=True)
    return rows


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--check-only", action="store_true")
    p.add_argument("--ptxas", action="store_true")
    p.add_argument("--trace", action="store_true")
    p.add_argument("--kstep", action="store_true")
    p.add_argument("--sass", default=None, help="write the kernel's SASS here and count its spills")
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("bench_mlp_branch: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    from mapdit_tpu_torch.ops.cuda import build

    smi = smi_line()
    print(smi, flush=True)
    print("[build] compiled=" + json.dumps({n: round(s, 2) for n, s in build.build_all().items()}), flush=True)
    if args.ptxas:
        ptxas()
    if args.sass:
        sass(args.sass)
    dev = torch.device("cuda", torch.cuda.current_device())
    gen = torch.Generator(device=dev).manual_seed(0)
    report = {"card": smi, "checks": {}, "times": {}}
    if args.check_only:
        cases = [(f"n{n}", n, TOKENS, B2_D, B2_HIDDEN) for n in SAMPLES] + list(RAGGED)
        for name, n, t, d, hid in cases:
            report["checks"][name] = check(f"fused_mlp_branch:{name}", mb.fused_mlp_branch,
                                           mb.fused_mlp_branch_plain, mlp_case(gen, dev, n, t, d, hid)["args"])
    report["checks"][DEEP[0]] = check_deep(gen, dev)
    if args.kstep:
        report["kstep"] = kstep(dev)
    if not args.check_only:
        for n in SAMPLES:
            case = mlp_case(gen, dev, n)
            fargs = case["args"]
            report["checks"][f"n{n}"] = check(f"fused_mlp_branch:n{n}", mb.fused_mlp_branch,
                                              mb.fused_mlp_branch_plain, fargs)
            row = {}
            for name, fn in (("kernel", lambda: mb.fused_mlp_branch(*fargs)),
                             ("route", lambda: mb.mlp_launch_sequence(*fargs)), ("library", case["library"]),
                             ("kernel_again", lambda: mb.fused_mlp_branch(*fargs))):
                row.update({f"{name}_{k}": v for k, v in times(fn).items()})
            row["kernel_device_ops"] = device_ops(lambda: mb.fused_mlp_branch(*fargs))[0]
            row["bound_ms"] = 1e3 * max(case["flops"] / 989e12, case["bytes"] / 3.35e12)
            report["times"][f"n{n}"] = row
            print(f"[time] kernel=fused_mlp_branch:n{n} " + " ".join(f"{k}={v:.4f}" for k, v in row.items()),
                  flush=True)
    if args.trace:
        report["trace"] = {}
        for n in SAMPLES:
            row = timeline(mlp_case(gen, dev, n)["args"])
            report["trace"][f"n{n}"] = row
            print(f"[trace] kernel=mlp_branch:n{n} " + " ".join(f"{k}={v:.4f}" for k, v in row.items()), flush=True)
    print(smi, flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(report, f, indent=1, default=str)
    return 0


if __name__ == "__main__":
    sys.exit(main())
