#!/usr/bin/env python3
"""Check and time ``dit_stack`` (``mapdit_tpu_torch/csrc/dit_stack.cu``, the
kernel of ``fused_dit_stack`` and ``fused_dit_block``) at every shape of
``chip_smoke.STACK_SHAPES`` on one NVIDIA GPU, through chip_smoke.py's own
rows (``stack_rows``: held against the plain version, the same bits twice,
the stack against chained depth-1 calls; device ms from CUDA-graph replays,
host ms and eager ms beside the launch sequence it replaced, graph-captured
and eager).

    python tools/bench_dit_stack.py [--check-only] [--ptxas] [--draws N] [--trace] \\
        [--ctas 132,99,66] [--out results/bench_dit_stack.json]

``--check-only`` builds, runs each shape and compares, and times nothing
(the first call after a change to the kernel). ``--ptxas`` first prints
the registers, shared memory and spills nvcc reports for the source.
``--draws N`` first holds the S/2 stack and the launch sequence it replaced
to the plain version on N other draws (generator seeds SEED + 20 on), with
how far each lands from phase 3's limit, and prints the float64 witness of
each draw (``chip_smoke.stack_witness``: kernel, plain version and launch
sequence against the plain version's roundings summed in float64). ``--trace`` first prints where one
launch's time goes at S2, B2, XL2 and S2:T256 (the kernel's own clock: the
ms a CTA spends on each kind of item). ``--ctas 132,99,66`` first times S2, B2 and
XL2 on grids of those CTA counts. Prints
one line a check and a shape and the card's name and power limit; writes
the rows to ``--out``.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402


TRACE_KINDS = ("modulation+pre", "qkv", "attention", "out", "fc1", "fc2")


def timeline(torch, k, name) -> dict:
    """One launch at a STACK_SHAPES entry with the kernel's trace on: the
    launch's span from the first CTA's start to the last CTA's end, and for
    each kind of work the ms a CTA spent on its items of that kind (the mean
    over CTAs; an item's time includes its waits on the rows it reads), with
    the rest of the span as ``other`` (the CTA done early, or between
    items), in ms."""
    case = dict(chip_smoke.stack_cases(torch))[name]
    (x, a, gains, ws, heads), _, _ = case
    n, t, d = x.shape
    depth = ws[0].shape[0]
    plan = k.stack_plan(n, t, d, ws[3].shape[1], heads, depth, k._resident_ctas(x.get_device(), d // heads))
    trace = torch.zeros(plan.trace_words, dtype=torch.int64, device=x.device)
    k.dit_stack(x, a, gains, *ws, heads, trace=trace)
    torch.cuda.synchronize()
    tr = trace.view(plan.ctas, k.STACK_TRACE_WORDS).double().cpu()
    span = float(tr[:, 7].max() - tr[:, 6].min()) / 1e6
    out = {"launch_ms": span}
    for i, kind in enumerate(TRACE_KINDS):
        out[kind] = float(tr[:, i].mean()) / 1e6
    out["other"] = span - sum(out[kind] for kind in TRACE_KINDS)
    return out


def grid_scaling(torch, k, counts) -> dict:
    """Device ms of the S2, B2 and XL2 launches on grids of ``counts`` CTAs
    (fewer than the card holds): whether a launch's time follows the SMs it
    runs on (each SM's own pipeline bounds it) or not (a shared resource,
    or a chain of row tiles, does)."""
    cases = dict(chip_smoke.stack_cases(torch))
    resident = k._resident_ctas
    out = {}
    try:
        for ctas in counts:
            k._resident_ctas = lambda device_index, hd, ctas=ctas: min(ctas, resident(device_index, hd))
            for name in ("S2", "B2", "XL2"):
                (x, a, gains, ws, heads), _, _ = cases[name]
                kernel = chip_smoke.stack_calls(k, name, x, a, gains, ws, heads)[0]
                out[f"{name}@{ctas}"] = chip_smoke.graph_ms(torch, kernel, iters=10)
                chip_smoke.phase("grid", shape=name, ctas=ctas, ms=f"{out[f'{name}@{ctas}']:.4f}")
    finally:
        k._resident_ctas = resident
    return out


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--check-only", action="store_true", help="compare every shape, time nothing")
    parser.add_argument("--draws", type=int, default=0,
                        help="first hold the S/2 stack and the launch sequence to the plain version on this many "
                             "other draws")
    parser.add_argument("--trace", action="store_true",
                        help="first print where one launch's time goes at S2, B2, XL2 and S2:T256")
    parser.add_argument("--ctas", default=None,
                        help="first time S2, B2 and XL2 on grids of these CTA counts, e.g. 132,99,66")
    parser.add_argument("--ptxas", action="store_true", help="print nvcc -Xptxas -v for csrc/dit_stack.cu first")
    parser.add_argument("--out", default=os.path.join(REPO, "results", "bench_dit_stack.json"))
    args = parser.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("bench_dit_stack: no CUDA device", file=sys.stderr)
        return 2
    from mapdit_tpu_torch.ops.cuda import build
    from mapdit_tpu_torch.ops.cuda import dit_block as k

    smi = chip_smoke.smi_line()
    print(smi, flush=True)
    if args.ptxas:
        source = build.CSRC / "dit_stack.cu"
        proc = subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-Xptxas", "-v", "-o", os.devnull, str(source)],
                              capture_output=True, text=True)
        print(proc.stdout + proc.stderr, flush=True)
    chip_smoke.phase("build", compiled=json.dumps({n: round(s, 2) for n, s in build.build_all().items()}))
    if args.ctas:
        grid_scaling(torch, k, [int(c) for c in args.ctas.split(",")])
    if args.draws:
        # the S/2 stack on other inputs: kernel and launch sequence against
        # the plain version under phase 3's rule (worst err - limit < 0
        # passes), then all three against the float64 witness
        dev = torch.device("cuda")
        for i in range(args.draws):
            case, _, _ = chip_smoke.stack_draw(torch, dev, i)
            kernel, plain, seq = chip_smoke.stack_calls(k, "S2", *case)
            want = plain()
            limit = 5e-2 + 5e-2 * want.float().abs()
            outs = {"kernel": kernel(), "launch-sequence": seq()}
            for what, got in outs.items():
                e = (got.float() - want.float()).abs()
                chip_smoke.phase("draw", seed=chip_smoke.SEED + 20 + i, what=what, max_abs_err=f"{float(e.max()):.3e}",
                                 mean_abs_err=f"{float(e.mean()):.3e}",
                                 worst_err_minus_limit=f"{float((e - limit).max()):+.3e}")
            chip_smoke.stack_witness(torch, k, f"dit_stack:S2:seed{chip_smoke.SEED + 20 + i}", case, outs["kernel"],
                                     want, outs["launch-sequence"])
    if args.check_only:
        for name, ((x, a, gains, ws, heads), _, _) in chip_smoke.stack_cases(torch):
            kernel, plain, _ = chip_smoke.stack_calls(k, name, x, a, gains, ws, heads)
            got = kernel()
            torch.cuda.synchronize()
            chip_smoke.compare(torch, got, plain(), 5e-2, 5e-2, f"dit_stack:{name}")
        print(smi, flush=True)
        return 0
    if args.trace:
        for name in ("S2", "B2", "XL2", "S2:T256"):
            chip_smoke.phase("timeline", shape=name, **{key: f"{v:.4f}" for key, v in timeline(torch, k, name).items()})
    rows = chip_smoke.stack_rows(torch, k)
    report = {"device": torch.cuda.get_device_name(0), "nvidia_smi": smi, "rows": rows,
              "launches": dict(k.LAUNCHES)}
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(report, f, indent=1)
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
