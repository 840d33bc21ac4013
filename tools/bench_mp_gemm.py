#!/usr/bin/env python3
"""Time ``mp_gemm`` (``mapdit_tpu_torch/csrc/mp_gemm.cu``) at every shape of
``chip_smoke.GEMM_SHAPES`` on one NVIDIA GPU through chip_smoke.py's own
check and timing (``gemm_row``: held against ``mp_gemm_plain``, device ms
beside the plain version and the bf16 ``torch.matmul`` yardstick), with the
device time of each kernel a call launches (prologue pass, product, split-K
sum) and, optionally, the first form of the kernel on the same inputs.

    python tools/bench_mp_gemm.py [--first-form PATH/mp_gemm.cu] \\
        [--parent PATH/mp_gemm.cu] [--out results/bench_mp_gemm.json]

``--first-form`` builds the given source (the WMMA form this one replaced, e.g.
``mapdit_tpu_torch/csrc/mp_gemm.cu`` from a ``git archive`` of an earlier tree)
with the port's nvcc flags, calls it through its C interface (no workspace
arguments) and holds it to the same rule. ``--parent`` builds an earlier
source with this tree's C interface (e.g. the parent commit's, from a ``git
archive``) and runs every shape through both libraries on the same inputs:
whether the outputs have the same bits, and both device times, in turns
(this tree, parent, parent, this tree). Prints one JSON line a shape and
the card's name and power limit; writes all of it to ``--out``.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
FIRST_FORM_ARGS = [_P, _I, _P, _P, _I, _I, _I, _I, _F, _I, _P, _I, _I, _I, _I, _P, _I, _I, _P, _I, _I, _P]


def load_first_form(build, source: str):
    target = build.BUILD_DIR / "mp_gemm_first_form.so"
    target.parent.mkdir(parents=True, exist_ok=True)
    subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-o", str(target), source], check=True)
    lib = ctypes.CDLL(str(target))
    lib.mp_gemm.argtypes = FIRST_FORM_ARGS
    lib.mp_gemm.restype = ctypes.c_int
    return lib


def load_parent(build, source: str):
    """``source`` built as a library with this tree's C interface (the
    entries it has: an earlier tree may lack a later one, such as
    mp_gemm_gate_residual_bwd)."""
    target = build.BUILD_DIR / "mp_gemm_parent.so"
    target.parent.mkdir(parents=True, exist_ok=True)
    subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-o", str(target), source], check=True)
    lib = ctypes.CDLL(str(target))
    for fn, (argtypes, restype) in build._SIGNATURES["mp_gemm"].items():
        if hasattr(lib, fn):
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = restype
    return lib


def against_parent(torch, build, k, parent, kw) -> dict:
    """One shape through this tree's library and ``parent`` (the wrapper
    reads the library from ``build``'s cache): same bits, and the device
    ms of each in turns."""
    ours = build.library("mp_gemm")
    outs, times = {}, {"ms": [], "parent_ms": []}
    try:
        for which in ("ms", "parent_ms", "parent_ms", "ms"):
            build._LIBS["mp_gemm"] = ours if which == "ms" else parent
            outs[which] = k.mp_gemm(**kw).clone()
            times[which].append(chip_smoke.graph_ms(torch, lambda: k.mp_gemm(**kw)))
    finally:
        build._LIBS["mp_gemm"] = ours
    return dict(same_bits_as_parent=bool(torch.equal(outs["ms"], outs["parent_ms"])), **times)


def first_form_call(torch, lib, kw):
    """The first form's C call on the wrapper's keyword arguments."""
    codes = {torch.float32: 0, torch.bfloat16: 1}
    a, w, w_kn = kw["a"], kw["w"], kw["w_kn"]
    m, k = a.shape
    n = w.shape[1] if w_kn else w.shape[0]
    out = torch.empty(m, n, dtype=kw["out_dtype"], device=a.device)
    mods = gain = x = None
    shift_off = scale_off = gate_off = 0
    if "modulate" in kw:
        mods, shift_off, scale_off, gain = kw["modulate"]
    if "residual" in kw:
        x, mods, gate_off = kw["residual"]

    def run():
        code = lib.mp_gemm(
            a.data_ptr(), codes[a.dtype], w.data_ptr(), out.data_ptr(), codes[out.dtype], m, n, k, kw["alpha"],
            1 if "modulate" in kw else 0, mods.data_ptr() if mods is not None else None,
            mods.shape[1] if mods is not None else 0, shift_off, scale_off, gate_off,
            gain.data_ptr() if gain is not None else None, kw["tokens"],
            1 if kw.get("silu") else (2 if x is not None else 0), x.data_ptr() if x is not None else None,
            codes[x.dtype] if x is not None else 0, 1 if w_kn else 0, torch.cuda.current_stream().cuda_stream,
        )
        if code:
            raise RuntimeError(f"first form: CUDA error {code}")
        return out

    return run


def kernel_ms(torch, fn, iters: int = 20) -> dict:
    """Device time of each kernel one call launches (the prologue pass, the
    product, the split-K sum), from a torch.profiler trace of ``iters``
    calls (no launch gaps)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    times = {}
    for evt in prof.key_averages():
        for kernel in ("mp_gemm_prologue", "mp_gemm_kernel", "mp_gemm_reduce"):
            if kernel in evt.key:
                us = getattr(evt, "self_device_time_total", None) or evt.self_cuda_time_total
                times[kernel] = times.get(kernel, 0.0) + us / 1e3 / iters
    return times


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--first-form", default=None, help="source of the first mp_gemm.cu to time beside")
    parser.add_argument("--parent", default=None, help="an earlier mp_gemm.cu with this tree's C interface")
    parser.add_argument("--out", default=os.path.join(REPO, "results", "bench_mp_gemm.json"))
    args = parser.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("bench_mp_gemm: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    from mapdit_tpu_torch.ops.cuda import build
    from mapdit_tpu_torch.ops.cuda import dit_block as k

    smi = chip_smoke.smi_line()
    print(smi, flush=True)
    t0 = time.perf_counter()
    compiled = build.build_all()
    print(json.dumps({"build_seconds": time.perf_counter() - t0, "compiled": compiled}), flush=True)
    report = {"device": smi, "shapes": []}
    first = load_first_form(build, args.first_form) if args.first_form else None
    parent = load_parent(build, args.parent) if args.parent else None
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(chip_smoke.SEED)
    for name, spec in chip_smoke.GEMM_SHAPES.items():
        kw, flops, nbytes, library = chip_smoke.gemm_case(torch, gen, dev, spec)
        site = name.split(":")[-1] if name.split(":")[-1] in k.GEMM_SITES else "qkv"
        row = chip_smoke.gemm_row(torch, k, name, kw, spec[:3], flops, nbytes, library, site)
        row.update(name=name, shape=list(spec[:3]), kernel_ms=kernel_ms(torch, lambda: k.mp_gemm(**kw)))
        if first is not None:
            run = first_form_call(torch, first, kw)
            chip_smoke.compare(torch, run(), k.mp_gemm_plain(**kw), 1e-2, 1e-2, f"first-form/{name}")
            row["first_form_ms"] = chip_smoke.graph_ms(torch, run)
        if parent is not None:
            row["against_parent"] = against_parent(torch, build, k, parent, kw)
        row["x_library"] = row["ms"] / row["library_ms"]
        report["shapes"].append(row)
        print(json.dumps(row), flush=True)
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(report, f, indent=1)
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
