#!/usr/bin/env python3
"""Time ``cosine_attention`` and ``fused_attention``
(``mapdit_tpu_torch/csrc/cosine_attention.cu``, ``fused_attention.cu``) at
every shape of ``chip_smoke.COSINE_SHAPES`` and ``chip_smoke.FUSED_SHAPES`` on
one NVIDIA GPU, through chip_smoke.py's own check and timing
(``cosine_case`` / ``fused_case`` held against the plain versions, device ms
of CUDA-graph replays beside the plain version, the bound and the SDPA
yardstick), and, optionally, the first forms of both kernels on the same
inputs in the same call.

    python tools/bench_attention.py [--first-form DIR] \\
        [--out results/bench_attention.json]

``--first-form DIR`` names a directory holding earlier ``cosine_attention.cu``
and ``fused_attention.cu`` (e.g. ``mapdit_tpu_torch/csrc`` of a ``git
archive`` of an earlier tree, whose f32-pipe forms take the C interfaces
below). They are built with the port's nvcc flags, called on the same
inputs, held to the same check and timed new, first, first, new; a shape
the first form cannot take (its shared memory grows as T^2) is reported
as such. Then the order witness: the bf16 no-cosine case at input scales
2 (the phase-3 row) and 6, kernel and plain version (on the card and on the
CPU, whose f32 sums run in other orders) each against a float64 evaluation
of the same roundings. Prints one JSON line a shape and the card's name and
power limit; writes all of it to ``--out``.
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
FIRST_FORM = {
    "cosine_attention": {
        "cosine_attention": ([_P, _P, _I, _P, _I, _I, _I, _I, _I, _P], _I),
        "cosine_attention_smem_bytes": ([_I, _I], ctypes.c_size_t),
    },
    "fused_attention": {
        "fused_attention": ([_P, _P, _P, _P, _I, _I, _I, _I, _I, _P, _F, _I, _I, _P], _I),
    },
}


def load_first_form(build, directory: str) -> dict:
    """The first forms' libraries, built in parallel into the build
    directory."""
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in FIRST_FORM:
        target = build.BUILD_DIR / f"{name}_first_form.so"
        cmd = [build._nvcc(), *build.NVCC_FLAGS, "-o", str(target), os.path.join(directory, f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd), target)
    libs = {}
    for name, (proc, target) in procs.items():
        if proc.wait() != 0:
            raise RuntimeError(f"first form {name}: nvcc exit {proc.returncode}")
        lib = ctypes.CDLL(str(target))
        for fn, (argtypes, restype) in FIRST_FORM[name].items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = restype
        libs[name] = lib
    return libs


def first_cosine(torch, lib, case):
    """The first form's call on a cosine case's inputs, or None where its
    T x T shared-memory block does not fit."""
    from mapdit_tpu_torch.ops.cuda.dit_block import MAX_SMEM_BYTES

    n, t, heads, hd = case.shape
    if lib.cosine_attention_smem_bytes(t, hd) > MAX_SMEM_BYTES:
        return None
    out = torch.empty(n * t, heads * hd, dtype=torch.bfloat16, device=case.qkv.device)
    probs = torch.empty_like(case.probs) if case.residual else None

    def run():
        code = lib.cosine_attention(
            case.qkv.data_ptr(), out.data_ptr(), 1, probs.data_ptr() if probs is not None else None,
            1 if case.residual else 0, n, t, heads, hd, torch.cuda.current_stream().cuda_stream)
        if code:
            raise RuntimeError(f"first form: CUDA error {code}")
        return out

    return run, lambda: case.check(run(), probs)


def first_fused(torch, lib, case):
    """The first form's call on a fused case's inputs (its query tile from
    the shared-memory rule the f32 path keeps)."""
    from mapdit_tpu_torch.ops.cuda import attention as at

    n, h, t, hd = case.shape
    qt = at.query_tile(t, hd)
    out = at._empty_like_layout(case.q)
    strides = (ctypes.c_longlong * 12)(*(s for z in (case.q, case.k, case.v, out) for s in at._strides(z)))
    dtype = 1 if case.q.dtype == torch.bfloat16 else 0

    def run():
        code = lib.fused_attention(
            case.q.data_ptr(), case.k.data_ptr(), case.v.data_ptr(), out.data_ptr(), dtype, n, h, t, hd, strides,
            float(case.scale), 1 if case.cosine else 0, qt, torch.cuda.current_stream().cuda_stream)
        if code:
            raise RuntimeError(f"first form: CUDA error {code}")
        return out

    return run, lambda: case.check(run())


def order_witness(torch, gen, dev) -> list:
    """Max abs distances at the bf16 no-cosine shape, input scales 2 and 6:
    kernel and plain version (card, CPU) from each other and from float64
    logits and p (p rounded to bf16, the product summed in float64)."""
    from mapdit_tpu_torch.ops.cuda import attention as at

    (n, h, t, hd), *_ = chip_smoke.FUSED_SHAPES["fused_attention:bf16-no-cosine-logits>88"]
    rows = []
    for scale_in in (2.0, 6.0):
        qkv = (torch.randn(n, t, 3 * h * hd, generator=gen, device=dev) * scale_in).to(torch.bfloat16)
        q, k, v = (z.reshape(n, t, h, hd).transpose(1, 2) for z in qkv.split(h * hd, dim=-1))
        got = at.fused_attention(q, k, v, 1.0, False).double()
        plain = at.fused_attention_plain(q, k, v, 1.0, False).double()
        plain_cpu = at.fused_attention_plain(q.cpu(), k.cpu(), v.cpu(), 1.0, False).double().to(dev)
        p64 = torch.softmax(q.double() @ k.double().transpose(-1, -2), dim=-1)
        ref = (p64.to(torch.bfloat16).double() @ v.double()).to(torch.bfloat16).double()

        def dist(a, b):
            return float((a - b).abs().max())

        rows.append(dict(input_scale=scale_in, max_abs_logit=float((q.float() @ k.float().transpose(-1, -2)).abs().max()),
                         kernel_vs_plain=dist(got, plain), plain_vs_plain_cpu=dist(plain, plain_cpu),
                         kernel_vs_f64=dist(got, ref), plain_vs_f64=dist(plain, ref), plain_cpu_vs_f64=dist(plain_cpu, ref)))
        print(json.dumps({"order_witness": rows[-1]}), flush=True)
    return rows


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--first-form", default=None, help="directory of the first cosine_attention.cu / fused_attention.cu")
    parser.add_argument("--out", default=os.path.join(REPO, "results", "bench_attention.json"))
    args = parser.parse_args()

    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        print("bench_attention: no CUDA device", file=sys.stderr)
        return 2
    from mapdit_tpu_torch.ops.cuda import build

    smi = chip_smoke.smi_line()
    print(smi, flush=True)
    t0 = time.perf_counter()
    compiled = build.build_all()
    first = load_first_form(build, args.first_form) if args.first_form else None
    print(json.dumps({"build_seconds": time.perf_counter() - t0, "compiled": compiled}), flush=True)
    report = {"device": smi, "shapes": []}
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(chip_smoke.SEED)
    cases = [("cosine_attention", name, chip_smoke.cosine_case) for name in chip_smoke.COSINE_SHAPES]
    cases += [("fused_attention", name, chip_smoke.fused_case) for name in chip_smoke.FUSED_SHAPES]
    for kernel, name, make in cases:
        case = make(torch, F, gen, dev, name)
        got = case.run()
        err = case.check(got, case.probs) if kernel == "cosine_attention" else case.check(got)
        row = chip_smoke.attention_row(torch, case, name, None, None)
        row.update(name=name, shape=list(case.shape), max_abs_err=err)
        if first is not None:
            made = (first_cosine if kernel == "cosine_attention" else first_fused)(torch, first[kernel], case)
            if made is None:
                row["first_form_ms"] = "does not fit"
            else:
                run, check = made
                row["first_form_max_abs_err"] = check()
                ff = [chip_smoke.graph_ms(torch, run) for _ in range(2)]
                row["ms_again"] = chip_smoke.graph_ms(torch, case.run)
                row["first_form_ms"] = min(ff)
                row["x_first_form"] = row["first_form_ms"] / min(row["ms"], row["ms_again"])
        row["x_library"] = row["ms"] / row["library_ms"]
        report["shapes"].append(row)
        print(json.dumps(row), flush=True)
    report["order_witness"] = order_witness(torch, gen, dev)
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(report, f, indent=1)
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
