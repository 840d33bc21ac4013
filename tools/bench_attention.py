#!/usr/bin/env python3
"""Time the attention kernels and the attention backward's products on one
NVIDIA GPU through chip_smoke.py's own checks and timing (device ms of
CUDA-graph replays beside the plain version, the bound and the library
yardstick), and, optionally, their first forms on the same inputs in the
same call.

    python tools/bench_attention.py [--part forward|backward|out-gate|all] \\
        [--first-form DIR] [--parent DIR] [--out results/bench_attention.json]

``forward``: ``cosine_attention`` and ``fused_attention``
(``mapdit_tpu_torch/csrc/cosine_attention.cu``, ``fused_attention.cu``) at
every shape of ``chip_smoke.COSINE_SHAPES`` and ``chip_smoke.FUSED_SHAPES``
(``cosine_case`` / ``fused_case`` held against the plain versions, SDPA
beside), then the order witness: the bf16 no-cosine case at input scales 2
(the phase-3 row's) and 6, kernel and plain version (on the card and on the
CPU, whose f32 sums run in other orders) each against a float64 evaluation
of the same roundings (``chip_smoke.order_witness``).

``backward``: ``attention_bwd`` (``csrc/attn_branch_bwd.cu``) at every
shape of ``chip_smoke.ATTN_BWD_SHAPES`` (``attn_bwd_case``'s check, SDPA's
forward and backward beside), the modulate passes around the backward's
products (``modulate_fwd``, ``modulate_bwd`` of the same source) at every
shape of ``chip_smoke.MODULATE_SHAPES`` (``modulate_case``'s check,
``torch.addcmul`` beside ``modulate_fwd``), the out product with the
residual backward as its epilogue (``out_gate_residual_bwd``,
``csrc/mp_gemm.cu``; the ``out-gate`` part alone) at every shape of
``chip_smoke.OUT_GATE_SHAPES`` (``out_gate_case``'s check, the bound, the
product alone as one ``torch.matmul``, host ms), and ``dw_gemm``
(``csrc/dw_gemm.cu``) at the
DiT-S/2 and DiT-B/2 training pairs of ``chip_smoke.DW_PAIRS`` and at
DiT-XL/2's (1e-4 + 1e-4 relative against the plain version, the same bits
on two runs, the bf16 cuBLAS pair and the f32 ``torch.matmul`` pair
beside). Each product of a
pair is also run under every plan of cluster size CS in {1, 2, 4, 8} and G
in {1, 2, 4, 8, 16, 32} groups (and the default's G) whose splits are at
least four k steps deep, timed beside the default plan with its error
against the plain version, so the thresholds of ``plan()`` can be read
against the card.

``--parent DIR`` names the ``csrc`` of the tree before the residual
backward moved into the out product's epilogue (e.g. ``git archive`` of
that commit): its ``mp_gemm.cu`` and ``attn_branch_bwd.cu`` are built and
every ``out-gate`` shape also runs the pair it replaced on the same
inputs, the product with an f32 ``out`` store, then ``gate_residual_bwd``
(held to the same plain version), timed fused, pair, pair, fused, each
launch of the pair timed alone beside.

``--first-form DIR`` names a directory holding earlier sources of the
part's kernels (e.g. ``mapdit_tpu_torch/csrc`` of a ``git archive`` of an
earlier tree; their C interfaces are the ones below: the modulate passes'
first forms took the f32 residual path dx0, made here outside the timed
call). They are built with
the port's nvcc flags, called on the same inputs, held to the same check
and timed new, first, first, new; a shape a first form cannot take (its
shared memory grows as T^2) is reported as such. Prints one JSON line a
shape and the card's name and power limit; writes all of it to ``--out``.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import math
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
FIRST_FORM = {
    "forward": {
        "cosine_attention": {
            "cosine_attention": ([_P, _P, _I, _P, _I, _I, _I, _I, _I, _P], _I),
            "cosine_attention_smem_bytes": ([_I, _I], ctypes.c_size_t),
        },
        "fused_attention": {
            "fused_attention": ([_P, _P, _P, _P, _I, _I, _I, _I, _I, _P, _F, _I, _I, _P], _I),
        },
    },
    "backward": {
        "attn_branch_bwd": {
            "attention_bwd": ([_P, _P, _P, _I, _I, _I, _I, _P], _I),
            "attention_bwd_smem_bytes": ([_I, _I], ctypes.c_size_t),
            "modulate_fwd": ([_P, _I, _P, _I, _I, _I, _P, _P, _I, _I, _I, _P], _I),
            "modulate_bwd_partials": ([_I, _I], _I),
            "modulate_bwd": ([_P, _P, _I, _P, _I, _I, _I, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _P], _I),
        },
        "dw_gemm": {"dw_gemm": ([_P, _P, _P, _P, _I, _I, _I, _F, _P], _I), "dw_gemm_splits": ([_I, _I, _I], _I)},
    },
}
# the parent's pair: its mp_gemm (this tree's C interface) and the residual
# pass of its attn_branch_bwd.cu
PARENT = {
    "mp_gemm": {
        "mp_gemm": ([_P, _I, _P, _P, _I, _I, _I, _I, _F, _I, _P, _I, _I, _I, _I, _P, _I, _I, _P, _I, _I, _P, _P, _P],
                    _I),
        "mp_gemm_splits": ([_I, _I, _I], _I),
    },
    "attn_branch_bwd": {"gate_residual_bwd": ([_P, _I, _P, _P, _I, _I, _P, _P, _I, _I, _I, _P], _I)},
}
DW_MIN_STEPS, DW_BK = 4, 64  # dw_gemm.cu's MIN_STEPS and BK
# chip_smoke's S/2 and B/2 pairs and DiT-XL/2's (D = 1152) at batch 256 x 64
# tokens, off the smoke
DW_PAIRS = dict(chip_smoke.DW_PAIRS, xl=((16384, 3456, 1152), (16384, 1152, 1152)))


def load_first_form(build, directory: str, parts, sources=None, suffix="first_form") -> dict:
    """The first forms' libraries of ``parts`` (or the libraries named in
    ``sources``, {name: signatures}), built in parallel into the build
    directory."""
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    if sources is None:
        sources = {name: fns for part in parts for name, fns in FIRST_FORM[part].items()}
    procs = {}
    for name in sources:
        target = build.BUILD_DIR / f"{name}_{suffix}.so"
        cmd = [build._nvcc(), *build.NVCC_FLAGS, "-o", str(target), os.path.join(directory, f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd), target)
    libs = {}
    for name, (proc, target) in procs.items():
        if proc.wait() != 0:
            raise RuntimeError(f"{suffix} {name}: nvcc exit {proc.returncode}")
        lib = ctypes.CDLL(str(target))
        for fn, (argtypes, restype) in sources[name].items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = restype
        libs[name] = lib
    return libs


def _raise_on(code):
    if code:
        raise RuntimeError(f"first form: CUDA error {code}")


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
        _raise_on(lib.cosine_attention(
            case.qkv.data_ptr(), out.data_ptr(), 1, probs.data_ptr() if probs is not None else None,
            1 if case.residual else 0, n, t, heads, hd, torch.cuda.current_stream().cuda_stream))
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
        _raise_on(lib.fused_attention(
            case.q.data_ptr(), case.k.data_ptr(), case.v.data_ptr(), out.data_ptr(), dtype, n, h, t, hd, strides,
            float(case.scale), 1 if case.cosine else 0, qt, torch.cuda.current_stream().cuda_stream))
        return out

    return run, lambda: case.check(run())


def first_attention_bwd(torch, lib, case):
    """The first form's call on an attention_bwd case's inputs, or None where
    its shared memory does not fit."""
    from mapdit_tpu_torch.ops.cuda.dit_block import MAX_SMEM_BYTES

    n, t, heads, hd = case.shape
    if lib.attention_bwd_smem_bytes(t, hd) > MAX_SMEM_BYTES:
        return None
    out = torch.empty(n * t, 3 * heads * hd, dtype=torch.bfloat16, device=case.qkv.device)

    def run():
        _raise_on(lib.attention_bwd(case.qkv.data_ptr(), case.dattn.data_ptr(), out.data_ptr(), n, t, heads, hd,
                                    torch.cuda.current_stream().cuda_stream))
        return out

    return run, lambda: chip_smoke.rel_l2(run(), case.plain())


def first_modulate(torch, lib, kernel, case):
    """The first form's call of a modulate_case kernel on the case's inputs
    (x and dy bf16) and its check: every output against the plain version
    at phase 3's limits, the max abs error returned."""
    from mapdit_tpu_torch.ops.cuda import attn_branch as ab

    v = case.inputs
    x, dy, rows, gain, dh = (v[key] for key in ("x", "dy", "rows", "gain", "dh"))
    n, t, d = case.shape
    dev, f32, bf = x.device, torch.float32, torch.bfloat16
    dx0 = dy.float() * ab.DX_FAC
    outs = {
        "modulate_fwd": (torch.empty(n * t, d, dtype=bf, device=dev),),
        "modulate_bwd": (torch.empty_like(x), torch.empty(n, d, dtype=f32, device=dev),
                         torch.empty(n, d, dtype=f32, device=dev), torch.empty(1, dtype=f32, device=dev)),
    }[kernel]
    partial = torch.empty(lib.modulate_bwd_partials(n, d), dtype=f32, device=dev)

    def run():
        stream = torch.cuda.current_stream().cuda_stream
        if kernel == "modulate_fwd":
            code = lib.modulate_fwd(x.data_ptr(), 1, rows.data_ptr(), 3 * d, 0, d, gain.data_ptr(), outs[0].data_ptr(),
                                    n, t, d, stream)
        else:
            code = lib.modulate_bwd(dh.data_ptr(), x.data_ptr(), 1, rows.data_ptr(), 3 * d, 0, d, gain.data_ptr(),
                                    dx0.data_ptr(), *(o.data_ptr() for o in outs[:3]), partial.data_ptr(),
                                    outs[3].data_ptr(), n, t, d, stream)
        _raise_on(code)
        return outs

    def check():
        got, want = run(), case.plain()
        want = want if isinstance(want, tuple) else (want,)
        return max(chip_smoke.compare(torch, g_, w_, 1e-2, 1e-2, f"{kernel}:first:{i}")
                   for i, (g_, w_) in enumerate(zip(got, want)))

    return run, check


def modulate_rows(torch, gen, dev, first) -> list:
    rows = []
    for name in chip_smoke.MODULATE_SHAPES:
        for kernel, case in chip_smoke.modulate_case(torch, gen, dev, name).items():
            err = case.check(case.run())
            row = chip_smoke.pass_row(torch, case, None)
            row.update(name=f"{kernel}:{name}", shape=list(case.shape), max_abs_err=err)
            if first is not None:
                with_first_form(torch, row, case.run, first_modulate(torch, first["attn_branch_bwd"], kernel, case))
            row["x_bound"] = row["ms"] / row["bound_ms"]
            if row["library_ms"]:
                row["x_library"] = row["ms"] / row["library_ms"]
            rows.append(row)
            print(json.dumps(row), flush=True)
    return rows


def parent_pair(torch, libs, case):
    """The route the fused call replaced, on an out_gate_case's inputs,
    through the parent's libraries: the product into an f32 out (mp_gemm,
    split K where it splits), then gate_residual_bwd. Returns the pair's
    run and each launch's run."""
    v = case.inputs
    attn, w, dy, rows = (v[key] for key in ("attn", "w", "dy", "rows"))
    n, t, d = case.shape
    m, dev, f32 = n * t, attn.device, torch.float32
    gemm, resid = libs["mp_gemm"], libs["attn_branch_bwd"]
    splits = gemm.mp_gemm_splits(m, d, d)
    partial = torch.empty(splits, m, d, dtype=f32, device=dev) if splits > 1 else None
    out = torch.empty(m, d, dtype=f32, device=dev)
    dout = torch.empty(m, d, dtype=torch.bfloat16, device=dev)
    dgate = torch.empty(n, d, dtype=f32, device=dev)

    def product():
        _raise_on(gemm.mp_gemm(attn.data_ptr(), 1, w.data_ptr(), out.data_ptr(), 0, m, d, d, 1 / math.sqrt(d), 0, None,
                               0, 0, 0, 0, None, t, 0, None, 0, 0, None,
                               None if partial is None else partial.data_ptr(), torch.cuda.current_stream().cuda_stream))
        return out

    def residual():
        _raise_on(resid.gate_residual_bwd(dy.data_ptr(), 1, out.data_ptr(), rows.data_ptr(), 3 * d, 2 * d,
                                          dout.data_ptr(), dgate.data_ptr(), n, t, d,
                                          torch.cuda.current_stream().cuda_stream))
        return dout, dgate

    def pair():
        product()
        return residual()

    return pair, product, residual


def out_gate_rows(torch, gen, dev, parent) -> list:
    """Every OUT_GATE_SHAPES entry: out_gate_case's check and row (device
    ms, plain ms, bound, torch.matmul of the product alone, host ms); with
    the parent's libraries, the pair it replaced held to the same plain
    version and timed in turns (fused, pair, pair, fused), each launch of
    the pair alone beside."""
    rows = []
    for name in chip_smoke.OUT_GATE_SHAPES:
        case = chip_smoke.out_gate_case(torch, gen, dev, name)
        err = case.check(case.run())
        row = chip_smoke.pass_row(torch, case, None, chip_smoke.GEMM_SRC)
        row.update(name=f"out_gate_residual:{name}", shape=list(case.shape), max_abs_err=err)
        if parent is not None:
            pair, product, residual = parent_pair(torch, parent, case)
            want = case.plain()
            row["parent_pair_err"] = max(chip_smoke.compare(torch, g_, w_, 1e-2, 1e-2, f"out_gate_residual:{name}:parent:{i}")
                                         for i, (g_, w_) in enumerate(zip(pair(), want)))
            turns = [chip_smoke.graph_ms(torch, fn) for fn in (case.run, pair, pair, case.run)]
            row.update(ms_turns=turns, parent_pair_ms=min(turns[1:3]),
                       x_parent_pair=min(turns[0], turns[3]) / min(turns[1:3]),
                       parent_product_ms=chip_smoke.graph_ms(torch, product),
                       parent_residual_ms=chip_smoke.graph_ms(torch, residual),
                       parent_pair_host_ms=chip_smoke.host_ms(torch, pair))
        row["x_bound"] = row["ms"] / row["bound_ms"]
        row["x_library"] = row["ms"] / row["library_ms"]
        rows.append(row)
        print(json.dumps(row), flush=True)
    return rows


def first_dw(torch, lib, a, b, alpha):
    m, p = a.shape
    q = b.shape[1]
    partial = torch.empty(lib.dw_gemm_splits(m, p, q), p, q, dtype=torch.float32, device=a.device)
    c = torch.empty(p, q, dtype=torch.float32, device=a.device)

    def run():
        _raise_on(lib.dw_gemm(a.data_ptr(), b.data_ptr(), partial.data_ptr(), c.data_ptr(), m, p, q, alpha,
                              torch.cuda.current_stream().cuda_stream))
        return c

    return run


def with_first_form(torch, row, case_run, made):
    """Times a first form (``made``: its run and its check, or None) beside
    the kernel: new, first, first, new."""
    if made is None:
        row["first_form_ms"] = "does not fit"
        return
    run, check = made
    row["first_form_err"] = check()
    ff = [chip_smoke.graph_ms(torch, run) for _ in range(2)]
    row["ms_again"] = chip_smoke.graph_ms(torch, case_run)
    row["first_form_ms"] = min(ff)
    row["x_first_form"] = row["first_form_ms"] / min(row["ms"], row["ms_again"])


def forward_rows(torch, F, gen, dev, first) -> dict:
    rows = []
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
            with_first_form(torch, row, case.run, made)
        row["x_library"] = row["ms"] / row["library_ms"]
        rows.append(row)
        print(json.dumps(row), flush=True)
    return dict(shapes=rows, order_witness=order_witness(torch, gen, dev))


def order_witness(torch, gen, dev) -> list:
    """chip_smoke.order_witness at the bf16 no-cosine shape, input scales 2
    and 6, for the plain version on the card and on the CPU."""
    from mapdit_tpu_torch.ops.cuda import attention as at

    name = "fused_attention:bf16-no-cosine-logits>88"
    (n, h, t, hd), _, _, _, atol, rtol = chip_smoke.FUSED_SHAPES[name]
    rows = []
    for scale_in in (2.0, 6.0):
        qkv = (torch.randn(n, t, 3 * h * hd, generator=gen, device=dev) * scale_in).to(torch.bfloat16)
        q, k, v = (z.reshape(n, t, h, hd).transpose(1, 2) for z in qkv.split(h * hd, dim=-1))
        got = at.fused_attention(q, k, v, 1.0, False)
        plain_cpu = at.fused_attention_plain(q.cpu(), k.cpu(), v.cpu(), 1.0, False).to(dev)
        row = dict(input_scale=scale_in,
                   max_abs_logit=float((q.float() @ k.float().transpose(-1, -2)).abs().max()),
                   card=chip_smoke.order_witness(torch, name, q, k, v, 1.0, got,
                                                 at.fused_attention_plain(q, k, v, 1.0, False), atol, rtol),
                   cpu=chip_smoke.order_witness(torch, name + ":cpu", q, k, v, 1.0, got, plain_cpu, atol, rtol))
        rows.append(row)
        print(json.dumps({"order_witness": row}), flush=True)
    return rows


def backward_rows(torch, F, gen, dev, first, parent) -> list:
    rows = []
    for name in chip_smoke.ATTN_BWD_SHAPES:
        case = chip_smoke.attn_bwd_case(torch, F, gen, dev, name)
        err = case.check(case.run())
        row = chip_smoke.attention_row(torch, case, name, None, None)
        row.update(name=name, shape=list(case.shape), rel_l2_err=err)
        if first is not None:
            with_first_form(torch, row, case.run, first_attention_bwd(torch, first["attn_branch_bwd"], case))
        row["x_library"] = row["ms"] / row["library_ms"]
        rows.append(row)
        print(json.dumps(row), flush=True)
    return (rows + modulate_rows(torch, gen, dev, first) + out_gate_rows(torch, gen, dev, parent)
            + dw_rows(torch, gen, dev, first))


def dw_check(torch, ab, got, run, a, b, alpha, what) -> float:
    err = chip_smoke.compare(torch, got, ab.dw_gemm_plain(a, b, alpha), 1e-4, 1e-4, what)
    if not torch.equal(got, run()):
        raise AssertionError(f"{what}: two runs on the same inputs differ in their bits")
    return err


def dw_plans(torch, ab, lib, a, b, alpha, what) -> list:
    """One product under every plan the sweep names (module docstring):
    each timed, with its k steps a split, its max abs error against the
    plain version and whether that lies within dw_gemm's 1e-4 + 1e-4
    relative (reported, not raised: the sweep also reads plans the kernel
    does not take); two runs must give the same bits. The default plan's G
    beside."""
    m, p = a.shape
    q = b.shape[1]
    default_g = lib.dw_gemm_splits(m, p, q)
    steps = -(-m // DW_BK)
    c = torch.empty(p, q, dtype=torch.float32, device=a.device)
    partial = torch.empty(max(32, default_g), p, q, dtype=torch.float32, device=a.device)
    want = ab.dw_gemm_plain(a, b, alpha)
    out = []
    for cs in (1, 2, 4, 8):
        for g in sorted({1, 2, 4, 8, 16, 32, default_g}):
            if cs * g * DW_MIN_STEPS > steps:
                continue

            def run(cs=cs, g=g):
                code = lib.dw_gemm_planned(a.data_ptr(), b.data_ptr(), partial.data_ptr(), c.data_ptr(), m, p, q,
                                           alpha, cs, g, torch.cuda.current_stream().cuda_stream)
                if code:
                    raise RuntimeError(f"{what}: dw_gemm_planned({cs}, {g}): {lib.dw_gemm_error_string(code)}")
                return c

            got = run().clone()
            if not torch.equal(got, run()):
                raise AssertionError(f"{what}:{cs}x{g}: two runs on the same inputs differ in their bits")
            err = (got - want).abs()
            out.append(dict(cs=cs, groups=g, steps=-(-steps // (cs * g)), ms=chip_smoke.graph_ms(torch, run),
                            max_abs_err=float(err.max()), within=bool((err <= 1e-4 + 1e-4 * want.abs()).all())))
    best = min((r for r in out if r["within"]), key=lambda r: r["ms"])
    default_ms = chip_smoke.graph_ms(torch, lambda: ab.dw_gemm(a, b, alpha))
    print(json.dumps({"dw_plans": what, "default_groups": default_g, "default_ms": default_ms, "best": best,
                      "x_best": default_ms / best["ms"], "plans": out}), flush=True)
    return dict(default_groups=default_g, default_ms=default_ms, plans=out)


def dw_rows(torch, gen, dev, first) -> list:
    from mapdit_tpu_torch.ops.cuda import attn_branch as ab
    from mapdit_tpu_torch.ops.cuda import build

    lib = build.library("dw_gemm")
    rows = []
    for name, pair in DW_PAIRS.items():
        ops = []
        for m, p, q in pair:
            a = torch.randn(m, p, generator=gen, device=dev).to(torch.bfloat16)
            b = torch.randn(m, q, generator=gen, device=dev).to(torch.bfloat16)
            ops.append((a, b, 1 / math.sqrt(q)))
        err = max(dw_check(torch, ab, ab.dw_gemm(a, b, alpha), lambda a=a, b=b, alpha=alpha: ab.dw_gemm(a, b, alpha),
                           a, b, alpha, f"dw_gemm:{name}:{i}") for i, (a, b, alpha) in enumerate(ops))

        def pair_run():
            return [ab.dw_gemm(a, b, alpha) for a, b, alpha in ops]

        flops = sum(2 * a.shape[0] * a.shape[1] * b.shape[1] for a, b, _ in ops)
        nbytes = sum((a.numel() + b.numel()) * 2 + a.shape[1] * b.shape[1] * 4 for a, b, _ in ops)
        bound, by = chip_smoke.bound_ms(flops, nbytes)
        row = dict(name=f"dw_gemm:{name}", shapes=[list(s) for s in pair], max_abs_err=err,
                   ms=chip_smoke.graph_ms(torch, pair_run),
                   plain_ms=chip_smoke.graph_ms(torch, lambda: [ab.dw_gemm_plain(a, b, alpha) for a, b, alpha in ops]),
                   bound_ms=bound, bound_by=by,
                   library_ms=chip_smoke.graph_ms(torch, lambda: [torch.matmul(a.t(), b) for a, b, _ in ops]),
                   f32_matmul_ms=chip_smoke.graph_ms(
                       torch, lambda: [(a.t().float() @ b.float()) * alpha for a, b, alpha in ops]))
        if first is not None:
            runs = [first_dw(torch, first["dw_gemm"], a, b, alpha) for a, b, alpha in ops]

            def first_check():
                return max(chip_smoke.compare(torch, run(), ab.dw_gemm_plain(a, b, alpha), 1e-4, 1e-4,
                                              f"dw_gemm:{name}:{i}:first")
                           for i, (run, (a, b, alpha)) in enumerate(zip(runs, ops)))

            with_first_form(torch, row, pair_run, (lambda: [run() for run in runs], first_check))
        row["x_library"] = row["ms"] / row["library_ms"]
        row["plans"] = [dw_plans(torch, ab, lib, a, b, alpha, f"dw_gemm:{name}:{i}") for i, (a, b, alpha) in enumerate(ops)]
        rows.append(row)
        print(json.dumps({k: v for k, v in row.items() if k != "plans"}), flush=True)
    return rows


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--part", choices=("forward", "backward", "out-gate", "all"), default="all")
    parser.add_argument("--first-form", default=None, help="directory of the part's first-form sources")
    parser.add_argument("--parent", default=None,
                        help="csrc of the tree whose out product stored f32 out for gate_residual_bwd")
    parser.add_argument("--out", default=os.path.join(REPO, "results", "bench_attention.json"))
    args = parser.parse_args()

    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        print("bench_attention: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    from mapdit_tpu_torch.ops.cuda import build

    parts = ("forward", "backward") if args.part == "all" else (args.part,)
    smi = chip_smoke.smi_line()
    print(smi, flush=True)
    t0 = time.perf_counter()
    compiled = build.build_all()
    first = load_first_form(build, args.first_form, [p for p in parts if p != "out-gate"]) if args.first_form else None
    parent = load_first_form(build, args.parent, (), PARENT, "parent") if args.parent else None
    print(json.dumps({"build_seconds": time.perf_counter() - t0, "compiled": compiled}), flush=True)
    report = {"device": smi}
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(chip_smoke.SEED)
    if "forward" in parts:
        report["forward"] = forward_rows(torch, F, gen, dev, first)
    if "backward" in parts:
        report["backward"] = backward_rows(torch, F, gen, dev, first, parent)
    if "out-gate" in parts:
        report["out_gate"] = out_gate_rows(torch, gen, dev, parent)
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(report, f, indent=1)
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
