"""Check and time the tensor-parallel partial kernels
(``mapdit_tpu_torch/csrc/dit_block_tp.cu``: ``tp_attn`` for rows 6 and 7,
``tp_mlp`` for row 8) on one NVIDIA GPU at the DiT-XL/2 shard shapes of
tp=2 and tp=4, and hold the cases ``chip_smoke.py`` phase 3 checks them on.

    python -m mapdit_tpu_torch.tools.bench_tp_kernels [--check-only] [--ptxas] [--trace] \\
        [--out results/bench_tp.json]

``--check-only`` builds and runs each kernel against its plain version at
T = 64, 16 and 4 (rel L2 1e-2, row 7's mods 1e-4, the same bits twice) and
times nothing: the first call after a change. Otherwise each row and one
XL/2 ``fused_dit_block_tp`` without its all-reduces are timed, kernel
route beside the launch sequences it replaced: device ms of CUDA-graph
replays, host ms a call, and eager ms (a host-launched loop, as the
program runs them); and rows 7 and 8 back to back in one graph. ``--ptxas`` first prints the registers, shared memory
and spills nvcc reports for the source. ``--trace`` prints where one
launch's time goes at tp=2 (the kernel's own clock: the ms a CTA spends in
each stage, mean and max over CTAs, and the launch's span). All at 8
samples of 64 tokens, phase 3's rows. Prints one line a check and a timing
and the card's name and power limit; writes the rows to ``--out``.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import math
import os
import subprocess
import sys

import torch
import torch.nn.functional as F

from mapdit_tpu_torch.ops.cuda import dit_block_tp as tpk
from mapdit_tpu_torch.utils import timing

TP_WAYS = (2, 4)  # the XL/2 shards: tp=2 the report rows, tp=4 checked and timed
XL_D, XL_HEADS, XL_HIDDEN = 1152, 16, 4608
SAMPLES = 8  # 4 pre-CFG samples, 8 rows a model call
STAGES = {"attn": ("modulation", "pre", "qkv", "attention", "out"), "mlp": ("modulation", "pre", "fc1", "fc2")}


def tp_cases(gen, dev, tp: int, t: int = 64, n: int = SAMPLES) -> dict:
    """The three TP partials at one DiT-XL/2 shard (D=1152, 16 heads of 72,
    H=4608, bf16; ``tp`` ranks: D_l = 1152 / tp, H_l = 4608 / tp) on n
    samples of t tokens: name -> (kernel wrapper, launch sequence, plain
    version, arguments, pallas_call line, FLOPs, bytes, library call). The
    library yardstick is the bf16 torch.matmul products and SDPA of the
    same work. Rows 6 and 8 take bf16 shift and scale rows here; the block
    (:func:`block_call`) gives row 8 f32 views of row 7's mods, as the
    program does."""
    from mapdit_tpu_torch.ops.mp import mp_silu, normalize

    bf, f32 = torch.bfloat16, torch.float32
    d, heads, hid = XL_D, XL_HEADS, XL_HIDDEN
    hd = d // heads

    def randn(*shape, dtype=f32):
        return torch.randn(*shape, generator=gen, device=dev).to(dtype)

    def weight(*shape):
        return normalize(randn(*shape)).to(bf).contiguous()

    x = randn(n, t, d, dtype=bf)
    a = mp_silu(randn(n, d)).to(bf)
    shift, scale = randn(n, d, dtype=bf), randn(n, d, dtype=bf)
    gains = torch.rand(2, generator=gen, device=dev) * 0.6 + 0.2
    w_mod = weight(6 * d, d)
    xf = x.reshape(n * t, d)
    d_l, h_l, hl = d // tp, hid // tp, heads // tp
    w_qkv, w_out, w1, w2 = weight(3 * d_l, d), weight(d, d_l), weight(h_l, d), weight(d, h_l)
    inv_h = 1 / math.sqrt(hid)
    q, k_, v = (z.contiguous() for z in torch.matmul(xf, w_qkv.t()).reshape(n, t, 3, hl, hd).permute(2, 0, 3, 1, 4))
    attn = randn(n * t, d_l, dtype=bf)

    def attn_library():
        return (torch.matmul(xf, w_qkv.t()), F.scaled_dot_product_attention(q, k_, v, scale=1 / math.sqrt(hd)),
                torch.matmul(attn, w_out.t()))

    attn_flops = 2 * n * t * d * 4 * d_l + 4 * n * hl * t * t * hd
    attn_bytes = n * t * d * 2 + 4 * d * d_l * 2 + n * t * d * 4
    return {
        "attn_tp_partial": (tpk.attn_tp_partial, tpk.attn_tp_launch_sequence, tpk.attn_tp_partial_plain,
                            (x, shift, scale, gains[0], w_qkv, w_out, hl), 1467, attn_flops,
                            attn_bytes + 2 * n * d * 2 + 4, attn_library),
        "block_tp_attn": (tpk.block_tp_attn, tpk.block_tp_launch_sequence, tpk.block_tp_attn_plain,
                          (x, a, gains, w_mod, w_qkv, w_out, hl), 1640, attn_flops + 2 * n * d * 6 * d,
                          attn_bytes + n * d * 2 + 8 + 6 * d * d * 2 + n * 6 * d * 4,
                          lambda: (torch.matmul(a, w_mod.t()), *attn_library())),
        "mlp_tp_partial": (tpk.mlp_tp_partial, tpk.mlp_tp_launch_sequence, tpk.mlp_tp_partial_plain,
                           (x, shift, scale, gains, w1, w2, inv_h), 1739, 4 * n * t * d * h_l,
                           n * t * d * 2 + 2 * n * d * 2 + 8 + 2 * d * h_l * 2 + n * t * d * 4,
                           lambda: torch.matmul(torch.matmul(xf, w1.t()), w2.t())),
    }


class _NoAllReduce:
    all_reduce = staticmethod(lambda *args, **kwargs: None)


@contextlib.contextmanager
def _block_route(route: str):
    """``fused_dit_block_tp`` as the program runs it on one rank, with its
    two all-reduces skipped; ``route`` "sequence" swaps in the launch
    sequences the kernels replaced."""
    saved = tpk.dist, tpk.block_tp_attn, tpk.mlp_tp_partial
    tpk.dist = _NoAllReduce
    if route == "sequence":
        tpk.block_tp_attn, tpk.mlp_tp_partial = tpk.block_tp_launch_sequence, tpk.mlp_tp_launch_sequence
    try:
        yield
    finally:
        tpk.dist, tpk.block_tp_attn, tpk.mlp_tp_partial = saved


def block_call(cases: dict, route: str):
    """One XL/2 block on one rank, ``fused_dit_block_tp`` minus its
    all-reduces, through ``route`` ("kernel": the two dit_block_tp
    launches; "sequence": the twelve launches they replaced), on the
    cases' row-7 and row-8 inputs."""
    x, a, gains, w_mod, w_qkv, w_out, hl = cases["block_tp_attn"][3]
    w1, w2 = cases["mlp_tp_partial"][3][4:6]

    def call():
        with torch.no_grad(), _block_route(route):
            return tpk.fused_dit_block_tp(x, a, gains, w_mod, w_qkv, w_out, w1, w2, heads_local=hl,
                                          hidden_total=XL_HIDDEN)

    return call


def times(fn, seq=None) -> dict:
    """A call's graph, host and eager ms, and its launch sequence's beside."""
    out = dict(ms=timing.graph_ms(fn), host_ms=timing.host_ms(fn), eager_ms=timing.eager_ms(fn))
    if seq is not None:
        out.update(sequence_ms=timing.graph_ms(seq), sequence_host_ms=timing.host_ms(seq),
                   sequence_eager_ms=timing.eager_ms(seq))
    return out


def device_ops(fn, calls: int = 5) -> float:
    """Device operations (kernels, copies, fills) a call, from a
    torch.profiler trace of ``calls`` calls after a warm-up one."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    device = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA
              and not getattr(e, "is_user_annotation", False) and e.self_device_time_total > 0]
    return sum(e.count for e in device) / calls


def smi_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def ptxas() -> None:
    from mapdit_tpu_torch.ops.cuda import build

    src = build.CSRC / "dit_block_tp.cu"
    cmd = [build._nvcc(), *build.NVCC_FLAGS, "-Xptxas", "-v", "-o", os.devnull, str(src)]
    out = subprocess.run(cmd, capture_output=True, text=True, check=True)
    for line in (out.stdout + out.stderr).splitlines():
        if "registers" in line or "spill" in line or "Function properties" in line:
            print("[ptxas]", line.strip(), flush=True)


def _launch(name, args, trace):
    """One call of the kernel under a row's wrapper, with its trace."""
    x = args[0]
    if name == "mlp_tp_partial":
        _, shift, scale, gains, w1, w2, inv_h = args
        return tpk.tp_mlp(x, shift, scale, gains[1:2].float().contiguous(), w1, w2, inv_h, trace=trace)
    if name == "attn_tp_partial":
        _, shift, scale, gain, w_qkv, w_out, hl = args
        return tpk.tp_attn(x, shift, scale, tpk._gain(gain, x.device), w_qkv, w_out, hl, trace=trace)
    _, a, gains, w_mod, w_qkv, w_out, hl = args
    return tpk.tp_attn(x, None, None, gains[0:1].float().contiguous(), w_qkv, w_out, hl, a=a, w_mod=w_mod,
                       trace=trace)


def timeline(name, args) -> dict:
    """One launch with the kernel's trace on: the span from the first CTA's
    start to the last CTA's end, and for each stage the ms a CTA spent on
    its items (mean and max over CTAs; an item's time includes its waits)."""
    x = args[0]
    n, t, d = x.shape
    if name == "mlp_tp_partial":
        plan = tpk.tp_plan("mlp", n, t, d, args[4].shape[0], ctas=tpk._resident_ctas(x.get_device(), 0))
    else:
        w_out, hl = args[5], args[6]
        plan = tpk.tp_plan("attn", n, t, d, w_out.shape[1], hl, name == "block_tp_attn",
                           tpk._resident_ctas(x.get_device(), w_out.shape[1] // hl))
    trace = torch.zeros(plan.trace_words, dtype=torch.int64, device=x.device)
    _launch(name, args, trace)
    torch.cuda.synchronize()
    tr = trace.view(plan.ctas, tpk.TP_TRACE_WORDS).double().cpu()
    out = {"span_ms": float(tr[:, 7].max() - tr[:, 6].min()) / 1e6}
    for i, kind in enumerate(STAGES["mlp" if name == "mlp_tp_partial" else "attn"]):
        out[f"{kind}_mean_ms"] = float(tr[:, i].mean()) / 1e6
        out[f"{kind}_max_ms"] = float(tr[:, i].max()) / 1e6
    out["pre_body_mean_ms"] = float(tr[:, 5].mean()) / 1e6
    items = float(tr[:, 12].sum())
    for w, part in ((8, "mainloop"), (9, "epilogue"), (10, "partial_ticket"), (11, "split_sum")):
        out[f"{part}_ms_an_item"] = float(tr[:, w].sum()) / 1e6 / items
    out["last_cta_start_ms"] = float(tr[:, 6].max() - tr[:, 6].min()) / 1e6
    return out


def rel_l2(got, want) -> float:
    return float((got.float() - want.float()).norm() / want.float().norm())


def check(what, fn, plain, args) -> dict:
    """The kernel route against its plain version: rel L2 1e-2 (row 7's
    mods: |err| <= 1e-4 + 1e-4 |want|) and the same bits on two runs."""
    got, again, want = fn(*args), fn(*args), plain(*args)
    mods_ok = True
    if isinstance(got, tuple):
        mods_ok = bool(((got[1] - want[1]).abs() <= 1e-4 + 1e-4 * want[1].abs()).all())
        same = all(torch.equal(g, h) for g, h in zip(got, again))
        got, want = got[0], want[0]
    else:
        same = torch.equal(got, again)
    err = rel_l2(got, want)
    ok = math.isfinite(err) and err <= 1e-2 and mods_ok and same
    print(f"[check] what={what} rel_l2_err={err:.3e} mods_ok={mods_ok} same_bits_twice={same} ok={ok}", flush=True)
    if not ok:
        raise AssertionError(f"{what}: the kernel disagrees with its plain version")
    return {"rel_l2_err": err, "same_bits_twice": same}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--check-only", action="store_true")
    p.add_argument("--ptxas", action="store_true")
    p.add_argument("--trace", action="store_true")
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("bench_tp_kernels: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    from mapdit_tpu_torch.ops.cuda import build

    smi = smi_line()
    print(smi, flush=True)
    print("[build] compiled=" + json.dumps({n: round(s, 2) for n, s in build.build_all().items()}), flush=True)
    if args.ptxas:
        ptxas()
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    report = {"card": smi, "checks": {}, "times": {}}
    for tp in TP_WAYS:
        for t in ((64, 16, 4) if args.check_only else (64,)):
            cases = tp_cases(gen, dev, tp, t=t)
            for name, (fn, seq, plain, fargs) in ((k, v[:4]) for k, v in cases.items()):
                report["checks"][f"{name}:tp{tp}:t{t}"] = check(f"{name}:tp{tp}:t{t}", fn, plain, fargs)
            if args.check_only:
                continue
            for name, (fn, seq, _, fargs, *_, library) in cases.items():
                kernel, sequence = (lambda fn=fn, fargs=fargs: fn(*fargs)), (lambda seq=seq, fargs=fargs: seq(*fargs))
                row = dict(times(kernel, sequence), library_ms=timing.graph_ms(library), device_ops=device_ops(kernel),
                           sequence_device_ops=device_ops(sequence))
                report["times"][f"{name}:tp{tp}"] = row
                print(f"[time] kernel={name}:tp{tp} " + " ".join(f"{k}={v:.4f}" for k, v in row.items()), flush=True)
            kernel, sequence = block_call(cases, "kernel"), block_call(cases, "sequence")
            row = dict(times(kernel, sequence), device_ops=device_ops(kernel), sequence_device_ops=device_ops(sequence))
            # rows 7 and 8 back to back, as a block runs them: their weights take turns in L2
            row7, row8 = cases["block_tp_attn"], cases["mlp_tp_partial"]
            row.update(rows_7_8_ms=timing.graph_ms(lambda: (row7[0](*row7[3]), row8[0](*row8[3]))),
                       rows_7_8_sequence_ms=timing.graph_ms(lambda: (row7[1](*row7[3]), row8[1](*row8[3]))))
            report["times"][f"fused_dit_block_tp:tp{tp}"] = row
            print(f"[time] kernel=fused_dit_block_tp-without-all-reduce:tp{tp} "
                  + " ".join(f"{k}={v:.4f}" for k, v in row.items()), flush=True)
    if args.trace:
        cases = tp_cases(gen, dev, TP_WAYS[0])
        report["trace"] = {name: timeline(name, cases[name][3]) for name in cases}
        for name, row in report["trace"].items():
            print(f"[trace] kernel={name} " + " ".join(f"{k}={v:.4f}" for k, v in row.items()), flush=True)
    print(smi, flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(report, f, indent=1, default=str)
    return 0


if __name__ == "__main__":
    sys.exit(main())
