"""Check and time the tensor-parallel partial kernels
(``mapdit_tpu_torch/csrc/dit_block_tp.cu``: ``tp_attn`` for rows 6 and 7,
``tp_mlp`` for row 8) on one NVIDIA GPU at the DiT-XL/2 shard shapes of
tp=2 and tp=4, and hold the cases ``chip_smoke.py`` phase 3 checks them on.

    python -m mapdit_tpu_torch.tools.bench_tp_kernels [--check-only] [--f32] [--ptxas] [--trace] \\
        [--profiler-sessions N [--profiler-rounds R]] [--f32-splits R] [--out results/bench_tp.json]

``--check-only`` builds and runs each kernel against its plain version at
T = 64, 16 and 4 (rel L2 1e-2, row 7's mods 1e-4, the same bits twice) and
times nothing: the first call after a change. Otherwise each row and one
XL/2 ``fused_dit_block_tp`` without its all-reduces are timed, kernel
route beside the launch sequences it replaced: device ms of CUDA-graph
replays, host ms a call, and eager ms (a host-launched loop, as the
program runs them), and the device operations a call (``device_ops``: the
nodes of a captured CUDA graph); and rows 7 and 8 back to back in one
graph. ``--f32`` runs every case in f32, on the f32 instances.
``--ptxas`` first prints the registers, shared memory and spills nvcc
reports for the source. ``--trace`` prints where one launch's time goes
at tp=2 (the kernel's own clock: the ms a CTA spends in each stage, mean
and max over CTAs, the launch's span, us a k step in the mainloop). All
at 8 samples of 64 tokens, phase 3's rows. ``--profiler-sessions N`` only
counts the device operations a call of every case, bf16 and f32, by graph
and over N torch.profiler sessions with the trace's window padded and
without (``profiler_ops``: what the trace drops, where), R times over
(``--profiler-rounds``). ``--f32-splits R`` only times rows 6-8 and row
9 in f32 (B/2, N = 64) under each split rule of :data:`SPLIT_RULES`, in
turns, R rounds. Prints one line a check and a timing and the card's name
and power limit; writes the rows to ``--out``.
"""

from __future__ import annotations

import argparse
import contextlib
import ctypes
import json
import math
import os
import subprocess
import sys
import time

import torch
import torch.nn.functional as F

from mapdit_tpu_torch.ops.cuda import dit_block_tp as tpk
from mapdit_tpu_torch.utils import timing

TP_WAYS = (2, 4)  # the XL/2 shards: tp=2 the report rows, tp=4 checked and timed
XL_D, XL_HEADS, XL_HIDDEN = 1152, 16, 4608
SAMPLES = 8  # 4 pre-CFG samples, 8 rows a model call
STAGES = {"attn": ("modulation", "pre", "qkv", "attention", "out"), "mlp": ("modulation", "pre", "fc1", "fc2")}


def tp_cases(gen, dev, tp: int, t: int = 64, n: int = SAMPLES, dtype=torch.bfloat16) -> dict:
    """The three TP partials at one DiT-XL/2 shard (D=1152, 16 heads of 72,
    H=4608; ``tp`` ranks: D_l = 1152 / tp, H_l = 4608 / tp) on n samples of
    t tokens, x, the weights and the rows in ``dtype`` (bf16, or f32 for the
    f32 instances): name -> (kernel wrapper, launch sequence, plain version,
    arguments, pallas_call line, FLOPs, bytes, library call). The library
    yardstick is the torch.matmul products and SDPA of the same work in
    ``dtype``. Rows 6 and 8 take shift and scale rows of ``dtype`` here; the
    block (:func:`block_call`) gives row 8 f32 views of row 7's mods, as the
    program does."""
    from mapdit_tpu_torch.ops.mp import mp_silu, normalize

    bf, f32 = dtype, torch.float32
    e = torch.empty((), dtype=dtype).element_size()
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
    attn_bytes = n * t * d * e + 4 * d * d_l * e + n * t * d * 4
    return {
        "attn_tp_partial": (tpk.attn_tp_partial, tpk.attn_tp_launch_sequence, tpk.attn_tp_partial_plain,
                            (x, shift, scale, gains[0], w_qkv, w_out, hl), 1467, attn_flops,
                            attn_bytes + 2 * n * d * e + 4, attn_library),
        "block_tp_attn": (tpk.block_tp_attn, tpk.block_tp_launch_sequence, tpk.block_tp_attn_plain,
                          (x, a, gains, w_mod, w_qkv, w_out, hl), 1640, attn_flops + 2 * n * d * 6 * d,
                          attn_bytes + n * d * e + 8 + 6 * d * d * e + n * 6 * d * 4,
                          lambda: (torch.matmul(a, w_mod.t()), *attn_library())),
        "mlp_tp_partial": (tpk.mlp_tp_partial, tpk.mlp_tp_launch_sequence, tpk.mlp_tp_partial_plain,
                           (x, shift, scale, gains, w1, w2, inv_h), 1739, 4 * n * t * d * h_l,
                           n * t * d * e + 2 * n * d * e + 8 + 2 * d * h_l * e + n * t * d * 4,
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


# CUgraphNodeType names (cuda.h) of the nodes device_ops can meet
NODE_KINDS = {0: "kernel", 1: "memcpy", 2: "memset", 3: "host", 4: "graph", 5: "empty", 6: "wait_event",
              7: "event_record", 10: "mem_alloc", 11: "mem_free", 12: "batch_mem_op", 13: "conditional"}


class _KernelNodeParams(ctypes.Structure):
    # CUDA_KERNEL_NODE_PARAMS_v2 (cuda.h)
    _fields_ = [("func", ctypes.c_void_p), ("grid", ctypes.c_uint * 3), ("block", ctypes.c_uint * 3),
                ("shared", ctypes.c_uint), ("params", ctypes.c_void_p), ("extra", ctypes.c_void_p),
                ("kern", ctypes.c_void_p), ("ctx", ctypes.c_void_p)]


def _node_name(driver, node, kind: int) -> str:
    """A kernel node's function name (the driver's, mangled; "kernel" where
    the driver gives none), else the node's kind in brackets."""
    if kind != 0:
        return f"[{NODE_KINDS.get(kind, kind)}]"
    params, name = _KernelNodeParams(), ctypes.c_char_p()
    if driver.cuGraphKernelNodeGetParams_v2(node, ctypes.byref(params)) != 0:
        return "kernel"
    if params.func and driver.cuFuncGetName(ctypes.byref(name), ctypes.c_void_p(params.func)) == 0:
        return name.value.decode()
    if params.kern and driver.cuKernelGetName(ctypes.byref(name), ctypes.c_void_p(params.kern)) == 0:
        return name.value.decode()
    return "kernel"


def device_ops(fn) -> tuple:
    """The device operations (kernels, copies, fills) of one call, after a
    warm-up one: the nodes of a CUDA graph captured around it, each a
    kernel's name or the node's kind in brackets. A capture drops no operation, where a
    torch.profiler trace late in a long process has dropped kernel events
    (:func:`profiler_ops`). Returns (count, names)."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(graph):
        fn()
    driver = ctypes.CDLL("libcuda.so.1")
    raw, count = ctypes.c_void_p(graph.raw_cuda_graph()), ctypes.c_size_t(0)
    if driver.cuGraphGetNodes(raw, None, ctypes.byref(count)) != 0:
        raise RuntimeError("cuGraphGetNodes failed")
    nodes = (ctypes.c_void_p * count.value)()
    if count.value and driver.cuGraphGetNodes(raw, nodes, ctypes.byref(count)) != 0:
        raise RuntimeError("cuGraphGetNodes failed")
    names = []
    for node in nodes:
        kind = ctypes.c_int(-1)
        if driver.cuGraphNodeGetType(ctypes.c_void_p(node), ctypes.byref(kind)) != 0:
            raise RuntimeError("cuGraphNodeGetType failed")
        names.append(_node_name(driver, ctypes.c_void_p(node), kind.value))
    del graph
    return len(names), tuple(names)


# host seconds of idle trace before the first call and after the last one
PROFILE_PAD_S = 0.1
LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel", "cuLaunchKernelEx")


def is_one_kernel(names) -> bool:
    """:func:`device_ops`'s names are one kernel's."""
    return len(names) == 1 and not names[0].startswith("[")


def profiler_ops(fn, calls: int = 5, pad: float = PROFILE_PAD_S) -> dict:
    """What a torch.profiler trace of ``calls`` calls (after a warm-up one,
    ``pad`` seconds of idle trace on either side) sees of them: the device
    events a call (``ops``), the launch calls the trace holds, and for each
    kernel event the ms from its launch call's start to its own start
    (matched by correlation id) and from the trace's start; the trace's
    span on the host's clock. Counts what the profiler drops, against
    :func:`device_ops`: the trace keeps a device event only inside its
    window on the host's clock, and its device and host stamps have
    disagreed by ms (kernels stamped up to 5.2 ms before their own launch
    calls on an H100), so a session can drop the first calls' kernels, or
    all of them, though a capture of the same call holds its one kernel."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        time.sleep(pad)
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        time.sleep(pad)
        stop_ns = time.time_ns()
    result = prof.profiler.kineto_results
    start_ns = result.trace_start_ns()
    events = result.events()
    launches = {e.correlation_id(): e.start_ns() for e in events if e.name() in LAUNCH_CALLS}
    device = [e for e in events if e.device_type() == DeviceType.CUDA and not e.is_user_annotation()]
    kernels = [e for e in device if e.correlation_id() in launches]
    return {
        "ops": len(device) / calls,
        "launch_calls": len(launches),
        "launch_to_kernel_ms": [round((e.start_ns() - launches[e.correlation_id()]) / 1e6, 4) for e in kernels],
        "kernel_start_ms": [round((e.start_ns() - start_ns) / 1e6, 3) for e in device],
        "launch_start_ms": sorted(round((t - start_ns) / 1e6, 3) for t in launches.values()),
        "trace_ms": round((stop_ns - start_ns) / 1e6, 3),
    }


def profiler_sessions(cases: dict, sessions: int, t0: float) -> dict:
    """How often a profiler session miscounts a case's device operations:
    for each case (name -> zero-argument call), its graph's count
    (:func:`device_ops`) and ``sessions`` runs of :func:`profiler_ops`
    unpadded and as many padded, taking turns; the count of sessions at
    each result, and the first miscounted session of each padding in full.
    ``t0``: the process's start on time.perf_counter's clock (the lines
    carry the process's age)."""
    out = {}
    for name, call in cases.items():
        timing.graph_ms(call)
        ops, names = device_ops(call)
        seen = {pad: {} for pad in (0.0, PROFILE_PAD_S)}
        first = {}
        for _ in range(sessions):
            for pad, counts in seen.items():
                read = profiler_ops(call, pad=pad)
                counts[read["ops"]] = counts.get(read["ops"], 0) + 1
                if read["ops"] != ops and pad not in first:
                    first[pad] = read
        out[name] = {"graph_ops": ops, "graph_names": names, "age_s": round(time.perf_counter() - t0, 1),
                     **{f"pad_s={pad}": counts for pad, counts in seen.items()},
                     **{f"first_miscount_pad_s={pad}": read for pad, read in first.items()}}
        print(f"[profiler] case={name} " + json.dumps(out[name]), flush=True)
    return out


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


def _plan(name, args):
    """The plan a row's wrapper launches on its arguments (bf16, or the f32
    instance's as x is f32)."""
    x = args[0]
    n, t, d = x.shape
    f32 = x.dtype == torch.float32
    if name == "mlp_branch":
        from mapdit_tpu_torch.ops.cuda import mlp_block as mb

        return mb.mlp_plan(n, t, d, args[5].shape[0], ctas=mb.resident_ctas(x.get_device(), f32), f32=f32)
    if name == "mlp_tp_partial":
        return tpk.tp_plan("mlp", n, t, d, args[4].shape[0], ctas=tpk._resident_ctas(x.get_device(), 0, f32),
                           f32=f32)
    w_out, hl = args[5], args[6]
    return tpk.tp_plan("attn", n, t, d, w_out.shape[1], hl, name == "block_tp_attn",
                       tpk._resident_ctas(x.get_device(), w_out.shape[1] // hl, f32), f32)


def _products(plan) -> list:
    return ([plan.modulation] if plan.modulation is not None else []) + [
        stage.product for stage in plan.stages if stage.product is not None]


def timeline(name, args) -> dict:
    """One launch with the kernel's trace on: the span from the first CTA's
    start to the last CTA's end, and for each stage the ms a CTA spent on
    its items (mean and max over CTAs; an item's time includes its waits);
    the mainloop's us a k step. bf16 or f32 (the f32 instance), as x is."""
    x = args[0]
    plan = _plan(name, args)
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
    steps = sum(p.tiles * p.kt for p in _products(plan))  # every split's k steps, over all items
    out["mainloop_us_a_k_step"] = float(tr[:, 8].sum()) / 1e3 / steps
    out["last_cta_start_ms"] = float(tr[:, 6].max() - tr[:, 6].min()) / 1e6
    return out


# the f32 split rules --f32-splits times in turns: tp_plan's (_f32_splits at
# its constants), one at twice the round trip's cost, one keeping 6 k steps
# a split, and the first f32 rule (bf16's: one wave, 18 k steps a split)
def _one_wave(tiles, kt, ctas):
    return 1 if tiles >= ctas else max(1, min(ctas // tiles, kt // tpk.TP_MIN_SPLIT_K, tpk.TP_MAX_SPLITS))


SPLIT_RULES = {"rule": {}, "cost2": {"TP_F32_SPLIT_COST": 2}, "min6": {"TP_F32_MIN_SPLIT_K": 6},
               "one-wave": {"_f32_splits": _one_wave}}


@contextlib.contextmanager
def _split_rule(rule: str):
    saved = {key: getattr(tpk, key) for key in SPLIT_RULES[rule]}
    for key, value in SPLIT_RULES[rule].items():
        setattr(tpk, key, value)
    tpk.tp_plan.cache_clear()
    try:
        yield
    finally:
        for key, value in saved.items():
            setattr(tpk, key, value)
        tpk.tp_plan.cache_clear()


def split_sweep(gen, dev, rounds: int) -> dict:
    """Rows 6, 7 and 8 in f32 at tp=2 and tp=4, and row 9 in f32 at B/2,
    N = 64, under each of SPLIT_RULES, in turns (the rules forward, then
    backward, ``rounds`` times): graph ms of each, its products' splits,
    and the f32 sequences' ms once."""
    from mapdit_tpu_torch.ops.cuda import mlp_block as mb
    from mapdit_tpu_torch.tools.bench_mlp_branch import mlp_case

    out = {}
    groups = [(f"tp{tp}", lambda tp=tp: tp_cases(gen, dev, tp, dtype=torch.float32)) for tp in TP_WAYS]
    groups.append(("n64", lambda: {"mlp_branch": (mb.fused_mlp_branch, mb.mlp_launch_sequence, None,
                                                  mlp_case(gen, dev, 64, dtype=torch.float32)["args"])}))
    for tag, make in groups:
        cases = make()
        order = list(SPLIT_RULES) + list(SPLIT_RULES)[::-1]
        for rule in order * rounds:
            with _split_rule(rule):
                for name, (fn, _, _, fargs) in ((k, v[:4]) for k, v in cases.items()):
                    row = out.setdefault(f"{name}:{tag}:{rule}", {"ms": []})
                    row["ms"].append(round(timing.graph_ms(lambda fn=fn, fargs=fargs: fn(*fargs)), 4))
                    row["splits"] = {p.name: p.splits for p in _products(_plan(name, fargs))}
        for name, (_, seq, _, fargs) in ((k, v[:4]) for k, v in cases.items()):
            out[f"{name}:{tag}:sequence"] = {"ms": [round(timing.graph_ms(lambda seq=seq, fargs=fargs: seq(*fargs)), 4)]}
        del cases
    for key, row in out.items():
        print(f"[splits] case={key} " + json.dumps(row), flush=True)
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
    t0 = time.perf_counter()
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--check-only", action="store_true")
    p.add_argument("--f32", action="store_true", help="the f32 instances: every case in f32")
    p.add_argument("--ptxas", action="store_true")
    p.add_argument("--trace", action="store_true")
    p.add_argument("--profiler-sessions", type=int, default=0, metavar="N",
                   help="only count device operations, by graph and over N profiler sessions a case")
    p.add_argument("--profiler-rounds", type=int, default=1, metavar="R",
                   help="with --profiler-sessions: go over the cases R times")
    p.add_argument("--f32-splits", type=int, default=0, metavar="R",
                   help="time rows 6-9 in f32 under each split rule, R rounds of turns")
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
    dtype = torch.float32 if args.f32 else torch.bfloat16
    gen = torch.Generator(device=dev).manual_seed(0)
    report = {"card": smi, "checks": {}, "times": {}}
    if args.profiler_sessions:
        # bf16 and f32 cases alike, whatever --f32 says
        calls = {}
        for tp in TP_WAYS:
            for dt in (torch.bfloat16, torch.float32):
                for name, (fn, *_, fargs) in ((k, v[:4]) for k, v in tp_cases(gen, dev, tp, dtype=dt).items()):
                    calls[f"{name}:tp{tp}:{str(dt)[6:]}"] = lambda fn=fn, fargs=fargs: fn(*fargs)
        report["profiler_sessions"] = [profiler_sessions(calls, args.profiler_sessions, t0)
                                       for _ in range(args.profiler_rounds)]
    if args.f32_splits:
        report["f32_splits"] = split_sweep(gen, dev, args.f32_splits)
    measure = not (args.profiler_sessions or args.f32_splits)
    for tp in (TP_WAYS if measure else ()):
        for t in ((64, 16, 4) if args.check_only else (64,)):
            cases = tp_cases(gen, dev, tp, t=t, dtype=dtype)
            for name, (fn, seq, plain, fargs) in ((k, v[:4]) for k, v in cases.items()):
                report["checks"][f"{name}:tp{tp}:t{t}"] = check(f"{name}:tp{tp}:t{t}", fn, plain, fargs)
            if args.check_only:
                continue
            for name, (fn, seq, _, fargs, *_, library) in cases.items():
                kernel, sequence = (lambda fn=fn, fargs=fargs: fn(*fargs)), (lambda seq=seq, fargs=fargs: seq(*fargs))
                row = dict(times(kernel, sequence), library_ms=timing.graph_ms(library),
                           device_ops=device_ops(kernel)[0], sequence_device_ops=device_ops(sequence)[0])
                report["times"][f"{name}:tp{tp}"] = row
                print(f"[time] kernel={name}:tp{tp} " + " ".join(f"{k}={v:.4f}" for k, v in row.items()), flush=True)
            kernel, sequence = block_call(cases, "kernel"), block_call(cases, "sequence")
            row = dict(times(kernel, sequence), device_ops=device_ops(kernel)[0],
                       sequence_device_ops=device_ops(sequence)[0])
            # rows 7 and 8 back to back, as a block runs them: their weights take turns in L2
            row7, row8 = cases["block_tp_attn"], cases["mlp_tp_partial"]
            row.update(rows_7_8_ms=timing.graph_ms(lambda: (row7[0](*row7[3]), row8[0](*row8[3]))),
                       rows_7_8_sequence_ms=timing.graph_ms(lambda: (row7[1](*row7[3]), row8[1](*row8[3]))))
            report["times"][f"fused_dit_block_tp:tp{tp}"] = row
            print(f"[time] kernel=fused_dit_block_tp-without-all-reduce:tp{tp} "
                  + " ".join(f"{k}={v:.4f}" for k, v in row.items()), flush=True)
    if args.trace:
        cases = tp_cases(gen, dev, TP_WAYS[0], dtype=dtype)
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
