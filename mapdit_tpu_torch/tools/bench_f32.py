"""Check and time the f32 forms on one NVIDIA GPU, through chip_smoke.py's
own phase-3 rows (each held to its f32 plain version with TF32 off at rtol =
atol = 2e-4; device ms from CUDA-graph replays beside the plain version, the
library call and the f32 launch sequence): the whole-block path,
``mp_gemm_f32`` (the five products of an S/2 block), ``cosine_attention_f32``
(both modes) and ``dit_stack``'s f32 instances (S/2 block and stack, 32 x 32
latents, the XL/2 block; the depth-12 stack also to its float64 witness);
then the attention half-block, rows 3, 5 and 4's f32 instances
(``csrc/attn_branch.cu``) at S/2, B/2 at T = 16 and odd N at T = 4 with
their f32 launch sequences, and the sequences' own f32 kernels
(``attention_bwd_f32``, the f32 ``out_gate_residual_bwd``, the dattn and dh
products, ``modulate_fwd_f32``); then ``csrc/dit_block_tp.cu``'s f32
instances: the TP partials, rows 6, 7 and 8, at the XL/2 shards, and row 9
(``mlp_branch_f32``) at B/2, N = 64 and 256, with their f32 launch
sequences (``chip_smoke.f32_tp_rows``).

    python -m mapdit_tpu_torch.tools.bench_f32 [--check-only] [--ptxas] [--out results/bench_f32.json]

``--check-only`` builds, runs each shape and compares, and times nothing
(the first call after a change to a kernel). ``--ptxas`` first prints the
registers, shared memory and spills nvcc reports for the six sources, and
any wgmma serialization warning (C7511).
Prints one line a check and a shape and the card's name and power limit;
writes the rows to ``--out``.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys

import torch

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
SOURCES = ("mp_gemm", "cosine_attention", "dit_stack", "attn_branch_f32", "attn_branch_bwd", "dit_block_tp_f32")


def ptxas(build) -> None:
    """nvcc -Xptxas -v of each source (all at once): a line a kernel
    function with its registers, its spill line, and any C7511 (wgmma
    serialized) warning."""
    procs = {name: subprocess.Popen([build._nvcc(), *build.NVCC_FLAGS, "-Xptxas", "-v", "-o", os.devnull,
                                     str(build.CSRC / f"{name}.cu")], stdout=subprocess.PIPE,
                                    stderr=subprocess.PIPE, text=True) for name in SOURCES}
    for name, proc in procs.items():
        _, err = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc -Xptxas -v {name}: exit {proc.returncode}\n{err}")
        function = None
        for line in err.splitlines():
            m = re.search(r"Compiling entry function '(\S+)'", line)
            if m:
                function = m.group(1)
            elif function and ("spill" in line or "registers" in line or "C7511" in line):
                print(f"[ptxas] source={name} function={function} {line.strip()}", flush=True)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--check-only", action="store_true", help="compare every shape, time nothing")
    p.add_argument("--ptxas", action="store_true", help="print nvcc -Xptxas -v for the sources first")
    p.add_argument("--out", default=os.path.join(REPO, "results", "bench_f32.json"))
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("bench_f32: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    import chip_smoke
    import torch.nn.functional as F

    from mapdit_tpu_torch.ops.cuda import build
    from mapdit_tpu_torch.ops.cuda import dit_block as k

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = chip_smoke.smi_line()
    print(card, flush=True)
    built = build.build_all()
    print(f"[build] compiled={json.dumps({n: round(s, 2) for n, s in built.items()})}", flush=True)
    if args.ptxas:
        ptxas(build)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(chip_smoke.SEED + 30)
    rows = {}
    if args.check_only:
        chip_smoke.f32_stack_rows(torch, k, check_only=True)
        chip_smoke.f32_branch_rows(torch, dev, check_only=True)
        chip_smoke.f32_part_rows(torch, F, dev, check_only=True)
        chip_smoke.f32_tp_rows(torch, dev, check_only=True)
        print(json.dumps({"ok": True, "card": card}), flush=True)
        return 0
    rows.update({f"mp_gemm:f32/{site}": row for site, row in chip_smoke.f32_gemm_rows(torch, k, gen, dev).items()})
    rows.update(chip_smoke.f32_cosine_rows(torch, F, k, gen, dev))
    rows.update({f"dit_stack:f32:{name}": row for name, row in chip_smoke.f32_stack_rows(torch, k).items()})
    rows.update(chip_smoke.f32_branch_rows(torch, dev))
    rows.update(chip_smoke.f32_part_rows(torch, F, dev))
    rows.update(chip_smoke.f32_tp_rows(torch, dev))
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump({"card": card, "rows": rows}, f, indent=1)
    print(json.dumps({"ok": True, "card": card, "out": args.out}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
