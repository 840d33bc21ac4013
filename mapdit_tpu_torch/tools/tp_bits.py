"""Save the bf16 outputs of ``csrc/dit_block_tp.cu``'s kernels (the
tensor-parallel partials, rows 6-8, and row 9's ``mlp_branch``: one launch
each) at fixed seeds, or hold them bit for bit to a file saved that way, so
that two checkouts can be compared on one card:

    PYTHONPATH=<other checkout> python mapdit_tpu_torch/tools/tp_bits.py --save other.pt
    python -m mapdit_tpu_torch.tools.tp_bits --compare other.pt

The cases are ``bench_tp_kernels.tp_cases`` (8 samples at the DiT-XL/2
shards) at tp = 2 and 4 and T = 64 and 16, and ``bench_mlp_branch``'s row-9
cases (B/2 at N = 64 and 256, DEEP, RAGGED), each drawn from a seed of its
own; the outputs are those of the kernel wrappers (row 7: the partial and
the mods). ``--compare`` prints one line an output and exits 1 unless every
output has the saved bits (``torch.equal``).
"""

from __future__ import annotations

import argparse
import os
import sys

import torch

TP_WAYS, TOKENS = (2, 4), (64, 16)


def outputs(dev) -> dict:
    from mapdit_tpu_torch.ops.cuda import mlp_block
    from mapdit_tpu_torch.tools import bench_mlp_branch as mlp
    from mapdit_tpu_torch.tools.bench_tp_kernels import tp_cases

    out = {}
    for tp in TP_WAYS:
        for t in TOKENS:
            gen = torch.Generator(device=dev).manual_seed(1000 * tp + t)
            for name, case in tp_cases(gen, dev, tp, t).items():
                got = case[0](*case[3])
                for i, z in enumerate(got if isinstance(got, tuple) else (got,)):
                    out[f"{name}:tp{tp}:t{t}:{i}"] = z.detach().cpu()
    deep_tag, *deep_shape, deep = mlp.DEEP
    cases = [(f"n{n}", (n,), 0.0) for n in mlp.SAMPLES] + [(deep_tag, tuple(deep_shape), deep)]
    for i, (tag, shape, scale) in enumerate(cases + [(tag, tuple(shape), 0.0) for tag, *shape in mlp.RAGGED]):
        gen = torch.Generator(device=dev).manual_seed(9000 + i)
        out[f"mlp_branch:{tag}"] = mlp_block.mlp_fwd(*mlp.mlp_case(gen, dev, *shape, deep=scale)["args"]).cpu()
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    what = p.add_mutually_exclusive_group(required=True)
    what.add_argument("--save", help="write the outputs here")
    what.add_argument("--compare", help="hold the outputs to this file's")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("tp_bits: no CUDA device", file=sys.stderr)
        return 2
    import mapdit_tpu_torch

    print(f"[tp-bits] package={os.path.dirname(mapdit_tpu_torch.__file__)}", flush=True)
    got = outputs(torch.device("cuda", torch.cuda.current_device()))
    if args.save:
        os.makedirs(os.path.dirname(os.path.abspath(args.save)), exist_ok=True)
        torch.save(got, args.save)
        print(f"[tp-bits] saved {len(got)} outputs to {args.save}", flush=True)
        return 0
    want = torch.load(args.compare)
    same = {key: key in want and torch.equal(z, want[key]) for key, z in got.items()}
    for key, ok in same.items():
        print(f"[tp-bits] {key} same_bits={ok}", flush=True)
    ok = all(same.values()) and set(want) == set(got)
    print(f"[tp-bits] outputs={len(got)} saved={len(want)} same_bits={sum(same.values())} ok={ok}", flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
