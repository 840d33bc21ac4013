#!/usr/bin/env python3
"""dgain, the gain's cotangent from the attention half-block's backward, on
the inputs that ``chip_smoke.py`` phase 3 draws for its ``attn_branch/bwd``
check: the kernels' value (``attn_bwd``) beside the bf16 plain version's
and the float32 plain path's (on the CPU), with the scale of the sum. dgain
sums N*T*D terms that cancel, so how far two orders of rounding land apart
is set by the terms, not by the sum.

    python tools/attn_bwd_witness.py --dump FILE [--smoke PATH/chip_smoke.py]
    python tools/attn_bwd_witness.py --inputs FILE [--tree DIR]

``--dump`` runs the given ``chip_smoke.py`` (default: this checkout's) on
one GPU up to phase 3's attention half-block checks and saves their inputs
to FILE (another checkout's smoke draws what its own phase 3 drew).
``--inputs`` prints one JSON line of readings on those inputs through the
kernels of the checkout DIR (default: this one), so two checkouts can be
held on the same inputs, one process each.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import math
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def load_smoke(path: str, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


class _Drawn(Exception):
    pass


def dump(target: str, smoke_path: str) -> int:
    """Run ``smoke_path`` with its train_kernel_rows replaced by one that
    draws the attention half-block's inputs as this checkout's smoke does,
    saves them and stops."""
    import torch

    ours = load_smoke(os.path.join(REPO, "chip_smoke.py"), "smoke_here")
    smoke = load_smoke(smoke_path, "smoke_dumped")

    def drawn(torch, F, k, gen, dev, t, d, heads, *rest):
        args, dy = ours.attn_branch_args(torch, gen, dev, smoke.TRAIN_BATCH, t, d, heads)
        torch.save({"args": [a.cpu() if torch.is_tensor(a) else a for a in args], "dy": dy.cpu()}, target)
        raise _Drawn

    smoke.train_kernel_rows = drawn
    try:
        rc = smoke.main()
    except _Drawn:
        print(json.dumps({"dumped": target, "smoke": smoke_path}), flush=True)
        return 0
    print(f"attn_bwd_witness: {smoke_path} ended (rc {rc}) before its attention half-block checks", file=sys.stderr)
    return 1


def readings(inputs: str, tree: str) -> int:
    sys.path.insert(0, os.path.abspath(tree))
    import torch

    from mapdit_tpu_torch.ops.cuda import attn_branch as ab
    from mapdit_tpu_torch.ops.cuda import dit_block as k

    if not os.path.abspath(ab.__file__).startswith(os.path.abspath(tree) + os.sep):
        raise SystemExit(f"attn_bwd_witness: imported {ab.__file__}, not the checkout {tree}")
    torch.backends.cuda.matmul.allow_tf32 = False
    ours = load_smoke(os.path.join(REPO, "chip_smoke.py"), "smoke_here")
    saved = torch.load(inputs)
    dev = torch.device("cuda")
    args = tuple(a.to(dev) if torch.is_tensor(a) else a for a in saved["args"])
    dy = saved["dy"].to(dev)
    got = float(ab.attn_bwd(dy, *args)[4].reshape(()))
    plain = float(ab.attn_bwd_plain(dy, *args)[4].reshape(()))
    cpu32 = [a.float().cpu() if torch.is_tensor(a) else a for a in args]
    f32 = float(ab.attn_bwd_plain(dy.float().cpu(), *cpu32)[4].reshape(()))
    terms = ours.dgain_terms(torch, ours.attn_bwd_stages(torch, k, ab, dy, args))
    print(json.dumps({
        "tree": tree, "device": ours.smi_line(), "dgain_kernel": got, "dgain_plain_bf16": plain,
        "dgain_plain_f32": f32, "kernel_minus_plain": got - plain, "kernel_minus_f32": got - f32,
        "plain_minus_f32": plain - f32, "terms": terms.numel(), "terms_sum": float(terms.double().sum()),
        "terms_abs_sum": float(terms.double().abs().sum()),
        "terms_rss": math.sqrt(float(terms.double().square().sum())),
    }), flush=True)
    return 0


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--dump", default=None, help="save chip_smoke's attention half-block inputs here")
    parser.add_argument("--smoke", default=os.path.join(REPO, "chip_smoke.py"), help="the chip_smoke.py to run")
    parser.add_argument("--inputs", default=None, help="inputs saved by --dump")
    parser.add_argument("--tree", default=REPO, help="checkout whose kernels run on --inputs")
    args = parser.parse_args()
    if (args.dump is None) == (args.inputs is None):
        parser.error("give one of --dump and --inputs")
    return dump(args.dump, args.smoke) if args.dump else readings(args.inputs, args.tree)


if __name__ == "__main__":
    sys.exit(main())
