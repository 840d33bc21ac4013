#!/usr/bin/env python3
"""Sampling rate of every block path at the models ``auto`` chooses between,
on one GPU: the measurement ``models/blocks.py:kernel_policy``'s choice
rests on.

    python tools/kernel_policy_sweep.py [--models DiT-S/2,DiT-B/2,DiT-XL/2] \\
        [--paths mega_stack,mega,mega_attn,off,auto] [--dtype bfloat16|float32] \\
        [--batch N] [--steps N] [--profile-dir results/policy_profile] [--out results/kernel_policy_sweep.json]

Each (model, path) is one ``python -m mapdit_tpu_torch.bench`` sample run in
this process (bench protocol: random folded weights from seed 0, CFG 1.5,
best of 3 timed chains after a warm-up; S and B at batch 32x2 and 250
steps, XL at 4x2 and 50 steps; ``--batch`` and ``--steps`` set them for
every model), in ``--dtype`` (bf16, or float32: a model
trained at the train CLI's default compute dtype samples in f32 on the f32
kernel instances), ``--rounds`` times, every other pass in reverse order, as
the host's pace drifts during a run. ``--profile-dir``
adds bench's torch.profiler table to the first ``auto`` run of each model.
Prints each bench line and the best rate of each path; writes all of it to
``--out``.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

# model -> (pre-CFG batch, DDPM steps), the bench settings of PERF.md section 5
SETTINGS = {"DiT-S/2": (32, 250), "DiT-B/2": (32, 250), "DiT-L/2": (32, 250), "DiT-XL/2": (4, 50)}


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--models", default="DiT-S/2,DiT-B/2,DiT-XL/2")
    parser.add_argument("--paths", default="mega_stack,mega,mega_attn,off,auto")
    parser.add_argument("--dtype", choices=("bfloat16", "float32"), default="bfloat16")
    parser.add_argument("--batch", type=int, default=None, help="pre-CFG batch of every model (default: SETTINGS)")
    parser.add_argument("--steps", type=int, default=None, help="DDPM steps of every model (default: SETTINGS)")
    parser.add_argument("--rounds", type=int, default=2,
                        help="passes over the paths, every other one in reverse order; the best of them is kept")
    parser.add_argument("--profile-dir", default=None)
    parser.add_argument("--out", default=os.path.join(REPO, "results", "kernel_policy_sweep.json"))
    args = parser.parse_args()

    from mapdit_tpu_torch import bench

    rows = []
    paths = args.paths.split(",")
    for model in args.models.split(","):
        batch, steps = SETTINGS[model]
        batch, steps = args.batch or batch, args.steps or steps
        for rnd in range(args.rounds):
            for path in paths if rnd % 2 == 0 else paths[::-1]:
                argv = ["--model", model, "--batch", str(batch), "--steps", str(steps), "--block-kernel", path,
                        "--dtype", args.dtype]
                if args.profile_dir and path == "auto" and rnd == 0:
                    argv += ["--profile-dir", os.path.join(args.profile_dir, model.replace("/", "_"))]
                buf = io.StringIO()
                with contextlib.redirect_stdout(buf):
                    bench.main(argv)
                line = buf.getvalue().strip().splitlines()[-1]
                print(line, flush=True)
                result = json.loads(line)
                rows.append(dict(model=model, path=path, dtype=args.dtype, batch=batch, steps=steps, round=rnd, steps_per_s=result["value"],
                                 unit=result["unit"], profile=result["profile"], device=result["device"]))
    for model in args.models.split(","):
        for path in paths:
            runs = [r["steps_per_s"] for r in rows if r["model"] == model and r["path"] == path]
            unit = next(r["unit"] for r in rows if r["model"] == model and r["path"] == path)
            print(f"{model:9s} {path:11s} best {max(runs):.4f} steps/s of {json.dumps(runs)}  ({unit})", flush=True)
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(rows, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
