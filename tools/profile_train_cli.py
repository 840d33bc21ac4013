#!/usr/bin/env python
"""Where a train step of the port's CLI goes on one GPU, with the attention
backward's dW products as f32 ``torch.matmul`` (the default) and through
``dw_gemm`` (``DW_IN_KERNEL_BUDGET`` raised).

    python tools/profile_train_cli.py [--out-dir results/profile_train_cli] [--steps 40] [--traced-steps 8]

Runs ``python -m mapdit_tpu_torch.train`` in process at DiT-S/2, batch 256,
bf16, ``--block-kernel mega_attn --attn-bwd pallas`` on ``synthetic:1024``,
in the order default, dw_gemm, dw_gemm, default (so that a drift of the
host or the card shows), each ``--steps`` steps untraced with
``--log-every 10``; then each once more for ``--traced-steps`` steps under
``--profile-dir``. Prints one JSON object: per form the untraced ms per step
of each run (from the logged intervals after the first), the traced
device-busy ms per step, the idle share 1 - busy / untraced, and the kernels
with the most device time; and the card's name and power limit.
"""

import argparse
import json
import os
import subprocess
import sys
import tempfile

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--out-dir", default="results/profile_train_cli")
    parser.add_argument("--steps", type=int, default=40)
    parser.add_argument("--traced-steps", type=int, default=8)
    args = parser.parse_args(argv)

    import torch

    from mapdit_tpu_torch import train
    from mapdit_tpu_torch.models import build_config
    from mapdit_tpu_torch.ops.cuda import attn_branch as ab

    if not torch.cuda.is_available():
        raise SystemExit("this profile measures a GPU and none is available")
    model = "DiT-S/2"
    budget = {"f32_matmul": 0, "dw_gemm": 16 * build_config(model).hidden_size ** 2}
    common = ["--model", model, "--data-path", "synthetic:1024", "--batch-size", "256", "--compute-dtype", "bfloat16",
              "--block-kernel", "mega_attn", "--attn-bwd", "pallas", "--num-classes", "1000", "--metrics-jsonl", "auto",
              "--num-lin-warmup", "4", "--start-decay", "10", "--ckpt-every", "1000000", "--ema-snapshot-every", "0"]

    def run(form, results, steps, *flags):
        ab.DW_IN_KERNEL_BUDGET = budget[form]
        try:
            exp = train.main(train.build_parser().parse_args(
                [*common, "--results-dir", results, "--num-steps", str(steps), *flags]))
        finally:
            ab.DW_IN_KERNEL_BUDGET = 0
        with open(os.path.join(exp, "metrics.jsonl")) as f:
            return [json.loads(line) for line in f]

    out = {form: {"untraced_ms_per_step": []} for form in budget}
    with tempfile.TemporaryDirectory(prefix="mapdit_profile_") as tmp:
        for i, form in enumerate(("f32_matmul", "dw_gemm", "dw_gemm", "f32_matmul")):
            rows = run(form, os.path.join(tmp, f"u{i}"), args.steps, "--log-every", "10")
            # the first interval builds the kernels and warms the allocator up
            steps = rows[-1]["step"] - rows[0]["step"]
            out[form]["untraced_ms_per_step"].append(1e3 * (rows[-1]["wall_time"] - rows[0]["wall_time"]) / steps)
            out[form].setdefault("logged_steps_per_sec", []).append([r["steps_per_sec"] for r in rows])
        for form in budget:
            prof_dir = os.path.join(args.out_dir, form)
            run(form, os.path.join(tmp, f"t_{form}"), args.traced_steps, "--log-every", "1000000", "--profile-dir", prof_dir)
            os.remove(os.path.join(prof_dir, "trace.json"))  # tens of MB; the table and the summary stay
            with open(os.path.join(prof_dir, "summary.json")) as f:
                summary = json.load(f)
            untraced = min(out[form]["untraced_ms_per_step"])
            out[form].update(
                traced_steps=summary["steps"],
                device_busy_ms_per_step=summary["device_busy_ms_per_step"],
                device_idle_share=1.0 - summary["device_busy_ms_per_step"] / untraced,
                top_kernels_ms_per_step=summary["top_kernels_ms_per_step"],
            )
    out["device"] = {
        "kind": torch.cuda.get_device_name(0),
        "nvidia_smi": subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                                     capture_output=True, text=True, timeout=60).stdout.strip(),
    }
    os.makedirs(args.out_dir, exist_ok=True)
    with open(os.path.join(args.out_dir, "result.json"), "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
