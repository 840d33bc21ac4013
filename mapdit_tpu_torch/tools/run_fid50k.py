"""Drive the full-scale FID protocol without Inception weights, port of the
JAX package's ``tools/run_fid50k.py``.

    python -m mapdit_tpu_torch.tools.run_fid50k --result-dir <exp> [--num-samples 50000] [--device cpu]

Runs ``python -m mapdit_tpu_torch.sample_fid`` at the reference protocol
(batch 128, 250 DDPM steps, CFG 1.5, clipped) against a local experiment in
a subprocess, records its wall time and its peak resident memory (VmHWM
polled from ``/proc/<pid>/status``, and its own ``ru_maxrss`` from
``wait4`` once it has exited, which a short run's last poll may miss),
then scores the samples with ``mapdit_tpu_torch.tools.fid``'s
random-projection features: their statistics are written beside the
samples and the samples are held against them (a FID of ~0 checks the pipeline, not the model).
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import threading
import time

from mapdit_tpu_torch.tools import fid

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def peak_rss_monitor(pid: int, out: list, interval: float = 0.5) -> None:
    """Keep ``out[0]`` at the process's VmHWM (kB) until it goes away."""
    while True:
        try:
            with open(f"/proc/{pid}/status") as f:
                for line in f:
                    if line.startswith("VmHWM:"):
                        out[0] = max(out[0], int(line.split()[1]))
        except (FileNotFoundError, ProcessLookupError):
            return
        time.sleep(interval)


def build_parser() -> argparse.ArgumentParser:
    from mapdit_tpu_torch.models.config import BLOCK_KERNELS

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--result-dir", required=True)
    p.add_argument("--num-samples", type=int, default=50000)
    p.add_argument("--batch-size", type=int, default=128)
    p.add_argument("--num-classes", type=int, default=10)
    p.add_argument("--output-file", default="samples_50k.npz")
    p.add_argument("--device", type=str, default="cuda", help="sample_fid's device; cuda unless given")
    p.add_argument("--block-kernel", choices=list(BLOCK_KERNELS), default=None,
                   help="sample_fid's --block-kernel (default: the training config's)")
    return p


def main(argv=None) -> dict:
    """Run the protocol; returns its report (wall seconds, peak RSS, the
    npz's shape and the pipeline FID)."""
    args = build_parser().parse_args(argv)
    cmd = [
        sys.executable, "-m", "mapdit_tpu_torch.sample_fid",
        "--result-dir", args.result_dir, "--use-vae", "false",
        "--num-samples", str(args.num_samples),
        "--batch-size", str(args.batch_size),
        "--num-classes", str(args.num_classes),
        "--num-sampling-steps", "250", "--cfg-scale", "1.5",
        "--clip-denoised", "true", "--output-file", args.output_file,
        "--device", args.device,
    ]
    if args.block_kernel is not None:
        cmd += ["--block-kernel", args.block_kernel]
    t0 = time.time()
    proc = subprocess.Popen(cmd, cwd=REPO)
    peak = [0]
    monitor = threading.Thread(target=peak_rss_monitor, args=(proc.pid, peak), daemon=True)
    monitor.start()
    _, status, usage = os.wait4(proc.pid, 0)
    proc.returncode = rc = os.waitstatus_to_exitcode(status)
    wall = time.time() - t0
    monitor.join(timeout=5)
    peak_kb = max(peak[0], usage.ru_maxrss)
    print(f"sample_fid rc={rc} wall={wall:.0f}s peak_rss={peak_kb / 1024:.0f} MB", flush=True)
    if rc != 0:
        raise SystemExit(rc)

    npz = os.path.join(args.result_dir, "fid_samples", args.output_file)
    samples = fid.load_samples(npz)
    print(f"npz: {samples.shape} {samples.dtype} size={os.path.getsize(npz) / 2**20:.0f} MB", flush=True)
    if samples.shape[0] != args.num_samples:
        raise SystemExit(f"the npz holds {samples.shape[0]} samples, not {args.num_samples}")

    stats = os.path.splitext(npz)[0] + "_random-proj_stats.npz"
    feats = fid.extract_features(samples, "random-proj")
    fid.save_stats(stats, feats, "random-proj")
    mu, sigma = fid.activation_stats(feats)
    score = fid.frechet_distance(mu, sigma, *fid.load_stats(stats, "random-proj"))
    print(f"wrote {stats}\nFID: {score:.4f}", flush=True)
    print(f"fid50k protocol OK: {args.num_samples} samples, {wall:.0f}s, {peak_kb / 1024:.0f} MB peak RSS", flush=True)
    return {"wall_seconds": wall, "peak_rss_kb": peak_kb, "shape": list(samples.shape), "fid": score,
            "npz": npz, "stats": stats}


if __name__ == "__main__":
    main()
