"""The port's training entry point (python -m mapdit_tpu_torch.train) on the
CPU, the counterpart of tests/test_cli.py's train tests: artifact layout,
config.yaml round trip, log format, --resume continuing the exact
trajectory, --metrics-jsonl rows, SIGTERM saving and resuming, the native
loader and the device prefetcher. DiT-XS/8, float32, --device cpu, main(args)
in process except for the signal test."""

import json
import os
import re
import shutil
import signal
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from mapdit_tpu_torch import train
from mapdit_tpu_torch.training import SyntheticLatentDataset
from mapdit_tpu_torch.training.native_loader import NativeLatentLoader
from mapdit_tpu_torch.utils import experiment

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# The suite runs several worker processes on a few cores, and XS-size models
# gain nothing from a wide intra-op pool: with the default (one thread per
# core in every worker) the training tests oversubscribe the machine.
torch.set_num_threads(2)
COMMON = ["--device", "cpu", "--data-path", "synthetic:64", "--model", "DiT-XS/8", "--num-classes", "10",
          "--batch-size", "8", "--num-lin-warmup", "2", "--start-decay", "8"]


def run(results, *flags):
    """One in-process run of the CLI; returns its experiment directory."""
    return train.main(train.build_parser().parse_args([*COMMON, "--results-dir", str(results), *flags]))


def checkpoint(exp_dir, step):
    return torch.load(os.path.join(exp_dir, "checkpoints", f"{step:07d}.pt"), weights_only=True)


def assert_same_state(a, b):
    for part in ("model", "ema"):
        flat_a = a[part] if part == "model" else {f"{k}/{n}": v for k, t in a[part].items() for n, v in t.items()}
        flat_b = b[part] if part == "model" else {f"{k}/{n}": v for k, t in b[part].items() for n, v in t.items()}
        assert flat_a.keys() == flat_b.keys()
        for name in flat_a:
            assert torch.equal(flat_a[name], flat_b[name]), (part, name)
    assert a["step"] == b["step"] and torch.equal(a["generator"], b["generator"])
    for sa, sb in zip(a["optimizer"]["state"].values(), b["optimizer"]["state"].values()):
        for key in sa:
            assert torch.equal(sa[key], sb[key]), key


@pytest.fixture(autouse=True)
def _drop_tmp_path(tmp_path):
    """Each test's files go when it ends (a failing test's too): the tier-1
    run's tests write GBs of checkpoints and weights, and pytest keeps the
    last three runs' directories, so they filled the disk."""
    yield
    shutil.rmtree(tmp_path, ignore_errors=True)


@pytest.fixture(scope="module")
def trained_run(tmp_path_factory):
    """12 steps, a checkpoint at 12, EMA snapshots at 4, 8 and 12."""
    results = tmp_path_factory.mktemp("results")
    yield run(results, "--num-steps", "12", "--log-every", "4", "--ckpt-every", "12", "--ema-snapshot-every", "4",
              "--metrics-jsonl", "auto")
    shutil.rmtree(results, ignore_errors=True)


def test_artifact_layout(trained_run):
    assert os.path.basename(trained_run) == "000-DiT-XS-8"
    for name in ("config.yaml", "log.txt", "constants.pt", "metrics.jsonl"):
        assert os.path.exists(os.path.join(trained_run, name)), name
    assert os.listdir(os.path.join(trained_run, "checkpoints")) == ["0000012.pt"]
    snaps = sorted(os.listdir(os.path.join(trained_run, "ema")))
    assert snaps == [f"{std}_{step:07d}.npz" for std in ("0.050", "0.100") for step in (4, 8, 12)]
    with np.load(os.path.join(trained_run, "ema", "0.100_0000004.npz")) as snap:
        assert snap["blocks.0.attn.qkv_proj.weight"].dtype == np.float16
        assert set(snap.files) == {k for k in checkpoint(trained_run, 12)["ema"]["0.100"]}


@pytest.mark.parametrize("with_yaml", [True, False])
def test_config_roundtrip(trained_run, with_yaml, monkeypatch, tmp_path):
    """config.yaml through load_config / config_from_args, with PyYAML and
    with the module's own reader and writer."""
    if not with_yaml:
        monkeypatch.setattr(experiment, "yaml", None)
    cfg = experiment.load_config(trained_run)
    assert cfg["model"] == "DiT-XS/8" and cfg["device"] == "cpu"
    assert cfg["in_channels"] == 4 and cfg["input_size"] == 16
    assert len(cfg["stats_mean"]) == 4 and len(cfg["stats_std"]) == 4
    assert cfg["use_cosine_attention"] is True and cfg["resume"] is None
    assert cfg["modulation"] == "adaln" and cfg["ema_stds"] == [0.05, 0.1]
    model_cfg = experiment.config_from_args(cfg)
    assert (model_cfg.depth, model_cfg.hidden_size, model_cfg.patch_size, model_cfg.num_classes) == (6, 256, 8, 10)
    experiment.save_config(str(tmp_path), cfg)
    assert experiment.load_config(str(tmp_path)) == cfg
    import yaml

    with open(tmp_path / "config.yaml") as f:
        assert yaml.safe_load(f) == cfg  # what the fallback writes is YAML


def test_log_format(trained_run):
    log = open(os.path.join(trained_run, "log.txt")).read()
    assert re.search(r"\(step=0000004\) train loss: \d+\.\d{4}, train steps/sec: \d+\.\d{2}", log), log
    for piece in ("experiment directory created at", "dataset contains 64 data points", "model parameters: 7,543,837",
                  "training for 12 steps...", "saving checkpoint to", "saving ema snapshot to", "done!"):
        assert piece in log, piece


def test_metrics_jsonl_keys(trained_run):
    rows = [json.loads(line) for line in open(os.path.join(trained_run, "metrics.jsonl"))]
    assert [r["step"] for r in rows] == [4, 8, 12]
    for r in rows:
        assert set(r) == {"step", "loss", "steps_per_sec", "lr", "samples_seen", "wall_time", "grad_norm"}
        assert r["loss"] > 0 and r["steps_per_sec"] > 0 and r["lr"] > 0 and r["grad_norm"] > 0
        assert r["samples_seen"] == r["step"] * 8
    assert rows[-1]["loss"] < rows[0]["loss"]


@pytest.mark.parametrize("resume_from", ["directory", "file"])
def test_resume_continues_the_exact_trajectory(tmp_path, resume_from):
    """6 steps in one run equal 3 steps, a checkpoint, --resume and 3 more,
    bit for bit: parameters, EMA trees, Adam moments, generator."""
    flags = ["--log-every", "3", "--ema-snapshot-every", "0", "--checkpointer", "torch-sync"]
    whole = run(tmp_path / "whole", "--num-steps", "6", "--ckpt-every", "6", *flags)
    first = run(tmp_path / "first", "--num-steps", "3", "--ckpt-every", "3", *flags)
    source = first if resume_from == "directory" else os.path.join(first, "checkpoints", "0000003.pt")
    second = run(tmp_path / "second", "--num-steps", "6", "--ckpt-every", "6", "--resume", source, *flags)
    assert "resumed from" in open(os.path.join(second, "log.txt")).read()
    assert_same_state(checkpoint(second, 6), checkpoint(whole, 6))
    with pytest.raises(FileNotFoundError, match="no checkpoint found"):
        run(tmp_path / "none", "--num-steps", "6", "--resume", str(tmp_path / "nowhere"))


def test_observability_flags(tmp_path):
    """--grad-accum, --grad-clip, --log-magnitudes, --profile-dir and the
    loss-second-moment sampler together, as the JAX CLI test drives them."""
    prof = tmp_path / "trace"
    exp = run(tmp_path / "results", "--num-steps", "6", "--log-every", "2", "--ckpt-every", "100",
              "--ema-snapshot-every", "0", "--metrics-jsonl", str(tmp_path / "m.jsonl"), "--profile-dir", str(prof),
              "--grad-accum", "2", "--grad-clip", "1.0", "--log-magnitudes", "--timestep-sampler", "loss-second-moment")
    rows = [json.loads(line) for line in open(tmp_path / "m.jsonl")]
    assert [r["step"] for r in rows] == [2, 4, 6]
    for r in rows:
        mags = r["magnitudes"]
        # forced weight normalization keeps the rows on the unit-RMS manifold
        assert mags["w_rms_dev_max"] < 1e-3
        assert len(mags["block_rms"]) == 6 and all(v > 0 for v in mags["block_rms"]) and mags["out_rms"] > 0
    assert "(magnitudes) w_rms_dev mean" in open(os.path.join(exp, "log.txt")).read()
    assert {"trace.json", "key_averages.txt", "summary.json"} <= set(os.listdir(prof))
    assert json.load(open(prof / "summary.json"))["steps"] == 6


def test_device_prefetch_thread_takes_the_same_steps(tmp_path):
    flags = ["--num-steps", "4", "--log-every", "2", "--ckpt-every", "4", "--ema-snapshot-every", "0"]
    inline = run(tmp_path / "inline", *flags)
    threaded = run(tmp_path / "thread", "--device-prefetch", "thread", *flags)
    assert "device prefetch" in open(os.path.join(threaded, "log.txt")).read()
    assert_same_state(checkpoint(threaded, 4), checkpoint(inline, 4))


def test_native_loader_serves_an_npy_dataset(tmp_path):
    """The port builds its own library from native/latent_loader.cc; its
    batches are rows of the dataset, and the CLI takes it for a .npy
    directory and not for synthetic data."""
    assert not NativeLatentLoader.available("synthetic:64")
    assert not NativeLatentLoader.available(str(tmp_path))
    ds = SyntheticLatentDataset(num_examples=40, num_classes=7, seed=3)
    data = tmp_path / "latents"
    data.mkdir()
    np.save(data / "posterior_means.npy", ds.means)
    np.save(data / "posterior_stds.npy", ds.stds)
    np.save(data / "labels.npy", ds.labels)
    np.savez(data / "stats.npz", **ds.stats)
    assert NativeLatentLoader.available(str(data))
    from mapdit_tpu_torch.training import native_loader

    assert "build/mapdit_tpu_torch" in str(native_loader._lib._name) and "mapdit_tpu/native" not in native_loader._lib._name
    loader = NativeLatentLoader(str(data), batch_size=10, seed=1, num_threads=2)
    assert loader.num_examples == 40
    lookup = {ds.means[i].tobytes(): i for i in range(len(ds))}
    batches = loader.batches()
    for _ in range(8):  # two epochs of four batches
        b = next(batches)
        assert b["mean"].shape == (10, 4, 16, 16) and b["mean"].dtype == np.float32 and b["y"].dtype == np.int32
        rows = [lookup[b["mean"][r].tobytes()] for r in range(10)]
        assert len(set(rows)) == 10
        np.testing.assert_array_equal(b["std"], ds.stds[rows])
        np.testing.assert_array_equal(b["y"], ds.labels[rows])
    loader.close()
    exp = train.main(train.build_parser().parse_args([
        "--device", "cpu", "--data-path", str(data), "--results-dir", str(tmp_path / "results"), "--model", "DiT-XS/8",
        "--num-classes", "7", "--batch-size", "8", "--num-steps", "3", "--log-every", "1", "--ckpt-every", "100",
        "--ema-snapshot-every", "0"]))
    assert "using native latent loader" in open(os.path.join(exp, "log.txt")).read()


def test_cli_has_every_flag_of_the_jax_cli():
    """Every --flag of the JAX package's train.py exists here under the same
    name, and --device beside them."""
    source = open(os.path.join(REPO, "train.py")).read()
    jax_flags = set(re.findall(r'add_argument\(\s*"(--[a-z-]+)"', source))
    jax_flags |= {f"--{name}" for name in re.findall(r'flag\("([a-z-]+)"\)', source)}
    assert len(jax_flags) >= 40, sorted(jax_flags)
    ours = {opt for action in train.build_parser()._actions for opt in action.option_strings}
    assert jax_flags <= ours, sorted(jax_flags - ours)
    assert "--device" in ours
    defaults = vars(train.build_parser().parse_args(["--data-path", "synthetic", "--results-dir", "r"]))
    assert (defaults["device"], defaults["batch_size"], defaults["lr"], defaults["num_steps"]) == ("cuda", 256, 1e-2, 400_000)
    assert (defaults["block_kernel"], defaults["attn_bwd"], defaults["checkpointer"]) == ("auto", "pallas", "torch")
    assert defaults["ema_stds"] == [0.05, 0.1] and defaults["grad_clip"] is None and defaults["device_prefetch"] == "off"


def test_sigterm_saves_then_resume_continues(tmp_path):
    """SIGTERM mid-training finishes the step in flight, writes a checkpoint
    and the EMA snapshots, and exits 0; --resume continues from that step."""
    results = str(tmp_path / "results")
    common = [*COMMON, "--log-every", "2", "--ckpt-every", "1000000", "--ema-snapshot-every", "4"]
    # the output goes to a file, never a pipe that nobody drains
    with open(tmp_path / "train.out", "w") as out:
        proc = subprocess.Popen(
            [sys.executable, "-m", "mapdit_tpu_torch.train", "--results-dir", results, "--num-steps", "100000", *common],
            stdout=out, stderr=subprocess.STDOUT, cwd=REPO,
        )
        try:
            logfile, deadline = None, time.time() + 300
            while time.time() < deadline and logfile is None:
                exps = os.listdir(results) if os.path.isdir(results) else []
                lf = os.path.join(results, exps[0], "log.txt") if exps else None
                # wait for a logged interval, so that the signal lands in the loop
                if lf and os.path.exists(lf) and "(step=" in open(lf).read():
                    logfile = lf
                    break
                assert proc.poll() is None, open(tmp_path / "train.out").read()
                time.sleep(0.2)
            assert logfile, "no training progress within the deadline"
            proc.send_signal(signal.SIGTERM)
            rc = proc.wait(timeout=120)
        finally:
            if proc.poll() is None:
                proc.kill()
    assert rc == 0, open(tmp_path / "train.out").read()
    exp = os.path.dirname(logfile)
    log = open(logfile).read()
    assert "(SIGTERM) graceful stop at step" in log and f"--resume {exp}" in log
    ckpts = os.listdir(os.path.join(exp, "checkpoints"))
    assert len(ckpts) == 1, ckpts
    stop_step = int(ckpts[0].split(".")[0])
    assert stop_step > 0
    assert any(f"{stop_step:07d}" in s for s in os.listdir(os.path.join(exp, "ema")))
    resumed = run(tmp_path / "resumed", "--num-steps", str(stop_step + 4), "--log-every", "2", "--ckpt-every",
                  "1000000", "--ema-snapshot-every", "0", "--resume", exp)
    assert f"at step {stop_step}" in open(os.path.join(resumed, "log.txt")).read()
