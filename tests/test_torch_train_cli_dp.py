"""The port's train CLI on two CPU ranks over gloo, DiT-XS/8 (the twins of
JAX tests/test_multiprocess.py and tests/test_parallel.py TestFsdpCli):

  * a data-parallel run under ``torchrun`` writes its artifacts once, from
    the lead (l.114);
  * an FSDP run with ``--checkpointer torch-sharded`` (every rank writes its
    slices) resumes on two ranks on its own trajectory, bit for bit in the
    logged losses, and on one process (l.235);
  * a SIGTERM to one rank stops both at the same log boundary, each writing
    its slices of the checkpoint, and both exit 0 (l.120). The ranks are
    started with the environment torchrun gives them, so that one of them
    can be signalled;
  * FSDP + TP on four ranks (``--n-model 2 --fsdp true``, a (2, 2) mesh;
    the twin of JAX tests/test_parallel.py:130 through the CLI) writes
    whole-tree files, and a resume on one process continues its loss
    history.

Each run is a few steps of XS/8 at a global batch of 16.
"""

import json
import os
import shutil
import signal
import socket
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch

from mapdit_tpu_torch import train
from mapdit_tpu_torch.models import build_config, init_model

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
COMMON = ["--device", "cpu", "--data-path", "synthetic:64", "--model", "DiT-XS/8", "--num-classes", "10",
          "--batch-size", "16", "--num-lin-warmup", "2", "--start-decay", "5", "--metrics-jsonl", "auto"]
TORCHRUN_ENV = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "LOCAL_WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")


@pytest.fixture(autouse=True)
def _drop_tmp_path(tmp_path):
    yield
    shutil.rmtree(tmp_path, ignore_errors=True)


def _env(**extra):
    env = {k: v for k, v in os.environ.items() if k not in TORCHRUN_ENV}
    env.update(OMP_NUM_THREADS="1", **extra)
    return env


def _torchrun(results, *flags, ranks=2):
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node", str(ranks),
         "-m", "mapdit_tpu_torch.train", *COMMON, "--results-dir", str(results), *flags],
        cwd=REPO, env=_env(), capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout[-4000:] + proc.stderr[-4000:]
    exps = sorted(os.listdir(results))
    return os.path.join(results, exps[-1]), exps


def _rows(exp):
    with open(os.path.join(exp, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def _whole_shapes():
    model = init_model(build_config("DiT-XS/8", in_channels=4, input_size=16, num_classes=10), device="cpu")
    return {k: tuple(v.shape) for k, v in model.named_parameters()}


def test_two_rank_train_writes_its_artifacts_once(tmp_path):
    exp, exps = _torchrun(tmp_path, "--num-steps", "6", "--log-every", "3", "--ckpt-every", "6",
                          "--ema-snapshot-every", "3", "--timestep-sampler", "loss-second-moment")
    assert len(exps) == 1, exps  # the lead alone made the experiment directory
    log = open(os.path.join(exp, "log.txt")).read()
    assert "devices: 2x cpu; mesh data=2 model=1" in log and "train loss:" in log
    assert log.count("(step=") == 2, log  # logged once, by the lead
    assert [r["step"] for r in _rows(exp)] == [3, 6] and all(np.isfinite(r["loss"]) for r in _rows(exp))
    assert all(os.path.isfile(os.path.join(exp, f)) for f in ("config.yaml", "constants.pt", "checkpoints/0000006.pt"))
    snaps = sorted(os.listdir(os.path.join(exp, "ema")))
    assert snaps == ["0.050_0000003.npz", "0.050_0000006.npz", "0.100_0000003.npz", "0.100_0000006.npz"], snaps
    shapes = _whole_shapes()
    tree = torch.load(os.path.join(exp, "checkpoints", "0000006.pt"), weights_only=True)
    assert tree["step"] == 6 and tree["sampler_state"]["counts"].sum() > 0
    assert all(tuple(tree["model"][k].shape) == s for k, s in shapes.items())


def test_fsdp_sharded_run_resumes_on_two_ranks_and_on_one(tmp_path):
    flags = ["--fsdp", "true", "--checkpointer", "torch-sharded", "--log-every", "1", "--ckpt-every", "4",
             "--ema-snapshot-every", "4"]
    # the lead's magnitude probe draws from a generator of its own: the
    # ranks' streams stay in step, which the resume below shows
    first, _ = _torchrun(tmp_path / "a", "--num-steps", "6", "--log-magnitudes", *flags)
    shards = os.path.join(first, "checkpoints", "0000004.shards")
    assert sorted(os.listdir(shards)) == ["index.pt", "rank00000.pt", "rank00001.pt"]
    assert not os.path.exists(shards + ".tmp")
    # the EMA snapshots hold whole tensors, gathered for the lead
    shapes = _whole_shapes()
    with np.load(os.path.join(first, "ema", "0.050_0000004.npz")) as f:
        assert {k: f[k].shape for k in f.files} == shapes
    losses = [r["loss"] for r in _rows(first)]
    assert all(len(r["magnitudes"]["block_rms"]) == 6 for r in _rows(first))

    # two ranks: the run's own trajectory (the same slices of the same batches)
    again, _ = _torchrun(tmp_path / "a", "--num-steps", "6", "--resume", first, *flags)
    assert "resumed from" in open(os.path.join(again, "log.txt")).read()
    assert [r["step"] for r in _rows(again)] == [5, 6]
    np.testing.assert_allclose([r["loss"] for r in _rows(again)], losses[4:], rtol=1e-6)

    # one process: the same state, each global batch on one device
    one = train.main(train.build_parser().parse_args(
        [*COMMON, "--results-dir", str(tmp_path / "b"), "--num-steps", "6", "--log-every", "1", "--resume", shards]))
    assert f"resumed from {shards} at step 4" in open(os.path.join(one, "log.txt")).read()
    rows = _rows(one)
    assert [r["step"] for r in rows] == [5, 6] and all(np.isfinite(r["loss"]) for r in rows)


def test_tp_fsdp_run_on_four_ranks_resumes_on_one_process(tmp_path):
    """One torchrun launch of four ranks, --n-model 2 --fsdp true, with the
    loss-history sampler and the magnitude telemetry (every rank runs its
    probe on a model axis): a torch-sharded checkpoint of two data ranks'
    slices of the whole tree, whole EMA snapshots and .pt-shaped state,
    resumed on one process, whose loss history continues the run's."""
    flags = ["--timestep-sampler", "loss-second-moment", "--log-every", "1", "--ckpt-every", "4",
             "--ema-snapshot-every", "4"]
    first, exps = _torchrun(tmp_path / "a", "--num-steps", "6", "--n-model", "2", "--fsdp", "true", "--checkpointer",
                            "torch-sharded", "--log-magnitudes", *flags, ranks=4)
    assert len(exps) == 1, exps
    log = open(os.path.join(first, "log.txt")).read()
    assert "devices: 4x cpu; mesh data=2 model=2" in log and log.count("(step=") == 6, log
    shapes = _whole_shapes()
    assert f"model parameters: {sum(int(np.prod(s)) for s in shapes.values()):,}" in log
    rows = _rows(first)
    assert [r["step"] for r in rows] == list(range(1, 7)) and all(np.isfinite(r["loss"]) for r in rows)
    assert all(len(r["magnitudes"]["block_rms"]) == 6 and r["magnitudes"]["w_rms_dev_max"] < 1e-3 for r in rows)
    shards = os.path.join(first, "checkpoints", "0000004.shards")
    assert sorted(os.listdir(shards)) == ["index.pt", "rank00000.pt", "rank00001.pt"]
    with np.load(os.path.join(first, "ema", "0.050_0000004.npz")) as f:
        assert {k: f[k].shape for k in f.files} == shapes
    index = torch.load(os.path.join(shards, "index.pt"), weights_only=True)
    assert {k: tuple(v) for k, v in index["shapes"].items()} == shapes

    one = train.main(train.build_parser().parse_args(
        [*COMMON, "--results-dir", str(tmp_path / "b"), "--num-steps", "6", "--resume", shards, *flags,
         "--ckpt-every", "2"]))
    assert f"resumed from {shards} at step 4" in open(os.path.join(one, "log.txt")).read()
    resumed = _rows(one)
    assert [r["step"] for r in resumed] == [5, 6] and all(np.isfinite(r["loss"]) for r in resumed)
    # the history: 16 draws a step, the run's 64 carried into the resumed 96
    carried = index["sampler_state"]["counts"]
    after = torch.load(os.path.join(one, "checkpoints", "0000006.pt"), weights_only=True)["sampler_state"]["counts"]
    assert int(carried.sum()) == 4 * 16 and int(after.sum()) == 6 * 16, (carried.sum(), after.sum())
    assert bool((after >= carried).all())


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_sigterm_to_one_rank_stops_both_at_one_step(tmp_path):
    results = tmp_path / "results"
    port = str(_free_port())
    procs = [
        subprocess.Popen(
            [sys.executable, "-m", "mapdit_tpu_torch.train", *COMMON, "--results-dir", str(results),
             "--num-steps", "100000", "--log-every", "2", "--ema-snapshot-every", "0", "--checkpointer",
             "torch-sharded"],
            cwd=REPO, text=True, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            env=_env(RANK=str(r), WORLD_SIZE="2", LOCAL_RANK=str(r), LOCAL_WORLD_SIZE="2", MASTER_ADDR="localhost",
                     MASTER_PORT=port))
        for r in range(2)
    ]
    outs = [None, None]

    def drain(i):
        outs[i] = procs[i].communicate(timeout=240)[0]

    threads = [threading.Thread(target=drain, args=(i,)) for i in range(2)]
    for t in threads:
        t.start()
    try:
        logfile, deadline = None, time.time() + 180
        while time.time() < deadline and logfile is None:
            exps = os.listdir(results) if results.is_dir() else []
            candidate = os.path.join(results, exps[0], "log.txt") if exps else None
            if candidate and os.path.exists(candidate) and "(step=" in open(candidate).read():
                logfile = candidate
            assert all(p.poll() is None for p in procs), outs
            time.sleep(0.2)
        assert logfile, "no training progress"
        procs[1].send_signal(signal.SIGTERM)  # the non-lead only
        for t in threads:
            t.join(timeout=240)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    assert [p.returncode for p in procs] == [0, 0], outs
    log = open(logfile).read()
    assert "(SIGTERM) graceful stop at step" in log, log
    step = int(log.split("graceful stop at step ")[1].split(":")[0])
    assert step % 2 == 0 and step < 100000
    ckpts = os.listdir(os.path.join(os.path.dirname(logfile), "checkpoints"))
    assert ckpts == [f"{step:07d}.shards"], ckpts
    # both ranks wrote their slices at that step
    assert sorted(os.listdir(os.path.join(os.path.dirname(logfile), "checkpoints", ckpts[0]))) == [
        "index.pt", "rank00000.pt", "rank00001.pt"]
