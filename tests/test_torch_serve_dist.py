"""The port's server on several ranks (``--shard true``, ``--n-model``): the
twins of JAX ``tests/test_serve.py:215 test_sharded_serving_virtual_mesh``
and ``:260 test_tensor_parallel_serving_virtual_mesh``, on gloo CPU ranks.

  * One spawn of two ranks runs ``SamplerService`` as one service (the lead
    samples in process, the other rank follows; bodies in
    ``tests/torch_serve_ranks.py``): (2, 1) and (1, 2) against the
    one-device server's floats and chains, the refusals of a world of two.
  * ``python -m torch.distributed.run --nproc-per-node 2 -m
    mapdit_tpu_torch.serve --shard true`` over HTTP: /healthz, PNG and npz,
    a bucket fill the data axis does not divide, a cached request.
  * Four ranks started with the environment torchrun gives them (so that
    the lead can be signalled and every exit code read) with ``--n-model
    2``: the (2, 2) mesh, a request, the cached 400, then SIGTERM to the
    lead: every rank exits 0.

The experiment is a 4-step XS/8 run of the train CLI with its latent
statistics set to mean 0 and std 2**-13, as in ``tests/test_torch_serve.py``.
"""

import io
import json
import os
import shutil
import signal
import socket
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

import torch_serve_ranks
from mapdit_tpu_torch import serve, train
from mapdit_tpu_torch.parallel import spawn
from mapdit_tpu_torch.utils.experiment import load_config, save_config

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TORCHRUN_ENV = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "LOCAL_WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")
SERVE = ["-m", "mapdit_tpu_torch.serve", "--device", "cpu", "--port", "0", "--buckets", "1,4", "--default-steps",
         "2", "--coalesce-ms", "0", "--shard", "true"]
torch.set_num_threads(2)


@pytest.fixture(scope="module")
def exp(tmp_path_factory):
    results = tmp_path_factory.mktemp("results")
    flags = ["--device", "cpu", "--data-path", "synthetic:64", "--model", "DiT-XS/8", "--num-classes", "10",
             "--batch-size", "8", "--num-lin-warmup", "2", "--start-decay", "2", "--num-steps", "4",
             "--log-every", "2", "--ckpt-every", "4", "--ema-snapshot-every", "2", "--results-dir", str(results)]
    exp_dir = train.main(train.build_parser().parse_args(flags))
    args = load_config(exp_dir)
    args["stats_mean"] = [0.0] * args["in_channels"]
    args["stats_std"] = [2.0**-13] * args["in_channels"]
    save_config(exp_dir, args)
    yield exp_dir
    shutil.rmtree(results, ignore_errors=True)


def test_service_on_spawned_ranks(exp):
    """(2, 1) and (1, 2) as one service on two spawned gloo ranks against
    the one-device server: dpm++ (no step noise) to 1e-5 of its largest
    value on the shard_map layout, and to 1e-4 through tensor parallelism,
    whose row-parallel sums round in another order (the chain's first step
    amplifies both); ddpm bit for bit per rank (torch_serve_ranks)."""
    one = serve.SamplerService(exp, buckets=torch_serve_ranks.BUCKETS, coalesce_ms=0.0, device="cpu")
    try:
        dpm_ref = one.sample([1, 2, 3, 4], torch_serve_ranks.STEPS, "dpm++", torch_serve_ranks.CFG_SCALE, seed=5)
    finally:
        one.close()
    spawn(torch_serve_ranks.run_cases, 2, args=(exp, dict(dpm_ref=dpm_ref, tp_tol=1e-4)), device="cpu")


def _env(**extra):
    env = {k: v for k, v in os.environ.items() if k not in TORCHRUN_ENV}
    env.update(OMP_NUM_THREADS="1", **extra)
    return env


def _wait_listening(proc, out):
    """The lead's port, from its "listening on" line (read from a thread)."""
    deadline = time.time() + 180
    while time.time() < deadline:
        text = "".join(out)
        if "listening on http://" in text:
            return int(text.split("listening on http://")[1].split()[0].rsplit(":", 1)[1])
        if proc.poll() is not None:
            raise AssertionError("the server exited:\n" + text[-4000:])
        time.sleep(0.2)
    raise AssertionError("no listening line:\n" + "".join(out)[-4000:])


def _drain(proc, out):
    thread = threading.Thread(target=lambda: [out.append(line) for line in proc.stdout], daemon=True)
    thread.start()
    return thread


def _request(base, path, body=None):
    req = urllib.request.Request(base + path, data=body)
    try:
        with urllib.request.urlopen(req, timeout=120) as resp:
            return resp.status, resp.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def _post(base, payload):
    return _request(base, "/v1/sample", json.dumps(payload).encode())


def _npz(body):
    with np.load(io.BytesIO(body)) as f:
        return f["arr_0"]


def test_torchrun_data_parallel_server(exp):
    """``torchrun`` of two CPU ranks, (2, 1): /healthz's devices and mesh; a
    dpm++ request's npz within one level of the one-device server's (the
    uint8 rounding of floats equal to f32); PNG; a one-sample fill of the
    4-bucket and a 1-bucket (not divisible: every rank runs it whole); a
    cached request on the data axis. torchrun's SIGTERM reaches both ranks:
    the lead stops and the follower leaves on the lead's stop."""
    one = serve.SamplerService(exp, buckets=(1, 4), coalesce_ms=0.0, device="cpu")
    try:
        want = serve.to_uint8(one.sample([1, 2, 3, 4], 2, "dpm++", 4.0, seed=3))
    finally:
        one.close()
    proc = subprocess.Popen(
        [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node", "2", *SERVE,
         "--result-dir", exp],
        cwd=REPO, env=_env(), stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    out = []
    _drain(proc, out)
    try:
        base = f"http://127.0.0.1:{_wait_listening(proc, out)}"
        info = json.loads(_request(base, "/healthz")[1])
        assert info["devices"] == 2 and info["mesh"] == {"data": 2, "model": 1}, info
        status, body = _post(base, {"class_labels": [1, 2, 3, 4], "seed": 3, "format": "npz"})
        assert status == 200
        got = _npz(body)
        assert got.shape == want.shape and np.abs(got.astype(int) - want).max() <= 1
        assert (got == want).mean() > 0.999
        assert _post(base, {"class_label": 2, "num_samples": 1, "seed": 4})[0] == 200  # PNG, the 1-bucket
        status, body = _post(base, {"class_labels": [1, 2], "format": "npz"})  # a fill of the 4-bucket
        assert status == 200 and _npz(body).shape == (2, 16, 16, 4)
        status, body = _post(base, {"class_labels": [1, 2, 3, 4], "cache_interval": 2,
                                    "format": "npz"})
        assert status == 200 and _npz(body).shape == (4, 16, 16, 4)
        info = json.loads(_request(base, "/healthz")[1])
        assert info["batches_run"] == 5 and info["compiled_programs"] == 3, info
    finally:
        proc.send_signal(signal.SIGTERM)
        proc.wait(timeout=120)
    text = "".join(out)
    assert "[serve] stopped" in text and "[serve] rank 1 stopped" in text, text[-4000:]


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_tensor_parallel_server_on_four_ranks_stops_on_sigterm(exp):
    """Four ranks, ``--n-model 2``: the (2, 2) mesh on /healthz; a dpm++
    request whose four rows split over the data axis and a one-sample
    request (bucket 1: the whole batch on each model pair); a cached
    request gets a 400 naming "tensor-parallel"; SIGTERM to the lead: it
    finishes, broadcasts the stop, and all four ranks exit 0."""
    port = str(_free_port())
    procs, outs = [], []
    for r in range(4):
        procs.append(subprocess.Popen(
            [sys.executable, *SERVE, "--n-model", "2", "--result-dir", exp], cwd=REPO, text=True,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            env=_env(RANK=str(r), WORLD_SIZE="4", LOCAL_RANK=str(r), LOCAL_WORLD_SIZE="4", MASTER_ADDR="localhost",
                     MASTER_PORT=port)))
        outs.append([])
        _drain(procs[-1], outs[-1])
    try:
        base = f"http://127.0.0.1:{_wait_listening(procs[0], outs[0])}"
        info = json.loads(_request(base, "/healthz")[1])
        assert info["devices"] == 4 and info["mesh"] == {"data": 2, "model": 2}, info
        status, body = _post(base, {"class_labels": [1, 2, 3, 4], "seed": 3, "format": "npz"})
        assert status == 200 and _npz(body).shape == (4, 16, 16, 4)
        status, body = _post(base, {"class_label": 2, "num_samples": 1, "seed": 4, "format": "npz"})
        assert status == 200 and _npz(body).shape == (1, 16, 16, 4)
        status, body = _post(base, {"class_label": 2, "num_samples": 1, "cache_interval": 2, "sampler": "dpm++"})
        assert status == 400 and "tensor-parallel" in json.loads(body)["error"]
        procs[0].send_signal(signal.SIGTERM)
        codes = [p.wait(timeout=120) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    assert codes == [0, 0, 0, 0], ["".join(o)[-2000:] for o in outs]
    assert "[serve] stopped" in "".join(outs[0])
