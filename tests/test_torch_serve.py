"""The port's server (python -m mapdit_tpu_torch.serve) on the CPU, in
process, on a DiT-XS/8 experiment written by the port's train CLI.

Held to the JAX package's serve.py (loaded by path): the HTTP handler of
both packages over one stub service (status codes, headers, PNG pixels,
npz arrays, /metrics) and the admission checks of both SamplerServices.
Then the port alone, on one ThreadingHTTPServer of the module: the served
latents against build_sample_fn / build_cached_sample_fn on the same z and
generator, bit for bit; coalescing; program reuse; the 503, 504 and
admission-400 paths; --warmup-protocols; the fused preamble; the seed
rules; the refusals; the shared weights; main's SIGTERM.

The experiment's latent statistics are set to mean 0 and std 2**-13: the
untrained model's chains reach latents of a few 1e3, which denormalise then to
below 1 exactly (a power of two), so the served values, clipped to [-1, 1]
like every image, carry the chains' bits."""

import contextlib
import importlib.util
import io
import json
import os
import shutil
import signal
import threading
import time
import types
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch
from PIL import Image

from mapdit_tpu_torch import serve, train
from mapdit_tpu_torch.diffusion import create_diffusion, respacing_string
from mapdit_tpu_torch.runtime import build_cached_sample_fn, build_sample_fn
from mapdit_tpu_torch.sample import decode_latents, load_variables, run_config
from mapdit_tpu_torch.utils.experiment import load_config, save_config

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
torch.set_num_threads(2)  # as tests/test_torch_train_cli.py: workers share the cores
STATS_STD = 2.0**-13
DEFAULTS = {"steps": 4, "sampler": "dpm++", "cfg_scale": 4.0}
CPU = torch.device("cpu")


def jax_script(name):
    """A JAX root script as a module (its name would clash with the port's)."""
    spec = importlib.util.spec_from_file_location(f"jax_{name}", os.path.join(REPO, f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


jax_serve = jax_script("serve")


@pytest.fixture(autouse=True)
def _drop_tmp_path(tmp_path):
    """Each test's files go when it ends (a failing test's too): the tier-1
    run's tests write GBs of checkpoints and weights, and pytest keeps the
    last three runs' directories, so they filled the disk."""
    yield
    shutil.rmtree(tmp_path, ignore_errors=True)


@pytest.fixture(scope="module")
def exp(tmp_path_factory):
    """A 12-step DiT-XS/8 run of the port's train CLI (10 classes, EMA
    snapshots at 4, 8 and 12) with its latent statistics set as the module
    docstring says."""
    results = tmp_path_factory.mktemp("results")
    flags = ["--device", "cpu", "--data-path", "synthetic:64", "--model", "DiT-XS/8", "--num-classes", "10",
             "--batch-size", "8", "--num-lin-warmup", "2", "--start-decay", "8", "--num-steps", "12",
             "--log-every", "6", "--ckpt-every", "12", "--ema-snapshot-every", "4", "--results-dir", str(results)]
    exp_dir = train.main(train.build_parser().parse_args(flags))
    args = load_config(exp_dir)
    args["stats_mean"] = [0.0] * args["in_channels"]
    args["stats_std"] = [STATS_STD] * args["in_channels"]
    save_config(exp_dir, args)
    yield exp_dir
    shutil.rmtree(results, ignore_errors=True)


def start_http(handler):
    """An HTTP server of ``handler`` on an ephemeral port, serving from a
    thread: (server, base URL)."""
    server = serve.ServingHTTPServer(("127.0.0.1", 0), handler)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    return server, f"http://127.0.0.1:{server.server_address[1]}"


@pytest.fixture(scope="module")
def served(exp):
    """The module's service (buckets 1 and 4, 4-step default chains, no
    coalescing wait unless a test sets one) behind one HTTP server on an
    ephemeral port."""
    service = serve.SamplerService(exp, buckets=(1, 4), coalesce_ms=0.0, device="cpu")
    server, base = start_http(serve.make_handler(service, DEFAULTS))
    yield service, base
    server.shutdown()
    server.server_close()
    service.close()


def request(base, path, body=None, timeout=120):
    """(status, headers, body bytes) of a GET (body None) or a POST."""
    req = urllib.request.Request(base + path, data=body)
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            return resp.status, resp.headers, resp.read()
    except urllib.error.HTTPError as e:
        return e.code, e.headers, e.read()


def post(base, payload, timeout=120):
    return request(base, "/v1/sample", json.dumps(payload).encode(), timeout)


def npz(body):
    with np.load(io.BytesIO(body)) as f:
        return f["arr_0"]


def png(body):
    return np.asarray(Image.open(io.BytesIO(body)))


# the time limit of every wait in the tests that hold the dispatcher
HOLD_LIMIT_S = 60.0


def wait_until(predicate, what, limit=HOLD_LIMIT_S):
    """Poll ``predicate`` (the service's own counters) until it holds."""
    deadline = time.monotonic() + limit
    while not predicate():
        assert time.monotonic() < deadline, f"not within {limit:g} s: {what}"
        time.sleep(0.01)


@contextlib.contextmanager
def held_dispatcher(service, monkeypatch):
    """Hold the service's dispatcher in its coalescing window until the
    event this yields is set: the window's sleep (``serve``'s ``time.sleep``)
    waits on the event instead of a clock, so a test orders admission and
    dispatch without racing the dispatcher. Released on exit in any case."""
    release = threading.Event()

    def sleep(seconds):
        if not release.wait(timeout=HOLD_LIMIT_S):
            raise TimeoutError(f"the dispatcher was held past {HOLD_LIMIT_S:g} s")

    monkeypatch.setattr(serve, "time", types.SimpleNamespace(sleep=sleep, time=time.time,
                                                             perf_counter=time.perf_counter))
    service.coalesce_ms = 1.0  # the dispatcher enters the window on its next job
    try:
        yield release
    finally:
        release.set()
        service.coalesce_ms = 0.0


# ---------------------------------------------------------------------------
# the handler and the admission checks, against the JAX package


class StubService:
    """What make_handler calls: fixed counters, and samples (or errors) that
    depend on the request only; the last call's arguments are kept."""

    INFO = {"status": "ok", "model": "DiT-XS/8", "num_classes": 10, "buckets": [1, 4], "devices": 1,
            "mesh": {"data": 1, "model": 1}, "compiled_programs": 3, "request_latency_seconds_sum": 0.1234,
            "preamble": "host", "coalesce_ms": 3.0, "distilled": None, "flag": True}

    def __init__(self, module):
        self.module = module
        self.calls = []

    def info(self):
        return dict(self.INFO)

    def sample(self, labels, steps, sampler, cfg_scale, seed=None, **protocol):
        self.calls.append((labels, steps, sampler, cfg_scale, seed, protocol))
        errors = {7: self.module.QueueFullError("queue full"), 8: self.module.RequestTimeoutError("too late"),
                  9: RuntimeError("boom")}
        if labels[0] in errors:
            raise errors[labels[0]]
        if len(labels) > 4:
            raise ValueError(f"num_samples {len(labels)} exceeds the largest batch bucket 4")
        channels = 3 if sampler == "ddim" else 4  # RGB grids and four-channel latent grids
        rng = np.random.default_rng(sum(labels) + 10 * steps)
        return rng.uniform(-1.2, 1.2, (len(labels), channels, 8, 8)).astype(np.float32)


BODIES = {
    "png": {"class_label": 3, "num_samples": 3, "seed": 1},
    "npz-ddpm": {"class_labels": [1, 2], "format": "npz", "sampler": "ddpm"},
    "rgb-grid": {"class_labels": [1, 2, 3, 4], "sampler": "ddim", "steps": 9},
    "every-field": {"class_labels": [1], "steps": 8, "sampler": "unipc", "cfg_scale": 1.5, "schedule": "karras",
                    "cache_interval": 2, "cache_mode": "hold", "cfg_interval": [0.3, 3.0],
                    "dynamic_threshold": 0.99, "seed": 5, "format": "npz"},
    "empty-body": b"",
    "malformed-json": b"{not json",
    "json-array": b"[1, 2]",
    "bad-sampler": {"class_label": 1, "sampler": "euler"},
    "bad-schedule": {"class_label": 1, "schedule": "exp"},
    "bad-format": {"class_label": 1, "format": "jpeg"},
    "steps-0": {"class_label": 1, "steps": 0},
    "steps-1001": {"class_label": 1, "steps": 1001},
    "labels-int": {"class_labels": 5},
    "labels-dict": {"class_labels": {"a": 1}},
    "num-samples-list": {"class_label": 1, "num_samples": [2]},
    "label-list": {"class_label": [1]},
    "cache-interval-str": {"class_label": 1, "cache_interval": "x"},
    "oversize": {"class_label": 1, "num_samples": 64},
    "503": {"class_label": 7},
    "504": {"class_label": 8},
    "500": {"class_label": 9},
}


@pytest.fixture(scope="module")
def handlers():
    """Both packages' handlers over stub services, each on its own HTTP
    server: {"jax": (stub, base), "torch": (stub, base)}."""
    out, servers = {}, []
    for name, module in (("jax", jax_serve), ("torch", serve)):
        stub = StubService(module)
        server, base = start_http(module.make_handler(stub, DEFAULTS))
        servers.append(server)
        out[name] = (stub, base)
    yield out
    for server in servers:
        server.shutdown()
        server.server_close()


def response_view(status, headers, body):
    """What must agree: the status, the content type, the two headers the
    server sets, and the body decoded by its type."""
    ctype = headers["Content-Type"]
    if ctype == "image/png":
        content = png(body).tolist()
    elif ctype == "application/x-npz":
        arr = npz(body)
        content = (arr.dtype.str, arr.tolist())
    elif ctype == "application/json":
        content = json.loads(body)
    else:
        content = body.decode()
    return status, ctype, headers.get("Retry-After"), headers.get("X-Seed-Deterministic"), content


@pytest.mark.parametrize("name", list(BODIES))
def test_post_matches_jax_handler(handlers, name):
    body = BODIES[name]
    raw = body if isinstance(body, bytes) else json.dumps(body).encode()
    views, calls = {}, {}
    for pkg, (stub, base) in handlers.items():
        stub.calls.clear()
        views[pkg] = response_view(*request(base, "/v1/sample", raw))
        calls[pkg] = stub.calls[:]
    assert views["torch"] == views["jax"]
    assert calls["torch"] == calls["jax"]  # the same arguments reached the service
    status = views["torch"][0]
    want = {"503": 503, "504": 504, "500": 500}.get(name, 200 if name in ("png", "npz-ddpm", "rgb-grid",
                                                                          "every-field", "empty-body") else 400)
    assert status == want


@pytest.mark.parametrize("method, path", [("GET", "/healthz"), ("GET", "/info"), ("GET", "/metrics"),
                                          ("GET", "/nope"), ("POST", "/nope")])
def test_paths_match_jax_handler(handlers, method, path):
    views = {pkg: response_view(*request(base, path, b"{}" if method == "POST" else None))
             for pkg, (_, base) in handlers.items()}
    assert views["torch"] == views["jax"]
    if path == "/metrics":
        text = views["torch"][4]
        assert "# TYPE mapdit_compiled_programs gauge\nmapdit_compiled_programs 3\n" in text
        assert "mapdit_flag" not in text and "mapdit_status" not in text


def bare_service(cls, **attrs):
    """A SamplerService without its __init__: the attributes sample()'s
    admission reads, for a service of buckets 1 and 4 and 10 classes."""
    service = cls.__new__(cls)
    state = dict(_distilled=False, _student_steps=None, buckets=(1, 4), cfg=types.SimpleNamespace(num_classes=10),
                 _cv=threading.Condition(), _pending=0, max_pending=64, _fns={}, max_programs=32, _rejected=0,
                 mesh=None)
    state.update(attrs)
    for key, value in state.items():
        setattr(service, key, value)
    return service


OTHER_PROGRAM = ("ddim", 4, 1.0, 1, "uniform", 0, None, "hold", None)
ADMISSION = {
    "no-labels": (dict(class_labels=[]), {}),
    "oversize": (dict(class_labels=[1] * 5), {}),
    "label-10": (dict(class_labels=[10]), {}),
    "label-negative": (dict(class_labels=[-1]), {}),
    "seed-str": (dict(seed="abc"), {}),
    "seed-list": (dict(seed=[1]), {}),
    "seed-negative": (dict(seed=-1), {}),
    "seed-2**63": (dict(seed=2**63), {}),
    "cfg-scale-str": (dict(cfg_scale="x"), {}),
    "cache-ddim": (dict(sampler="ddim", cache_interval=2), {}),
    "cache-not-dividing": (dict(cache_interval=3), {}),
    "cache-negative": (dict(cache_interval=-1), {}),
    "cache-mode": (dict(cache_mode="x"), {}),
    "cfg-interval-one": (dict(cfg_interval=[1.0]), {}),
    "cfg-interval-order": (dict(cfg_interval=[2.0, 1.0]), {}),
    "cfg-interval-str": (dict(cfg_interval="ab"), {}),
    "cfg-interval-no-cfg": (dict(cfg_interval=[0.3, 3.0], cfg_scale=1.0), {}),
    "cfg-interval-ddim": (dict(cfg_interval=[0.3, 3.0], sampler="ddim"), {}),
    "threshold-0": (dict(dynamic_threshold=0), {}),
    "threshold-1.5": (dict(dynamic_threshold=1.5), {}),
    "threshold-str": (dict(dynamic_threshold="x"), {}),
    "distilled-cache": (dict(cache_interval=2), dict(_distilled=True, _student_steps=2)),
    "distilled-cfg-interval": (dict(cfg_interval=[0.3, 3.0]), dict(_distilled=True, _student_steps=2)),
    "queue-full": ({}, dict(_pending=64)),
    "program-budget": ({}, dict(max_programs=1, _fns={OTHER_PROGRAM: None})),
}


@pytest.mark.parametrize("name", list(ADMISSION))
def test_admission_matches_jax(name):
    """An invalid request raises the same exception, with the same message,
    in both SamplerServices, before anything is queued."""
    overrides, attrs = ADMISSION[name]
    call = {**dict(class_labels=[1, 2], steps=4, sampler="dpm++", cfg_scale=4.0), **overrides}
    raised = {}
    for pkg, module in (("jax", jax_serve), ("torch", serve)):
        service = bare_service(module.SamplerService, **attrs)
        with pytest.raises(Exception) as info:
            service.sample(**call)
        raised[pkg] = (type(info.value).__name__, str(info.value))
        assert service._pending == attrs.get("_pending", 0)
    assert raised["torch"] == raised["jax"]
    assert raised["torch"][0] == ("QueueFullError" if name == "queue-full" else "ValueError")


# ---------------------------------------------------------------------------
# the port's service


def chain_reference(service, exp, labels, seed, steps, sampler, cfg_scale, counter, schedule="uniform",
                    cache_interval=0, cache_mode="forecast", **kw):
    """What the server must return for one seeded request run alone: the
    port's build_sample_fn / build_cached_sample_fn on the host preamble's z
    and generator, decoded."""
    train_args = load_config(exp)
    cfg = run_config(train_args, None)
    sd = load_variables(exp, train_args)
    n = len(labels)
    bucket = service._bucket(n)
    z = torch.cat([serve.draw(seed, (n, 4, 16, 16), CPU), torch.zeros(bucket - n, 4, 16, 16)])
    y = torch.tensor(list(labels) + [0] * (bucket - n))
    guidance = cfg_scale if cfg_scale > 1.0 else None
    if guidance:
        z, y = torch.cat([z, z]), torch.cat([y, torch.full_like(y, cfg.num_classes)])
    diffusion = create_diffusion(respacing_string(steps, sampler, schedule), device=CPU)
    if cache_interval > 1:
        fn = build_cached_sample_fn(cfg, sd, diffusion, cfg_scale=guidance, cache_interval=cache_interval,
                                    sampler=sampler, cache_mode=cache_mode, device=CPU, **kw)
    else:
        fn = build_sample_fn(cfg, sd, diffusion, cfg_scale=guidance, sampler=sampler, batch_hint=bucket, device=CPU,
                             **kw)
    out = fn(z, y, serve.generator(serve.chain_seed(0, counter), CPU))[:n].numpy()
    return decode_latents(out, train_args, False)


PROTOCOLS = {
    "ddpm": dict(sampler="ddpm", steps=2, cfg_scale=1.5),
    "ddpm-no-cfg": dict(sampler="ddpm", steps=2, cfg_scale=1.0),
    "ddim": dict(sampler="ddim", steps=4, cfg_scale=4.0),
    "dpm++-karras": dict(sampler="dpm++", steps=4, cfg_scale=4.0, schedule="karras"),
    "unipc": dict(sampler="unipc", steps=4, cfg_scale=4.0),
    "dpm++-cfg-interval": dict(sampler="dpm++", steps=4, cfg_scale=4.0, cfg_interval=(0.3, 3.0)),
    "unipc-cfg-interval": dict(sampler="unipc", steps=4, cfg_scale=4.0, cfg_interval=(0.3, 3.0)),
    "dpm++-threshold": dict(sampler="dpm++", steps=4, cfg_scale=4.0, dynamic_threshold=0.99),
    "cached-dpm++-hold": dict(sampler="dpm++", steps=4, cfg_scale=4.0, cache_interval=2, cache_mode="hold"),
    "cached-dpm++-forecast": dict(sampler="dpm++", steps=4, cfg_scale=4.0, cache_interval=2, cache_mode="forecast"),
    "cached-ddpm": dict(sampler="ddpm", steps=2, cfg_scale=1.5, cache_interval=2),
}


@pytest.mark.parametrize("name", list(PROTOCOLS))
def test_served_latents_equal_the_chain_functions(served, exp, name):
    """One seeded request of three samples (bucket 4) against the chain
    functions on the same z, labels and chain generator: the same bits."""
    service, _ = served
    proto = dict(PROTOCOLS[name])
    labels, seed = [1, 2, 3], 11
    got = service.sample(labels, proto.pop("steps"), proto.pop("sampler"), proto.pop("cfg_scale"), seed=seed,
                         **proto)
    counter = service._request_counter
    proto = dict(PROTOCOLS[name])
    want = chain_reference(service, exp, labels, seed, counter=counter, **proto)
    assert got.shape == (3, 4, 16, 16) and np.isfinite(got).all()
    assert np.abs(got).max() < 1  # nothing clipped: the comparison sees the chain's values
    np.testing.assert_array_equal(got, want)


def test_http_formats_and_seed_determinism(served):
    service, base = served
    status, headers, body = post(base, {"class_labels": [1, 2, 3], "seed": 7, "format": "npz"})
    assert status == 200 and headers["Content-Type"] == "application/x-npz"
    assert headers["X-Seed-Deterministic"] == "true"
    arr = npz(body)
    assert arr.shape == (3, 16, 16, 4) and arr.dtype == np.uint8 and arr.std() > 0
    np.testing.assert_array_equal(npz(post(base, {"class_labels": [1, 2, 3], "seed": 7, "format": "npz"})[2]), arr)
    assert not np.array_equal(npz(post(base, {"class_labels": [1, 2, 3], "seed": 8, "format": "npz"})[2]), arr)
    status, headers, body = post(base, {"class_label": 3, "num_samples": 3, "seed": 7, "sampler": "ddpm",
                                        "steps": 2})
    assert status == 200 and headers["Content-Type"] == "image/png"
    assert headers["X-Seed-Deterministic"] == "false"
    assert png(body).shape == (2 * 18 + 2, 2 * 18 + 2, 4)


def test_coalescing_is_invariant_within_a_bucket(served, monkeypatch):
    """Two concurrent two-sample requests run as one batch of bucket 4, and
    each gets the bits it gets alone (also bucket 4); different seeds give
    different rows. The dispatcher is held until both are queued."""
    service, base = served
    proto = {"steps": 4, "sampler": "dpm++", "cfg_scale": 4.0, "format": "npz"}
    alone = {seed: npz(post(base, {**proto, "class_labels": [5, 6], "seed": seed})[2]) for seed in (11, 12)}
    before = service.info()["coalesced_batches"]
    results = {}

    def fire(seed):
        results[seed] = npz(post(base, {**proto, "class_labels": [5, 6], "seed": seed}, timeout=HOLD_LIMIT_S)[2])

    with held_dispatcher(service, monkeypatch) as release:
        threads = [threading.Thread(target=fire, args=(seed,)) for seed in (11, 12)]
        for t in threads:
            t.start()
        wait_until(lambda: service.info()["pending"] == 2, "both requests queued")
        release.set()
        for t in threads:
            t.join(timeout=HOLD_LIMIT_S)
        assert not any(t.is_alive() for t in threads)
    assert service.info()["coalesced_batches"] == before + 1
    for seed in (11, 12):
        np.testing.assert_array_equal(results[seed], alone[seed])
    assert not np.array_equal(results[11], results[12])


# bucket 1 against bucket 4 on the CPU: torch's f32 matrix products tile
# their sums by the row count, so the two differ in the last bits, which
# the chain carries on. Measured: at most 7.2e-7 relative L2 over eight
# seeds of each of dpm++, ddim and unipc (4 steps, CFG 4), 1.8e-7 under the
# fused preamble; 1e-5 is ~80 f32 ulps
ACROSS_BUCKETS_REL = 1e-5


def rel(a, b):
    return float(np.linalg.norm((a - b).ravel()) / np.linalg.norm(b.ravel()))


def test_across_buckets_within_tolerance(served):
    service, _ = served
    one = service.sample([5], 4, "dpm++", 4.0, seed=21)  # bucket 1
    four = service.sample([5, 6], 4, "dpm++", 4.0, seed=21)  # bucket 4; row 0 has the same z
    assert rel(one[0], four[0]) <= ACROSS_BUCKETS_REL


def test_programs_are_reused(served):
    service, base = served
    proto = {"steps": 4, "sampler": "ddim", "cfg_scale": 1.0, "schedule": "uniform"}
    post(base, {**proto, "class_label": 1})
    programs, batches = service.info()["compiled_programs"], service.info()["batches_run"]
    for labels in ([1], [2], [3]):
        assert post(base, {**proto, "class_labels": labels})[0] == 200
    info = service.info()
    assert info["compiled_programs"] == programs and info["batches_run"] == batches + 3
    assert post(base, {**proto, "class_labels": [1, 2]})[0] == 200  # bucket 4: one more program
    assert service.info()["compiled_programs"] == programs + 1
    assert info["chain_seconds_count"] >= 3 and info["compile_seconds_count"] >= 1
    assert info["request_latency_seconds_count"] >= 4


def test_queue_full_503(served, monkeypatch):
    """Past --max-pending a request gets a 503 with Retry-After at once: "b"
    is sent once the service counts "a" as pending, with the dispatcher held
    so that "a" stays queued."""
    service, base = served
    proto = {"class_label": 1, "steps": 2, "sampler": "dpm++", "cfg_scale": 1.0}
    codes, rejected = {}, service.info()["rejected"]

    def fire(name):
        status, headers, _ = post(base, proto, timeout=HOLD_LIMIT_S)
        codes[name] = (status, headers.get("Retry-After"))

    service.max_pending = 1
    try:
        with held_dispatcher(service, monkeypatch) as release:
            first = threading.Thread(target=fire, args=("a",))
            first.start()
            wait_until(lambda: service.info()["pending"] == 1, "request a queued")
            fire("b")
            release.set()
            first.join(timeout=HOLD_LIMIT_S)
            assert not first.is_alive()
    finally:
        service.max_pending = 64
    assert codes == {"a": (200, None), "b": (503, "5")}
    assert service.info()["rejected"] == rejected + 1 and service.info()["pending"] == 0


def test_timeout_504_skips_the_queued_job_and_recovers(served, monkeypatch):
    """Jobs whose deadline passes while queued get 504s and are never run;
    the server then serves the same protocol. The dispatcher is held past
    both deadlines, then released to drop both."""
    service, base = served
    proto = {"class_label": 1, "steps": 2, "sampler": "dpm++", "cfg_scale": 1.0}
    post(base, proto)  # built
    codes, info0 = {}, service.info()

    def fire(name):
        codes[name] = post(base, proto, timeout=HOLD_LIMIT_S)[0]

    service.request_timeout_s = 0.4
    try:
        with held_dispatcher(service, monkeypatch) as release:
            threads = [threading.Thread(target=fire, args=(name,)) for name in ("a", "b")]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=HOLD_LIMIT_S)
            assert codes == {"a": 504, "b": 504}
            release.set()
            # the dispatcher takes both from the queue, finds them abandoned, runs nothing
            wait_until(lambda: service.info()["pending"] == 0, "both abandoned jobs dropped")
    finally:
        service.request_timeout_s = 600.0
    info = service.info()
    assert info["timeouts"] == info0["timeouts"] + 2 and info["batches_run"] == info0["batches_run"]
    assert post(base, proto)[0] == 200


def test_program_budget_400_at_admission(served):
    service, base = served
    known = {"class_label": 1, "steps": 2, "sampler": "dpm++", "cfg_scale": 1.0}
    post(base, known)
    service.max_programs = len(service._fns)
    try:
        status, _, body = post(base, {**known, "steps": 3})
        assert status == 400 and "compile budget" in json.loads(body)["error"]
        assert post(base, {**known, "class_label": 2})[0] == 200
    finally:
        service.max_programs = 32


def test_warmup_protocols(exp):
    """--warmup-protocols builds and runs its protocols at the largest
    bucket at startup; a request of that protocol then reuses it."""
    args = serve.build_parser().parse_args([
        "--result-dir", exp, "--device", "cpu", "--port", "0", "--buckets", "1,4", "--default-steps", "4",
        "--warmup", "false", "--coalesce-ms", "0",
        "--warmup-protocols", '[{"steps": 2, "sampler": "dpm++", "cfg_scale": 4.0, "cfg_interval": [0.3, 3.0]}]'])
    server, service = serve.build_server(args, serve.build_service(args))
    try:
        assert service.info()["compiled_programs"] == 1 and service.info()["compile_seconds_count"] == 1
        service.sample([1, 2, 3, 4], 2, "dpm++", 4.0, cfg_interval=[0.3, 3.0])
        info = service.info()
        assert info["compiled_programs"] == 1 and info["chain_seconds_count"] == 1
    finally:
        server.server_close()
        service.close()


def test_fused_preamble(exp):
    """Each row's z from its own generator: a row is the same alone and in a
    larger batch (bucket 1 against bucket 4, within ACROSS_BUCKETS_REL) and
    equals build_sample_fn on the rule's z; the seed is deterministic and a
    seed past 2**32 does not alias its low bits."""
    service = serve.SamplerService(exp, buckets=(1, 4), coalesce_ms=0.0, device="cpu", preamble="fused")
    try:
        assert service.info()["preamble"] == "fused"
        pair = service.sample([1, 1], 4, "ddim", 1.0, seed=3)
        np.testing.assert_array_equal(service.sample([1, 1], 4, "ddim", 1.0, seed=3), pair)
        alone = service.sample([1], 4, "ddim", 1.0, seed=3)
        assert rel(alone[0], pair[0]) <= ACROSS_BUCKETS_REL
        assert not np.array_equal(pair[0], pair[1])  # rows differ within a job
        big = service.sample([1], 4, "ddim", 1.0, seed=2**40 + 3)
        assert serve.row_seed(2**40 + 3, 0) != serve.row_seed(3, 0) and not np.array_equal(big, alone)

        counter = service._request_counter + 1
        got = service.sample([1, 2], 4, "dpm++", 4.0, seed=5)  # CFG doubling inside the program
        train_args = load_config(exp)
        cfg = run_config(train_args, None)
        z = torch.cat([torch.stack([serve.draw(serve.row_seed(5, r), (4, 16, 16), CPU) for r in range(2)]),
                       torch.zeros(2, 4, 16, 16)])
        y = torch.tensor([1, 2, 0, 0])
        fn = build_sample_fn(cfg, load_variables(exp, train_args), create_diffusion("4", device=CPU), cfg_scale=4.0,
                             sampler="dpm++", batch_hint=4, device=CPU)
        want = fn(torch.cat([z, z]), torch.cat([y, torch.full_like(y, 10)]),
                  serve.generator(serve.chain_seed(0, counter), CPU))[:2].numpy()
        np.testing.assert_array_equal(got, decode_latents(want, train_args, False))
    finally:
        service.close()


def test_seed_rules():
    """Unseeded jobs draw from seeds no explicit seed can take; the streams
    differ by their tags, the counter and the server seed."""
    anon = {serve.anon_job_seed(0, counter) for counter in range(1, 200)}
    assert len(anon) == 199 and all(2**63 <= s < 2**64 for s in anon)
    assert serve.chain_seed(0, 1) != serve.chain_seed(0, 2) != serve.chain_seed(1, 2)
    assert serve.row_seed(3, 0) != serve.row_seed(3, 1) != serve.anon_row_seed(0, 3, 1)
    assert serve.row_seed(2**32 + 3, 0) != serve.row_seed(3, 0)
    a, b = serve.draw(7, (2, 3), CPU), serve.draw(7, (2, 3), CPU)
    assert torch.equal(a, b) and not torch.equal(a, serve.draw(8, (2, 3), CPU))


def test_unseeded_requests_differ(served):
    service, _ = served
    a = service.sample([1], 4, "dpm++", 4.0)
    b = service.sample([1], 4, "dpm++", 4.0)
    assert not np.array_equal(a, b)


def test_weights_are_prepared_once(served):
    """Every program, exact or cached, of every bucket, runs on the one
    prepared model and weight stack."""
    service, _ = served
    service.sample([1], 2, "dpm++", 4.0, seed=1, cache_interval=2)
    service.sample([1, 2], 2, "unipc", 4.0, seed=1)
    service.sample([1], 2, "unipc", 4.0, seed=1)
    programs = [fn for fn, _ in service._fns.values()]
    assert len(programs) >= 3 and any(hasattr(fn, "span") for fn in programs)  # a cached program among them
    assert all(fn.prepared is service._prepared for fn in programs)


def test_weight_stack_is_built_once(exp):
    """Under mega_stack (here named: on the CPU auto stays per block) the
    programs of every bucket share the one bf16 weight stack."""
    service = serve.SamplerService(exp, buckets=(1, 4), coalesce_ms=0.0, device="cpu", block_kernel="mega_stack")
    try:
        service.sample([1], 2, "dpm++", 4.0, seed=1)
        service.sample([1, 2], 2, "dpm++", 4.0, seed=1)
        stacks = [fn.prepared["block_stack"] for fn, _ in service._fns.values()]
        assert len(stacks) == 2 and all(s is service._prepared["block_stack"] for s in stacks)
        assert service._prepared["block_stack"]["w_qkv"].dtype == service.cfg.dtype
    finally:
        service.close()


@pytest.mark.parametrize("kw, match", [
    (dict(n_model=2), "does not divide the 1-rank world"),  # JAX's rule: n_model divides the fleet
    (dict(preamble="jit"), "preamble"),
])
def test_refusals(exp, kw, match):
    with pytest.raises((NotImplementedError, ValueError), match=match):
        serve.SamplerService(exp, device="cpu", **kw)


def test_shard_under_a_distributed_world_raises(exp, monkeypatch):
    """Under a torchrun world of several ranks ``--shard true`` serves over
    the process group, which the service does not join itself (``main``
    does); ``--shard false`` is one independent server a rank."""
    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(RuntimeError, match="join it first"):
        serve.SamplerService(exp, device="cpu")
    serve.SamplerService(exp, device="cpu", shard=False).close()  # one process a device: served


def test_device_defaults_to_cuda(exp, monkeypatch):
    assert serve.build_parser().parse_args(["--result-dir", exp]).device == "cuda"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        serve.SamplerService(exp)


def test_main_serves_until_sigterm(exp, monkeypatch, capsys):
    """main(): warm-up, /healthz, /metrics, a PNG and an npz over HTTP on an
    ephemeral port, then SIGTERM: it returns and puts the old handler back."""
    built = {}
    build_server = serve.build_server

    def spy(args, service):
        built["server"], built["service"] = build_server(args, service)
        return built["server"], built["service"]

    monkeypatch.setattr(serve, "build_server", spy)
    seen = {}

    def client():
        while "server" not in built:
            time.sleep(0.05)
        base = f"http://127.0.0.1:{built['server'].server_address[1]}"
        seen["healthz"] = json.loads(request(base, "/healthz")[2])
        seen["metrics"] = request(base, "/metrics")[2].decode()
        seen["png"] = post(base, {"class_label": 3, "num_samples": 2, "seed": 1})
        seen["npz"] = post(base, {"class_labels": [1, 2], "format": "npz"})
        os.kill(os.getpid(), signal.SIGTERM)

    previous = signal.getsignal(signal.SIGTERM)
    thread = threading.Thread(target=client, daemon=True)
    thread.start()
    serve.main(serve.build_parser().parse_args(
        ["--result-dir", exp, "--device", "cpu", "--port", "0", "--buckets", "1,4", "--default-steps", "2"]))
    thread.join(timeout=60)
    assert not thread.is_alive() and signal.getsignal(signal.SIGTERM) is previous
    assert seen["healthz"]["devices"] == 1 and seen["healthz"]["mesh"] == {"data": 1, "model": 1}
    assert seen["healthz"]["compiled_programs"] == 1  # the warm-up's
    assert "mapdit_batches_run " in seen["metrics"] and "mapdit_chain_seconds_sum " in seen["metrics"]
    assert seen["png"][0] == 200 and png(seen["png"][2]).shape == (20, 38, 4)
    assert seen["npz"][0] == 200 and npz(seen["npz"][2]).shape == (2, 16, 16, 4)
    out = capsys.readouterr().out
    assert "warmup compile done" in out and "SIGTERM: shutting down" in out and "stopped" in out
    assert not built["service"]._dispatcher.is_alive()
