"""Batching HTTP inference server around the sampling chains, port of the
JAX package's ``serve.py``.

    python -m mapdit_tpu_torch.serve --result-dir results/000-DiT-S-2 --port 8000
    python -m mapdit_tpu_torch.serve --device cpu --result-dir results/000-DiT-XS-8 --port 0
    curl -s -X POST localhost:8000/v1/sample \\
         -d '{"class_label": 88, "num_samples": 4, "steps": 20, "sampler": "dpm++"}' -o grid.png

Design, as in the JAX server:
  * **Program cache by bucket**: requests are padded up to a fixed set of
    batch buckets, and each (sampler, steps, cfg_scale, bucket, schedule,
    cache_interval, cfg_interval, cache_mode, dynamic_threshold) chain is
    built once, at most ``--max-programs`` of them. The weights are loaded,
    EMA-reconstructed and folded **once** (``runtime.prepare_weights``) and
    every program runs on that one copy on the device: the exact protocols
    through ``build_sample_fn(prepared=)`` (``auto`` with the bucket as the
    batch hint: one ``dit_stack`` launch a model call on the card), the
    span-cached ones through ``build_cached_sample_fn(prepared=)`` (one
    ``fused_dit_block`` launch a computed block).
  * **One device, one dispatcher**: a dispatcher thread owns all device
    work (chains and VAE decode) and coalesces concurrent same-protocol
    requests into one padded batch; HTTP threads only parse JSON and encode
    PNG / npz.
  * **Backpressure**: at most ``--max-pending`` queued requests (503 with
    ``Retry-After`` past it), the program budget checked at admission
    (400), a per-request deadline (504; a job that times out while queued
    is skipped, never run).

Endpoints: ``GET /healthz`` and ``/info`` (JSON counters), ``GET /metrics``
(Prometheus gauges of the numeric counters), ``POST /v1/sample`` (a PNG
grid, or ``"format": "npz"``: ADM ``arr_0`` uint8 NHWC). The request body
and the status codes are the JAX server's (``docs/SERVING.md``).

Seed rules. The JAX package's PRNG bits are not reproduced; the port keeps
the JAX contracts with its own rules (``stream_seed`` below mixes integer
words with splitmix64 into a 64-bit ``torch.Generator`` seed):
  * host preamble (default): a seeded job draws its z (rows, C, H, W) from a
    ``torch.Generator`` on the device seeded with its seed; an unseeded job
    from the seed ``anon_job_seed(--seed, counter)``, which lies in
    [2**63, 2**64) where no explicit seed (``[0, 2**63)``) can, so counter N
    never equals an explicit seed=N. Each batch's step noise comes from a
    generator seeded with ``chain_seed(--seed, counter)``; the counter
    advances once a batch and once an unseeded job, so a restarted server
    replays its stream. Deterministic samplers (dpm++, unipc, ddim with eta
    0) draw no step noise: a request gives the same bits alone or coalesced
    with others into the same bucket (``X-Seed-Deterministic: true``); ddpm
    shares the step noise across the batch (``false``).
  * ``--preamble fused``: each row's z comes from its own generator seeded
    with ``row_seed(seed, row)`` (unseeded rows: ``anon_row_seed(--seed,
    counter, row)``), so a row is the same whatever the batch composition
    and the whole 63-bit seed is mixed (2**32 + k never aliases k); the
    draws, CFG doubling and chain generator live in the program's one
    call. In JAX that is one device dispatch; here it is still one launch
    a row for its draw plus the chain's launches. One device only, as in
    JAX.
Across buckets the chain's products may tile differently (``stack_plan``
splits K by the tile count), so a row served in bucket 1 and in bucket 4
may differ in its last bits on the card; within one bucket it may not.

``compile_seconds`` keeps the JAX name: the first call of each program,
which here is the kernels' build or load, CUDA set-up and the first chain;
``chain_seconds`` is every later call, host clock around the chain and its
copy to the host (a synchronisation).

Several ranks (``torchrun``, ``--shard true``): one service over a
('data', 'model') mesh of the world's ranks, ``--n-model`` of them on the
model axis, as the JAX server lays out its devices
(``serve.py:122-178, 264-320`` of the JAX package):

    python -m torch.distributed.run --nproc-per-node 2 -m mapdit_tpu_torch.serve \
        --result-dir results/000-DiT-S-2 --shard true [--n-model 2]

  * The lead (rank 0) owns HTTP, admission, the queues and the dispatcher;
    every other rank runs :meth:`SamplerService.follow`. For each batch the
    lead's dispatcher thread broadcasts a descriptor (the program key, the
    z rows and labels it drew, the chain seed; HTTP threads never touch the
    process group); every rank looks the program up or builds it, one
    ``any_rank`` agrees that every rank has it, then all run the chain and
    the lead gets the gathered rows. An idle lead broadcasts a no-op every
    few seconds, so no follower waits on a collective longer than that and
    the group's timeout (``DIST_TIMEOUT_S``) bounds a real hang.
  * Layouts: an exact protocol whose bucket divides the data axis under
    ``--n-model 1`` runs ``build_dp_sharded_sample_fn`` (each rank the
    one-device chain on its rows, its own stream); a tensor-parallel server
    runs ``build_sample_fn(mesh=)`` (a TP island or the plain path, the
    batch on the data axis where it divides); a cached protocol runs
    ``build_cached_sample_fn(mesh=)`` on the data axis and is refused (400,
    "tensor-parallel") on a TP server; anything else runs the one-device
    chain on every rank.
  * SIGTERM to the lead (or to torchrun, which passes it on) stops
    accepting, finishes the batch in flight and broadcasts a stop; every
    rank leaves the group and exits 0. A follower ignores SIGTERM alone.
    A rank whose chain fails ends the world with a non-zero exit.
  * ``--shard false`` under several ranks is one independent server a
    rank; the fused preamble runs on one device only, as in JAX.

Not ported: the persistent compile cache and the relay guard of the JAX
``main`` (XLA's).

A distilled student's experiment (``mapdit_tpu_torch.distill``) is served
on its one valid chain, as in JAX: every request is normalised onto DDIM at
the student's own grid and cfg 1 (guidance baked, no doubling), and
``/info`` reports the ``distilled`` block.
"""

from __future__ import annotations

import argparse
import io
import json
import os
import signal
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import torch

from mapdit_tpu_torch.diffusion import create_diffusion, respacing_string
from mapdit_tpu_torch.diffusion.distill import student_diffusion_from_config
from mapdit_tpu_torch.models.config import BLOCK_KERNELS
from mapdit_tpu_torch.parallel.mesh import any_rank, init_distributed, make_mesh
from mapdit_tpu_torch.runtime import (
    SAMPLERS,
    build_cached_sample_fn,
    build_dp_sharded_sample_fn,
    build_sample_fn,
    prepare_weights,
)
from mapdit_tpu_torch.sample import check_experiment, decode_latents, load_variables, run_config
from mapdit_tpu_torch.utils.device import resolve_device
from mapdit_tpu_torch.utils.image import save_image_grid, to_uint8

# an idle lead's no-op broadcast, so followers never wait long in one collective
HEARTBEAT_S = 5.0
# the process group's timeout under torchrun: past it a hung collective ends
# the world non-zero (above any program's build and chain)
DIST_TIMEOUT_S = 600.0
_NOOP, _STOP = "noop", "stop"

_M64 = (1 << 64) - 1
# the streams' tags, the first word of every stream_seed
_SEEDED_ROW, _ANON_JOB, _ANON_ROW, _CHAIN = 1, 2, 3, 4


def _splitmix64(x: int) -> int:
    x = (x + 0x9E3779B97F4A7C15) & _M64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _M64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _M64
    return x ^ (x >> 31)


def stream_seed(*words: int) -> int:
    """A 64-bit generator seed from integer words (each taken mod 2**64),
    splitmix64 chained over them."""
    h = 0
    for w in words:
        h = _splitmix64(h ^ (int(w) & _M64))
    return h


def anon_job_seed(server_seed: int, counter: int) -> int:
    """An unseeded job's z seed under the host preamble, in [2**63, 2**64)."""
    return (1 << 63) | (stream_seed(_ANON_JOB, server_seed, counter) >> 1)


def chain_seed(server_seed: int, counter: int) -> int:
    """The seed of a batch's step-noise generator."""
    return stream_seed(_CHAIN, server_seed, counter)


def row_seed(seed: int, row: int) -> int:
    """Row ``row`` of a seeded job under the fused preamble."""
    return stream_seed(_SEEDED_ROW, seed, row)


def anon_row_seed(server_seed: int, counter: int, row: int) -> int:
    """Row ``row`` of an unseeded job under the fused preamble."""
    return stream_seed(_ANON_ROW, server_seed, counter, row)


def generator(seed: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(seed)


def draw(seed: int, shape, device) -> torch.Tensor:
    """Standard normals of ``shape`` from a generator seeded with ``seed``."""
    return torch.randn(shape, generator=generator(seed, device), device=device)


_CACHE_ON_TP = ("cache_interval is not supported on a tensor-parallel (--n-model) server; use a data-parallel "
                "fleet for cached protocols")


class QueueFullError(Exception):
    """Pending-request cap hit — surfaces as HTTP 503 (shed load now,
    retry later) instead of letting queues grow without bound."""


class RequestTimeoutError(Exception):
    """The per-request deadline elapsed before the dispatcher finished —
    surfaces as HTTP 504. The job is abandoned (skipped if still queued)."""


class _Job:
    """One request in the coalescing queue."""

    __slots__ = ("labels", "seed", "done", "result", "error", "abandoned")

    def __init__(self, labels, seed):
        self.labels = labels
        self.seed = seed
        self.done = threading.Event()
        self.result = None
        self.error = None
        self.abandoned = False  # set on timeout; dispatcher skips it


def _world_size() -> int:
    if torch.distributed.is_available() and torch.distributed.is_initialized():
        return torch.distributed.get_world_size()
    return int(os.environ.get("WORLD_SIZE", "1"))


def _distributed(shard: bool) -> bool:
    """Whether a server joins a process group: ``--shard true`` under a
    torchrun world of several ranks."""
    return bool(shard) and int(os.environ.get("WORLD_SIZE", "1")) > 1


class SamplerService:
    """Loads a trained experiment once; serves padded-bucket sample calls.

    Concurrent requests with the same protocol are coalesced into one
    device batch by a dispatcher thread: the first request waits up to
    ``coalesce_ms`` for companions, then the group runs as one padded-bucket
    program and the results are split per request (seed rules: the module
    docstring). ``block_kernel`` overrides the training config's (a
    ``mega_attn`` training run serves through ``auto`` with it), as the
    sampling CLIs' ``--block-kernel`` does. ``close()`` stops the
    dispatcher.

    In a process group of several ranks with ``shard`` (the module
    docstring) every rank constructs the service with the same arguments;
    the lead (``mesh.lead``) serves and every other rank calls
    :meth:`follow`.
    """

    def __init__(
        self,
        result_dir: str,
        ckpt=None,
        ema_std: float = 0.05,
        use_vae: bool = False,
        vae_path=None,
        buckets=(1, 4, 8),
        seed: int = 0,
        coalesce_ms: float = 3.0,
        shard: bool = True,
        n_model: int = 1,
        max_programs: int = 32,
        max_pending: int = 64,
        request_timeout_s: float = 600.0,
        preamble: str = "host",
        device="cuda",
        block_kernel=None,
    ):
        n_model = max(1, int(n_model))
        if n_model > 1 and not shard:
            raise ValueError("--n-model needs --shard true")
        world = _world_size() if shard else 1
        if world % n_model:
            raise ValueError(f"--n-model {n_model} does not divide the {world}-rank world")
        if preamble not in ("host", "fused"):
            raise ValueError(f"preamble must be 'host' or 'fused', got {preamble!r}")
        if world > 1 and not torch.distributed.is_initialized():
            raise RuntimeError(
                f"--shard true in a world of {world} ranks serves over their process group: join it first "
                "(main does, under torchrun), or run one server a rank with --shard false"
            )
        if world > 1 and preamble == "fused":
            # the fused preamble's program is a one-device call (as in JAX)
            raise ValueError("--preamble fused requires a single device")
        dev = resolve_device(device)
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        self.device = dev
        self.result_dir = result_dir
        self.train_args = check_experiment(result_dir)
        self.cfg = run_config(self.train_args, block_kernel)
        if n_model > 1 and self.cfg.block_kernel not in ("auto", "off"):
            # fail at startup, not on the first request (JAX's rule)
            raise ValueError(
                f"--n-model {n_model} needs block_kernel auto/off (the experiment pins "
                f"'{self.cfg.block_kernel}', a single-device kernel)"
            )
        self.mesh = make_mesh(n_model=n_model, device=dev) if world > 1 else None
        # collectives go through host memory under gloo
        self._flag_device = dev if self.mesh is None or torch.distributed.get_backend() == "nccl" else "cpu"
        # a distilled student: exactly ONE valid chain, its own nested DDIM
        # grid with guidance baked; requests are normalised onto it
        # (sampler / steps / cfg_scale in the body are advisory for it)
        self._distilled = bool(self.train_args.get("distill_rounds"))
        self._student_steps = int(self.train_args["distill_num_steps"]) if self._distilled else None
        variables = load_variables(result_dir, self.train_args, ckpt, ema_std)
        # the folded weights (and the bf16 stack), once, shared by every
        # program: on a model axis this rank's shards; on a data axis the
        # per-rank bucket is the hint (only whether one is given matters)
        n_data = self.mesh.n_data if self.mesh is not None else 1
        self._prepared = prepare_weights(self.cfg, variables, batch_hint=max(1, max(buckets) // n_data),
                                         device=dev, mesh=self.mesh)
        self.use_vae = use_vae
        self.vae_path = vae_path
        self._decoder = None
        if use_vae:
            from mapdit_tpu_torch.models.vae import load_decoder

            self._decoder = load_decoder(vae_path, dev)  # load weights ONCE
        self.buckets = tuple(sorted(set(buckets)))
        self.preamble = preamble
        self.seed = int(seed)
        self.coalesce_ms = coalesce_ms
        self.max_programs = max_programs
        self.max_pending = max_pending
        self.request_timeout_s = request_timeout_s
        self._pending = 0  # jobs enqueued but not yet taken by the dispatcher
        self._timeouts = 0
        self._rejected = 0
        # end-to-end request latency (enqueue -> result), Prometheus
        # summary-style counters
        self._lat_sum = 0.0
        self._lat_count = 0
        self._lat_max = 0.0
        # chain time per coalesced batch (excludes HTTP, coalescing, decode
        # and PNG); the first call of each program (kernel build or load,
        # CUDA set-up, first chain) is kept apart as compile_seconds
        self._chain_sum = 0.0
        self._chain_count = 0
        self._chain_max = 0.0
        self._compile_sum = 0.0
        self._compile_count = 0
        self._warm_keys = set()
        # (sampler, steps, cfg_scale, bucket, schedule, cache_interval,
        #  cfg_interval, cache_mode, dynamic_threshold) -> (sample fn, layout)
        self._fns = {}
        self._request_counter = 0
        self._coalesced_batches = 0
        self._batches_run = 0
        self._closed = False
        # set when a chain failed under a mesh: the world is broken
        self.fatal = None
        self.on_fatal = None
        self.started = time.time()
        # protocol-key -> list of pending _Job; one dispatcher owns the device
        self._queues = {}
        self._cv = threading.Condition()
        self._dispatcher = threading.Thread(target=self._dispatch_loop, daemon=True)
        if self.mesh is None or self.mesh.lead:
            self._dispatcher.start()

    @property
    def lead(self) -> bool:
        """Whether this rank serves HTTP (always, on one device)."""
        return self.mesh is None or self.mesh.lead

    def close(self) -> None:
        """Stop the dispatcher once its current batch ends (under a mesh it
        then broadcasts the stop to the followers). Jobs still queued fail
        with a 503."""
        with self._cv:
            self._closed = True
            for jobs in self._queues.values():
                for job in jobs:
                    job.error = QueueFullError("server shutting down")
                    job.done.set()
                jobs.clear()
            self._pending = 0
            self._cv.notify_all()
        if self._dispatcher.is_alive():
            self._dispatcher.join(timeout=None if self.mesh is not None else 60)

    # ------------------------------------------------------------------ #

    def _bucket(self, n: int) -> int:
        for b in self.buckets:
            if n <= b:
                return b
        raise ValueError(f"num_samples {n} exceeds the largest batch bucket {self.buckets[-1]}")

    def _get_fn(
        self, sampler: str, steps: int, cfg_scale: float, bucket: int, schedule: str = "uniform",
        cache_interval: int = 0, cfg_interval=None, cache_mode: str = "forecast", dynamic_threshold=None,
    ):
        key = (
            sampler, steps, float(cfg_scale), bucket, schedule, cache_interval, cfg_interval, cache_mode,
            dynamic_threshold,
        )
        fn = self._fns.get(key)
        if fn is not None:
            return fn
        if len(self._fns) >= self.max_programs:
            # each new program costs a build and a first chain on the one
            # dispatcher: bound it so a protocol-scanning client cannot
            # wedge the server
            raise ValueError(
                f"compile budget exhausted ({self.max_programs} programs); reuse an already-compiled (sampler, "
                "steps, cfg_scale, schedule, cache_interval, cfg_interval, cache_mode) protocol or restart with "
                "--max-programs"
            )
        if self._distilled:
            diffusion = student_diffusion_from_config(self.train_args, device=self.device)
        else:
            diffusion = create_diffusion(respacing_string(steps, sampler, schedule), device=self.device)
        guidance = cfg_scale if cfg_scale > 1.0 else None
        mesh, layout = self.mesh, "plain"
        n_model = mesh.n_model if mesh is not None else 1
        if cache_interval > 1:
            if n_model > 1:
                raise ValueError(_CACHE_ON_TP)
            # Delta-DiT block-span caching (lossy), block by block on the
            # shared model; on a data axis each rank takes its rows
            base = build_cached_sample_fn(
                self.cfg, None, diffusion, cfg_scale=guidance, cache_interval=cache_interval, sampler=sampler,
                cfg_interval=cfg_interval, cache_mode=cache_mode, dynamic_threshold=dynamic_threshold,
                device=self.device, prepared=self._prepared, mesh=mesh,
            )
        elif mesh is not None and n_model == 1 and bucket % mesh.n_data == 0:
            # each data rank runs the one-device chain on its rows (the
            # un-doubled interface: CFG doubled on each rank), so the
            # kernels stay those of one device
            base = build_dp_sharded_sample_fn(
                self.cfg, None, diffusion, mesh, cfg_scale=guidance, sampler=sampler, cfg_interval=cfg_interval,
                batch_hint=bucket, dynamic_threshold=dynamic_threshold, device=self.device,
                prepared=self._prepared,
            )
            layout = "shard_map"
        else:
            # a TP server runs every exact program on the mesh; any other
            # program runs the one-device chain on every rank
            base = build_sample_fn(
                self.cfg, None, diffusion, cfg_scale=guidance, sampler=sampler, cfg_interval=cfg_interval,
                batch_hint=bucket, dynamic_threshold=dynamic_threshold, device=self.device,
                prepared=self._prepared, mesh=mesh if n_model > 1 else None,
            )
        fn = (self._fused(base, cfg_scale), "fused") if self.preamble == "fused" else (base, layout)
        with self._cv:  # admission reads the keys from the HTTP threads
            self._fns[key] = fn
        return fn

    def _cfg_batch(self, z: torch.Tensor, y_rows: torch.Tensor, cfg_scale: float):
        """The reference CFG batch contract: [z; z], [labels; null]."""
        if cfg_scale <= 1.0:
            return z, y_rows
        return torch.cat([z, z]), torch.cat([y_rows, torch.full_like(y_rows, self.cfg.num_classes)])

    def _fused(self, base_fn, cfg_scale: float):
        """The fused preamble's program: per-row z draws (None: a zero pad
        row), CFG doubling and the chain generator inside one call."""
        c, s, dev = self.train_args["in_channels"], self.train_args["input_size"], self.device

        def fused(row_seeds, labels, chain_seed_):
            z = torch.stack([
                draw(rs, (c, s, s), dev) if rs is not None else torch.zeros((c, s, s), device=dev)
                for rs in row_seeds
            ])
            z, y = self._cfg_batch(z, torch.as_tensor(labels, dtype=torch.int64, device=dev), cfg_scale)
            return base_fn(z, y, generator(chain_seed_, dev))

        return fused

    def warmup(self, sampler: str, steps: int, cfg_scale: float, **protocol):
        """Build and run the largest bucket's program so the first request
        is fast. Extra protocol fields (schedule / cache_interval /
        cfg_interval / cache_mode / dynamic_threshold) pass through;
        ``--warmup-protocols`` warms each of its protocols this way."""
        self.sample([0] * self.buckets[-1], steps, sampler, cfg_scale, seed=0, **protocol)

    # ------------------------------------------------------------------ #

    def sample(
        self, class_labels, steps, sampler, cfg_scale, seed=None, schedule="uniform", cache_interval=0,
        cfg_interval=None, cache_mode="forecast", dynamic_threshold=None,
    ):
        """(labels, protocol) -> float latents/images (n, C, H, W) in [-1, 1].

        Called from HTTP threads: validates, enqueues a job under the
        protocol key, and blocks until the dispatcher fills in the result
        (already decoded; the dispatcher thread owns all device work).
        """
        n = len(class_labels)
        if n < 1:
            raise ValueError("num_samples / class_labels must request >= 1 sample")
        if self._distilled:
            # one valid protocol: normalize onto the student grid; the
            # accelerator fields cannot apply to a distilled chain
            if int(cache_interval) > 1 or cfg_interval is not None:
                raise ValueError(
                    "cache_interval / cfg_interval do not apply to a distilled student (already a few-step exact "
                    "chain)"
                )
            sampler, steps, schedule = "ddim", self._student_steps, "uniform"
            cfg_scale = 1.0  # guidance baked at distill time (if any)
        self._bucket(n)  # reject oversize requests before enqueueing
        num_classes = self.cfg.num_classes
        for lab in class_labels:
            if not 0 <= int(lab) < num_classes:
                raise ValueError(f"class label {lab} outside [0, {num_classes})")
        if seed is not None:
            # validate HERE: a bad seed must fail this request alone, not
            # poison a coalesced group inside the dispatcher
            try:
                seed = int(seed)
            except (TypeError, ValueError):
                raise ValueError(f"seed must be an integer, got {seed!r}") from None
            if not 0 <= seed < 2**63:
                raise ValueError("seed must be in [0, 2**63)")
        cfg_scale = float(cfg_scale)
        if cfg_scale <= 1.0:
            cfg_scale = 1.0  # all <= 1 values build the same no-CFG program
        cache_interval = int(cache_interval)
        if cache_interval > 1:
            if self.mesh is not None and self.mesh.n_model > 1:
                raise ValueError(_CACHE_ON_TP)
            if sampler not in ("ddpm", "dpm++"):
                raise ValueError("cache_interval composes with sampler ddpm or dpm++")
            if int(steps) % cache_interval != 0:
                raise ValueError(f"cache_interval {cache_interval} must divide steps {steps}")
        elif cache_interval < 0:
            raise ValueError("cache_interval must be >= 0")
        if cache_mode not in ("hold", "forecast"):
            raise ValueError("cache_mode must be 'hold' or 'forecast'")
        if cache_interval <= 1:
            cache_mode = "hold"  # no skip steps: both modes are one program; normalize so the key dedupes
        if cfg_interval is not None:
            # limited-interval guidance: validated at admission so a bad
            # interval fails this request alone
            try:
                lo, hi = (float(v) for v in cfg_interval)
            except (TypeError, ValueError):
                raise ValueError("cfg_interval must be [sigma_lo, sigma_hi] (two numbers)") from None
            if not (0.0 <= lo <= hi):
                raise ValueError("cfg_interval needs 0 <= sigma_lo <= sigma_hi")
            if cfg_scale <= 1.0:
                raise ValueError("cfg_interval needs cfg_scale > 1")
            if sampler not in ("ddpm", "dpm++", "unipc"):
                raise ValueError("cfg_interval composes with sampler ddpm, dpm++ or unipc")
            cfg_interval = (lo, hi)
        if dynamic_threshold is not None:
            try:
                dynamic_threshold = float(dynamic_threshold)
            except (TypeError, ValueError):
                raise ValueError("dynamic_threshold must be a number in (0, 1]") from None
            if not 0.0 < dynamic_threshold <= 1.0:
                raise ValueError("dynamic_threshold must be in (0, 1]")

        job = _Job(np.asarray(class_labels, np.int64), seed)
        key = (sampler, int(steps), cfg_scale, schedule, cache_interval, cfg_interval, cache_mode, dynamic_threshold)
        with self._cv:
            # Backpressure: bound the pending queue (503 on overflow) and
            # gate brand-new protocols on the program budget at admission,
            # so a protocol-scanning client gets a 400 before it parks jobs
            # behind a build.
            if self._pending >= self.max_pending:
                self._rejected += 1
                raise QueueFullError(
                    f"server overloaded: {self._pending} pending requests (max {self.max_pending}); retry later"
                )
            # _fns keys carry an extra bucket element at index 3
            if len(self._fns) >= self.max_programs and not any(k[:3] + k[4:] == key for k in self._fns):
                raise ValueError(
                    f"compile budget exhausted ({self.max_programs} programs); reuse an already-compiled (sampler, "
                    "steps, cfg_scale, schedule, cache_interval, cfg_interval, cache_mode) protocol or restart "
                    "with --max-programs"
                )
            self._pending += 1
            self._queues.setdefault(key, []).append(job)
            self._cv.notify()
        enqueue_t = time.time()
        if not job.done.wait(timeout=self.request_timeout_s or None):
            job.abandoned = True  # the dispatcher skips it if still queued
            with self._cv:
                self._timeouts += 1
            raise RequestTimeoutError(
                f"request did not complete within {self.request_timeout_s:g}s (the first use of a protocol pays "
                "its kernel build and first chain; warm protocols or raise --request-timeout-s)"
            )
        if job.error is not None:
            raise job.error
        elapsed = time.time() - enqueue_t
        with self._cv:
            self._lat_sum += elapsed
            self._lat_count += 1
            self._lat_max = max(self._lat_max, elapsed)
        return job.result

    # ---------------------------------------------------------------- #
    # dispatcher: owns the device; coalesces compatible jobs per batch

    def _take_group(self):
        """Block until work exists; return (protocol_key, jobs) where the
        jobs fit one bucket, or (None, []) once closed. Waits coalesce_ms
        for companions first. Under a mesh an idle wait ends after
        ``HEARTBEAT_S`` with (_NOOP, [])."""
        with self._cv:
            while not self._closed and not any(self._queues.values()):
                if not self._cv.wait(timeout=HEARTBEAT_S if self.mesh is not None else None):
                    return _NOOP, []
            if self._closed:
                return None, []
        if self.coalesce_ms > 0:
            time.sleep(self.coalesce_ms / 1e3)
        with self._cv:
            key = next((k for k, v in self._queues.items() if v), None)
            if key is None:  # closed while coalescing
                return _NOOP, []
            # round-robin across protocols: move the served key to the back
            # so a sustained stream on one protocol cannot starve others
            self._queues[key] = self._queues.pop(key)
            pending = self._queues[key]
            group, rows = [], 0
            while pending and rows + len(pending[0].labels) <= self.buckets[-1]:
                job = pending.pop(0)
                self._pending -= 1
                if job.abandoned:  # timed out while queued: don't run it
                    continue
                group.append(job)
                rows += len(job.labels)
            return key, group

    def _dispatch_loop(self):
        # the current CUDA device and grad mode are per thread: set both here
        if self.device.type == "cuda":
            torch.cuda.set_device(self.device)
        with torch.no_grad():
            while True:
                try:
                    key, group = self._take_group()
                except Exception:  # noqa: BLE001 — queue plumbing must not die
                    import traceback

                    traceback.print_exc()
                    time.sleep(0.1)
                    continue
                if key is None:
                    self._broadcast(_STOP)
                    return
                if not group:  # idle, or every queued job timed out before we got to it
                    self._broadcast(_NOOP)
                    continue
                try:
                    self._run_group(key, group)
                except Exception as e:  # noqa: BLE001 — propagate to every waiter
                    for job in group:
                        job.error = e
                        job.done.set()
                if self.fatal is not None:
                    if self.on_fatal is not None:
                        self.on_fatal()
                    return

    def _broadcast(self, descriptor):
        """The lead's descriptor on every rank (the lead passes it, the
        followers pass None); nothing on one device."""
        if self.mesh is None:
            return descriptor
        box = [descriptor]
        torch.distributed.broadcast_object_list(box, src=0)
        return box[0]

    def follow(self) -> None:
        """A follower's loop: receive each batch descriptor from the lead
        and run the same program, in the lead's order, until the lead
        broadcasts the stop. An error in a chain propagates (the world is
        broken: the rank must exit non-zero); a program that some rank could
        not build is skipped on every rank, as the lead answers it."""
        if self.device.type == "cuda":
            torch.cuda.set_device(self.device)
        with torch.no_grad():
            while True:
                d = self._broadcast(None)
                if d == _STOP:
                    return
                if d == _NOOP:
                    continue
                self._execute(*d)

    def _program(self, fn_key):
        """The program of ``fn_key``, built on first use. Under a mesh every
        rank builds it in descriptor order and one ``any_rank`` agrees that
        every rank has it before any chain runs; if some rank failed, every
        rank drops it and raises (the lead answers the batch with it)."""
        if self.mesh is None:
            return self._get_fn(*fn_key)
        fn, err = None, None
        try:
            fn = self._get_fn(*fn_key)
        except Exception as e:  # noqa: BLE001 — agreed below, then raised
            err = e
        if any_rank(err is not None, self._flag_device):
            with self._cv:
                self._fns.pop(fn_key, None)
            raise err if err is not None else RuntimeError(f"another rank failed to build the program {fn_key}")
        return fn

    def _execute(self, fn_key, z, labels, seed):
        """Run program ``fn_key`` on the bucket's z rows and labels with a
        chain generator seeded ``seed``: the whole of a batch's device work
        on every rank. Returns the bucket's rows (the gathered rows under a
        mesh)."""
        try:
            fn, layout = self._program(fn_key)
        except Exception:  # noqa: BLE001 — agreed by every rank
            if self.lead:
                raise
            return None
        dev = self.device
        z, y = z.to(dev), torch.as_tensor(labels, dtype=torch.int64, device=dev)
        gen = generator(seed, dev)
        try:
            # the un-doubled interface under shard_map
            out = fn(z, y, gen) if layout == "shard_map" else fn(*self._cfg_batch(z, y, fn_key[2]), gen)
        except Exception as e:
            if self.mesh is not None:
                self.fatal = e
            raise
        return out

    def _run_group(self, key, group):
        (sampler, steps, cfg_scale, schedule, cache_interval, cfg_interval, cache_mode, dynamic_threshold) = key
        n = sum(len(j.labels) for j in group)
        bucket = self._bucket(n)
        c, s, dev = self.train_args["in_channels"], self.train_args["input_size"], self.device
        # program identity (the bucket included): its first run is kept out
        # of the steady-state chain window
        fn_key = (
            sampler, steps, float(cfg_scale), bucket, schedule, cache_interval, cfg_interval, cache_mode,
            dynamic_threshold,
        )
        # a program the lead cannot build fails this batch before any rank sees it
        fn, _ = self._get_fn(*fn_key)
        labels = np.zeros((bucket,), np.int64)
        labels[:n] = np.concatenate([job.labels for job in group])
        if self.preamble == "fused":
            row_seeds = []
            for job in group:
                if job.seed is None:
                    self._request_counter += 1
                    row_seeds += [anon_row_seed(self.seed, self._request_counter, r) for r in range(len(job.labels))]
                else:
                    row_seeds += [row_seed(job.seed, r) for r in range(len(job.labels))]
            row_seeds += [None] * (bucket - n)
            self._request_counter += 1
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            chain_t0 = time.perf_counter()
            out = fn(row_seeds, labels, chain_seed(self.seed, self._request_counter))[:n].cpu().numpy()
            self._finish_group(group, out, fn_key, time.perf_counter() - chain_t0)
            return
        # per-job z: a row's noise does not depend on its batch position
        zs = []
        for job in group:
            if job.seed is None:
                self._request_counter += 1
                job_seed = anon_job_seed(self.seed, self._request_counter)
            else:
                job_seed = job.seed
            zs.append(draw(job_seed, (len(job.labels), c, s, s), dev))
        zs.append(torch.zeros((bucket - n, c, s, s), device=dev))
        z = torch.cat(zs)
        # the step noise (ddpm, ddim at eta > 0): a fresh stream a batch
        self._request_counter += 1
        seed = chain_seed(self.seed, self._request_counter)
        if self.mesh is not None:
            z = z.cpu()  # the descriptor travels through host memory
            self._broadcast((fn_key, z, labels, seed))
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        chain_t0 = time.perf_counter()
        out = self._execute(fn_key, z, labels, seed)[:n].cpu().numpy()  # the copy to the host synchronises
        chain_s = time.perf_counter() - chain_t0
        self._finish_group(group, out, fn_key, chain_s)

    def _finish_group(self, group, out, fn_key, chain_s):
        """Chain accounting, decode, fan-out."""
        with self._cv:
            if fn_key in self._warm_keys:
                self._chain_sum += chain_s
                self._chain_count += 1
                self._chain_max = max(self._chain_max, chain_s)
            else:
                # the program's first call: build or load, set-up, first chain
                self._warm_keys.add(fn_key)
                self._compile_sum += chain_s
                self._compile_count += 1
        # decode on this thread too: the dispatcher owns all device work
        out = decode_latents(out, self.train_args, self.use_vae, self.vae_path, decoder=self._decoder,
                             device=self.device)
        with self._cv:
            self._batches_run += 1
            if len(group) > 1:
                self._coalesced_batches += 1
        off = 0
        for job in group:
            job.result = out[off : off + len(job.labels)]
            off += len(job.labels)
            job.done.set()

    def info(self) -> dict:
        return {
            "status": "ok",
            "model": self.train_args.get("model"),
            "num_classes": self.cfg.num_classes,
            "input_size": self.train_args["input_size"],
            "in_channels": self.train_args["in_channels"],
            "buckets": list(self.buckets),
            "device": str(self.device),
            "devices": self.mesh.size if self.mesh is not None else 1,
            "mesh": {"data": self.mesh.n_data, "model": self.mesh.n_model} if self.mesh is not None else
                    {"data": 1, "model": 1},
            "compiled_programs": len(self._fns),
            "max_programs": self.max_programs,
            "batches_run": self._batches_run,
            "coalesced_batches": self._coalesced_batches,
            "pending": self._pending,
            "max_pending": self.max_pending,
            "request_timeout_s": self.request_timeout_s,
            "timeouts": self._timeouts,
            "rejected": self._rejected,
            "request_latency_seconds_sum": round(self._lat_sum, 4),
            "request_latency_seconds_count": self._lat_count,
            "request_latency_seconds_max": round(self._lat_max, 4),
            "chain_seconds_sum": round(self._chain_sum, 4),
            "chain_seconds_count": self._chain_count,
            "chain_seconds_max": round(self._chain_max, 4),
            # the first call of each program (build or load, set-up, first
            # chain), kept out of the chain_seconds steady-state window
            "compile_seconds_sum": round(self._compile_sum, 4),
            "compile_seconds_count": self._compile_count,
            "preamble": self.preamble,
            "coalesce_ms": self.coalesce_ms,
            "uptime_s": round(time.time() - self.started, 1),
            "decode": "vae" if self.use_vae else "latent",
            # ddpm shares its step noise across the coalesced batch; a seed
            # reproduces its output only for identical batch compositions
            # (the X-Seed-Deterministic response header per request)
            "seed_deterministic_samplers": ["dpm++", "unipc", "ddim"],
            # a distilled student's protocol is pinned server-side: every
            # request runs its own few-step DDIM grid
            "distilled": {
                "steps": self._student_steps,
                "rounds": int(self.train_args["distill_rounds"]),
                "baked_cfg_scale": float(self.train_args.get("distill_cfg_scale", 1.0)),
            } if self._distilled else None,
        }


def make_handler(service: SamplerService, defaults: dict):

    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def _json(self, code: int, obj: dict, headers=None):
            self._bytes(code, json.dumps(obj).encode(), "application/json", headers)

        def _bytes(self, code: int, body: bytes, ctype: str, headers=None):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            for k, v in (headers or {}).items():
                self.send_header(k, v)
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path in ("/healthz", "/info"):
                self._json(200, service.info())
            elif self.path == "/metrics":
                # Prometheus text exposition of the numeric counters
                lines = []
                for k, v in service.info().items():
                    if isinstance(v, (int, float)) and not isinstance(v, bool):
                        lines.append(f"# TYPE mapdit_{k} gauge")
                        lines.append(f"mapdit_{k} {v}")
                self._bytes(200, ("\n".join(lines) + "\n").encode(), "text/plain; version=0.0.4")
            else:
                self._json(404, {"error": f"unknown path {self.path}"})

        def do_POST(self):
            if self.path != "/v1/sample":
                self._json(404, {"error": f"unknown path {self.path}"})
                return
            try:
                length = int(self.headers.get("Content-Length", "0"))
                req = json.loads(self.rfile.read(length) or b"{}")
                if not isinstance(req, dict):
                    raise ValueError("request body must be a JSON object")
                labels = req.get("class_labels")
                if labels is not None:
                    if not isinstance(labels, list):
                        raise ValueError("class_labels must be a list of integers")
                    labels = [int(lab) for lab in labels]
                else:
                    labels = [int(req.get("class_label", 0))] * int(req.get("num_samples", 1))
                steps = int(req.get("steps", defaults["steps"]))
                sampler = req.get("sampler", defaults["sampler"])
                if sampler not in SAMPLERS:
                    raise ValueError(f"unknown sampler {sampler!r}")
                if not 1 <= steps <= 1000:
                    raise ValueError("steps must be in [1, 1000]")
                cfg_scale = float(req.get("cfg_scale", defaults["cfg_scale"]))
                schedule = req.get("schedule", "uniform")
                if schedule not in ("uniform", "karras"):
                    raise ValueError(f"unknown schedule {schedule!r}")
                fmt = req.get("format", "png")
                if fmt not in ("png", "npz"):
                    raise ValueError(f"unknown format {fmt!r}")
                cache_interval = int(req.get("cache_interval", 0))
                samples = service.sample(
                    labels, steps, sampler, cfg_scale, seed=req.get("seed"), schedule=schedule,
                    cache_interval=cache_interval, cfg_interval=req.get("cfg_interval"),
                    cache_mode=req.get("cache_mode", "forecast"), dynamic_threshold=req.get("dynamic_threshold"),
                )
            except QueueFullError as e:
                self._json(503, {"error": str(e)}, {"Retry-After": "5"})  # standard shed-load signal
                return
            except RequestTimeoutError as e:
                self._json(504, {"error": str(e)})
                return
            except (ValueError, TypeError) as e:
                # TypeError covers malformed JSON value types (e.g. a dict
                # where an int belongs): a client error, not a server fault
                self._json(400, {"error": str(e)})
                return
            except Exception as e:  # noqa: BLE001 — surface as a 500, keep serving
                self._json(500, {"error": f"{type(e).__name__}: {e}"})
                return

            # seed determinism disclosure: ddpm shares its step noise across
            # the coalesced batch
            headers = {"X-Seed-Deterministic": "false" if sampler == "ddpm" else "true"}
            if fmt == "npz":
                # ADM evaluator format, like sample_fid (arr_0 uint8 NHWC)
                buf = io.BytesIO()
                np.savez(buf, arr_0=to_uint8(samples))
                self._bytes(200, buf.getvalue(), "application/x-npz", headers)
            else:
                buf = io.BytesIO()
                save_image_grid(samples, buf, nrow=max(1, int(np.ceil(np.sqrt(len(samples))))))
                self._bytes(200, buf.getvalue(), "image/png", headers)

        def log_message(self, fmt, *args):  # route through stdout, one line
            print(f"[serve] {self.address_string()} {fmt % args}", flush=True)

    return Handler


class ServingHTTPServer(ThreadingHTTPServer):
    """The stdlib threading server with a listen backlog of 128: with the
    default of 5, a burst of concurrent clients loses connections that TCP
    retries only after a second, before the pending cap (503) can act."""

    request_queue_size = 128


def build_service(args) -> SamplerService:
    """The service of the parsed flags (every rank builds it alike)."""
    return SamplerService(
        args.result_dir, ckpt=args.ckpt, ema_std=args.ema_std, use_vae=args.use_vae, vae_path=args.vae_path,
        buckets=tuple(int(b) for b in args.buckets.split(",")), seed=args.seed, coalesce_ms=args.coalesce_ms,
        shard=args.shard, n_model=args.n_model, max_programs=args.max_programs, max_pending=args.max_pending,
        request_timeout_s=args.request_timeout_s, preamble=args.preamble, device=args.device,
        block_kernel=args.block_kernel,
    )


def build_server(args, service: SamplerService):
    """``service`` (of :func:`build_service`), warmed as ``--warmup`` and
    ``--warmup-protocols`` say, and its HTTP server, bound but not yet
    serving: ``(server, service)``."""
    defaults = {"steps": args.default_steps, "sampler": args.default_sampler, "cfg_scale": args.default_cfg_scale}
    try:
        if args.warmup:
            t0 = time.time()
            service.warmup(defaults["sampler"], defaults["steps"], defaults["cfg_scale"])
            print(f"[serve] warmup compile done in {time.time() - t0:.1f}s", flush=True)
        if args.warmup_protocols:
            protos = json.loads(args.warmup_protocols)
            if not isinstance(protos, list):
                raise SystemExit("error: --warmup-protocols must be a JSON list")
            for proto in protos:
                t0 = time.time()
                p = dict(proto)
                sampler = p.pop("sampler", defaults["sampler"])
                steps = int(p.pop("steps", defaults["steps"]))
                cfg_scale = float(p.pop("cfg_scale", defaults["cfg_scale"]))
                if p.get("cfg_interval") is not None:
                    p["cfg_interval"] = [float(v) for v in p["cfg_interval"]]
                service.warmup(sampler, steps, cfg_scale, **p)
                print(f"[serve] warmed {sampler}/{steps}/{cfg_scale:g} {p or ''} in {time.time() - t0:.1f}s",
                      flush=True)
        server = ServingHTTPServer((args.host, args.port), make_handler(service, defaults))
    except BaseException:
        service.close()
        raise
    info = service.info()
    print(f"[serve] listening on http://{args.host}:{server.server_address[1]} "
          f"({info['model']}, decode={info['decode']}, device={info['device']}, mesh={info['mesh']})", flush=True)
    return server, service


def main(args) -> None:
    """Serve until SIGTERM (the container stop signal: finish in-flight
    requests, stop accepting, return) or an interrupt. Under torchrun with
    ``--shard true`` every rank joins the process group; the lead serves
    and the others follow it (module docstring) until its stop."""
    distributed = _distributed(args.shard)
    if distributed:
        dev = init_distributed(None if args.device == "cuda" else args.device, timeout_s=DIST_TIMEOUT_S)
        args = argparse.Namespace(**{**vars(args), "device": str(dev)})
    try:
        if distributed and torch.distributed.get_rank() != 0:
            _follow(args)
        else:
            _serve(args)
    finally:
        if distributed:
            torch.distributed.destroy_process_group()


def _follow(args) -> None:
    """A follower rank: the service's collectives, then its loop."""
    # a follower stops when the lead broadcasts the stop; torchrun passes
    # its SIGTERM to every rank, and the lead's carries the shutdown
    previous = signal.signal(signal.SIGTERM, lambda *_: print("[serve] SIGTERM: a follower waits for the lead's stop",
                                                              flush=True))
    try:
        service = build_service(args)
        service.follow()
    finally:
        signal.signal(signal.SIGTERM, previous)
    print(f"[serve] rank {torch.distributed.get_rank()} stopped", flush=True)


def _serve(args) -> None:
    """The lead rank, or the one server of a process."""
    server, service = build_server(args, build_service(args))

    def _term(signum, frame):
        print("[serve] SIGTERM: shutting down", flush=True)
        threading.Thread(target=server.shutdown, daemon=True).start()

    service.on_fatal = lambda: threading.Thread(target=server.shutdown, daemon=True).start()
    previous = signal.signal(signal.SIGTERM, _term)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        signal.signal(signal.SIGTERM, previous)
        server.server_close()
        service.close()
        print("[serve] stopped", flush=True)
    if service.fatal is not None:
        raise SystemExit(f"[serve] a chain failed on the mesh, the world is broken: {service.fatal!r}")


def _bool(s: str) -> bool:
    return s.lower() in ("1", "true", "yes")


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--result-dir", type=str, required=True)
    parser.add_argument("--host", type=str, default="127.0.0.1")
    parser.add_argument("--port", type=int, default=8000, help="0 = ephemeral")
    parser.add_argument("--ckpt", type=str, default=None)
    parser.add_argument("--ema-std", type=float, default=0.05)
    parser.add_argument("--use-vae", type=_bool, default=False, metavar="BOOL")
    parser.add_argument("--vae-path", type=str, default=None)
    parser.add_argument("--buckets", type=str, default="1,4,8",
                        help="batch buckets; requests pad to the next bucket so every (sampler, steps, bucket) "
                             "program is built once")
    parser.add_argument("--default-steps", type=int, default=20)
    parser.add_argument("--default-sampler", choices=list(SAMPLERS), default="dpm++")
    parser.add_argument("--default-cfg-scale", type=float, default=4.0)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--max-programs", type=int, default=32,
                        help="budget of distinct (sampler, steps, cfg_scale, bucket, schedule, cache_interval) "
                             "programs; new protocols past it are 400s at admission")
    parser.add_argument("--max-pending", type=int, default=64,
                        help="pending-request cap; requests past it get an immediate 503 + Retry-After instead of "
                             "queueing without bound")
    parser.add_argument("--request-timeout-s", type=float, default=600.0,
                        help="per-request deadline (504 on expiry; a still-queued timed-out job is skipped, never "
                             "run). The first use of a protocol pays its kernel build and first chain: keep this "
                             "above that or pre-warm (0 = no deadline)")
    parser.add_argument("--shard", type=_bool, default=True, metavar="BOOL",
                        help="under torchrun, serve over every rank as one service: divisible buckets "
                             "data-parallel, --n-model ranks tensor-parallel (false: one independent server a rank)")
    parser.add_argument("--n-model", type=int, default=1,
                        help="tensor-parallel width on the ranks (needs --shard true; must divide the world)")
    parser.add_argument("--preamble", choices=["host", "fused"], default="host",
                        help="request preamble: host = per-job z generators (the default seed rule); fused = "
                             "per-row z generators, CFG doubling and the chain generator inside the program's call "
                             "(one device; other seeded outputs, see the module docstring)")
    parser.add_argument("--coalesce-ms", type=float, default=3.0,
                        help="how long the dispatcher waits to merge concurrent same-protocol requests into one "
                             "device batch (0 = run each request immediately)")
    parser.add_argument("--warmup-protocols", type=str, default=None,
                        help='JSON list of protocol dicts to build and run at startup, e.g. \'[{"steps": 20, '
                             '"sampler": "dpm++", "cfg_scale": 4.0, "cfg_interval": [0.3, 3.0]}]\'')
    parser.add_argument("--warmup", type=_bool, default=True, metavar="BOOL")
    parser.add_argument("--device", type=str, default="cuda", help="torch device; cuda unless given")
    parser.add_argument("--block-kernel", choices=list(BLOCK_KERNELS), default=None,
                        help="block kernel of the chains (default: the training config's)")
    return parser


if __name__ == "__main__":
    main(build_parser().parse_args())
