"""Sampling runtime, port of ``mapdit_tpu/runtime.py``: the chains of every
sampler, limited-interval guidance, dynamic thresholding and block-span
caching.

``build_sample_fn`` folds the weights once (every weight-normalized matrix
pre-normalized, so the chain skips the in-graph normalization), resolves the
block-kernel policy, stacks the block weights for the whole-stack kernel
when it is chosen, and returns ``sample_fn(noise, y, generator)``. The
samplers are ``ddpm`` (ancestral), ``ddim`` (``eta`` sets its noise),
``dpm++`` (DPM-Solver++(2M)) and ``unipc`` (UniPC bh2). With CFG the chain
evolves only the first half of the [z; z] batch and duplicates it into the
[cond; uncond] model call (the half-CFG chain); the result keeps the
reference's 2N shape. PyTorch runs the chain eagerly, one Python iteration
per step; capturing it in a CUDA graph is the ROADMAP item "Sampling
runtime leftovers".

``build_cached_sample_fn`` is the Delta-DiT block-span cache for ddpm and
dpm++; it runs the blocks one by one (``auto`` resolves per block), since
the whole-stack kernel cannot skip a span.

``build_sample_fn(mesh=)`` runs the chain on a ('data', 'model') mesh of
ranks (``parallel/mesh.py``): the data axis splits the batch, the model axis
runs the tensor-parallel islands of ``ops/cuda/dit_block_tp.py`` on each
rank's weight shards.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import numpy as np
import torch

from mapdit_tpu_torch.models.blocks import kernel_family_ok, resolve_block_kernel_tp, stack_auto_ok
from mapdit_tpu_torch.models.config import TP_KERNELS, DiTConfig
from mapdit_tpu_torch.models.dit import DiT
from mapdit_tpu_torch.ops.mp import normalize
from mapdit_tpu_torch.parallel.mesh import all_gather_rows, check_replicated, shard_state_dict
from mapdit_tpu_torch.utils.device import resolve_device


def fold_weights_for_inference(state_dict: Dict[str, torch.Tensor], cfg: DiTConfig) -> Dict[str, torch.Tensor]:
    """Normalize every weight-normalized matrix once (``*.weight`` entries,
    the class embedding table included). The 3-D stacks of ``scan_blocks``
    are normalized a depth at a time, as the per-block layout's matrices
    are, so both layouts fold to the same bits (the JAX package leaves
    them unfolded)."""
    out = {}
    for key, value in state_dict.items():
        names = key.split(".")
        if names[-1] != "weight" or value.ndim not in (2, 3):
            out[key] = value
            continue
        is_embedding = len(names) >= 2 and names[-2] == "embedding"
        flag = cfg.use_mp_embedding if is_embedding else cfg.use_weight_normalization
        if not flag:
            out[key] = value
        else:
            out[key] = torch.stack([normalize(w) for w in value]) if value.ndim == 3 else normalize(value)
    return out


def build_block_stack(state_dict: Dict[str, torch.Tensor], cfg: DiTConfig) -> Dict[str, torch.Tensor]:
    """Depth-stacked folded block weights (in ``cfg.dtype``) and f32 gains
    (depth, 2) for ``fused_dit_stack``; built once, before the chain."""
    if not cfg.fold_weights:
        raise ValueError("mega_stack needs folded (pre-normalized) weights")

    def stack(suffix):
        return torch.stack([state_dict[f"blocks.{i}.{suffix}"] for i in range(cfg.depth)]).to(cfg.dtype).contiguous()

    gains = torch.stack(
        [torch.stack([state_dict[f"blocks.{i}.gain_msa"], state_dict[f"blocks.{i}.gain_mlp"]]) for i in range(cfg.depth)]
    ).float()
    return {
        "gains": gains.contiguous(),
        "w_mod": stack("modulation.1.weight"),
        "w_qkv": stack("attn.qkv_proj.weight"),
        "w_out": stack("attn.out_proj.weight"),
        "w1": stack("mlp.net.0.weight"),
        "w2": stack("mlp.net.2.weight"),
    }


SAMPLERS = ("ddpm", "ddim", "dpm++", "unipc")


def resolve_run_config(cfg: DiTConfig, fold: bool = True, batch_hint: Optional[int] = None, device=None) -> DiTConfig:
    """The config a chain runs: folded weights when ``fold`` and weight
    normalization are on, and ``auto`` promoted to ``mega_stack`` where
    ``stack_auto_ok`` takes it (a batch hint given; its value does not
    matter; ``device`` is the chain's torch.device)."""
    run_cfg = cfg.replace(fold_weights=True) if (fold and cfg.use_weight_normalization) else cfg
    if run_cfg.block_kernel == "auto" and stack_auto_ok(run_cfg, batch_hint, device):
        run_cfg = run_cfg.replace(block_kernel="mega_stack")
    if run_cfg.block_kernel == "mega_stack" and run_cfg.scan_blocks:
        raise ValueError("mega_stack replaces scan_blocks: a scan_blocks model runs its blocks one by one "
                         "(auto takes the whole-block kernel for each)")
    return run_cfg


def folded_model(cfg: DiTConfig, state_dict: Dict[str, torch.Tensor], fold: bool = True, device=None) -> DiT:
    """The model on ``device`` (default CUDA) with its weights folded when
    ``fold`` and weight normalization are on."""
    device = resolve_device(device)
    run_cfg = cfg.replace(fold_weights=True) if (fold and cfg.use_weight_normalization) else cfg
    sd = {k: v.to(device) for k, v in state_dict.items()}
    if run_cfg.fold_weights:
        sd = fold_weights_for_inference(sd, run_cfg)
    model = DiT(run_cfg).to(device).eval()
    model.load_state_dict(sd)
    return model


def build_model_fn(
    cfg: DiTConfig, state_dict: Dict[str, torch.Tensor], cfg_scale: Optional[float] = None, fold: bool = True,
    device=None,
) -> Callable:
    """``model_fn(x, t, y)`` on the folded weights: the plain forward, or
    with ``cfg_scale`` the batched-CFG forward (the caller passes [z; z]
    and [cond; null] labels)."""
    model = folded_model(cfg, state_dict, fold, device)

    @torch.no_grad()
    def model_fn(x, t, y):
        if cfg_scale is None:
            return model(x, t, y)
        return model.forward_with_cfg(x, t, y, cfg_scale)

    return model_fn


def prepare_weights(
    cfg: DiTConfig, state_dict: Dict[str, torch.Tensor], fold: bool = True, batch_hint: Optional[int] = None,
    device=None, mesh=None,
) -> Dict:
    """The weights the chains of one run config share: ``{"model",
    "block_stack"}``. The model is :func:`folded_model`'s, on
    the per-block config (an ``auto`` that resolves to ``mega_stack`` stays
    ``auto`` in its blocks), so a block-by-block chain runs it as it is;
    under ``mega_stack`` the bf16 weight stack is built once beside it. They
    depend on the resolved run config (:func:`resolve_run_config`), not on
    the batch, so one prepared dict serves every chain of that config
    whatever its batch hint (:func:`check_prepared`). With a ``mesh`` (two
    or more ranks) it first checks that every rank holds the same weights,
    and under a TP kernel loads only this rank's shards."""
    device = resolve_device(device)
    run_cfg = resolve_run_config(cfg, fold, batch_hint, device)
    if mesh is None and run_cfg.block_kernel not in TP_KERNELS:
        model = folded_model(cfg, state_dict, fold, device)
        sd = model.state_dict()
    else:
        sd = {k: v.to(device) for k, v in state_dict.items()}
        if run_cfg.fold_weights:
            sd = fold_weights_for_inference(sd, run_cfg)
        model = DiT(resolve_run_config(cfg, fold, None, device)).to(device).eval()
        if mesh is not None:
            check_replicated(sd, device)
        if run_cfg.block_kernel in TP_KERNELS:
            model.load_tensor_parallel(shard_state_dict(sd, run_cfg, mesh, run_cfg.block_kernel), mesh)
        else:
            model.load_state_dict(sd)
    stack = build_block_stack(sd, run_cfg) if run_cfg.block_kernel == "mega_stack" else None
    return {"model": model, "block_stack": stack}


def check_prepared(prepared: Dict, cfg: DiTConfig, fold: bool, use_stack: Optional[bool] = None) -> None:
    """Raise ``ValueError`` unless ``prepared`` (:func:`prepare_weights`)
    holds ``cfg``'s model folded as ``fold`` says and, for a chain that
    runs the block stack (``use_stack``; None for a block-by-block chain,
    which ignores it), a stack exactly where the chain runs one."""
    want = resolve_run_config(cfg, fold)
    model_cfg, has_stack = prepared["model"].cfg, prepared["block_stack"] is not None
    if model_cfg != want or (use_stack is not None and has_stack != use_stack):
        raise ValueError(
            f"the prepared weights run block_kernel={model_cfg.block_kernel!r} (fold_weights="
            f"{model_cfg.fold_weights}, block stack {has_stack}); this chain needs {want.block_kernel!r} "
            f"(fold_weights={want.fold_weights}, block stack {use_stack})"
        )


def cfg_interval_segments(diffusion, sigma_lo: float, sigma_hi: float):
    """The chain positions [g0, g1) whose noise level sigma(t) =
    sqrt((1 - acp_t) / acp_t) lies in [sigma_lo, sigma_hi]. Walked in chain
    order sigma falls monotonically, so the guided steps are one run; an
    interval that holds no grid point gives (0, 0)."""
    acp = diffusion.alphas_cumprod.cpu().numpy().astype(np.float64)
    sigma = np.sqrt((1.0 - acp) / acp)[::-1]
    guided = (sigma >= float(sigma_lo)) & (sigma <= float(sigma_hi))
    idx = np.flatnonzero(guided)
    if idx.size == 0:
        return (0, 0)
    g0, g1 = int(idx[0]), int(idx[-1]) + 1
    assert guided[g0:g1].all()
    return (g0, g1)


def _denoised_fn(dynamic_threshold: Optional[float]):
    if dynamic_threshold is None:
        return None
    from mapdit_tpu_torch.diffusion.gaussian import dynamic_threshold_fn

    return dynamic_threshold_fn(dynamic_threshold)


def build_shared_sample_fn(
    cfg: DiTConfig,
    diffusion,
    cfg_scale: Optional[float] = None,
    fold: bool = True,
    sampler: str = "ddpm",
    eta: float = 0.0,
    scan_unroll: int = 1,
    clip_denoised: bool = False,
    cfg_interval: Optional[tuple] = None,
    batch_hint: Optional[int] = None,
    dynamic_threshold: Optional[float] = None,
    noise_fn: Optional[Callable] = None,
    device=None,
    mesh=None,
):
    """``(prepare, sample_fn)``: ``prepare(state_dict)`` is
    :func:`prepare_weights` at this chain's config (the folded model and
    the weight stack); ``sample_fn(prepared, noise, y, generator)`` runs the
    chain, so one built function serves many weight sets (``sample_ema``'s
    five EMA stds).

    ``sampler``: ``ddpm``, ``ddim`` (``eta`` 0 is the ODE, 1 DDPM-like),
    ``dpm++`` or ``unipc``; any other raises naming the ROADMAP item
    "Beyond-reference samplers". ``scan_unroll`` is taken for the JAX
    signature and ignored: the chain is a Python loop, not a scan.
    ``dynamic_threshold``: the percentile of
    :func:`~mapdit_tpu_torch.diffusion.gaussian.dynamic_threshold_fn`.

    ``cfg_interval=(sigma_lo, sigma_hi)``: limited-interval guidance. CFG
    runs only on the chain positions :func:`cfg_interval_segments` gives;
    the others call the cond-only model on N rows. The chain runs as three
    segments stitched through the carried state (the generator for ddpm,
    the history for dpm++ and unipc), so the full interval is the CFG
    chain and the empty one the cond-only chain. ddpm (the fast chain),
    dpm++ and unipc only.

    ``batch_hint`` (the pre-CFG sample count) lets ``block_kernel="auto"``
    promote to the whole-stack kernel (``models/blocks.py:stack_auto_ok``).
    ``noise_fn(t, shape)`` replaces the step noise of ddpm and of ddim at
    ``eta > 0`` (cross-framework parity tests); a call may pass its own.

    Weights fold only under ``use_weight_normalization``; without it a
    weight-normalized class table (``use_mp_embedding``) is normalized in
    the graph at every step, as in the JAX package. ``fused_dit_stack``
    hard-codes the MP + adaln + cosine-attention family (a rotation head
    has 4D or 5D rows, not 6D), so an explicit ``mega_stack`` on another
    family raises ``ValueError``; ``auto`` never promotes one.
    """
    del scan_unroll
    if sampler not in SAMPLERS:
        raise NotImplementedError(
            f"sampler={sampler!r} is not a sampler of the JAX package; the ROADMAP item 'Beyond-reference samplers' "
            f"ported {SAMPLERS}"
        )
    device = resolve_device(device)
    from mapdit_tpu_torch.diffusion import gd
    from mapdit_tpu_torch.diffusion.dpm_solver import dpm_solver_pp_loop, dpm_solver_pp_tables
    from mapdit_tpu_torch.diffusion.unipc import unipc_loop, unipc_tables

    run_cfg = resolve_run_config(cfg, fold, batch_hint, device)
    use_stack = run_cfg.block_kernel == "mega_stack"
    if use_stack and not kernel_family_ok(run_cfg):
        raise ValueError(
            f"mega_stack hard-codes the MP + adaln + cosine-attention family; got flags {run_cfg.flags_dict()}"
        )
    if use_stack and not run_cfg.fold_weights:
        raise ValueError("mega_stack needs fold=True (folded weights)")
    if run_cfg.block_kernel in TP_KERNELS and (mesh is None or mesh.n_model < 2):
        raise ValueError(f"block_kernel={run_cfg.block_kernel!r} runs on build_sample_fn(mesh=) with a model axis")
    use_fast = sampler == "ddpm" and diffusion.mean_type == gd.EPSILON and diffusion.var_type == gd.LEARNED_RANGE
    segments = None
    if cfg_interval is not None:
        if cfg_scale is None:
            raise ValueError("--cfg-interval needs CFG (cfg_scale)")
        if not (sampler in ("dpm++", "unipc") or use_fast):
            raise ValueError("--cfg-interval composes with --sampler ddpm, dpm++ or unipc")
        segments = cfg_interval_segments(diffusion, *cfg_interval)
    denoised = _denoised_fn(dynamic_threshold)
    # the ODE chains' coefficient tables, built once (a chain that built
    # them would read the schedule back from the device at every call)
    tables = None
    if sampler == "dpm++":
        tables = dpm_solver_pp_tables(diffusion, device)
    elif sampler == "unipc":
        tables = unipc_tables(diffusion, device)

    def prepare(state_dict: Dict[str, torch.Tensor]) -> Dict:
        return prepare_weights(cfg, state_dict, fold, batch_hint, device, mesh)

    def run(model_fn, x, generator, noise_fn, kw, step_slice=None, carry=None, return_carry=False):
        """One segment of the chain: positions ``step_slice`` (None: all)
        entered with ``carry``; returns x, or (x, carry) with
        ``return_carry``."""
        if sampler == "dpm++":
            return dpm_solver_pp_loop(
                diffusion, model_fn, x, step_slice=step_slice, prev_x0=carry, return_carry=return_carry, tables=tables,
                **kw)
        if sampler == "unipc":
            out = unipc_loop(
                diffusion, model_fn, x, step_slice=step_slice, prev_carry=carry, return_carry=return_carry,
                tables=tables, **kw)
            return (out[0], out) if return_carry else out
        if sampler == "ddim":
            return diffusion.ddim_sample_loop(model_fn, x, generator, eta=eta, noise_fn=noise_fn, **kw)
        if use_fast:
            out = diffusion.p_sample_loop_fast(
                model_fn, x, generator, noise_fn=noise_fn, step_slice=step_slice, return_carry=return_carry, **kw)
            return (out[0], None) if return_carry else out
        return diffusion.p_sample_loop(model_fn, x, generator, noise_fn=noise_fn, **kw)

    @torch.no_grad()
    def sample_fn(
        prepared: Dict, noise: torch.Tensor, y: torch.Tensor, generator=None, noise_fn=noise_fn
    ) -> torch.Tensor:
        model, stack = prepared["model"], prepared["block_stack"]

        def model_fn_cond(x, t, y):
            return model(x, t, y, block_stack=stack)

        if cfg_scale is None:
            model_fn, chain_noise, chain_y = model_fn_cond, noise, y
        else:
            n_half = noise.shape[0] // 2
            chain_noise, chain_y = noise[:n_half], y[:n_half]
            y_full = y  # [cond labels; null labels], length 2N

            def model_fn(x_half, t, y):
                out = model.forward_with_cfg(
                    torch.cat([x_half, x_half]), torch.cat([t, t]), y_full, cfg_scale, block_stack=stack
                )
                return out[:n_half]

        kw = dict(clip_denoised=clip_denoised, denoised_fn=denoised, model_kwargs={"y": chain_y})
        if segments is None:
            x = run(model_fn, chain_noise, generator, noise_fn, kw)
        else:
            # unguided positions run the cond-only forward on N rows
            (g0, g1), steps = segments, diffusion.num_timesteps
            x, carry = run(model_fn_cond, chain_noise, generator, noise_fn, kw, (0, g0), None, True)
            x, carry = run(model_fn, x, generator, noise_fn, kw, (g0, g1), carry, True)
            x = run(model_fn_cond, x, generator, noise_fn, kw, (g1, steps), carry)
        if cfg_scale is not None:
            x = torch.cat([x, x])
        return x

    sample_fn.run_cfg = run_cfg
    sample_fn.cfg_segments = segments
    return prepare, sample_fn


def build_sample_fn(
    cfg: DiTConfig,
    state_dict: Dict[str, torch.Tensor],
    diffusion,
    cfg_scale: Optional[float] = None,
    fold: bool = True,
    sampler: str = "ddpm",
    eta: float = 0.0,
    scan_unroll: int = 1,
    clip_denoised: bool = False,
    cfg_interval: Optional[tuple] = None,
    batch_hint: Optional[int] = None,
    dynamic_threshold: Optional[float] = None,
    noise_fn: Optional[Callable] = None,
    mesh=None,
    device=None,
    prepared: Optional[Dict] = None,
):
    """``sample_fn(noise, y, generator)`` over the full chain, with the
    weights prepared once. ``noise`` is (2N, C, H, W) and ``y`` is
    [cond labels; null labels] under CFG. The sampler arguments are those
    of :func:`build_shared_sample_fn`.

    ``prepared`` (:func:`prepare_weights` at the same config, fold and
    device) is used in place of preparing ``state_dict`` (which may then be
    None), so many chains share one set of weights on the device
    (:func:`check_prepared` holds it to this chain).

    ``mesh`` (``parallel.make_mesh``): the layout of ``runtime.py:646-748``
    of the JAX package on torch.distributed, called on every rank with the
    same arguments (the same weights, the global noise and labels, a
    generator with the same seed). Its model axis runs the tensor-parallel
    islands: ``auto`` resolves through ``resolve_block_kernel_tp``,
    ``mega_attn_tp`` and ``mega_tp`` may be named; the other kernels, the
    plain path and every family outside MP + adaln + cosine attention are
    refused there. A data-only mesh runs any kernel on full weights. The
    data axis splits the pre-CFG batch, each rank keeping matching cond and
    null rows; each rank draws the step noise at the global shape and keeps
    its rows, so the chain equals the unsharded one under the same
    generator (ddim at ``eta > 0`` too; dpm++ and unipc draw none). The
    result is all-gathered over the data group. A batch the data axis does
    not divide runs whole on every rank."""
    if mesh is not None and mesh.size > 1:
        device = mesh.device if device is None else device
        cfg = _mesh_config(cfg, fold, mesh, device)
    else:
        mesh = None
    prepare, shared_fn = build_shared_sample_fn(
        cfg, diffusion, cfg_scale=cfg_scale, fold=fold, sampler=sampler, eta=eta, scan_unroll=scan_unroll,
        clip_denoised=clip_denoised, cfg_interval=cfg_interval, batch_hint=batch_hint,
        dynamic_threshold=dynamic_threshold, noise_fn=noise_fn, device=device, mesh=mesh,
    )
    if prepared is None:
        prepared = prepare(state_dict)
    else:
        check_prepared(prepared, cfg, fold, shared_fn.run_cfg.block_kernel == "mega_stack")

    def sample_fn(noise: torch.Tensor, y: torch.Tensor, generator=None) -> torch.Tensor:
        n_pre = noise.shape[0] // 2 if cfg_scale is not None else noise.shape[0]
        if mesh is None or mesh.n_data == 1 or n_pre % mesh.n_data:
            return shared_fn(prepared, noise, y, generator)
        n_loc = n_pre // mesh.n_data
        keep = slice(mesh.data_index * n_loc, (mesh.data_index + 1) * n_loc)

        def rows(z):
            return torch.cat([z[keep], z[n_pre:][keep]]) if cfg_scale is not None else z[keep]

        def step_noise(t, shape):
            full = (n_pre, *shape[1:])
            if noise_fn is not None:
                return noise_fn(t[:1].expand(n_pre), full)[keep]
            return torch.randn(full, generator=generator, device=noise.device, dtype=noise.dtype)[keep]

        out = shared_fn(prepared, rows(noise), rows(y), generator, noise_fn=step_noise)
        x = all_gather_rows(out[:n_loc], mesh.data_group)
        return torch.cat([x, x]) if cfg_scale is not None else x

    sample_fn.run_cfg = shared_fn.run_cfg
    sample_fn.cfg_segments = shared_fn.cfg_segments
    sample_fn.prepared = prepared
    return sample_fn


CACHE_MODES = ("hold", "forecast")


def build_cached_sample_fn(
    cfg: DiTConfig,
    state_dict: Dict[str, torch.Tensor],
    diffusion,
    cfg_scale: Optional[float] = None,
    fold: bool = True,
    span: Optional[tuple] = None,
    cache_interval: int = 2,
    clip_denoised: bool = False,
    sampler: str = "ddpm",
    cfg_interval: Optional[tuple] = None,
    cache_mode: str = "forecast",
    dynamic_threshold: Optional[float] = None,
    noise_fn: Optional[Callable] = None,
    device=None,
    prepared: Optional[Dict] = None,
):
    """``sample_fn(noise, y, generator)``: the ddpm or dpm++ chain with
    Delta-DiT block-span caching, a lossy accelerator. The chain runs in
    groups of ``cache_interval`` steps: a group's first step runs the full
    model and records the displacement of blocks ``span = (i, j)`` (default
    the middle half of the depth); its other steps skip those blocks and add
    the recorded displacement (``cache_mode="hold"``) or extrapolate it
    linearly from the two latest full steps (``"forecast"``; the first group
    of each segment holds). An empty span or ``cache_interval=1`` is the
    exact chain.

    The blocks run one by one: ``auto`` resolves per block
    (``fused_dit_block`` on the card), and an explicit ``mega_stack``
    raises, since the whole-stack kernel cannot skip a span.
    ``cfg_interval`` is snapped outward to whole cache groups (a group's
    delta has the shape of one kind of call) and the chain runs as three
    stitched segments, as in :func:`build_shared_sample_fn`.
    ``noise_fn(t, shape)`` replaces the ddpm step noise.

    ``prepared``: as in :func:`build_sample_fn`; the chain runs its model
    block by block and leaves any block stack aside."""
    from mapdit_tpu_torch.diffusion import gd
    from mapdit_tpu_torch.diffusion.dpm_solver import dpm_solver_pp_tables, dpm_solver_pp_update, x0_of

    if sampler not in ("ddpm", "dpm++"):
        raise ValueError(f"--cache-interval composes with --sampler ddpm or dpm++, not {sampler!r}")
    if cache_mode not in CACHE_MODES:
        raise ValueError(f"cache_mode {cache_mode!r} is not one of {CACHE_MODES}")
    if cfg.block_kernel == "mega_stack":
        raise ValueError(
            "block-span caching skips a block subrange, which the whole-stack kernel cannot express; use "
            "--block-kernel mega (or auto) with --cache-interval"
        )
    if cfg.scan_blocks:
        raise ValueError("block-span caching needs scan_blocks=False")
    if not (diffusion.mean_type == gd.EPSILON and diffusion.var_type == gd.LEARNED_RANGE):
        raise ValueError("block-span caching runs the eps + learned-range chain")
    n_steps = diffusion.num_timesteps
    if cache_interval < 1 or n_steps % cache_interval:
        raise ValueError(f"cache_interval {cache_interval} must divide the {n_steps} chain steps")
    forecast = cache_mode == "forecast" and cache_interval > 1
    n_groups = n_steps // cache_interval
    bounds = [(0, n_groups)]
    if cfg_interval is not None:
        if cfg_scale is None:
            raise ValueError("cfg_interval needs CFG (cfg_scale)")
        g0, g1 = cfg_interval_segments(diffusion, *cfg_interval)
        lo, hi = g0 // cache_interval, -(-g1 // cache_interval)
        bounds = [(0, lo), (lo, hi), (hi, n_groups)]
    if span is None:
        span = (cfg.depth // 4, cfg.depth - cfg.depth // 4)
    denoised = _denoised_fn(dynamic_threshold)
    dev = resolve_device(device)
    if prepared is None:
        model = folded_model(cfg, state_dict, fold, dev)
    else:
        check_prepared(prepared, cfg, fold)
        model = prepared["model"]
    step_tables = None if sampler == "ddpm" else dpm_solver_pp_tables(diffusion, dev)

    @torch.no_grad()
    def sample_fn(noise: torch.Tensor, y: torch.Tensor, generator=None, noise_fn=noise_fn) -> torch.Tensor:
        if cfg_scale is None:
            chain_noise, chain_y = noise, y
        else:
            n_half = noise.shape[0] // 2
            chain_noise, chain_y = noise[:n_half], y[:n_half]
        n = chain_noise.shape[0]

        def call(guided, x, t_vec, delta):
            """The model at ``x`` with the span computed (``delta`` None:
            returns the new delta too) or replaced by ``delta``."""
            kw = dict(span=span, cached_delta=delta, return_delta=delta is None)
            if guided:
                out = model.forward_with_cfg(torch.cat([x, x]), torch.cat([t_vec, t_vec]), y, cfg_scale, **kw)
            else:
                out = model(x, t_vec, chain_y, **kw)
            out, new_delta = out if delta is None else (out, delta)
            return (out[:n] if guided else out), new_delta

        x, prev_x0 = chain_noise, torch.zeros_like(chain_noise)
        for k, (a, b) in enumerate(bounds):
            # the middle segment of a cfg interval (or the only one) is guided
            guided = cfg_scale is not None and (len(bounds) == 1 or k == 1)
            prev_delta = None  # the forecast history is local to a segment
            for g in range(a, b):
                delta = None
                for s_ in range(cache_interval):
                    i = g * cache_interval + s_
                    ti = n_steps - 1 - i
                    t_vec = diffusion.timestep_map[ti].float().expand(n).to(dev)
                    if s_ == 0:
                        out, delta = call(guided, x, t_vec, None)
                    else:
                        pred = delta
                        if forecast and prev_delta is not None:
                            # the weight rounded to the stream's type, as JAX casts it
                            coef = float(torch.tensor(s_ / cache_interval, dtype=delta.dtype))
                            pred = delta + coef * (delta - prev_delta)
                        out, _ = call(guided, x, t_vec, pred)
                    if sampler == "ddpm":
                        x = diffusion.fast_step(out, x, ti, generator, clip_denoised, denoised, noise_fn)
                    else:
                        x0 = x0_of(diffusion, out, x, step_tables[1][i], step_tables[2][i], clip_denoised, denoised)
                        x, prev_x0 = dpm_solver_pp_update(step_tables, i, x, x0, prev_x0), x0
                prev_delta = delta
        return torch.cat([x, x]) if cfg_scale is not None else x

    sample_fn.span = span
    sample_fn.prepared = prepared
    return sample_fn


def _mesh_config(cfg: DiTConfig, fold: bool, mesh, device) -> DiTConfig:
    """The kernel checks of ``runtime.py:692-714`` of the JAX package: the
    config a mesh of two or more ranks runs, or the reason it cannot."""
    tp = mesh.n_model
    if tp > 1 and cfg.scan_blocks:
        raise NotImplementedError(
            "tensor parallelism on the scan_blocks layout is the ROADMAP item 'Multi-GPU layouts, the rest'"
        )
    if tp == 1:
        if cfg.block_kernel in TP_KERNELS:
            raise ValueError(f"block_kernel={cfg.block_kernel!r} needs a model axis of 2 or more ranks")
        return cfg
    if cfg.block_kernel not in ("auto", "off", *TP_KERNELS):
        raise ValueError(
            f"block_kernel={cfg.block_kernel!r} is a single-device kernel and cannot run on a mesh with a model "
            f"axis; use 'auto' (resolves to mega_tp or mega_attn_tp), 'mega_attn_tp' or 'mega_tp'"
        )
    folded = fold and cfg.use_weight_normalization
    kernel = resolve_block_kernel_tp(cfg, folded, tp, device)
    if kernel == "off" or not kernel_family_ok(cfg):
        raise NotImplementedError(
            f"tensor parallelism of the plain path (block_kernel={cfg.block_kernel!r} resolving to {kernel!r} on "
            f"{tp} model ranks, flags {cfg.flags_dict()}) is the ROADMAP item 'Multi-GPU layouts, the rest' "
            f"(TP of the plain path): the port splits "
            f"only the MP + adaln + cosine-attention islands mega_attn_tp and mega_tp"
        )
    if not folded:
        raise ValueError(f"{kernel} takes folded weights: build with fold=True")
    hidden = int(cfg.hidden_size * cfg.mlp_ratio)
    if cfg.num_heads % tp or (kernel == "mega_tp" and hidden % tp):
        raise ValueError(f"{kernel}: {cfg.num_heads} heads (and hidden width {hidden}) do not split over {tp} ranks")
    return cfg.replace(block_kernel=kernel)
