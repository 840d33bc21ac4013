"""Sampling runtime, port of ``mapdit_tpu/runtime.py`` for the DDPM chain.

``build_sample_fn`` folds the weights once (every weight-normalized matrix
pre-normalized, so the chain skips the in-graph normalization), resolves the
block-kernel policy, stacks the block weights for the whole-stack kernel
when it is chosen, and returns ``sample_fn(noise, y, generator)``. With CFG
the chain evolves only the first half of the [z; z] batch and duplicates it
into the [cond; uncond] model call (the half-CFG chain); the result keeps
the reference's 2N shape. PyTorch runs the chain eagerly, one Python
iteration per step; capturing it in a CUDA graph is the ROADMAP item
"Sampling runtime leftovers".

``build_sample_fn(mesh=)`` runs the chain on a ('data', 'model') mesh of
ranks (``parallel/mesh.py``): the data axis splits the batch, the model axis
runs the tensor-parallel islands of ``ops/cuda/dit_block_tp.py`` on each
rank's weight shards.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import torch

from mapdit_tpu_torch.models.blocks import kernel_family_ok, resolve_block_kernel_tp, stack_auto_ok
from mapdit_tpu_torch.models.config import TP_KERNELS, DiTConfig
from mapdit_tpu_torch.models.dit import DiT
from mapdit_tpu_torch.ops.mp import normalize
from mapdit_tpu_torch.parallel.mesh import all_gather_rows, check_replicated, shard_state_dict
from mapdit_tpu_torch.utils.device import resolve_device


def fold_weights_for_inference(state_dict: Dict[str, torch.Tensor], cfg: DiTConfig) -> Dict[str, torch.Tensor]:
    """Normalize every weight-normalized matrix once (2-D ``*.weight``
    entries, the class embedding table included)."""
    out = {}
    for key, value in state_dict.items():
        names = key.split(".")
        if names[-1] != "weight" or value.ndim != 2:
            out[key] = value
            continue
        is_embedding = len(names) >= 2 and names[-2] == "embedding"
        flag = cfg.use_mp_embedding if is_embedding else cfg.use_weight_normalization
        out[key] = normalize(value) if flag else value
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


def build_shared_sample_fn(
    cfg: DiTConfig,
    diffusion,
    cfg_scale: Optional[float] = None,
    fold: bool = True,
    sampler: str = "ddpm",
    clip_denoised: bool = False,
    batch_hint: Optional[int] = None,
    noise_fn: Optional[Callable] = None,
    device=None,
    mesh=None,
):
    """``(prepare, sample_fn)``: ``prepare(state_dict)`` builds the folded
    model (and the weight stack); ``sample_fn(prepared, noise, y,
    generator)`` runs the chain, so one built function serves many weight
    sets. With a ``mesh`` (two or more ranks), ``prepare`` first checks
    that every rank holds the same weights, and under a TP kernel loads
    only this rank's shards of the folded weights.

    ``batch_hint`` (the pre-CFG sample count) lets ``block_kernel="auto"``
    promote to the whole-stack kernel (``models/blocks.py:stack_auto_ok``).
    ``noise_fn(t, shape)`` replaces the step noise (cross-framework parity
    tests); a call may pass its own. Only ``sampler="ddpm"`` is ported; the
    others are the ROADMAP item "Beyond-reference samplers".

    Weights fold only under ``use_weight_normalization``; without it a
    weight-normalized class table (``use_mp_embedding``) is normalized in
    the graph at every step, as in the JAX package. ``fused_dit_stack``
    hard-codes the MP + adaln + cosine-attention family (a rotation head
    has 4D or 5D rows, not 6D), so an explicit ``mega_stack`` on another
    family raises ``ValueError``; ``auto`` never promotes one.
    """
    if sampler != "ddpm":
        raise NotImplementedError(
            f"sampler={sampler!r} is the ROADMAP item 'Beyond-reference samplers'; the port runs 'ddpm'"
        )
    device = resolve_device(device)
    from mapdit_tpu_torch.diffusion import gd

    run_cfg = cfg.replace(fold_weights=True) if (fold and cfg.use_weight_normalization) else cfg
    if run_cfg.block_kernel == "auto" and stack_auto_ok(run_cfg, batch_hint, device):
        run_cfg = run_cfg.replace(block_kernel="mega_stack")
    use_stack = run_cfg.block_kernel == "mega_stack"
    if use_stack and not kernel_family_ok(run_cfg):
        raise ValueError(
            f"mega_stack hard-codes the MP + adaln + cosine-attention family; got flags {run_cfg.flags_dict()}"
        )
    if use_stack and not run_cfg.fold_weights:
        raise ValueError("mega_stack needs fold=True (folded weights)")
    if run_cfg.block_kernel in TP_KERNELS and (mesh is None or mesh.n_model < 2):
        raise ValueError(f"block_kernel={run_cfg.block_kernel!r} runs on build_sample_fn(mesh=) with a model axis")
    use_fast = diffusion.mean_type == gd.EPSILON and diffusion.var_type == gd.LEARNED_RANGE

    def prepare(state_dict: Dict[str, torch.Tensor]) -> Dict:
        sd = {k: v.to(device) for k, v in state_dict.items()}
        if run_cfg.fold_weights:
            sd = fold_weights_for_inference(sd, run_cfg)
        model = DiT(run_cfg).to(device).eval()
        if mesh is not None:
            check_replicated(sd, device)
        if run_cfg.block_kernel in TP_KERNELS:
            model.load_tensor_parallel(shard_state_dict(sd, run_cfg, mesh, run_cfg.block_kernel), mesh)
        else:
            model.load_state_dict(sd)
        return {"model": model, "block_stack": build_block_stack(sd, run_cfg) if use_stack else None}

    @torch.no_grad()
    def sample_fn(
        prepared: Dict, noise: torch.Tensor, y: torch.Tensor, generator=None, noise_fn=noise_fn
    ) -> torch.Tensor:
        model, stack = prepared["model"], prepared["block_stack"]
        if cfg_scale is None:
            def model_fn(x, t, y):
                return model(x, t, y, block_stack=stack)

            chain_noise, chain_y = noise, y
        else:
            n_half = noise.shape[0] // 2
            chain_noise, chain_y = noise[:n_half], y[:n_half]
            y_full = y  # [cond labels; null labels], length 2N

            def model_fn(x_half, t, y):
                out = model.forward_with_cfg(
                    torch.cat([x_half, x_half]), torch.cat([t, t]), y_full, cfg_scale, block_stack=stack
                )
                return out[:n_half]

        loop = diffusion.p_sample_loop_fast if use_fast else diffusion.p_sample_loop
        x = loop(
            model_fn, chain_noise, generator, clip_denoised=clip_denoised,
            model_kwargs={"y": chain_y}, noise_fn=noise_fn,
        )
        if cfg_scale is not None:
            x = torch.cat([x, x])
        return x

    sample_fn.run_cfg = run_cfg
    return prepare, sample_fn


def build_sample_fn(
    cfg: DiTConfig,
    state_dict: Dict[str, torch.Tensor],
    diffusion,
    cfg_scale: Optional[float] = None,
    fold: bool = True,
    sampler: str = "ddpm",
    clip_denoised: bool = False,
    batch_hint: Optional[int] = None,
    noise_fn: Optional[Callable] = None,
    mesh=None,
    device=None,
):
    """``sample_fn(noise, y, generator)`` over the full chain, with the
    weights prepared once. ``noise`` is (2N, C, H, W) and ``y`` is
    [cond labels; null labels] under CFG.

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
    generator. The result is all-gathered over the data group. A batch the
    data axis does not divide runs whole on every rank."""
    if mesh is not None and mesh.size > 1:
        device = mesh.device if device is None else device
        cfg = _mesh_config(cfg, fold, mesh, device)
    else:
        mesh = None
    prepare, shared_fn = build_shared_sample_fn(
        cfg, diffusion, cfg_scale=cfg_scale, fold=fold, sampler=sampler, clip_denoised=clip_denoised,
        batch_hint=batch_hint, noise_fn=noise_fn, device=device, mesh=mesh,
    )
    prepared = prepare(state_dict)

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
    return sample_fn


def _mesh_config(cfg: DiTConfig, fold: bool, mesh, device) -> DiTConfig:
    """The kernel checks of ``runtime.py:692-714`` of the JAX package: the
    config a mesh of two or more ranks runs, or the reason it cannot."""
    tp = mesh.n_model
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
