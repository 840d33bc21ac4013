"""The DiT model, port of ``mapdit_tpu/models/dit.py`` (forward with train-time
label dropout, ``forward_with_cfg``, the whole-stack kernel path, the
block-span cache protocol and ``project_weights``)."""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from mapdit_tpu_torch.models.blocks import DiTBlock, FinalLayer, LabelEmbedder, TimestepEmbedder, kernel_family_ok
from mapdit_tpu_torch.models.config import DiTConfig
from mapdit_tpu_torch.models.layers import MPLinear, activation
from mapdit_tpu_torch.ops.mp import mp_sum, normalize
from mapdit_tpu_torch.ops.patch import patchify, unpatchify
from mapdit_tpu_torch.ops.pos_embed import get_2d_sincos_pos_embed
from mapdit_tpu_torch.utils.device import resolve_device


def pos_embed_buffer(cfg: DiTConfig) -> torch.Tensor:
    """The (1, T, D) f32 positional table, the reference's ``pos_embed``
    buffer: row-normalized under ``use_mp_pos_enc``, raw otherwise."""
    table = torch.from_numpy(get_2d_sincos_pos_embed(cfg.hidden_size, cfg.input_size // cfg.patch_size)).float()
    return (normalize(table) if cfg.use_mp_pos_enc else table)[None]


class DiT(nn.Module):
    """Diffusion Transformer with the magnitude-preserving variants the
    ``use_*`` flags and ``modulation`` select.

    ``forward(x, t, y)`` with x (N, C, H, W), t (N,) float timesteps and
    y (N,) int labels returns (N, 2C, H, W) f32 (learn_sigma) or (N, C, H, W).
    Parameter names are the reference's state-dict names.
    """

    def __init__(self, cfg: DiTConfig):
        super().__init__()
        self.cfg = cfg
        p = cfg.patch_size
        # bias-free MP design: a ones column appended to the patch features
        # acts as the input bias; without weight normalization the linear
        # has its own bias
        self.x_embedder = MPLinear(p * p * cfg.in_channels + int(cfg.use_weight_normalization), cfg.hidden_size, cfg)
        self.t_embedder = TimestepEmbedder(cfg)
        self.y_embedder = LabelEmbedder(cfg)
        self.blocks = nn.ModuleList(DiTBlock(cfg) for _ in range(cfg.depth))
        self.final_layer = FinalLayer(cfg)
        self.register_buffer("pos_embed", pos_embed_buffer(cfg))

    def reset_parameters(self, generator: torch.Generator) -> None:
        """Draw every parameter and Fourier buffer from ``generator`` (gains
        start at 0, as in the reference)."""
        for module in self.modules():
            if module is not self and hasattr(module, "reset_parameters"):
                module.reset_parameters(generator)

    def load_tensor_parallel(self, state_dict, mesh) -> None:
        """Load one rank's ``parallel.shard_state_dict``: each weight split
        over the model axis replaces its full-size parameter (so the rank
        holds only its shard), and every block runs its island over
        ``mesh``."""
        for name, value in state_dict.items():
            module_name, _, attr = name.rpartition(".")
            module = self.get_submodule(module_name)
            param = getattr(module, attr)
            if isinstance(param, nn.Parameter) and param.shape != value.shape:
                setattr(module, attr, nn.Parameter(param.new_empty(value.shape), requires_grad=False))
        self.load_state_dict(state_dict)
        for block in self.blocks:
            block.mesh = mesh

    def forward(
        self,
        x: torch.Tensor,
        t: torch.Tensor,
        y: torch.Tensor,
        force_drop_ids: Optional[torch.Tensor] = None,
        block_stack: Optional[dict] = None,
        train: bool = False,
        generator: Optional[torch.Generator] = None,
        span: Optional[tuple] = None,
        cached_delta: Optional[torch.Tensor] = None,
        return_delta: bool = False,
    ):
        """``block_stack`` (from ``runtime.build_block_stack``) runs all
        blocks through the whole-stack kernel ``fused_dit_stack``. ``train``
        drops class labels with ``class_dropout_prob``, drawn from
        ``generator``.

        The block-span cache protocol (``runtime.build_cached_sample_fn``):
        ``span=(i, j), return_delta=True`` also returns the span's
        token-state displacement (the stream after block j-1 minus the
        stream before block i); ``span=(i, j), cached_delta=delta`` skips
        blocks [i, j) and adds ``delta`` instead. The whole-stack kernel
        cannot skip a span: ``block_stack`` with ``span`` raises."""
        cfg = self.cfg
        dt = cfg.dtype
        x = patchify(x, cfg.patch_size).to(dt)
        if cfg.use_weight_normalization:
            x = torch.cat([x, torch.ones_like(x[:, :, :1])], dim=-1)
        x = self.x_embedder(x)
        pos = self.pos_embed.to(dt)
        x = mp_sum(x, pos, t=0.5) if cfg.use_mp_pos_enc else x + pos

        t_emb, y_emb = self.t_embedder(t), self.y_embedder(y, force_drop_ids, train, generator)
        c = mp_sum(t_emb, y_emb, t=0.5) if cfg.mp_style else t_emb + y_emb

        delta = None
        if block_stack is not None:
            from mapdit_tpu_torch.ops.cuda.dit_block import fused_dit_stack

            if span is not None:
                raise ValueError("block-span caching composes with the per-block kernels only, not mega_stack")

            if not kernel_family_ok(cfg):
                raise ValueError("fused_dit_stack hard-codes the MP + adaln + cosine-attention family")

            x = fused_dit_stack(
                x.to(dt).contiguous(),
                activation(c, cfg).to(dt).contiguous(),
                block_stack["gains"],
                block_stack["w_mod"],
                block_stack["w_qkv"],
                block_stack["w_out"],
                block_stack["w1"],
                block_stack["w2"],
                cfg.num_heads,
            )
        elif span is not None:
            lo, hi = span
            if not 0 <= lo <= hi <= cfg.depth:
                raise ValueError(f"span {span} is not inside the depth {cfg.depth}")
            for block in self.blocks[:lo]:
                x = block(x, c)
            if cached_delta is not None:
                x, delta = x + cached_delta, cached_delta
            else:
                x_before = x
                for block in self.blocks[lo:hi]:
                    x = block(x, c)
                delta = x - x_before
            for block in self.blocks[hi:]:
                x = block(x, c)
        else:
            for block in self.blocks:
                x = block(x, c)

        out = self.final_layer(x, c)
        if cfg.learn_sigma:
            mean, sigma = out
            out = torch.cat(
                [unpatchify(mean, cfg.input_size, cfg.patch_size), unpatchify(sigma, cfg.input_size, cfg.patch_size)],
                dim=1,
            ).float()
        else:
            out = unpatchify(out, cfg.input_size, cfg.patch_size).float()
        return (out, delta) if return_delta else out

    def forward_with_cfg(
        self,
        x: torch.Tensor,
        t: torch.Tensor,
        y: torch.Tensor,
        cfg_scale,
        block_stack: Optional[dict] = None,
        span: Optional[tuple] = None,
        cached_delta: Optional[torch.Tensor] = None,
        return_delta: bool = False,
    ):
        """Batched classifier-free guidance: the first half of x is the real
        batch, labels carry [cond; null]. Only the eps channels are guided;
        the sigma channels pass through. The span protocol passes through to
        :meth:`forward` (the delta covers the [cond; uncond] batch)."""
        c = self.cfg
        half = x[: x.shape[0] // 2]
        model_out = self(
            torch.cat([half, half], dim=0), t, y, block_stack=block_stack, span=span, cached_delta=cached_delta,
            return_delta=return_delta,
        )
        delta = None
        if return_delta:
            model_out, delta = model_out
        eps, rest = model_out[:, : c.in_channels], model_out[:, c.in_channels :]
        cond_eps, uncond_eps = torch.chunk(eps, 2, dim=0)
        half_eps = uncond_eps + cfg_scale * (cond_eps - uncond_eps)
        eps = torch.cat([half_eps, half_eps], dim=0)
        out = torch.cat([eps, rest], dim=1)
        return (out, delta) if return_delta else out


@torch.no_grad()
def project_weights(model: DiT, cfg: DiTConfig) -> None:
    """Row-normalize every weight-normalized matrix of ``model`` in place
    (forced weight normalization): the stored weights are projected back
    onto the norm-sqrt(in_dim) manifold after each optimizer update. The
    class embedding table follows ``use_mp_embedding``, the other 2-D
    ``weight`` matrices ``use_weight_normalization``; both need
    ``use_forced_weight_normalization``. In place where the JAX package
    returns a new tree."""
    for name, param in model.named_parameters():
        names = name.split(".")
        if names[-1] != "weight" or param.ndim != 2:
            continue
        is_embedding = len(names) >= 2 and names[-2] == "embedding"
        flag = cfg.use_mp_embedding if is_embedding else cfg.use_weight_normalization
        if flag and cfg.use_forced_weight_normalization:
            param.copy_(normalize(param))


def init_model(cfg: DiTConfig, seed: int = 0, device=None) -> DiT:
    """A DiT with weights drawn from ``seed`` (on the CPU, so the draw does
    not depend on the device), moved to ``device`` (default CUDA)."""
    device = resolve_device(device)
    model = DiT(cfg)
    model.reset_parameters(torch.Generator().manual_seed(seed))
    return model.to(device).eval()
