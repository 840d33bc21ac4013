"""The DiT model, port of ``mapdit_tpu/models/dit.py`` (forward with train-time
label dropout, ``forward_with_cfg``, the whole-stack kernel path and
``project_weights``)."""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from mapdit_tpu_torch.models.blocks import DiTBlock, FinalLayer, LabelEmbedder, TimestepEmbedder
from mapdit_tpu_torch.models.config import DiTConfig
from mapdit_tpu_torch.models.layers import MPLinear
from mapdit_tpu_torch.ops.mp import mp_silu, mp_sum, normalize
from mapdit_tpu_torch.ops.patch import patchify, unpatchify
from mapdit_tpu_torch.ops.pos_embed import get_2d_sincos_pos_embed
from mapdit_tpu_torch.utils.device import resolve_device


def pos_embed_buffer(cfg: DiTConfig) -> torch.Tensor:
    """The normalized (1, T, D) f32 positional table, the reference's
    ``pos_embed`` buffer."""
    table = get_2d_sincos_pos_embed(cfg.hidden_size, cfg.input_size // cfg.patch_size)
    return normalize(torch.from_numpy(table).float())[None]


class DiT(nn.Module):
    """Diffusion Transformer, default MaP family.

    ``forward(x, t, y)`` with x (N, C, H, W), t (N,) float timesteps and
    y (N,) int labels returns (N, 2C, H, W) f32 (learn_sigma) or (N, C, H, W).
    Parameter names are the reference's state-dict names.
    """

    def __init__(self, cfg: DiTConfig):
        super().__init__()
        self.cfg = cfg
        p = cfg.patch_size
        # bias-free MP design: a ones column appended to the patch features
        # acts as the input bias
        self.x_embedder = MPLinear(p * p * cfg.in_channels + 1, cfg.hidden_size, cfg)
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

    def forward(
        self,
        x: torch.Tensor,
        t: torch.Tensor,
        y: torch.Tensor,
        force_drop_ids: Optional[torch.Tensor] = None,
        block_stack: Optional[dict] = None,
        train: bool = False,
        generator: Optional[torch.Generator] = None,
    ) -> torch.Tensor:
        """``block_stack`` (from ``runtime.build_block_stack``) runs all
        blocks through the whole-stack kernel ``fused_dit_stack``. ``train``
        drops class labels with ``class_dropout_prob``, drawn from
        ``generator``."""
        cfg = self.cfg
        dt = cfg.dtype
        x = patchify(x, cfg.patch_size).to(dt)
        x = torch.cat([x, torch.ones_like(x[:, :, :1])], dim=-1)
        x = self.x_embedder(x)
        x = mp_sum(x, self.pos_embed.to(dt), t=0.5)

        c = mp_sum(self.t_embedder(t), self.y_embedder(y, force_drop_ids, train, generator), t=0.5)

        if block_stack is not None:
            from mapdit_tpu_torch.ops.cuda.dit_block import fused_dit_stack

            x = fused_dit_stack(
                x.to(dt).contiguous(),
                mp_silu(c).to(dt).contiguous(),
                block_stack["gains"],
                block_stack["w_mod"],
                block_stack["w_qkv"],
                block_stack["w_out"],
                block_stack["w1"],
                block_stack["w2"],
                cfg.num_heads,
            )
        else:
            for block in self.blocks:
                x = block(x, c)

        out = self.final_layer(x, c)
        if cfg.learn_sigma:
            mean, sigma = out
            return torch.cat(
                [unpatchify(mean, cfg.input_size, cfg.patch_size), unpatchify(sigma, cfg.input_size, cfg.patch_size)],
                dim=1,
            ).float()
        return unpatchify(out, cfg.input_size, cfg.patch_size).float()

    def forward_with_cfg(
        self,
        x: torch.Tensor,
        t: torch.Tensor,
        y: torch.Tensor,
        cfg_scale,
        block_stack: Optional[dict] = None,
    ) -> torch.Tensor:
        """Batched classifier-free guidance: the first half of x is the real
        batch, labels carry [cond; null]. Only the eps channels are guided;
        the sigma channels pass through."""
        c = self.cfg
        half = x[: x.shape[0] // 2]
        model_out = self(torch.cat([half, half], dim=0), t, y, block_stack=block_stack)
        eps, rest = model_out[:, : c.in_channels], model_out[:, c.in_channels :]
        cond_eps, uncond_eps = torch.chunk(eps, 2, dim=0)
        half_eps = uncond_eps + cfg_scale * (cond_eps - uncond_eps)
        eps = torch.cat([half_eps, half_eps], dim=0)
        return torch.cat([eps, rest], dim=1)


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
