"""DiT blocks: modulation, embedders, final layer, and the block-kernel policy.

Port of ``mapdit_tpu/models/blocks.py`` for the default MaP family (MP
adaln modulation, fixed t=0.3 MP residuals, learned scalar gains).
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
from torch import nn

from mapdit_tpu_torch.models.config import DiTConfig
from mapdit_tpu_torch.models.layers import MLP, Attention, MPEmbedding, MPLinear, MPLinearSplit, MPSiLU
from mapdit_tpu_torch.ops.mp import modulate, mp_silu, mp_sum


def kernel_policy(cfg: DiTConfig, seq_len: int, device: torch.device) -> str:
    """What ``block_kernel="auto"`` resolves to: the whole-block kernels
    (``mega``) for folded-weight bf16 programs on a CUDA device at T <= 64,
    the plain path (``off``) otherwise. The JAX policy's conditions on the
    flag family, folding and T carry over; its VMEM weight budgets do not.
    Float32 stays on the plain path: the kernels take bf16 operands."""
    if cfg.fold_weights and seq_len <= 64 and cfg.dtype == torch.bfloat16 and torch.device(device).type == "cuda":
        return "mega"
    return "off"


def use_megakernel(cfg: DiTConfig, seq_len: int, device: torch.device) -> bool:
    """Whether a DiTBlock runs through ``fused_dit_block``."""
    if cfg.block_kernel == "mega":
        return True
    return cfg.block_kernel == "auto" and kernel_policy(cfg, seq_len, device) == "mega"


def stack_auto_ok(cfg: DiTConfig, batch_hint: Optional[int], device: torch.device) -> bool:
    """Whether the sampling runtime promotes ``auto`` to ``mega_stack``: a
    batch hint is given and the per-block policy would take the kernels."""
    if batch_hint is None:
        return False
    return kernel_policy(cfg, cfg.num_patches, device) == "mega"


class ModulationHead(nn.Sequential):
    """MP-SiLU then one linear whose output splits into modulation chunks;
    a Sequential so the weight is named ``modulation.1.weight``."""

    def __init__(self, cfg: DiTConfig, dims: Tuple[int, ...]):
        super().__init__(MPSiLU(), MPLinearSplit(cfg.hidden_size, dims, cfg))

    @property
    def linear(self) -> MPLinearSplit:
        return self[1]

    def forward(self, c: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        return self[1](self[0](c))


class DiTBlock(nn.Module):
    """Transformer block with modulated attention and MLP branches and gated
    MP residuals ``mp_sum(x, gate * branch, t=0.3)``."""

    def __init__(self, cfg: DiTConfig):
        super().__init__()
        self.cfg = cfg
        d = cfg.hidden_size
        self.modulation = ModulationHead(cfg, (d,) * 6)
        self.gain_msa = nn.Parameter(torch.zeros(()))
        self.gain_mlp = nn.Parameter(torch.zeros(()))
        self.attn = Attention(cfg, d)
        self.mlp = MLP(cfg, d, d)

    def forward(self, x: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        if use_megakernel(cfg, x.shape[1], x.device):
            from mapdit_tpu_torch.ops.cuda.dit_block import fused_dit_block

            dt = cfg.dtype
            return fused_dit_block(
                x.to(dt).contiguous(),
                mp_silu(c).to(dt).contiguous(),
                torch.stack([self.gain_msa, self.gain_mlp]).float(),
                self.modulation.linear.effective_weight().to(dt),
                self.attn.qkv_proj.effective_weight().to(dt),
                self.attn.out_proj.effective_weight().to(dt),
                self.mlp.fc1.effective_weight().to(dt),
                self.mlp.fc2.effective_weight().to(dt),
                cfg.num_heads,
            )
        shift_msa, scale_msa, gate_msa, shift_mlp, scale_mlp, gate_mlp = self.modulation(c)
        h = modulate(x, shift_msa, scale_msa, self.gain_msa)
        x = mp_sum(x, gate_msa[:, None, :] * self.attn(h), t=0.3)
        h = modulate(x, shift_mlp, scale_mlp, self.gain_mlp)
        return mp_sum(x, gate_mlp[:, None, :] * self.mlp(h), t=0.3)


class MPFourier(nn.Module):
    """Random Fourier features; scale = 2*pi*N(0,1) and shift = 2*pi*U(0,1)
    are buffers, not parameters."""

    def __init__(self, num_channels: int):
        super().__init__()
        self.register_buffer("scale", torch.empty(num_channels))
        self.register_buffer("shift", torch.empty(num_channels))

    def reset_parameters(self, generator: torch.Generator) -> None:
        with torch.no_grad():
            self.scale.normal_(0.0, 1.0, generator=generator).mul_(2.0 * math.pi)
            self.shift.uniform_(0.0, 1.0, generator=generator).mul_(2.0 * math.pi)

    def forward(self, t: torch.Tensor) -> torch.Tensor:
        return math.sqrt(2.0) * torch.cos(torch.outer(t.float(), self.scale) + self.shift)


class TimestepEmbedder(nn.Module):
    """Timestep -> conditioning vector. Raw float timesteps (0..999) enter
    with no rescaling."""

    def __init__(self, cfg: DiTConfig, frequency_embedding_size: int = 256):
        super().__init__()
        self.embedding = MPFourier(frequency_embedding_size)
        self.mlp = MLP(cfg, frequency_embedding_size, cfg.hidden_size, hidden_dim=cfg.hidden_size)

    def forward(self, t: torch.Tensor) -> torch.Tensor:
        return self.mlp(self.embedding(t))


class LabelEmbedder(nn.Module):
    """Class label -> conditioning vector; the null (unconditional) class is
    row ``num_classes``. ``force_drop_ids == 1`` swaps a label for it."""

    def __init__(self, cfg: DiTConfig):
        super().__init__()
        self.cfg = cfg
        self.embedding = MPEmbedding(cfg.num_classes + int(cfg.class_dropout_prob > 0), cfg.hidden_size, cfg)

    def forward(self, labels: torch.Tensor, force_drop_ids: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Random label dropout belongs to training (ROADMAP A.6)."""
        if force_drop_ids is not None:
            labels = torch.where(force_drop_ids == 1, self.cfg.num_classes, labels)
        return self.embedding(labels)


class MPScale(nn.Module):
    """Per-sample output scale ``sigmoid(<MPLinear(c), reference> / sqrt(8))``."""

    def __init__(self, cfg: DiTConfig, zero_init: bool, angle_dim: int = 8):
        super().__init__()
        self.zero_init, self.angle_dim = zero_init, angle_dim
        self.linear = MPLinear(cfg.hidden_size, angle_dim, cfg)
        self.reference = nn.Parameter(torch.empty(angle_dim))

    def reset_parameters(self, generator: torch.Generator) -> None:
        with torch.no_grad():
            self.reference.fill_(0.0 if self.zero_init else 1.0)

    def forward(self, c: torch.Tensor) -> torch.Tensor:
        proj = self.linear(c)
        return torch.sigmoid((proj @ self.reference.to(proj.dtype)) / math.sqrt(self.angle_dim))


class FinalLayer(nn.Module):
    """Output head: own modulation with a learned gain, fused mean/sigma
    head, and a per-sample MPScale on each output."""

    def __init__(self, cfg: DiTConfig):
        super().__init__()
        self.cfg = cfg
        d = cfg.hidden_size
        out_dim = cfg.patch_size * cfg.patch_size * cfg.out_channels
        self.modulation = ModulationHead(cfg, (d, d))
        self.gain_mod = nn.Parameter(torch.zeros(()))
        self.linear = MPLinearSplit(d, (out_dim,) * (2 if cfg.learn_sigma else 1), cfg)
        self.mean_scale = MPScale(cfg, zero_init=False)
        if cfg.learn_sigma:
            self.sigma_scale = MPScale(cfg, zero_init=True)

    def forward(self, x: torch.Tensor, c: torch.Tensor):
        shift, scale = self.modulation(c)
        heads = self.linear(modulate(x, shift, scale, self.gain_mod))
        mean = heads[0] * self.mean_scale(c)[:, None, None]
        if not self.cfg.learn_sigma:
            return mean
        return mean, heads[1] * self.sigma_scale(c)[:, None, None]
