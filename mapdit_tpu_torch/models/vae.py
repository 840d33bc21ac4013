"""The Stable-Diffusion AutoencoderKL (SD-VAE), port of
``mapdit_tpu/models/vae.py``, as a plain PyTorch module.

Encoder: four down blocks (128, 256, 512, 512 channels) of two resnets, a
stride-2 downsample after each but the last with diffusers' asymmetric
(0, 1, 0, 1) pad, a mid block (resnet, single-head attention, resnet).
Decoder mirrored with three resnets a block and nearest x2 upsampling.
GroupNorm(32, eps 1e-6) and SiLU throughout. The JAX package computes it
with flax convolutions and an einsum attention outside any Pallas kernel,
so the port is ``F.conv2d``, ``F.group_norm``, matmul and softmax.

Parameters carry diffusers' own key names, so a diffusers checkpoint loads
with ``load_state_dict``; the legacy attention names
(``query/key/value/proj_attn``) are renamed on load, and a key the model
does not have raises ``KeyError``. ``encode`` returns the posterior
(mean, std) with logvar clamped to [-30, 20] and no 0.18215 factor.
"""

from __future__ import annotations

import os
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from mapdit_tpu_torch.utils.device import resolve_device

BLOCK_CHANNELS = (128, 256, 512, 512)
LATENT_CHANNELS = 4
NORM_GROUPS = 32
LEGACY_ATTENTION = {"query": "to_q", "key": "to_k", "value": "to_v", "proj_attn": "to_out.0"}


def _norm(channels: int) -> nn.GroupNorm:
    return nn.GroupNorm(NORM_GROUPS, channels, eps=1e-6)


class ResnetBlock(nn.Module):
    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        self.norm1 = _norm(in_channels)
        self.conv1 = nn.Conv2d(in_channels, out_channels, 3, padding=1)
        self.norm2 = _norm(out_channels)
        self.conv2 = nn.Conv2d(out_channels, out_channels, 3, padding=1)
        self.conv_shortcut = nn.Conv2d(in_channels, out_channels, 1) if in_channels != out_channels else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.conv1(F.silu(self.norm1(x)))
        h = self.conv2(F.silu(self.norm2(h)))
        if self.conv_shortcut is not None:
            x = self.conv_shortcut(x)
        return x + h


class AttentionBlock(nn.Module):
    """Single-head self-attention over the spatial positions."""

    def __init__(self, channels: int):
        super().__init__()
        self.group_norm = _norm(channels)
        self.to_q = nn.Linear(channels, channels)
        self.to_k = nn.Linear(channels, channels)
        self.to_v = nn.Linear(channels, channels)
        self.to_out = nn.ModuleList([nn.Linear(channels, channels)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, c, h, w = x.shape
        y = self.group_norm(x).reshape(b, c, h * w).transpose(1, 2)
        q, k, v = self.to_q(y), self.to_k(y), self.to_v(y)
        attn = torch.softmax(q @ k.transpose(1, 2) / float(np.sqrt(c)), dim=-1)
        y = self.to_out[0](attn @ v)
        return x + y.transpose(1, 2).reshape(b, c, h, w)


class MidBlock(nn.Module):
    def __init__(self, channels: int):
        super().__init__()
        self.resnets = nn.ModuleList([ResnetBlock(channels, channels), ResnetBlock(channels, channels)])
        self.attentions = nn.ModuleList([AttentionBlock(channels)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.resnets[1](self.attentions[0](self.resnets[0](x)))


class Sampler(nn.Module):
    """A diffusers down- or upsampler: the key ``...samplers.0.conv``."""

    def __init__(self, channels: int, down: bool):
        super().__init__()
        self.down = down
        self.conv = nn.Conv2d(channels, channels, 3, stride=2 if down else 1, padding=0 if down else 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.down:
            return self.conv(F.pad(x, (0, 1, 0, 1)))
        return self.conv(F.interpolate(x, scale_factor=2.0, mode="nearest"))


class Block(nn.Module):
    def __init__(self, in_channels: int, out_channels: int, n_resnets: int, sampler: Optional[str]):
        super().__init__()
        self.resnets = nn.ModuleList(
            ResnetBlock(in_channels if j == 0 else out_channels, out_channels) for j in range(n_resnets)
        )
        if sampler == "down":
            self.downsamplers = nn.ModuleList([Sampler(out_channels, down=True)])
        elif sampler == "up":
            self.upsamplers = nn.ModuleList([Sampler(out_channels, down=False)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for resnet in self.resnets:
            x = resnet(x)
        for sampler in getattr(self, "downsamplers", ()) or getattr(self, "upsamplers", ()):
            x = sampler(x)
        return x


class Encoder(nn.Module):
    def __init__(self):
        super().__init__()
        ch = BLOCK_CHANNELS
        self.conv_in = nn.Conv2d(3, ch[0], 3, padding=1)
        last = len(ch) - 1
        self.down_blocks = nn.ModuleList(
            Block(ch[max(i - 1, 0)], c, 2, "down" if i < last else None) for i, c in enumerate(ch)
        )
        self.mid_block = MidBlock(ch[-1])
        self.conv_norm_out = _norm(ch[-1])
        self.conv_out = nn.Conv2d(ch[-1], 2 * LATENT_CHANNELS, 3, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.conv_in(x)
        for block in self.down_blocks:
            x = block(x)
        x = self.mid_block(x)
        return self.conv_out(F.silu(self.conv_norm_out(x)))


class Decoder(nn.Module):
    def __init__(self):
        super().__init__()
        rev = tuple(reversed(BLOCK_CHANNELS))  # (512, 512, 256, 128)
        self.conv_in = nn.Conv2d(LATENT_CHANNELS, rev[0], 3, padding=1)
        self.mid_block = MidBlock(rev[0])
        last = len(rev) - 1
        self.up_blocks = nn.ModuleList(
            Block(rev[max(i - 1, 0)], c, 3, "up" if i < last else None) for i, c in enumerate(rev)
        )
        self.conv_norm_out = _norm(rev[-1])
        self.conv_out = nn.Conv2d(rev[-1], 3, 3, padding=1)

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        x = self.mid_block(self.conv_in(z))
        for block in self.up_blocks:
            x = block(x)
        return self.conv_out(F.silu(self.conv_norm_out(x)))


class AutoencoderKL(nn.Module):
    """The whole VAE on NCHW tensors."""

    def __init__(self):
        super().__init__()
        self.encoder = Encoder()
        self.decoder = Decoder()
        self.quant_conv = nn.Conv2d(2 * LATENT_CHANNELS, 2 * LATENT_CHANNELS, 1)
        self.post_quant_conv = nn.Conv2d(LATENT_CHANNELS, LATENT_CHANNELS, 1)

    def encode(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """(N, 3, H, W) in [-1, 1] -> posterior (mean, std), each
        (N, 4, H/8, W/8)."""
        mean, logvar = torch.chunk(self.quant_conv(self.encoder(x)), 2, dim=1)
        return mean, torch.exp(0.5 * logvar.clamp(-30.0, 20.0))

    def decode(self, z: torch.Tensor) -> torch.Tensor:
        """(N, 4, h, w) latents -> (N, 3, 8h, 8w) image in about [-1, 1]."""
        return self.decoder(self.post_quant_conv(z))

    def forward(self, x: torch.Tensor, mode: str = "decode"):
        return self.encode(x) if mode == "encode" else self.decode(x)


def init_vae(seed: int = 0) -> AutoencoderKL:
    """A VAE with PyTorch's default init drawn under ``seed`` (the global
    generator's state is restored after), on the CPU: random weights in
    diffusers' layout, for runs without the real ones."""
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        return AutoencoderKL()


def diffusers_key(key: str) -> str:
    """A diffusers state-dict key under this module's names: the legacy
    attention names become ``to_q/to_k/to_v/to_out.0``."""
    parts = key.split(".")
    if len(parts) >= 3 and parts[-3] == "0" and parts[-2] in LEGACY_ATTENTION:
        parts[-2] = LEGACY_ATTENTION[parts[-2]]
    return ".".join(parts)


def load_state_dict(model: AutoencoderKL, state_dict) -> AutoencoderKL:
    """Load diffusers weights (numpy arrays or tensors) into ``model``. A key
    the model does not have raises ``KeyError`` naming it, as does a
    parameter the file lacks: a half-loaded VAE decodes garbage."""
    own = model.state_dict()
    sd = {
        diffusers_key(k): v.float() if isinstance(v, torch.Tensor) else torch.from_numpy(np.array(v, np.float32))
        for k, v in state_dict.items()
    }
    for what, keys in (("unmapped diffusers VAE keys (naming drift?)", set(sd) - set(own)),
                       ("VAE parameters missing from the checkpoint", set(own) - set(sd))):
        if keys:
            raise KeyError(f"{what}: {sorted(keys)[:8]}{' ...' if len(keys) > 8 else ''}")
    model.load_state_dict(sd)
    return model


def read_weights(path: str) -> Dict:
    """A checkpoint's arrays: ``.safetensors`` through the port's own
    reader, anything else through ``torch.load``."""
    if path.endswith(".safetensors"):
        from mapdit_tpu_torch.utils.safetensors import load_file

        return load_file(path)
    return torch.load(path, map_location="cpu", weights_only=True)


def load_vae(vae_path: Optional[str], device=None) -> Optional[AutoencoderKL]:
    """The VAE with the weights at ``vae_path`` on ``device`` (default
    CUDA), or None when the path is not given or does not exist."""
    if not vae_path or not os.path.exists(vae_path):
        return None
    device = resolve_device(device)
    return load_state_dict(AutoencoderKL(), read_weights(vae_path)).to(device).eval()


def load_decoder(vae_path: Optional[str], device=None):
    """``decode(z)``, latents -> images, from local weights, or None when
    they are missing (the caller warns and writes raw latents)."""
    model = load_vae(vae_path, device)
    return None if model is None else torch.no_grad()(model.decode)


def load_encoder(vae_path: Optional[str], device=None):
    """``encode(x)`` -> (mean, std), or None when the weights are missing."""
    model = load_vae(vae_path, device)
    return None if model is None else torch.no_grad()(model.encode)
