"""DiT blocks: modulation, embedders, final layer, and the block-kernel policy.

Port of ``mapdit_tpu/models/blocks.py`` for every ``use_*`` flag set and the
three modulation kinds. Rotation modulation replaces the shift of adaLN by a
learned Givens rotation of channel pairs. The block kernels hard-code the
MP + adaln + cosine-attention arithmetic; any other family runs the generic
path of :class:`DiTBlock`, whatever ``block_kernel`` says, except the
tensor-parallel islands ``mega_attn_tp`` / ``mega_tp``, which refuse it.
"""

from __future__ import annotations

import functools
import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from mapdit_tpu_torch.models.config import DiTConfig
from mapdit_tpu_torch.models.layers import (
    MLP,
    Attention,
    MPEmbedding,
    MPLinear,
    MPLinearSplit,
    activation,
    activation_module,
)
from mapdit_tpu_torch.ops.mp import modulate, mp_sum, rotate_pairs


def mp_adaln_family(cfg: DiTConfig) -> bool:
    """The family whose MLP half ``fused_mlp_branch`` computes."""
    return (
        cfg.modulation == "adaln"
        and cfg.mp_style
        and cfg.use_mp_silu
        and cfg.use_mp_residual
        and cfg.use_weight_normalization
    )


def kernel_family_ok(cfg: DiTConfig) -> bool:
    """The family whose arithmetic the whole-block, whole-stack and
    attention half-block kernels hard-code."""
    return mp_adaln_family(cfg) and cfg.use_cosine_attention and cfg.hidden_size % cfg.num_heads == 0


# The float32 weights of a block up to which ``auto`` takes the whole-block
# kernels (bf16 has no budget). Their f32 forms run the products by FFMA, at
# about half f32 cuBLAS's rate: ahead of the plain path at DiT-S/2 (10.6 MB),
# behind it from DiT-B/2 (42.5 MB) up wherever the device sets the pace
# (tools/kernel_policy_sweep.py --dtype float32; PERF.md section 5).
F32_WEIGHT_BUDGET = 16 * 2**20


def whole_block_weight_bytes(cfg: DiTConfig) -> int:
    """A block's weights as the JAX policy counts them: 10 D^2 + 2 D H
    elements of the model's type."""
    d, hid = cfg.hidden_size, int(cfg.hidden_size * cfg.mlp_ratio)
    return (10 * d * d + 2 * d * hid) * (2 if cfg.dtype == torch.bfloat16 else 4)


def kernel_policy(cfg: DiTConfig, seq_len: int, device: torch.device) -> str:
    """The auto policy (the per-block dispatch, the stack promotion and the
    tensor-parallel resolver all derive from it): the whole-block kernels
    (``mega``) for folded-weight programs of the kernels' family
    (:func:`kernel_family_ok`) on a CUDA device at T <= 64, in bf16, or in
    float32 within :data:`F32_WEIGHT_BUDGET`; the plain path (``off``)
    otherwise. The JAX policy's conditions on the flag family, folding and
    T carry over; its VMEM weight budgets (7 MB / 11 MB, the TPU's) do not:
    on the H100 the whole-block kernels were the fastest path measured at
    DiT-S/2, B/2 and XL/2 in bf16, ahead of ``mega_attn`` and ``off``, and
    in float32 at S/2 only (PERF.md)."""
    if not kernel_family_ok(cfg):
        return "off"
    if not (cfg.fold_weights and seq_len <= 64 and torch.device(device).type == "cuda"):
        return "off"
    if cfg.dtype == torch.bfloat16:
        return "mega"
    if cfg.dtype == torch.float32 and whole_block_weight_bytes(cfg) <= F32_WEIGHT_BUDGET:
        return "mega"
    return "off"


def use_megakernel(cfg: DiTConfig, seq_len: int, device: torch.device) -> bool:
    """Whether a DiTBlock runs through ``fused_dit_block``. An explicit
    ``mega`` on another family takes the generic path."""
    if not kernel_family_ok(cfg):
        return False
    if cfg.block_kernel == "mega":
        return True
    return cfg.block_kernel == "auto" and kernel_policy(cfg, seq_len, device) == "mega"


def use_attn_halfkernel(cfg: DiTConfig) -> bool:
    """Whether a DiTBlock runs its attention half through
    ``fused_attn_branch`` (modulation head and MLP stay plain): an explicit
    ``mega_attn`` on the kernels' family. ``auto`` never resolves to it: on
    the H100 the whole-block kernels were faster at every size measured
    (:func:`kernel_policy`)."""
    return kernel_family_ok(cfg) and cfg.block_kernel == "mega_attn"


def use_fused_mlp(cfg: DiTConfig) -> bool:
    """Whether a DiTBlock on the generic path runs its MLP half through
    ``fused_mlp_branch``: ``block_kernel="pallas"`` on the MP + adaln
    family. (The JAX policy also asks for T % 8 == 0, a TPU tile shape; the
    Hopper kernel takes any T.)"""
    return mp_adaln_family(cfg) and cfg.block_kernel == "pallas"


def stack_auto_ok(cfg: DiTConfig, batch_hint: Optional[int], device: torch.device) -> bool:
    """Whether the sampling runtime promotes ``auto`` to ``mega_stack``: a
    batch hint is given, the blocks are in the per-block layout (a
    ``scan_blocks`` model runs its blocks one by one, as in the JAX
    package) and the per-block policy would take the kernels."""
    if batch_hint is None or cfg.scan_blocks:
        return False
    return kernel_policy(cfg, cfg.num_patches, device) == "mega"


def resolve_block_kernel_tp(cfg: DiTConfig, folded: bool, tp: int, device) -> str:
    """What ``block_kernel="auto"`` resolves to on a mesh whose model axis
    has ``tp`` ranks (``blocks.py:210-239`` of the JAX package, its TPU
    branch read as CUDA): ``off`` for tp < 2, heads that do not split
    evenly, or a single-device policy of ``off``; the whole-block island
    ``mega_tp`` when the MLP hidden width splits evenly too, the attention
    island ``mega_attn_tp`` otherwise. Off CUDA ``off``, as the JAX package
    resolves off-TPU. A float32 model follows :func:`kernel_policy` with no
    dtype condition, as JAX's resolver does: its islands run the f32
    instances of ``csrc/dit_block_tp.cu``. Timed turns of f32 DiT-S/2 on a
    (1, 2) mesh (two ranks sharing one card over gloo, which sets the pace)
    could not tell ``mega_tp`` from ``off`` (PERF.md). Explicit values pass
    through."""
    if cfg.block_kernel != "auto":
        return cfg.block_kernel
    if torch.device(device).type != "cuda" or tp < 2 or cfg.num_heads % tp:
        return "off"
    if kernel_policy(cfg.replace(fold_weights=folded), cfg.num_patches, device) == "off":
        return "off"
    return "mega_tp" if int(cfg.hidden_size * cfg.mlp_ratio) % tp == 0 else "mega_attn_tp"


def modulation_dims(cfg: DiTConfig, with_gate: bool) -> Tuple[int, ...]:
    """Output chunk sizes of one branch's modulation head: adaln (shift,
    scale[, gate]), rotation (theta[, gate]) with D/2 angles,
    rotation_scale (theta, scale[, gate])."""
    h = cfg.hidden_size
    base = {"adaln": (h, h), "rotation": (h // 2,), "rotation_scale": (h // 2, h)}[cfg.modulation]
    return base + ((h,) if with_gate else ())


def apply_modulation(x: torch.Tensor, mods: Tuple[torch.Tensor, ...], gain, cfg: DiTConfig) -> torch.Tensor:
    """Inject the conditioning into (N, T, D) activations. MP-style adaln is
    ``modulate`` = mp_sum(x*scale, shift, gain); vanilla adaln is
    ``x * (1 + scale) + shift``. The rotation kinds rotate channel pairs by
    ``gain * theta`` (the gain starts at 0: the identity at init)."""
    if cfg.modulation == "adaln":
        shift, scale = mods
        if cfg.mp_style:
            return modulate(x, shift, scale, gain)
        return x * (1.0 + scale[:, None, :]) + shift[:, None, :]
    if cfg.modulation == "rotation":
        (theta,) = mods
        return rotate_pairs(x, gain * theta)
    theta, scale = mods
    scale = scale if cfg.mp_style else 1.0 + scale
    return rotate_pairs(x * scale[:, None, :], gain * theta)


def layer_norm(z: torch.Tensor) -> torch.Tensor:
    """LayerNorm without affine parameters, eps 1e-6."""
    return F.layer_norm(z, z.shape[-1:], eps=1e-6)


class ModulationHead(nn.Sequential):
    """(MP-)SiLU then one linear whose output splits into modulation chunks
    (zero-initialised without the MP style: adaLN-Zero); a Sequential so the
    weight is named ``modulation.1.weight``."""

    def __init__(self, cfg: DiTConfig, dims: Tuple[int, ...]):
        super().__init__(
            activation_module(cfg), MPLinearSplit(cfg.hidden_size, dims, cfg, zero_init=not cfg.mp_style)
        )

    @property
    def linear(self) -> MPLinearSplit:
        return self[1]

    def forward(self, c: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        return self[1](self[0](c))


class DiTBlock(nn.Module):
    """Transformer block with modulated attention and MLP branches. MP
    path: learned scalar gains (init 0) drive the modulation mix, residuals
    are ``mp_sum(x, gate * branch, t=0.3)``. Vanilla path: LayerNorm
    without affine before each modulation, adaLN-Zero, plain residual add."""

    def __init__(self, cfg: DiTConfig):
        super().__init__()
        self.cfg = cfg
        d = cfg.hidden_size
        dims = modulation_dims(cfg, with_gate=True)
        self.branch_chunks = len(dims)
        self.modulation = ModulationHead(cfg, dims + dims)
        self.gain_msa = nn.Parameter(torch.zeros(()))
        self.gain_mlp = nn.Parameter(torch.zeros(()))
        self.attn = Attention(cfg, d)
        self.mlp = MLP(cfg, d, d)
        # the mesh of the tensor-parallel islands, set with this rank's weight
        # shards by DiT.load_tensor_parallel
        self.mesh = None

    def forward(self, x: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        block_kernel = self._block_kernel(x)
        if block_kernel is not None:
            dt = cfg.dtype
            return block_kernel(
                x.to(dt).contiguous(),
                activation(c, cfg).to(dt).contiguous(),
                torch.stack([self.gain_msa, self.gain_mlp]).float(),
                self.modulation.linear.effective_weight().to(dt),
                self.attn.qkv_proj.effective_weight().to(dt),
                self.attn.out_proj.effective_weight().to(dt),
                self.mlp.fc1.effective_weight().to(dt),
                self.mlp.fc2.effective_weight().to(dt),
            )
        mods = self.modulation(c)
        n = self.branch_chunks
        msa_mods, gate_msa = mods[: n - 1], mods[n - 1]
        mlp_mods, gate_mlp = mods[n : 2 * n - 1], mods[2 * n - 1]
        attn_kernel = self._attn_half_kernel()
        if attn_kernel is not None:
            dt = cfg.dtype
            shift_msa, scale_msa = msa_mods
            x = attn_kernel(
                x.to(dt).contiguous(),
                shift_msa.to(dt),
                scale_msa.to(dt),
                gate_msa.to(dt),
                self.gain_msa,
                self.attn.qkv_proj.effective_weight().to(dt).contiguous(),
                self.attn.out_proj.effective_weight().to(dt).contiguous(),
            )
            h = apply_modulation(x, mlp_mods, self.gain_mlp, cfg)
            return mp_sum(x, gate_mlp[:, None, :] * self.mlp(h), t=0.3)

        def maybe_norm(z):
            return z if cfg.use_no_layernorm else layer_norm(z)

        def residual(z, branch, gate):
            gated = gate[:, None, :] * branch
            return mp_sum(z, gated, t=0.3) if cfg.use_mp_residual else z + gated

        h = apply_modulation(maybe_norm(x), msa_mods, self.gain_msa, cfg)
        x = residual(x, self.attn(h), gate_msa)
        if use_fused_mlp(cfg):
            shift_mlp, scale_mlp = mlp_mods
            return self.mlp.fused_branch(x, shift_mlp, scale_mlp, gate_mlp, self.gain_mlp)
        h = apply_modulation(maybe_norm(x), mlp_mods, self.gain_mlp, cfg)
        return residual(x, self.mlp(h), gate_mlp)

    def _block_kernel(self, x: torch.Tensor):
        """The whole-block kernel this block runs, as a function of (x, a,
        gains, W_mod, W_qkv, W_out, W1, W2): ``fused_dit_block``, or the TP
        island ``fused_dit_block_tp`` on this rank's shards; None for the
        paths that run the modulation head in PyTorch."""
        cfg = self.cfg
        if cfg.block_kernel == "mega_tp":
            from mapdit_tpu_torch.ops.cuda.dit_block_tp import fused_dit_block_tp

            heads_local, group = self._tp_layout()
            return functools.partial(fused_dit_block_tp, heads_local=heads_local,
                                     hidden_total=int(cfg.hidden_size * cfg.mlp_ratio), group=group)
        if use_megakernel(cfg, x.shape[1], x.device):
            from mapdit_tpu_torch.ops.cuda.dit_block import fused_dit_block

            return functools.partial(fused_dit_block, heads=cfg.num_heads)
        return None

    def _attn_half_kernel(self):
        """The attention half-block kernel this block runs, as a function of
        (x, shift, scale, gate, gain, W_qkv, W_out) that returns the stream
        after the gated residual: ``fused_attn_branch``, or the TP island
        ``fused_attn_branch_tp`` on this rank's heads (its modulation head
        and MLP then run replicated in plain PyTorch on full weights; GSPMD's
        split of them in the JAX package gives the same result); None for
        the generic path."""
        cfg = self.cfg
        if cfg.block_kernel == "mega_attn_tp":
            from mapdit_tpu_torch.ops.cuda.dit_block_tp import fused_attn_branch_tp

            heads_local, group = self._tp_layout()
            return functools.partial(fused_attn_branch_tp, heads_local=heads_local, group=group)
        if use_attn_halfkernel(cfg):
            from mapdit_tpu_torch.ops.cuda.attn_branch import fused_attn_branch

            return functools.partial(fused_attn_branch, heads=cfg.num_heads, bwd=cfg.attn_bwd)
        return None

    def _tp_layout(self) -> Tuple[int, object]:
        """(heads per rank, model group) of the TP islands
        (``blocks.py:348-483`` of the JAX package), after their checks."""
        cfg, mesh = self.cfg, self.mesh
        if not kernel_family_ok(cfg):
            raise ValueError(f"{cfg.block_kernel} hard-codes the MP + adaln + cosine-attention family")
        if not cfg.fold_weights:
            raise ValueError(f"{cfg.block_kernel} takes folded weights, sharded after folding")
        if mesh is None:
            raise RuntimeError(
                f"block_kernel={cfg.block_kernel!r} needs a mesh: build_sample_fn(mesh=) loads the shards"
            )
        if cfg.num_heads % mesh.n_model:
            raise ValueError(f"{cfg.num_heads} heads do not split over {mesh.n_model} model ranks")
        return cfg.num_heads // mesh.n_model, mesh.model_group


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


def sinusoidal_embedding(t: torch.Tensor, dim: int, max_period: float = 10000.0) -> torch.Tensor:
    """Vanilla DiT's deterministic timestep features (cos | sin halves)."""
    half = dim // 2
    freqs = torch.exp(-math.log(max_period) * torch.arange(half, dtype=torch.float32, device=t.device) / half)
    args = t.float()[:, None] * freqs[None]
    return torch.cat([torch.cos(args), torch.sin(args)], dim=-1)


class TimestepEmbedder(nn.Module):
    """Timestep -> conditioning vector: random Fourier features under
    ``use_mp_embedding``, sinusoidal features otherwise, then an MLP. Raw
    float timesteps (0..999) enter with no rescaling."""

    def __init__(self, cfg: DiTConfig, frequency_embedding_size: int = 256):
        super().__init__()
        self.frequency_embedding_size = frequency_embedding_size
        if cfg.use_mp_embedding:
            self.embedding = MPFourier(frequency_embedding_size)
        self.mlp = MLP(cfg, frequency_embedding_size, cfg.hidden_size, hidden_dim=cfg.hidden_size)

    def forward(self, t: torch.Tensor) -> torch.Tensor:
        if hasattr(self, "embedding"):
            return self.mlp(self.embedding(t))
        return self.mlp(sinusoidal_embedding(t, self.frequency_embedding_size))


class LabelEmbedder(nn.Module):
    """Class label -> conditioning vector; the null (unconditional) class is
    row ``num_classes``. ``force_drop_ids == 1`` swaps a label for it; in
    training each label is dropped with ``class_dropout_prob``, drawn from
    ``generator``."""

    def __init__(self, cfg: DiTConfig):
        super().__init__()
        self.cfg = cfg
        self.embedding = MPEmbedding(
            cfg.num_classes + int(cfg.class_dropout_prob > 0), cfg.hidden_size, cfg, use_wn=cfg.use_mp_embedding
        )

    def forward(
        self,
        labels: torch.Tensor,
        force_drop_ids: Optional[torch.Tensor] = None,
        train: bool = False,
        generator: Optional[torch.Generator] = None,
    ) -> torch.Tensor:
        cfg = self.cfg
        if force_drop_ids is not None:
            labels = torch.where(force_drop_ids == 1, cfg.num_classes, labels)
        elif train and cfg.class_dropout_prob > 0:
            drop = torch.rand(labels.shape, generator=generator, device=labels.device) < cfg.class_dropout_prob
            labels = torch.where(drop, cfg.num_classes, labels)
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
    """Output head. MP path: own modulation with a learned gain, fused
    mean/sigma head, and a per-sample MPScale on each output. Vanilla path
    (``use_no_layernorm`` off): LayerNorm, modulation, a zero-initialised
    head and no output scaling."""

    def __init__(self, cfg: DiTConfig):
        super().__init__()
        self.cfg = cfg
        d = cfg.hidden_size
        out_dim = cfg.patch_size * cfg.patch_size * cfg.out_channels
        self.modulation = ModulationHead(cfg, modulation_dims(cfg, with_gate=False))
        self.gain_mod = nn.Parameter(torch.zeros(()))
        self.linear = MPLinearSplit(d, (out_dim,) * (2 if cfg.learn_sigma else 1), cfg, zero_init=not cfg.mp_style)
        if cfg.mp_style:
            self.mean_scale = MPScale(cfg, zero_init=False)
            if cfg.learn_sigma:
                self.sigma_scale = MPScale(cfg, zero_init=True)

    def forward(self, x: torch.Tensor, c: torch.Tensor):
        cfg = self.cfg
        if not cfg.use_no_layernorm:
            x = layer_norm(x)
        heads = self.linear(apply_modulation(x, self.modulation(c), self.gain_mod, cfg))
        if not cfg.mp_style:
            return heads if cfg.learn_sigma else heads[0]
        mean = heads[0] * self.mean_scale(c)[:, None, None]
        if not self.cfg.learn_sigma:
            return mean
        return mean, heads[1] * self.sigma_scale(c)[:, None, None]
