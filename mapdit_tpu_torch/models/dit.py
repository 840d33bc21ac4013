"""The DiT model, port of ``mapdit_tpu/models/dit.py`` (forward with train-time
label dropout, ``forward_with_cfg``, the whole-stack kernel path, the
block-span cache protocol, ``remat``, the ``scan_blocks`` layout and its
converters, and ``project_weights``)."""

from __future__ import annotations

import functools
import re
from typing import Callable, Dict, List, Optional

import torch
from torch import nn
from torch.func import functional_call
from torch.utils.checkpoint import checkpoint

from mapdit_tpu_torch.models.blocks import DiTBlock, FinalLayer, LabelEmbedder, TimestepEmbedder, kernel_family_ok
from mapdit_tpu_torch.models.config import TP_KERNELS, DiTConfig
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


def stacked_block(cfg: DiTConfig) -> DiTBlock:
    """The ``scan_blocks`` layout of the blocks: one :class:`DiTBlock` whose
    every parameter carries a leading ``(depth,)`` axis, so the state-dict
    names are the reference's without the block index
    (``blocks.attn.qkv_proj.weight`` of shape (depth, 3D, D)). Its values
    are set by :meth:`DiT.reset_parameters` or a state dict."""
    block = DiTBlock(cfg)
    for module in block.modules():
        for name, param in list(module.named_parameters(recurse=False)):
            setattr(module, name, nn.Parameter(param.new_empty((cfg.depth, *param.shape))))
    return block


def _call_at_depth(block: DiTBlock, params: Dict[str, torch.Tensor], x: torch.Tensor, c: torch.Tensor):
    return functional_call(block, params, (x, c))


class DiT(nn.Module):
    """Diffusion Transformer with the magnitude-preserving variants the
    ``use_*`` flags and ``modulation`` select.

    ``forward(x, t, y)`` with x (N, C, H, W), t (N,) float timesteps and
    y (N,) int labels returns (N, 2C, H, W) f32 (learn_sigma) or (N, C, H, W).
    Parameter names are the reference's state-dict names; under
    ``scan_blocks`` the blocks' are stacked (:func:`stacked_block`).
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
        self.blocks = stacked_block(cfg) if cfg.scan_blocks else nn.ModuleList(DiTBlock(cfg) for _ in range(cfg.depth))
        self.final_layer = FinalLayer(cfg)
        self.register_buffer("pos_embed", pos_embed_buffer(cfg))

    def reset_parameters(self, generator: torch.Generator) -> None:
        """Draw every parameter and Fourier buffer from ``generator`` (gains
        start at 0, as in the reference). Under ``scan_blocks`` depth
        per-block draws, in the order of the per-block layout, fill the
        stacked parameters: one seed gives the same weights in both
        layouts. (The JAX package's ``nn.scan`` splits its keys, so its
        two layouts differ.)"""

        def reset(root: nn.Module) -> None:
            for module in root.modules():
                if hasattr(module, "reset_parameters"):
                    module.reset_parameters(generator)

        for name, child in self.named_children():
            if name != "blocks" or not self.cfg.scan_blocks:
                reset(child)
                continue
            block, stacked = DiTBlock(self.cfg), dict(child.named_parameters())
            with torch.no_grad():
                for i in range(self.cfg.depth):
                    reset(block)
                    for key, param in block.named_parameters():
                        stacked[key][i].copy_(param)

    def _block_calls(self) -> List[Callable]:
        """The depth block calls ``fn(x, c)`` in order: the blocks, or under
        ``scan_blocks`` the stacked block called on views of each depth's
        parameters (``torch.func.functional_call``; the views are
        contiguous, so the kernels take them as they are). Under ``remat``
        with gradients enabled each call runs under
        ``torch.utils.checkpoint``: the backward recomputes the block from
        its inputs instead of keeping its activations (``nn.remat`` of the
        JAX package). The block paths draw no random numbers."""
        if self.cfg.scan_blocks:
            names, stacked = zip(*self.blocks.named_parameters())
            calls = [
                functools.partial(_call_at_depth, self.blocks, dict(zip(names, views)))
                for views in zip(*(p.unbind(0) for p in stacked))
            ]
        else:
            calls = list(self.blocks)
        if self.cfg.remat and torch.is_grad_enabled():
            calls = [functools.partial(checkpoint, call, use_reentrant=False) for call in calls]
        return calls

    def load_tensor_parallel(self, state_dict, mesh) -> None:
        """Load one rank's ``parallel.shard_state_dict``: each tensor split
        over the model axis replaces its full-size parameter (so the rank
        holds only its shard; it keeps the full-size one's
        ``requires_grad``). Under a TP island (``mega_attn_tp``,
        ``mega_tp``; folded weights) every block runs its island over
        ``mesh``; otherwise the blocks run the plain path
        (``block_kernel="off"``) on the plain layout, raw or folded: each
        split attention or MLP half sums its row-parallel partials over the
        mesh's model group (``layers.MPLinear.row_parallel``), under
        autograd too. Under ``scan_blocks`` the stacked block takes the
        group and its (depth, out, in) stacks are split one axis later;
        ``_call_at_depth`` views them a depth at a time."""
        from mapdit_tpu_torch.parallel.mesh import plain_tp_splits

        plain = self.cfg.block_kernel not in TP_KERNELS
        if plain and self.cfg.block_kernel != "off":
            raise ValueError(
                f"block_kernel={self.cfg.block_kernel!r} is a single-device kernel; the plain path's tensor-parallel "
                "layout runs block_kernel 'off'"
            )
        for name, value in state_dict.items():
            module_name, _, attr = name.rpartition(".")
            module = self.get_submodule(module_name)
            param = getattr(module, attr)
            if isinstance(param, nn.Parameter) and param.shape != value.shape:
                setattr(module, attr, nn.Parameter(param.new_empty(value.shape), requires_grad=param.requires_grad))
        self.load_state_dict(state_dict)
        attn_split, mlp_split = plain_tp_splits(self.cfg, mesh.n_model)
        for block in [self.blocks] if self.cfg.scan_blocks else self.blocks:
            block.mesh = mesh
            if plain:
                block.attn.tp_group = mesh.model_group if attn_split else None
                block.mlp.tp_group = mesh.model_group if mlp_split else None

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
            if cfg.scan_blocks:
                raise ValueError("block-span caching needs scan_blocks=False")
            lo, hi = span
            if not 0 <= lo <= hi <= cfg.depth:
                raise ValueError(f"span {span} is not inside the depth {cfg.depth}")
            blocks = self._block_calls()
            for block in blocks[:lo]:
                x = block(x, c)
            if cached_delta is not None:
                x, delta = x + cached_delta, cached_delta
            else:
                x_before = x
                for block in blocks[lo:hi]:
                    x = block(x, c)
                delta = x - x_before
            for block in blocks[hi:]:
                x = block(x, c)
        else:
            for block in self._block_calls():
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
    class embedding table follows ``use_mp_embedding``, the other ``weight``
    matrices (2-D, or 3-D stacked under ``scan_blocks``: each row of each
    depth) ``use_weight_normalization``; both need
    ``use_forced_weight_normalization``. In place where the JAX package
    returns a new tree."""
    for name, param in model.named_parameters():
        if forced_wn(name, param, cfg):
            param.copy_(normalize(param))


def forced_wn(name: str, param: torch.Tensor, cfg: DiTConfig) -> bool:
    """Whether :func:`project_weights` row-normalizes the parameter ``name``."""
    names = name.split(".")
    if names[-1] != "weight" or param.ndim not in (2, 3):
        return False
    is_embedding = len(names) >= 2 and names[-2] == "embedding"
    flag = cfg.use_mp_embedding if is_embedding else cfg.use_weight_normalization
    return flag and cfg.use_forced_weight_normalization


def init_model(cfg: DiTConfig, seed: int = 0, device=None) -> DiT:
    """A DiT with weights drawn from ``seed`` (on the CPU, so the draw does
    not depend on the device), moved to ``device`` (default CUDA)."""
    device = resolve_device(device)
    model = DiT(cfg)
    model.reset_parameters(torch.Generator().manual_seed(seed))
    return model.to(device).eval()


_BLOCK_KEY = re.compile(r"^blocks\.(\d+)\.(.+)$")


def stack_block_params(state_dict: Dict[str, torch.Tensor], depth: int) -> Dict[str, torch.Tensor]:
    """A per-block state dict (``blocks.{i}.<name>``) in the ``scan_blocks``
    layout: one ``blocks.<name>`` entry with a leading (depth,) axis, in the
    place of block 0's. Works on any tree keyed by parameter names (Adam
    moments, EMA copies)."""
    out = {}
    for key, value in state_dict.items():
        m = _BLOCK_KEY.match(key)
        if m is None:
            out[key] = value
        elif m.group(1) == "0":
            out[f"blocks.{m.group(2)}"] = torch.stack([state_dict[f"blocks.{i}.{m.group(2)}"] for i in range(depth)])
    return out


def unstack_block_params(state_dict: Dict[str, torch.Tensor], depth: int) -> Dict[str, torch.Tensor]:
    """The inverse of :func:`stack_block_params`: each depth's slice as its
    own tensor (a copy, so that saving one does not write the stack)."""
    stacked = [key for key in state_dict if key.startswith("blocks.")]
    out = {}
    for key, value in state_dict.items():
        if not key.startswith("blocks."):
            out[key] = value
        elif key == stacked[0]:
            for i in range(depth):
                for name in stacked:
                    out[f"blocks.{i}.{name[len('blocks.'):]}"] = state_dict[name][i].clone()
    return out
