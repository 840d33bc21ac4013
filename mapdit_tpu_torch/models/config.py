"""Model configuration, port of ``mapdit_tpu/models/config.py``.

Every field of the JAX ``DiTConfig`` is here. The port so far implements the
default MaP family (all ``use_*`` flags on, ``modulation="adaln"``), the
``auto``/``xla`` attention path, the ``auto``, ``mega``, ``mega_attn``,
``mega_stack`` and ``off`` block kernels and every ``attn_bwd``; any other
value raises ``NotImplementedError`` naming the ROADMAP item that ports it.
"""

from __future__ import annotations

import dataclasses

import torch

MODULATION_KINDS = ("adaln", "rotation", "rotation_scale")
BLOCK_KERNELS = ("auto", "mega", "mega_attn", "mega_stack", "off")
# block_kernel values of the JAX package the port has not reached yet
_UNPORTED_BLOCK_KERNELS = {
    "pallas": "ROADMAP B.8 (MLP half-block kernel)",
    "mega_attn_tp": "ROADMAP B.10 (head-sharded attention kernel)",
    "mega_tp": "ROADMAP B.11 (full-block tensor-parallel kernels)",
}


@dataclasses.dataclass(frozen=True)
class DiTConfig:
    depth: int
    hidden_size: int
    patch_size: int
    num_heads: int
    input_size: int = 32
    in_channels: int = 3
    mlp_ratio: float = 4.0
    class_dropout_prob: float = 0.1
    num_classes: int = 1000
    learn_sigma: bool = True

    use_cosine_attention: bool = True
    use_weight_normalization: bool = True
    use_forced_weight_normalization: bool = True
    use_mp_residual: bool = True
    use_mp_silu: bool = True
    use_no_layernorm: bool = True
    use_mp_pos_enc: bool = True
    use_mp_embedding: bool = True

    modulation: str = "adaln"

    compute_dtype: str = "float32"  # "float32" | "bfloat16"
    attention_impl: str = "auto"  # "auto" | "xla"
    # "mega": each block through fused_dit_block (ops/cuda/dit_block.py);
    # "mega_stack": the whole stack through fused_dit_stack inside the
    # sampling runtime (elsewhere it runs the plain path, as in the JAX
    # package); "mega_attn": the attention half of each block through
    # fused_attn_branch (ops/cuda/attn_branch.py), the MLP half plain;
    # "auto": the policy in models/blocks.py; "off": plain torch.
    block_kernel: str = "off"
    # VJP of fused_attn_branch under mega_attn: "pallas" (fused backward
    # kernels), "residual" (residual-emitting forward, plain backward),
    # "reference" (autograd through the plain reference)
    attn_bwd: str = "pallas"
    remat: bool = False
    scan_blocks: bool = False
    # weights pre-normalized once (runtime.fold_weights_for_inference)
    fold_weights: bool = False

    def __post_init__(self):
        assert self.hidden_size % self.num_heads == 0
        assert self.hidden_size % 2 == 0
        assert self.modulation in MODULATION_KINDS, self.modulation
        assert self.compute_dtype in ("float32", "bfloat16")
        assert self.attention_impl in ("auto", "xla", "pallas", "pallas_v2", "pallas_v3")
        assert self.block_kernel in BLOCK_KERNELS + tuple(_UNPORTED_BLOCK_KERNELS)
        assert self.attn_bwd in ("pallas", "residual", "reference")
        off = [f.name for f in dataclasses.fields(self) if f.name.startswith("use_") and not getattr(self, f.name)]
        if off or self.modulation != "adaln":
            raise NotImplementedError(
                f"flag set {off or self.modulation!r}: the port implements the default MaP "
                "family only; other flag sets and modulations are ROADMAP A.2"
            )
        if self.block_kernel in _UNPORTED_BLOCK_KERNELS:
            raise NotImplementedError(
                f"block_kernel={self.block_kernel!r} is {_UNPORTED_BLOCK_KERNELS[self.block_kernel]}"
            )
        if self.attention_impl.startswith("pallas"):
            raise NotImplementedError(
                f"attention_impl={self.attention_impl!r} is ROADMAP B.9 (standalone attention kernel)"
            )
        if self.scan_blocks or self.remat:
            raise NotImplementedError("scan_blocks and remat are later items of training (ROADMAP A.6)")

    @property
    def dtype(self) -> torch.dtype:
        return torch.bfloat16 if self.compute_dtype == "bfloat16" else torch.float32

    @property
    def out_channels(self) -> int:
        return self.in_channels

    @property
    def num_patches(self) -> int:
        return (self.input_size // self.patch_size) ** 2

    def replace(self, **kw) -> "DiTConfig":
        return dataclasses.replace(self, **kw)
