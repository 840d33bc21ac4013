"""Model configuration, port of ``mapdit_tpu/models/config.py``.

Every field of the JAX ``DiTConfig`` is here: the eight ``use_*`` flags as
real switches (all off with ``modulation="adaln"`` is a vanilla DiT), the
three modulation kinds, every ``attention_impl``, the ``auto``, ``pallas``,
``mega``, ``mega_attn``, ``mega_stack`` and ``off`` block kernels and every
``attn_bwd``, and the tensor-parallel islands ``mega_attn_tp`` and
``mega_tp`` (``build_sample_fn(mesh=)``), ``remat`` (each block under
``torch.utils.checkpoint`` where gradients are taken) and ``scan_blocks``
(the block parameters stacked on a leading depth axis, ``models/dit.py``).
"""

from __future__ import annotations

import dataclasses

import torch

from mapdit_tpu_torch.ops.attention import ATTENTION_IMPLS

MODULATION_KINDS = ("adaln", "rotation", "rotation_scale")
TP_KERNELS = ("mega_attn_tp", "mega_tp")  # the tensor-parallel islands, on a mesh's model axis
BLOCK_KERNELS = ("auto", "pallas", "mega", "mega_attn", "mega_stack", *TP_KERNELS, "off")


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
    # "auto"/"xla": the plain path; "pallas", "pallas_v2", "pallas_v3": the
    # standalone attention kernel fused_attention (ops/cuda/attention.py),
    # one Hopper kernel behind the JAX package's three names
    attention_impl: str = "auto"
    # "mega": each block through fused_dit_block (ops/cuda/dit_block.py);
    # "mega_stack": the whole stack through fused_dit_stack inside the
    # sampling runtime (elsewhere it runs the plain path, as in the JAX
    # package); "mega_attn": the attention half of each block through
    # fused_attn_branch (ops/cuda/attn_branch.py), the MLP half plain;
    # "pallas": the MLP half of each block through fused_mlp_branch
    # (ops/cuda/mlp_block.py), the attention half on the generic path;
    # "mega_attn_tp" / "mega_tp": the tensor-parallel islands of
    # ops/cuda/dit_block_tp.py on a mesh's model axis (attention half, or
    # the whole block), set up by runtime.build_sample_fn(mesh=);
    # "auto": the policy in models/blocks.py; "off": plain torch.
    # The kernels hard-code the MP + adaln arithmetic: on another flag
    # family every value runs the generic path (models/blocks.py).
    block_kernel: str = "off"
    # VJP of fused_attn_branch under mega_attn: "pallas" (fused backward
    # kernels), "residual" (residual-emitting forward, plain backward),
    # "reference" (autograd through the plain reference)
    attn_bwd: str = "pallas"
    # per-block activation rematerialization: each block's activations are
    # recomputed in the backward instead of kept (models/dit.py)
    remat: bool = False
    # the block parameters live once, stacked on a leading (depth,) axis
    # under the reference names without the block index; the forward runs
    # the depth as a loop over views of them (models/dit.py)
    scan_blocks: bool = False
    # weights pre-normalized once (runtime.fold_weights_for_inference)
    fold_weights: bool = False

    def __post_init__(self):
        assert self.hidden_size % self.num_heads == 0
        assert self.hidden_size % 2 == 0
        assert self.modulation in MODULATION_KINDS, self.modulation
        assert self.compute_dtype in ("float32", "bfloat16")
        assert self.attention_impl in ATTENTION_IMPLS, self.attention_impl
        assert self.block_kernel in BLOCK_KERNELS, self.block_kernel
        assert self.attn_bwd in ("pallas", "residual", "reference")

    @property
    def dtype(self) -> torch.dtype:
        return torch.bfloat16 if self.compute_dtype == "bfloat16" else torch.float32

    @property
    def out_channels(self) -> int:
        return self.in_channels

    @property
    def num_patches(self) -> int:
        return (self.input_size // self.patch_size) ** 2

    @property
    def mp_style(self) -> bool:
        """MP conditioning arithmetic (``mp_sum(x*scale, shift, gain)``)
        against the classic adaLN-Zero ``x*(1+scale)+shift``; keyed on
        ``use_no_layernorm`` alone, since the classic form pairs with the
        pre-modulation LayerNorm."""
        return self.use_no_layernorm

    def replace(self, **kw) -> "DiTConfig":
        return dataclasses.replace(self, **kw)

    def flags_dict(self) -> dict:
        return {
            f.name: getattr(self, f.name)
            for f in dataclasses.fields(self)
            if f.name.startswith("use_") or f.name == "modulation"
        }
