"""Multi-head attention compute paths, port of ``mapdit_tpu/ops/attention.py``.

``impl="xla"`` (and ``"auto"``, which resolves to it as in the JAX package)
is the plain path: einsum, float32 softmax, einsum. ``"pallas"``,
``"pallas_v2"`` and ``"pallas_v3"`` all go to the one standalone Hopper
kernel ``fused_attention`` (``ops/cuda/attention.py``): the JAX package's
v3 head pairing shapes tiles for a 128x128 matrix unit and has no
counterpart on this card. The block kernels of ``ops/cuda`` carry their own
attention core.
"""

from __future__ import annotations

import torch

from mapdit_tpu_torch.ops.mp import normalize

ATTENTION_IMPLS = ("auto", "xla", "pallas", "pallas_v2", "pallas_v3")


def plain_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float, cosine: bool) -> torch.Tensor:
    """softmax(q k^T * scale) v over (B, H, T, D') tensors, the softmax in
    float32; with ``cosine`` q and k rows are first normalized to norm
    sqrt(D')."""
    if cosine:
        q = normalize(q)
        k = normalize(k)
    logits = torch.einsum("bhqd,bhkd->bhqk", q, k) * scale
    weights = torch.softmax(logits.float(), dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bhkd->bhqd", weights, v)


def dot_product_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float, *, cosine: bool = False, impl: str = "auto"
) -> torch.Tensor:
    """Attention over (B, H, T, D') tensors by ``impl`` (module docstring)."""
    if impl not in ATTENTION_IMPLS:
        raise ValueError(f"impl must be one of {ATTENTION_IMPLS}, got {impl!r}")
    if impl.startswith("pallas"):
        from mapdit_tpu_torch.ops.cuda.attention import fused_attention

        return fused_attention(q, k, v, scale, cosine)
    return plain_attention(q, k, v, scale, cosine)
