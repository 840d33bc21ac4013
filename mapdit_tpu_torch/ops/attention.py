"""Plain, unfused multi-head attention, port of ``mapdit_tpu/ops/attention.py``'s
default path. The fused forms live in ``ops/cuda`` (the block kernels);
the standalone attention kernel is ROADMAP B.9."""

from __future__ import annotations

import torch

from mapdit_tpu_torch.ops.mp import normalize


def dot_product_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float, *, cosine: bool = False
) -> torch.Tensor:
    """softmax(q k^T * scale) v over (B, H, T, D') tensors, the softmax in
    float32. With ``cosine=True`` q and k rows are first normalized to norm
    sqrt(D')."""
    if cosine:
        q = normalize(q)
        k = normalize(k)
    logits = torch.einsum("bhqd,bhkd->bhqk", q, k) * scale
    weights = torch.softmax(logits.float(), dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bhkd->bhqd", weights, v)
