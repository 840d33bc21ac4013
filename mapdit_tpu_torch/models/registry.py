"""Model registry: the 15 DiT configs, port of ``mapdit_tpu/models/registry.py``.

{XL(28, 1152, 16h), L(24, 1024, 16h), B(12, 768, 12h), S(12, 384, 6h),
 XS(6, 256, 4h)} x patch {2, 4, 8}.
"""

from __future__ import annotations

from mapdit_tpu_torch.models.config import DiTConfig

_SIZES = {
    "XL": dict(depth=28, hidden_size=1152, num_heads=16),
    "L": dict(depth=24, hidden_size=1024, num_heads=16),
    "B": dict(depth=12, hidden_size=768, num_heads=12),
    "S": dict(depth=12, hidden_size=384, num_heads=6),
    "XS": dict(depth=6, hidden_size=256, num_heads=4),
}

DIT_MODELS = {
    f"DiT-{size}/{patch}": dict(patch_size=patch, **spec)
    for size, spec in _SIZES.items()
    for patch in (2, 4, 8)
}


def build_config(model_name: str, **overrides) -> DiTConfig:
    """A DiTConfig for a registry name with field overrides applied."""
    if model_name not in DIT_MODELS:
        raise KeyError(f"unknown model {model_name!r}; choices: {sorted(DIT_MODELS)}")
    spec = dict(DIT_MODELS[model_name])
    spec.update(overrides)
    return DiTConfig(**spec)
