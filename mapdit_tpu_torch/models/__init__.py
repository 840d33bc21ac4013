from mapdit_tpu_torch.models.config import DiTConfig
from mapdit_tpu_torch.models.dit import DiT, init_model
from mapdit_tpu_torch.models.registry import DIT_MODELS, build_config

__all__ = ["DiTConfig", "DiT", "init_model", "DIT_MODELS", "build_config"]
