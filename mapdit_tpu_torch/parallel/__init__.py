"""Multi-rank layouts over torch.distributed (``mesh.py``)."""

from mapdit_tpu_torch.parallel.mesh import (
    DATA_AXIS,
    MODEL_AXIS,
    Mesh,
    init_distributed,
    make_mesh,
    shard_state_dict,
    spawn,
)

__all__ = ["DATA_AXIS", "MODEL_AXIS", "Mesh", "init_distributed", "make_mesh", "shard_state_dict", "spawn"]
