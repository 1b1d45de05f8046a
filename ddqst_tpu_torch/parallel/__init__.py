"""Process meshes: data- and tensor-parallel training over torch.distributed."""

from ddqst_tpu_torch.parallel.mesh import (  # noqa: F401
    DATA_AXIS,
    MODEL_AXIS,
    Mesh,
    gather_data,
    init_distributed,
    make_mesh,
    replicate,
    shard_data,
)
from ddqst_tpu_torch.parallel.tensor import (  # noqa: F401
    gather_params,
    shard_params,
    transformer_param_shardings,
)
