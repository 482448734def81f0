"""Parallelism of the port: the (data, model) device mesh, the process
group and the Megatron layers of the model axis."""

from irp_tpu_torch.parallel.mesh import (  # noqa: F401
    DATA_AXIS,
    MODEL_AXIS,
    Mesh,
    batch_sharding,
    gather_variables,
    make_mesh,
    param_shardings,
    replicated,
    shard_variables,
    unshard_variables,
)
