"""Parallelism of the port: the device mesh and the process group."""

from irp_tpu_torch.parallel.mesh import (  # noqa: F401
    DATA_AXIS,
    MODEL_AXIS,
    Mesh,
    batch_sharding,
    make_mesh,
    replicated,
    shard_variables,
)
