"""Mesh and sharding layer of the PyTorch port (dp / sp / pp over
``torch.distributed``), the counterpart of ``hygrid_tpu.parallel``.
Importing it creates no process group."""
from .mesh import (P, Mesh, create_mesh, shard_batch, replicate, batch_spec,
                   spatial_spec)
from .spatial import (halo_exchange, sharded_hex_conv2d,
                      sharded_hex_conv2d_fn, sharded_resample)
from .pipeline import (pipeline_apply, pipeline_hex_conv_stack,
                       stack_stage_params)
from .distributed import (initialize_multihost, global_mesh,
                          host_local_batch_slice)

__all__ = [
    "pipeline_apply",
    "pipeline_hex_conv_stack",
    "stack_stage_params",
    "P",
    "Mesh",
    "create_mesh",
    "shard_batch",
    "replicate",
    "batch_spec",
    "spatial_spec",
    "halo_exchange",
    "sharded_hex_conv2d",
    "sharded_hex_conv2d_fn",
    "sharded_resample",
    "initialize_multihost",
    "global_mesh",
    "host_local_batch_slice",
]
