"""Multi-device parallelism on ``torch.distributed``: data, spatial,
tensor and pipeline parallel paths (``mesh.py``, ``tensor.py``,
``pipeline.py``) over the collectives of ``comm.py``; ``dryrun.py`` runs
them all in a job of N ranks."""

from .mesh import (make_mesh, make_mesh_2d, shard_batch, replicate,
                   sharded_sampler, sharded_second_moment,
                   spatial_sharded_sampler, vmapped_multi_edit)
from .pipeline import gpipe, pipelined_style_mapper
from .tensor import (tp_param_sharding, tensor_shard_params,
                     tensor_sharded_sampler)

__all__ = ["make_mesh", "make_mesh_2d", "shard_batch", "replicate",
           "sharded_sampler", "sharded_second_moment",
           "spatial_sharded_sampler", "vmapped_multi_edit",
           "gpipe", "pipelined_style_mapper",
           "tp_param_sharding", "tensor_shard_params",
           "tensor_sharded_sampler"]
