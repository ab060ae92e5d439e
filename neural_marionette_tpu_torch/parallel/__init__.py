"""Distributed layer: the (data, model) mesh of the training processes and
its collectives (counterpart of ``neural_marionette_tpu/parallel``)."""
from .mesh import (DATA_AXIS, MODEL_AXIS, Mesh, check_batch_shape,
                   make_mesh, replicate, shard_batch)

__all__ = ["make_mesh", "shard_batch", "replicate", "check_batch_shape",
           "Mesh", "DATA_AXIS", "MODEL_AXIS"]
