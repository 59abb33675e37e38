"""Parallelism of the port (counterpart of ``fovealseg_tpu/parallel``): one
process per rank with ``torch.distributed``, NCCL between cards and gloo
between CPU processes (or ranks that share a card).

* :mod:`.multihost`: the process group's bootstrap, the reference's rank
  sampler and the topology snapshot;
* :mod:`.launch`: ``run_workers``, which starts N rank processes, drains
  their output while they run and stops them all when one fails;
* :mod:`.mesh`: the 1-D data-parallel train and eval steps (DDP, the
  gradients and metrics averaged over the ranks), ``shard_batch`` and
  ``replicate_state``; the 2-D (data, model) mesh: ``make_mesh_2d``,
  ``model_sharded``, ``shard_model_2d``, ``gather_state_2d`` and
  ``slice_state_2d`` (its steps are ``train/step.py``'s given ``mesh=``);
* :mod:`.tensor_parallel`: the column-parallel ``Conv2d`` and ``Linear`` of
  the 2-D mesh's model axis;
* :mod:`.spatial`: one frame's encoder and decoder row-partitioned over N
  ranks (``cli.infer --spatial``).

Cross-rank BN is ``models/layers.py::convert_sync_bn``.
"""

from fovealseg_torch.parallel.mesh import (Mesh2D, gather_state_2d, make_mesh_2d,
                                           model_sharded, replicate_state, shard_batch,
                                           shard_model_2d, slice_state_2d)
from fovealseg_torch.parallel.spatial import RowShards, run_trunk

__all__ = ["Mesh2D", "RowShards", "gather_state_2d", "make_mesh_2d", "model_sharded",
           "replicate_state", "run_trunk", "shard_batch", "shard_model_2d", "slice_state_2d"]
