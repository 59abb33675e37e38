"""Data parallelism of the port (counterpart of ``fovealseg_tpu/parallel``):
one process per rank with ``torch.distributed``, NCCL between cards and gloo
between CPU processes.

* :mod:`.multihost`: the process group's bootstrap, the reference's rank
  sampler and the topology snapshot;
* :mod:`.launch`: ``run_workers``, which starts N rank processes, drains
  their output while they run and stops them all when one fails;
* :mod:`.mesh`: the 1-D data-parallel train and eval steps (DDP, the
  gradients and metrics averaged over the ranks), ``shard_batch`` and
  ``replicate_state``.

Cross-rank BN is ``models/layers.py::convert_sync_bn``.
"""
