"""The multi-device mesh and the multi-rank router on ``torch.distributed``
(port of ``dreamlab_tpu/parallel``): ``sharding`` (the ("data", "model")
mesh, data rows, the tensor-parallel UNet's placements), ``multihost_router``
(HTTP on rank 0, every call broadcast to every rank) and ``multihost`` (rank
processes, their rendezvous, the dryruns)."""
