"""Data parallelism over ``torch.distributed`` (``mesh.py``), ZeRO-1
optimizer-state sharding (``zero.py``) and single-clip sharding: one clip's
sample split over the ranks (``sampling.py``, with the shard context and its
collectives in ``shard.py``)."""
