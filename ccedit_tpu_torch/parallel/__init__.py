"""Data parallelism over ``torch.distributed`` (``mesh.py``) and ZeRO-1
optimizer-state sharding (``zero.py``)."""
