"""Tensor-parallel serving: the mesh (``mesh.py``) and the per-shard trees (``sharding.py``)."""
