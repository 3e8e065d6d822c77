"""Meshes and what runs over them: the mesh (``mesh.py``), the per-shard
trees (``sharding.py``), the ring prefill (``ring_attention.py``,
``long_context.py``) and the pipelined trainer (``pipeline.py``)."""
