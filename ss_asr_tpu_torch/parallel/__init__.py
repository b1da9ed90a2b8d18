"""Data parallelism: the device mesh, batch sharding and the collectives of
the data-parallel train step (``parallel/mesh.py``)."""
