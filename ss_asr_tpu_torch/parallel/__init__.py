"""Data and tensor parallelism: the device mesh, the sharding rules, batch
sharding and the collectives of the parallel train steps
(``parallel/mesh.py``)."""
