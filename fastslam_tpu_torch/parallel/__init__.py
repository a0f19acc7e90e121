"""The particle-sharded engine: the state split on its particle axis over a
mesh of shards, the sharded filter steps, and the distributed resamplers with
the ring halo exchange kernel.  One controller holds every shard; the shards
lie on the CPU or on one card, which the mesh may name several times."""
