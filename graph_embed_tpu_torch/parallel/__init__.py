"""Multi-shard designs: the halo-exchange flat step with its ring overlap,
and the aggregate-sharded refinement, with every shard on one device."""
