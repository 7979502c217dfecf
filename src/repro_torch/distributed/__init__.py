"""Elastic, fault-tolerant arenas for traversal serving: owner-function
epochs (``sharding``), failure detection and the live reshard's planner
(``elastic``), checkpoints (``checkpoint``), and snapshots, the commit log,
replay recovery and hot-shard replicas (``arena_ft``)."""
