"""Elastic arenas for traversal serving: owner-function epochs
(``sharding``) and the live reshard's planner (``elastic``)."""
