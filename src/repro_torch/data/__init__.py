"""Synthetic training data: the deterministic, host-sharded token stream
with exact resume (``pipeline``)."""
