"""LM serving: continuous batching over the model zoo and the paged KV
cache whose page tables are PULSE linked lists."""
