"""paged_attention: decode attention over a paged KV pool as a
hand-written CUDA kernel (``ops``), its plain torch version (``ref``) and
its build and binding (``kernel``)."""
