"""ssd_scan: the Mamba2 SSD chunked scan as a hand-written CUDA kernel
(``ops``), its plain torch versions (``ref``) and its build and binding
(``kernel``)."""
