"""flash_attention: GQA forward attention as a hand-written CUDA kernel
(``ops``), its plain torch version (``ref``) and its build and binding
(``kernel``)."""
