"""pulse_chase: the PULSE accelerator as a CUDA kernel that runs PULSE ISA
programs (``ops``), its plain torch version (``ref``) and its build and
binding (``kernel``)."""
