"""PULSE core, single memory node, on torch tensors.

Layers (paper section in parens):
  arena        flat disaggregated heap + allocation policies (S2, App. Fig 5)
  translation  hierarchical address translation / protection (S5, Fig. 6)
  iterator     init/next/end + scratch_pad programming model (S3)
  isa          restricted RISC ISA + batched VM (S4.1, Table 2)
  verify       pulse-verify static verifier (S4.1)
  dispatch     offload cost model t_c <= eta * t_d (S4.1)
  commit       the write path's sequential commit (staged mutations)
  engine       PulseEngine front door + the cpu_node baseline (S6)
  structures   ported data structures (S3, Table 5, Appendix B)
"""

from repro_torch.core.arena import (  # noqa: F401
    NULL,
    Arena,
    ArenaBuilder,
    arena_from_numpy,
    f2i,
    i2f,
    load_node,
    make_arena,
)
from repro_torch.core.dispatch import AcceleratorSpec, offload_decision  # noqa: F401
from repro_torch.core.engine import PulseEngine, cpu_node_execute  # noqa: F401
from repro_torch.core.iterator import (  # noqa: F401
    STATUS_ACTIVE,
    STATUS_DONE,
    STATUS_FAULT,
    STATUS_MAXED,
    PulseIterator,
    execute_batched,
)
