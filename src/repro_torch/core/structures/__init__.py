"""Linked data structures ported to the PULSE iterator interface (paper S3,
Table 5 / Appendix B), read path.

  * list:  ``linked_list`` (STL list/forward_list ``std::find``),
           ``hash_table`` (bucket chains, ``unordered_map::find``)
  * tree:  ``btree`` (Google BTree descent + B+tree leaf-chain range
           aggregation), ``bst`` (STL map/set ``_M_lower_bound``)
  * ``isa_programs``: the same finds hand-assembled for the PULSE ISA

Each module provides a host-side numpy builder, batched PULSE iterators,
and pure-Python references used as test oracles.
"""

from repro_torch.core.structures import (  # noqa: F401
    bst,
    btree,
    hash_table,
    isa_programs,
    linked_list,
)
