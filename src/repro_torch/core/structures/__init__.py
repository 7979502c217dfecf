"""Linked data structures ported to the PULSE iterator interface (paper S3,
Table 5 / Appendix B), read and write paths.

  * list:  ``linked_list`` (STL list/forward_list ``std::find``),
           ``hash_table`` (bucket chains, ``unordered_map::find``)
  * tree:  ``btree`` (Google BTree descent + B+tree leaf-chain range
           aggregation), ``bst`` (STL map/set ``_M_lower_bound``)
  * ``skiplist``: fat-pointer skip list (find, level-0 insert and delete)
  * ``isa_programs``: the same finds hand-assembled for the PULSE ISA

Each module provides a host-side numpy builder, batched PULSE iterators
(the mutating ones stage their writes for the commit path), and
pure-Python references used as test oracles.
"""

from repro_torch.core.structures import (  # noqa: F401
    bst,
    btree,
    hash_table,
    isa_programs,
    linked_list,
    skiplist,
)
