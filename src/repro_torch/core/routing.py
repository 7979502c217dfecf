"""In-network switch routing (paper S5): the part the single-node path uses.

Only the access-check elision predicate lives here for now; the record
format, supersteps and fabrics come with the multi-shard slice (ROADMAP
queue 1, item 6).
"""

from __future__ import annotations

from repro_torch.core.arena import PERM_READ, Arena
from repro_torch.core.iterator import PulseIterator


def can_elide_access_check(it: PulseIterator, arena: Arena) -> bool:
    """True when the per-hop PERM_READ probe is statically constant-true.

    Two proofs combine: the iterator's pulse-verify certificate
    (``it.facts``) shows the traversal only ever reads, and a host-side
    scan shows every shard of ``arena.perms`` grants PERM_READ.  Under
    both, ``check_access`` would return True for every pointer the
    traversal can present, so replacing the probe with the constant is
    bit-identical.  Unverified iterators (``facts is None``) never qualify.
    """
    facts = it.facts
    if facts is None or not getattr(facts, "read_only", False) or it.mutates:
        return False
    return bool(((arena.perms & PERM_READ) == PERM_READ).all())
