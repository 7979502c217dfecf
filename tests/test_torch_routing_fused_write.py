"""Port parity: the device-resident schedules (``schedule="fused"`` and
``"pipelined"``) and the ring fabric on the write path (item 6(c)), beside
``tests/test_torch_routing_fused.py`` (a file of its own, so that a
parallel run puts it on a worker of its own).

Every schedule and fabric against the port's dispatched dense run at P = 2,
4 and 8, on the mutating workloads of ``tests/test_torch_routing_write.py``
(the list's insert/delete, the hash table's rw batch, BST and B+tree
updates, a revoked shard, an exhausted allocator, the skip list's insert and
delete), compacted and not: records, final ``data`` and ``heap``, and every
stats field the JAX package reports on those schedules, bit-equal; the
input arena left as it was."""

import sys
from pathlib import Path

import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent))
from test_torch_routing_fused import (  # noqa: E402
    DEVICE_RESIDENT,
    _assert_device_resident_stats,
    _carry,
    _run,
    jax,
    needs_jax,
)

if jax is not None:
    from test_torch_routing_write import _phases

WRITE_NAMES = ("chain_mixed_rw", "hash_mixed_rw", "bst_update", "btree_update", "perm_fault",
               "alloc_exhaustion", "skiplist_insert_delete")  # test_torch_routing_write.NAMES


@needs_jax
@pytest.mark.parametrize("compact", [True, False], ids=["compact", "uncompacted"])
@pytest.mark.parametrize("P", [2, 4, 8])
@pytest.mark.parametrize("name", WRITE_NAMES)
def test_write_schedules_match_the_dispatched_run(name, P, compact):
    """Mutating batches on every schedule and fabric: records, final
    ``data`` and ``heap``, commits and epochs bit-equal to the dispatched
    dense run; the input arena left as it was (the skip list's second
    phase runs on the first's committed arena)."""
    jar, phases = _phases(name, P)
    tar = _carry(jar)
    for phase, _, tit, _, targs, max_iters in phases:
        init = tit.init(*targs)
        before = (tar.data.clone(), tar.heap.clone())
        rec, st, want = _run(tit, tar, *init, P, max_iters=max_iters, compact=compact)
        ring_rec, ring_st, ring_ar = _run(tit, tar, *init, P, max_iters=max_iters,
                                          compact=compact, fabric="ring")
        assert torch.equal(ring_rec, rec) and torch.equal(ring_ar.data, want.data)
        assert ring_st.supersteps == st.supersteps and ring_st.commits == st.commits
        for schedule, fabric in DEVICE_RESIDENT:
            got, gst, gar = _run(tit, tar, *init, P, max_iters=max_iters, compact=compact,
                                 schedule=schedule, fabric=fabric)
            assert torch.equal(got, rec), (phase, schedule, fabric)
            assert torch.equal(gar.data, want.data) and torch.equal(gar.heap, want.heap)
            assert gar.bounds is tar.bounds and gar.perms is tar.perms
            _assert_device_resident_stats(gst, st, schedule, fabric)
        assert torch.equal(tar.data, before[0]) and torch.equal(tar.heap, before[1])
        tar = want
