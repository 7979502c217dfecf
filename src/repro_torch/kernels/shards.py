"""The kernel wrappers on DTensors.

A step sharded as DTensors (the launch tooling's dry run on a fake world,
or a real mesh) hands ``flash_attention`` and ``ssd_scan`` DTensors that
the model's sharding hints have placed.  Each wrapper runs its own route
(the kernel, the plain version or the meta count) on every rank's local
shards and places the result as its inputs say.  A placement the wrapper
cannot run on local shards raises: nothing falls through to DTensor's own
dispatch, which would run the function on the global shapes.
"""

from __future__ import annotations

import sys


def is_dtensor(x) -> bool:
    """Whether ``x`` is a DTensor.  Nothing is imported: until some code
    has loaded ``torch.distributed.tensor``, no tensor is one."""
    mod = sys.modules.get("torch.distributed.tensor")
    return mod is not None and isinstance(x, mod.DTensor)


def local_of(t, out_like):
    """``t``'s local shard, for a function whose output is placed as
    ``out_like``.  Where a mesh dim shards that output and leaves ``t``
    whole, each rank's output takes only its own term of ``t``'s gradient:
    the gradient is placed as a partial sum there."""
    from torch.distributed.tensor import Partial

    return t.to_local(grad_placements=[
        Partial() if o.is_shard() and p.is_replicate() else p
        for o, p in zip(out_like.placements, t.placements)])


def placed_as(local, like, placements):
    """The local tensor ``local`` as a DTensor on ``like``'s mesh with
    ``placements`` (no check across ranks: each rank made its own shard)."""
    from torch.distributed.tensor import DTensor

    return DTensor.from_local(local, like.device_mesh, placements, run_check=False)
