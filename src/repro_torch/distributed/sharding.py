"""Logical sharding rules (param path -> spec), and the versioned
shard-of-slot owner function of an elastic arena.

The rules are the JAX package's Megatron TP + FSDP hybrid, written as data:
  * ``model`` axis: TP for attention heads and the MLP hidden, EP for
    experts, vocab-parallel for embed/unembed;
  * ``data`` (+ ``pod``): FSDP shards the other matrix dimension, so every
    large matrix is 2-D sharded; DP carries the batch;
  * norm scales, biases and small vectors: replicated.
A spec is a tuple with one entry per tensor dim: an axis name, a tuple of
names, or None (the JAX ``PartitionSpec`` as data).  A mesh is anything
with ``.axis_names`` and ``.shape`` (name -> size), as
``launch.mesh.MeshSpec``; the hints also take a ``torch.distributed``
``DeviceMesh``.  The port's layer stacks are lists of per-layer dicts
(``layers``, Whisper's ``enc``/``dec``): a per-layer leaf's spec is the
reference's spec of the stacked leaf without its leading entry.
``placements`` turns a spec into DTensor placements; ``shard_hint``
redistributes a DTensor as the reference's hint constrains it
(``hint_axes``) and returns a plain tensor unchanged.  The helpers below
it place, for a step run as DTensors, the ops DTensor has no rule or a
costly one for; each is the identity, or the plain op, on plain tensors.

The arena side: an arena is range partitioned, shard ``s`` owning the
global rows ``[bounds[s], bounds[s + 1])``.  A live reshard
(``arena.remap_shards``) installs new bounds; per-shard serving state
minted under the old ones forwards to the new shards covering the same
rows.  Pure index translation on the host: pointers are global, so no
record is rewritten.
"""

from __future__ import annotations

import dataclasses
import re

import numpy as np

from repro_torch.kernels.shards import is_dtensor

STACK_KEYS = ("layers", "enc", "dec")  # top-level keys of the per-layer lists


def fsdp_axes(mesh):
    """The data-parallel axes usable for FSDP sharding."""
    return tuple(a for a in ("pod", "data") if a in mesh.axis_names)


def _axis_size(mesh, ax) -> int:
    size = 1
    for a in (ax if isinstance(ax, tuple) else (ax,)):
        size *= mesh.shape[a]
    return size


def _axes_of(mesh):
    """(axis names, name -> size) of a ``MeshSpec`` or a ``DeviceMesh``."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return tuple(names), dict(zip(names, mesh.shape))
    return tuple(mesh.axis_names), dict(mesh.shape)


def axis_size(mesh, name: str) -> int:
    """The size of ``mesh``'s axis ``name`` (1 where it has none, or no mesh)."""
    return 1 if mesh is None else _axes_of(mesh)[1].get(name, 1)


def hint_axes(shape, mesh, *axes):
    """The spec ``shard_hint`` would constrain a tensor of ``shape`` to, or
    None where the reference's hint is the identity (no mesh, or a rank
    that is not ``len(axes)``).  ``"dp"`` resolves to the (pod, data) axes
    present; an axis missing from the mesh or not dividing its dim is
    dropped.  ``mesh`` is a ``MeshSpec`` or a ``DeviceMesh``."""
    if mesh is None or len(shape) != len(axes):
        return None
    names, sizes = _axes_of(mesh)
    resolved = []
    for dim, ax in zip(shape, axes):
        if ax == "dp":
            ax = tuple(a for a in ("pod", "data") if a in names) or None
        if ax is None:
            resolved.append(None)
            continue
        want = ax if isinstance(ax, tuple) else (ax,)
        if not all(a in names for a in want):
            resolved.append(None)
            continue
        size = 1
        for a in want:
            size *= sizes[a]
        resolved.append(_entry(ax) if (dim % size == 0 and dim >= size) else None)
    return tuple(resolved)


def placements(spec, device_mesh) -> list:
    """A spec (a ``param_specs`` or ``batch_specs`` entry) as DTensor
    placements on ``device_mesh``: a mesh dim named in a tensor dim's entry
    is ``Shard(dim)``, every other mesh dim ``Replicate()``.  Several mesh
    dims on one tensor dim shard it in the spec's order, which must be the
    mesh's."""
    from torch.distributed.tensor import Replicate, Shard

    names = tuple(device_mesh.mesh_dim_names)
    out = [Replicate() for _ in names]
    for dim, ax in enumerate(spec):
        if ax is None:
            continue
        want = ax if isinstance(ax, tuple) else (ax,)
        idx = [names.index(a) for a in want]
        if idx != sorted(idx):
            raise ValueError(f"spec entry {ax!r} shards dim {dim} out of the mesh's "
                             f"order {names}")
        for i in idx:
            out[i] = Shard(dim)
    return out


def shard_hint(x, mesh, *axes):
    """The reference's ``with_sharding_constraint``: a DTensor ``x`` is
    redistributed to the placements of ``hint_axes(x.shape, mesh, *axes)``
    (its partial sums reduced, its shards moved or gathered as they ask),
    and so is its gradient in the backward, as JAX constrains the
    cotangent; a plain tensor is returned unchanged, since one process has
    nothing to constrain."""
    if not is_dtensor(x):
        return x
    spec = hint_axes(x.shape, mesh, *axes)
    if spec is None:
        return x
    return x.redistribute(x.device_mesh, placements(spec, x.device_mesh))


def settle(x):
    """A DTensor's partial sums reduced (its ``Partial`` mesh dims made
    ``Replicate``); any other tensor unchanged.  Where DTensor's own rule
    keeps a partial sum it cannot carry on (a gather's mask through a
    select), this is the all-reduce the reference's partitioner inserts."""
    if not is_dtensor(x) or not any(p.is_partial() for p in x.placements):
        return x
    from torch.distributed.tensor import Replicate

    return x.redistribute(x.device_mesh, [Replicate() if p.is_partial() else p
                                          for p in x.placements])


def fsdp_gather(w):
    """The FSDP unshard of a parameter before its use: a DTensor's pod and
    data mesh dims made ``Replicate`` (an all-gather over them, whose
    backward reduce-scatters the gradient back to the parameter's shards),
    its other dims kept; a plain tensor unchanged."""
    if not is_dtensor(w):
        return w
    from torch.distributed.tensor import Replicate

    want = [Replicate() if name in ("pod", "data") else p
            for name, p in zip(w.device_mesh.mesh_dim_names, w.placements)]
    return w if list(w.placements) == want else w.redistribute(w.device_mesh, want)


def batch_unsharded(x) -> bool:
    """Whether ``x`` is a DTensor of rank 3 or more whose batch (dim 0) is
    whole on a dp dim (the batch does not divide over it).  A product of
    it with a matrix flattens the batch and its rows, and DTensor's rule
    may shard those rows on that dim where no whole batch row lies on a
    rank, which the product's output then cannot be unflattened from."""
    if not (is_dtensor(x) and x.dim() > 2):
        return False
    from torch.distributed.tensor import Shard

    return any(name in ("pod", "data") and p != Shard(0)
               for name, p in zip(x.device_mesh.mesh_dim_names, x.placements))


def take_rows(w, idx):
    """``w[idx]``: rows of a table (an embedding lookup).  On a DTensor
    table, the lookup of the FSDP-gathered table by ``F.embedding``, whose
    sharding rule looks a vocab-sharded table up on each shard; the masked
    rows are summed at once (one all-reduce, as the reference's partitioner
    does), so the backward gets its gradient whole."""
    if not is_dtensor(w):
        return w[idx]
    import torch.nn.functional as F

    rows = settle(F.embedding(idx, fsdp_gather(w)))
    if rows.requires_grad:  # a partial-sum gradient is reduced before the lookup's backward
        rows.register_hook(settle)
    return rows


def put_rows(caches, pos, vals) -> None:
    """``cache[b, pos[b]] = val[b]`` for every row b of each (cache, val)
    pair, in place: a decode step's new K and V written into their (B, S,
    ...) caches.  On DTensor caches whose placements shard only their batch
    and sequence dims (the decode cache's), each rank writes the rows and
    positions its shard holds, ``val`` and ``pos`` placed by the batch as
    the cache is; no position moves between ranks."""
    import torch

    if not is_dtensor(caches[0]):
        rows = torch.arange(caches[0].shape[0], device=caches[0].device)
        pos = pos.long()
        for cache, val in zip(caches, vals):
            cache[rows, pos] = val.to(cache.dtype)
        return
    for cache, val in zip(caches, vals):
        _put_rows_on_shards(cache, pos, val)


def _put_rows_on_shards(cache, pos, val) -> None:
    import torch
    from torch.distributed.tensor import Replicate, Shard

    mesh = cache.device_mesh
    if any(p.is_partial() or (p.is_shard() and p.dim > 1) for p in cache.placements):
        raise ValueError(f"put_rows: a cache placed {cache.placements} shards more than its "
                         f"batch and sequence dims")
    by_batch = [Shard(0) if p == Shard(0) else Replicate() for p in cache.placements]
    val = val.to(cache.dtype).redistribute(mesh, by_batch).to_local()
    pos = pos.redistribute(mesh, by_batch).to_local().long()
    local = cache.to_local()
    start = 0  # this rank's first position: its block index over the dims sharding S
    for m, pl in enumerate(cache.placements):
        if pl == Shard(1):
            start = start * mesh.size(m) + mesh.get_coordinate()[m]
    p = pos - start * local.shape[1]
    inside = (p >= 0) & (p < local.shape[1])
    p = p.clamp(0, local.shape[1] - 1)
    rows = torch.arange(local.shape[0], device=local.device)
    mask = inside.reshape((-1,) + (1,) * (val.dim() - 1))
    local[rows, p] = torch.where(mask, val, local[rows, p])


def zeros_placed_as(like, shape, dtype):
    """Zeros of ``shape`` placed as the DTensor ``like`` is (its mesh and
    placements; every dim they shard divides): a buffer the step fills from
    ``like``, say a prefill's cache from its K/V, made where its shards
    will be written."""
    import torch
    from torch.distributed.tensor import DTensor

    local = list(shape)
    for m, p in enumerate(like.placements):
        if p.is_shard():
            n = like.device_mesh.size(m)
            if local[p.dim] % n:
                raise ValueError(f"dim {p.dim} of {tuple(shape)} does not divide over {n} ranks")
            local[p.dim] //= n
    zeros = torch.zeros(local, dtype=dtype, device=like.to_local().device)
    return DTensor.from_local(zeros, like.device_mesh, like.placements, run_check=False)


def param_rules(mesh):
    fsdp = fsdp_axes(mesh)
    fs = fsdp if fsdp else None
    return [
        # embeddings: vocab-parallel x fsdp
        (r"embed$", ("model", fs)),
        (r"unembed/w$", (fs, "model")),
        (r"patch_proj/w$", (fs, "model")),
        (r"frame_proj/w$", (fs, "model")),
        # attention
        (r"(attn|self_attn|cross_attn)/wq/w$", (fs, "model")),
        (r"(attn|self_attn|cross_attn)/wk/w$", (fs, "model")),
        (r"(attn|self_attn|cross_attn)/wv/w$", (fs, "model")),
        (r"(attn|self_attn|cross_attn)/wo/w$", ("model", fs)),
        (r"(attn|self_attn|cross_attn)/w[qkv]/b$", ("model",)),
        (r"(attn|self_attn|cross_attn)/wo/b$", ()),
        # dense mlp
        (r"mlp/wi/w$", (fs, "model")),
        (r"mlp/wg/w$", (fs, "model")),
        (r"mlp/wo/w$", ("model", fs)),
        (r"mlp/wi/b$", ("model",)),
        (r"mlp/wo/b$", ()),
        # moe: experts over model (EP), dims over fsdp
        (r"moe/wi$", ("model", fs, None)),
        (r"moe/wg$", ("model", fs, None)),
        (r"moe/wo$", ("model", None, fs)),
        (r"moe/router/w$", (fs, None)),
        (r"moe/shared/wi/w$", (fs, "model")),
        (r"moe/shared/wg/w$", (fs, "model")),
        (r"moe/shared/wo/w$", ("model", fs)),
        # ssm
        (r"ssm/in_proj/w$", (fs, "model")),
        (r"ssm/out_proj/w$", ("model", fs)),
        (r"ssm/conv_w$", (None, "model")),
        (r"ssm/conv_b$", ("model",)),
        (r"ssm/(A_log|dt_bias|D_skip)$", ()),
        (r"ssm/norm/scale$", ("model",)),
        # everything else (norms, small vectors): replicated
        (r".*", ()),
    ]


def spec_for(path_str: str, ndim: int, rules) -> tuple:
    """The first matching rule's spec for a leaf of rank ``ndim``, padded
    on the left with None (the stacked leading axes); a leaf of lower rank
    than its rule replicates."""
    for pat, spec in rules:
        if re.search(pat, path_str):
            pad = ndim - len(spec)
            if pad < 0:
                return ()
            return (None,) * pad + tuple(spec)
    return ()


def _entry(ax):
    """A spec entry as ``PartitionSpec`` keeps it: a tuple of one axis is
    that axis."""
    return ax[0] if isinstance(ax, tuple) and len(ax) == 1 else ax


def valid_spec(spec, shape, mesh) -> tuple:
    """``spec`` over ``shape``, one entry per dim: an axis (or axes) whose
    size does not divide its dim, or exceeds it, is dropped."""
    fixed = []
    for dim, ax in zip(shape, tuple(spec) + (None,) * (len(shape) - len(spec))):
        if ax is None:
            fixed.append(None)
            continue
        size = _axis_size(mesh, ax)
        fixed.append(_entry(ax) if dim % size == 0 and dim >= size else None)
    return tuple(fixed)


def map_with_path(fn, tree, path=()):
    """``fn(path, leaf)`` over a tree of dicts and lists (a leaf is anything
    else: a tensor, a spec tuple), the structure kept."""
    if isinstance(tree, dict):
        return {k: map_with_path(fn, v, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, list):
        return [map_with_path(fn, v, path + (i,)) for i, v in enumerate(tree)]
    return fn(path, tree)


def in_layer_stack(path, tree) -> bool:
    """Whether ``path`` lies in a per-layer list of ``tree``'s top level."""
    return (len(path) >= 2 and path[0] in STACK_KEYS and isinstance(path[1], int)
            and isinstance(tree.get(path[0]), list))


def param_specs(params, mesh):
    """The tree of specs of a param tree.  A per-layer leaf takes the spec
    the reference gives the stacked leaf, ``(n_layers,) + shape``, without
    its leading entry; its path is the reference's (the layer index left
    out)."""
    rules = param_rules(mesh)

    def one(path, leaf):
        shape = tuple(leaf.shape)
        stacked = in_layer_stack(path, params)
        if stacked:
            shape = (len(params[path[0]]),) + shape
            path = path[:1] + path[2:]
        spec = valid_spec(spec_for("/".join(str(k) for k in path), len(shape), rules),
                          shape, mesh)
        return spec[1:] if stacked else spec

    return map_with_path(one, params)


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A spec on a mesh, the JAX ``NamedSharding`` as data: what a tensor
    would be split into, each device holding one shard."""

    mesh: object
    spec: tuple

    def shard_shape(self, shape) -> tuple:
        """The shape of one device's shard of a tensor of ``shape``."""
        spec = tuple(self.spec) + (None,) * (len(shape) - len(self.spec))
        return tuple(d if ax is None else d // _axis_size(self.mesh, ax)
                     for d, ax in zip(shape, spec))


def shardings(spec_tree, mesh):
    """A tree of specs as a tree of ``NamedSharding`` on ``mesh``."""
    return map_with_path(lambda _p, spec: NamedSharding(mesh, spec), spec_tree)


def param_shardings(params, mesh):
    return shardings(param_specs(params, mesh), mesh)


def opt_state_specs(opt_state, param_spec_tree):
    """Optimizer moments mirror their param's spec; scalars replicate.
    AdamW ``{mu, nu, step}``; Adafactor ``{v, step}``, whose factored
    statistics the reference replicates here (``launch.steps._opt_shardings``
    gives them their params' axes)."""
    out = {}
    for k, v in opt_state.items():
        if k == "step":
            out[k] = ()
        elif k in ("mu", "nu"):
            out[k] = param_spec_tree
        else:
            out[k] = map_with_path(lambda _p, _leaf: (), v)
    return out


def batch_specs(batch, mesh):
    """Batch dim over (pod, data); everything else replicated."""
    dp = fsdp_axes(mesh)
    dp = dp if dp else None
    return map_with_path(
        lambda _p, leaf: () if leaf.dim() == 0 else (_entry(dp),) + (None,) * (leaf.dim() - 1),
        batch)


# ---------------------------------------------------------------------------
# Versioned shard-of-slot owner function (elastic arenas)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class OwnerEpoch:
    """One version of the owner function: the switch's translation base
    table (the range-partition bounds) at a reshard epoch."""

    epoch: int
    bounds: tuple[int, ...]  # (num_shards + 1,) sorted row-range partition

    @property
    def num_shards(self) -> int:
        return len(self.bounds) - 1

    def owner_of(self, ptr):
        """Owning shard of global address(es); -1 when out of range."""
        b = np.asarray(self.bounds, np.int64)
        p = np.asarray(ptr, np.int64)
        shard = np.searchsorted(b, p, side="right") - 1
        valid = (p >= 0) & (p < b[-1]) & (shard >= 0) & (shard < self.num_shards)
        return np.where(valid, shard, -1).astype(np.int32)


class VersionedOwnerMap:
    """Owner-function epochs with forwarding between them.

    ``advance`` installs a new epoch; ``forward_shard`` and
    ``forward_mask`` translate state minted under an older epoch: an old
    shard goes to the new shards covering its address range."""

    def __init__(self, bounds):
        self._epochs = [OwnerEpoch(0, tuple(int(b) for b in bounds))]

    @property
    def current(self) -> OwnerEpoch:
        return self._epochs[-1]

    @property
    def epoch(self) -> int:
        return self._epochs[-1].epoch

    def at(self, epoch: int) -> OwnerEpoch:
        for e in self._epochs:
            if e.epoch == epoch:
                return e
        raise KeyError(f"unknown owner epoch {epoch}")

    def advance(self, bounds) -> OwnerEpoch:
        """Install a new owner function (the forwarding epoch boundary)."""
        new = tuple(int(b) for b in bounds)
        cur = self.current
        if new[0] != cur.bounds[0] or new[-1] != cur.bounds[-1]:
            raise ValueError(
                "an owner epoch must cover the same address space: "
                f"{cur.bounds[0]}..{cur.bounds[-1]} vs {new[0]}..{new[-1]}")
        nxt = OwnerEpoch(cur.epoch + 1, new)
        self._epochs.append(nxt)
        return nxt

    def forward_shard(self, shard: int, *, from_epoch: int,
                      to_epoch: int | None = None) -> tuple[int, ...]:
        """The shards of ``to_epoch`` (default: the current one) whose
        ranges overlap ``shard``'s range at ``from_epoch``."""
        src = self.at(from_epoch)
        dst = self.current if to_epoch is None else self.at(to_epoch)
        if not 0 <= shard < src.num_shards:
            raise ValueError(f"shard {shard} out of range for epoch {from_epoch}")
        lo, hi = src.bounds[shard], src.bounds[shard + 1]
        db = np.asarray(dst.bounds, np.int64)
        first = int(np.searchsorted(db, lo, side="right")) - 1
        last = int(np.searchsorted(db, hi, side="left"))
        return tuple(range(max(first, 0), min(last, dst.num_shards)))

    def forward_mask(self, mask, *, from_epoch: int, to_epoch: int | None = None) -> np.ndarray:
        """Forward a per-shard bool mask: a new shard is set iff an old
        shard overlapping it was."""
        src = self.at(from_epoch)
        dst = self.current if to_epoch is None else self.at(to_epoch)
        mask = np.asarray(mask, bool)
        if mask.shape != (src.num_shards,):
            raise ValueError(
                f"mask shape {mask.shape} != ({src.num_shards},) of epoch {from_epoch}")
        out = np.zeros(dst.num_shards, bool)
        for s in np.flatnonzero(mask):
            for d in self.forward_shard(int(s), from_epoch=from_epoch, to_epoch=dst.epoch):
                out[d] = True
        return out
