"""Mixture-of-Experts layer with PULSE-style switch routing, the JAX
package's ``models/moe.py``.

Token -> expert dispatch reuses the paper's in-network routing shape: the
router ("switch") computes each token copy's owner from a range partition
of expert ids (``owner = e // E_loc``), as the arena routes addresses to
memory nodes; records go to the owning shard, and the results combine
back in the same record format.  Capacity overflow drops copies (standard
MoE), mirroring the paper's bounded per-link capacity; the residual
connection stands in for the retry.

``moe_apply`` runs two paths.  With no mesh, a ``launch.mesh.MeshSpec`` (the
dry run's description) or a mesh whose ``model`` dim has one rank, every
expert is on one shard.  Under a ``torch.distributed`` ``DeviceMesh`` whose
dims carry the JAX mesh's names (``"pod"``, ``"data"``, ``"model"``) and
whose ``model`` dim has more ranks, it is the JAX package's expert-parallel
``shard_map`` body, one rank a device: the experts range-partitioned over
``model``, this dp rank's tokens, the FSDP weight gather over the dp dims
(tiled, as ``jax.lax.all_gather(..., tiled=True)``), ``_moe_local`` for this
``model`` rank, and the partial outputs summed in f32 by one all-reduce over
``model``.  ``shard_moe_params`` cuts the whole params as the JAX
package's ``pspec`` cuts them.  Given DTensors (a step sharded as
DTensors), the same body runs on each rank's shards.  The router, the
ranks and the combine are plain torch ops, and the grouped SwiGLU is batched matmuls: the JAX package
computes them outside any Pallas kernel.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.distributed import world
from repro_torch.distributed.sharding import is_dtensor, shard_hint
from repro_torch.models.common import dense_apply, dense_init, swiglu_apply, swiglu_init


def moe_init(gen: torch.Generator, cfg, device=None):
    """Random params from ``gen``, on ``device`` (by default ``gen``'s):
    the router (D, E), the experts' ``wi``/``wg`` (E, D, F) and ``wo`` (E,
    F, D) at std 1/sqrt(fan-in), and the shared expert when
    ``cfg.n_shared_experts``."""
    D, E, Fd = cfg.d_model, cfg.n_experts, cfg.moe_d_ff
    device = device or gen.device

    def ew(a, b):
        w = torch.randn((E, a, b), generator=gen, device=device) / math.sqrt(a)
        return w.to(cfg.param_dtype)

    p = {
        "router": dense_init(gen, D, E, cfg.param_dtype, device=device),
        "wi": ew(D, Fd),
        "wg": ew(D, Fd),
        "wo": ew(Fd, D),
    }
    if cfg.n_shared_experts:
        p["shared"] = swiglu_init(gen, D, Fd * cfg.n_shared_experts, cfg.param_dtype, device)
    return p


def capacity(cfg, T: int) -> int:
    """Slots per expert for ``T`` tokens: ``max(8, ceil(T*K/E * factor))``."""
    return max(8, int(math.ceil(T * cfg.moe_top_k / cfg.n_experts * cfg.moe_capacity_factor)))


def route(p, cfg, x_flat):
    """The router: x_flat (T, D) -> (probs (T, E), top_p (T, K), top_e (T, K)).

    Logits and softmax in f32; ``torch.topk`` in descending order, as
    ``lax.top_k`` (which breaks exact ties by the lower index, where
    ``torch.topk`` promises no order; f32 probabilities from real inputs
    do not tie exactly); ``top_p`` renormalised to sum 1 when
    ``cfg.moe_renormalize``."""
    logits = dense_apply(p["router"], x_flat, torch.float32)
    probs = torch.softmax(logits.float(), dim=-1)
    top_p, top_e = torch.topk(probs, cfg.moe_top_k, dim=-1)
    if cfg.moe_renormalize:
        top_p = top_p / top_p.sum(-1, keepdim=True).clamp_min(1e-9)
    return probs, top_p, top_e


def rank_in_expert(copies_e, n_experts: int):
    """Each copy's rank among the copies of its expert, in copy order (the
    stable sort by expert id): copy ``i`` keeps its slot iff its rank is
    below the capacity."""
    n = copies_e.shape[0]
    order = torch.argsort(copies_e, stable=True)
    sorted_e = copies_e[order]
    start = torch.searchsorted(sorted_e, torch.arange(n_experts, device=copies_e.device))
    rank = torch.empty_like(copies_e)
    rank[order] = torch.arange(n, device=copies_e.device) - start[sorted_e]
    return rank


def _expert_ffn(wi, wg, wo, xb, compute_dtype):
    """Grouped SwiGLU: xb (E_loc, C, D) through each expert's weights."""
    xb = xb.to(compute_dtype)
    h = F.silu(torch.bmm(xb, wg.to(compute_dtype))) * torch.bmm(xb, wi.to(compute_dtype))
    return torch.bmm(h, wo.to(compute_dtype))


def _moe_local(p, cfg, x_flat, my_rank: int, ep: int, compute_dtype):
    """One expert shard's body: route, compact, grouped FFN, weighted
    combine.

    x_flat (T, D): the tokens, the same on every shard.  ``p``'s experts are
    this shard's ``E // ep`` (its slice of the expert axis); the router is
    whole.  Returns the shard's partial output (T, D), to be summed over
    the ``ep`` shards."""
    T, D = x_flat.shape
    E, K = cfg.n_experts, cfg.moe_top_k
    E_loc = E // ep
    C = capacity(cfg, T)
    dev = x_flat.device
    _, top_p, top_e = route(p, cfg, x_flat)

    # the switch: owner = range partition of expert ids
    copies_e = top_e.reshape(-1)  # (T*K,) expert id per copy
    copies_t = torch.arange(T, device=dev).repeat_interleave(K)  # token of each copy
    copies_w = top_p.reshape(-1)
    mine = copies_e // E_loc == my_rank
    rank = rank_in_expert(copies_e, E)
    fits = mine & (rank < C)
    trash = E_loc * C  # the slot a dropped or foreign copy goes to
    slot = torch.where(fits, (copies_e % E_loc) * C + rank, trash)

    # gather tokens into the expert buffer (E_loc, C, D); T is the zero row
    buf_tok = torch.full((trash + 1,), T, dtype=torch.long, device=dev)
    buf_tok[slot] = torch.where(fits, copies_t, T)
    x_pad = torch.cat([x_flat, x_flat.new_zeros((1, D))])
    xb = x_pad[buf_tok[:trash]].reshape(E_loc, C, D)
    yb = _expert_ffn(p["wi"], p["wg"], p["wo"], xb, compute_dtype).reshape(trash, D)

    # combine: scatter-add the weighted expert outputs back to their tokens
    yb_pad = torch.cat([yb, yb.new_zeros((1, D))])
    y_copies = yb_pad[slot] * torch.where(fits, copies_w, 0.0)[:, None].to(yb.dtype)
    return yb.new_zeros((T, D)).index_add_(0, copies_t, y_copies)


def _device_mesh(mesh):
    """``mesh`` when it is a ``torch.distributed`` ``DeviceMesh`` whose
    ``model`` dim has more than one rank (the expert-parallel path), else
    None."""
    from torch.distributed.device_mesh import DeviceMesh

    if not isinstance(mesh, DeviceMesh) or "model" not in (mesh.mesh_dim_names or ()):
        return None
    return mesh if mesh["model"].size() > 1 else None


def _dp_mesh(mesh):
    """The 1-D mesh of ``mesh``'s dp dims (``pod`` then ``data``, flattened
    rank-major as JAX orders a multi-axis gather), or None."""
    dp = tuple(a for a in ("pod", "data") if a in mesh.mesh_dim_names)
    if not dp:
        return None
    return mesh[dp[0]] if len(dp) == 1 else mesh[dp]._flatten()


def _moe_specs(p):
    """Each leaf's cut, the JAX package's ``pspec``: ``{path: (model axis,
    dp axis)}``, None where the leaf is whole along that mesh dim."""
    specs = {("router", "w"): (None, 0), ("wi",): (0, 1), ("wg",): (0, 1), ("wo",): (0, 2)}
    if "shared" in p:
        specs.update({("shared", "wi", "w"): (1, 0), ("shared", "wg", "w"): (1, 0),
                      ("shared", "wo", "w"): (0, 1)})
    return specs


def _leaf(p, path):
    for k in path:
        p = p[k]
    return p


def _with_leaves(leaves):
    """The nested params of ``leaves`` ({path: tensor})."""
    out = {}
    for path, t in leaves.items():
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = t
    return out


def shard_moe_params(p, mesh):
    """This rank's shard of one MoE layer's whole params ``p`` under
    ``mesh`` (a ``DeviceMesh`` with a ``model`` dim), as the JAX package's
    ``pspec`` cuts them: the experts' ``wi``/``wg``/``wo`` by range over
    ``model`` and ``D`` over the dp dims, the router's ``D`` over the dp
    dims, the shared expert's ``F`` over ``model`` and ``D`` over the dp
    dims.  Raises when a cut dim does not divide."""
    model, dp = mesh["model"], _dp_mesh(mesh)
    cuts = [(model.size(), model.get_local_rank())]
    cuts.append((dp.size(), dp.get_local_rank()) if dp is not None else (1, 0))
    leaves = {}
    for path, axes in _moe_specs(p).items():
        t = _leaf(p, path)
        for axis, (n, i) in zip(axes, cuts):
            if axis is None:
                continue
            if t.shape[axis] % n:
                raise ValueError(f"moe param {'/'.join(path)} {tuple(t.shape)}: dim {axis} "
                                 f"does not divide over {n} ranks")
            t = t.narrow(axis, i * (t.shape[axis] // n), t.shape[axis] // n)
        leaves[path] = t.contiguous()
    return _with_leaves(leaves)


def _moe_expert_parallel(p, cfg, x, mesh, compute_dtype):
    """The JAX package's expert-parallel body on this rank: ``p`` its shard
    (``shard_moe_params``), ``x`` (B_loc, L, D) its dp rank's tokens."""
    model, dp = mesh["model"], _dp_mesh(mesh)
    ep, my = model.size(), model.get_local_rank()
    group = dp.get_group() if dp is not None else None

    def gather(w, axis):
        """The FSDP unshard over the dp dims, tiled along ``axis``."""
        return torch.cat(world.all_gather(w, group), dim=axis) if dp is not None else w

    # f32 at the boundary, the router's weights too, as the JAX package
    # passes them into its shard_map
    xf = x.float().reshape(-1, x.shape[-1])
    full = {path: gather(_leaf(p, path), axes[1])
            for path, axes in _moe_specs(p).items()}
    full[("router", "w")] = full[("router", "w")].float()
    full = _with_leaves(full)
    y = _moe_local(full, cfg, xf, my, ep, compute_dtype)
    if "shared" in p:
        # the shared expert's F-slice partial joins the same sum
        y = y + swiglu_apply(full["shared"], xf, compute_dtype)
    y = world.all_reduce_sum(y.float(), model.get_group())
    return y.reshape(x.shape).to(x.dtype)


def _moe_on_shards(p, cfg, x, mesh, compute_dtype):
    """The expert-parallel body on DTensors (a step sharded as DTensors):
    each leaf of ``p`` placed as ``shard_moe_params`` cuts it, ``x`` with
    its batch on the dp dims and whole on ``model``; the body runs on this
    rank's shards, and its result is placed as ``x``.  Each ``model``
    rank's partial output takes only its own experts' terms of the
    gradients of ``x`` and of the leaves whole on ``model`` (the router):
    those are partial sums over ``model``, as JAX sums a replicated
    input's cotangent at its ``shard_map``."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    names = mesh.mesh_dim_names

    def local(t):
        return t.to_local(grad_placements=[
            Partial() if n == "model" and pl.is_replicate() else pl
            for n, pl in zip(names, t.placements)])

    leaves = {}
    for path, (model_axis, dp_axis) in _moe_specs(p).items():
        want = [Shard(model_axis) if n == "model" and model_axis is not None
                else Shard(dp_axis) if n in ("pod", "data") and dp_axis is not None
                else Replicate() for n in names]
        w = _leaf(p, path)
        leaves[path] = local(w if list(w.placements) == want else w.redistribute(mesh, want))
    x = shard_hint(x, mesh, "dp", None, None)
    y = _moe_expert_parallel(_with_leaves(leaves), cfg, local(x), mesh, compute_dtype)
    return DTensor.from_local(y, mesh, x.placements, run_check=False)


def moe_apply(p, cfg, x, *, mesh=None, compute_dtype=None):
    """x (B, L, D) -> (B, L, D): every expert on one shard, plus the shared
    expert when the config has one; with no mesh, a ``MeshSpec`` or a mesh
    of one ``model`` rank.  Under a ``DeviceMesh`` with more than one
    ``model`` rank, the expert-parallel path: ``p`` is this rank's shard
    (``shard_moe_params``) and ``x`` this dp rank's tokens, and the result
    is this dp rank's."""
    compute_dtype = compute_dtype or cfg.compute_dtype
    dmesh = _device_mesh(mesh)
    if dmesh is not None and is_dtensor(x):
        return _moe_on_shards(p, cfg, x, dmesh, compute_dtype)
    if dmesh is not None:
        return _moe_expert_parallel(p, cfg, x, dmesh, compute_dtype)
    B, L, D = x.shape
    xf = x.reshape(B * L, D)
    y = _moe_local(p, cfg, xf, 0, 1, compute_dtype)
    if "shared" in p:
        y = y + swiglu_apply(p["shared"], xf, compute_dtype)
    return y.reshape(B, L, D)
