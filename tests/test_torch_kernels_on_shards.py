"""The float kernels' wrappers on DTensors (``kernels/shards.py``):
``flash_attention`` and ``ssd_scan`` run on each rank's local shards, as
placed by the caller, or raise; and the MoE's expert-parallel body on
DTensors (``models/moe.py``), each ``model`` rank's experts on its shards.

Each case runs as every rank in turn of a fake world of 2 (one mesh dim,
``model``): a rank's inputs are its shards of seeded global inputs, made
with ``DTensor.from_local``, and no collective runs.  Its output shard and
its gradients are held within 1e-6 of the largest magnitude against the
plain version on the global inputs (the same function, on the CPU): the
slice of the output the rank holds, and the gradients of that slice's
loss alone (a gradient a dim sums over its ranks is this rank's term).
The MoE's rank output is its own experts' partial sum (the fake world's
all-reduce moves nothing), held against ``moe._moe_local`` for that rank
on the whole weights.
"""

import contextlib

import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.kernels.flash_attention.ref import mha_reference
from repro_torch.kernels.shards import is_dtensor
from repro_torch.kernels.ssd_scan.ops import ssd_scan
from repro_torch.kernels.ssd_scan.ref import ssd_chunked_batched
from repro_torch.models import moe

N_RANKS = 2
TOL = 1e-6


@contextlib.contextmanager
def _as_rank(rank):
    """A one-dim mesh ``model`` over a fake world of N_RANKS, as ``rank``."""
    from torch.testing._internal.distributed.fake_pg import FakeStore  # registers "fake"

    assert not dist.is_initialized()
    dist.init_process_group("fake", store=FakeStore(), rank=rank, world_size=N_RANKS)
    try:
        yield DeviceMesh("cpu", torch.arange(N_RANKS), mesh_dim_names=("model",))
    finally:
        dist.destroy_process_group()


def _rand(rng, *shape):
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32))


def _close(got, want, what):
    err = float((got.detach() - want).abs().max())
    assert err <= TOL * max(1.0, float(want.abs().max())), f"{what}: {err}"


def _grads(fn, inputs, keep, g):
    """Gradients of ``(fn(*inputs)[keep] * g).sum()`` for every input."""
    inputs = [t.detach().clone().requires_grad_() for t in inputs]
    out = fn(*inputs)
    out = out[0] if isinstance(out, tuple) else out
    return torch.autograd.grad((out[keep] * g).sum(), inputs)


def _leaf(t, mesh, placement, rank):
    """``rank``'s shard of ``t`` as a DTensor leaf placed ``placement`` on
    the one mesh dim."""
    return DTensor.from_local(_shard(t, placement, rank).clone(), mesh, [placement],
                              run_check=False).requires_grad_()


def _shard(t, placement, rank):
    return t if placement == Replicate() else t.chunk(N_RANKS, dim=placement.dim)[rank]


def _check_grads(leaves, placements, want, out_placement, rank):
    """Each leaf's gradient: the shard of ``want`` it holds, placed as its
    leaf, or a partial sum where the output is sharded and the leaf whole."""
    for leaf, p, w in zip(leaves, placements, want):
        partial = out_placement != Replicate() and p == Replicate()
        assert tuple(leaf.grad.placements) == ((Partial(),) if partial else (p,))
        _close(leaf.grad.to_local(), _shard(w, p, rank), f"grad {p}")


# (q's placement, k's and v's, causal): the heads on model, or q's rows on
# model with the keys whole on every rank
FLASH_CASES = [(Shard(1), Shard(1), True), (Shard(2), Replicate(), True),
               (Shard(2), Replicate(), False), (Replicate(), Replicate(), True)]


@pytest.mark.parametrize("qp, kp, causal", FLASH_CASES)
@pytest.mark.parametrize("rank", range(N_RANKS))
def test_flash_attention_runs_each_ranks_shards(rank, qp, kp, causal):
    rng = np.random.default_rng(0)
    q, k, v = _rand(rng, 2, 4, 16, 8), _rand(rng, 2, 2, 16, 8), _rand(rng, 2, 2, 16, 8)
    want = mha_reference(q, k, v, causal=causal)
    keep = [slice(None)] * 4
    if qp != Replicate():
        n = q.shape[qp.dim] // N_RANKS
        keep[qp.dim] = slice(rank * n, (rank + 1) * n)
    keep = tuple(keep)
    g = _rand(rng, *want[keep].shape)
    with _as_rank(rank) as mesh:
        leaves = [_leaf(t, mesh, p, rank) for t, p in ((q, qp), (k, kp), (v, kp))]
        out = flash_attention(*leaves, causal)
        assert is_dtensor(out) and tuple(out.placements) == (qp,)
        _close(out.to_local(), want[keep], "output")
        (out.to_local() * g).sum().backward()
        want_grads = _grads(lambda *t: mha_reference(*t, causal=causal), (q, k, v), keep, g)
        _check_grads(leaves, (qp, kp, kp), want_grads, qp, rank)


@pytest.mark.parametrize("qp, kp", [(Shard(3), Shard(3)), (Shard(1), Replicate()),
                                    (Shard(2), Shard(2)), (Partial(), Partial())])
def test_flash_attention_refuses_other_placements(qp, kp):
    rng = np.random.default_rng(1)
    q, k = _rand(rng, 2, 4, 16, 8), _rand(rng, 2, 4, 16, 8)
    with _as_rank(0) as mesh:
        qd = DTensor.from_local(q, mesh, [qp], run_check=False)
        kd = DTensor.from_local(k, mesh, [kp], run_check=False)
        with pytest.raises(ValueError, match="do not run on local shards"):
            flash_attention(qd, kd, kd, True)


# x's placement -> dt's, A's, B's and C's: the batch or the heads on model
SSD_CASES = {"batch": (Shard(0), Shard(0), Replicate(), Shard(0)),
             "heads": (Shard(2), Shard(2), Shard(0), Replicate())}


@pytest.mark.parametrize("case", sorted(SSD_CASES))
@pytest.mark.parametrize("rank", range(N_RANKS))
def test_ssd_scan_runs_each_ranks_shards(rank, case):
    rng = np.random.default_rng(2)
    Bt, L, H, dh, N, chunk = 2, 16, 4, 4, 8, 8
    x, dt = _rand(rng, Bt, L, H, dh), torch.nn.functional.softplus(_rand(rng, Bt, L, H))
    A = -torch.exp(_rand(rng, H))
    B, C = _rand(rng, Bt, L, N), _rand(rng, Bt, L, N)
    y, S = ssd_chunked_batched(x, dt, A, B, C, chunk=chunk)
    xp, dtp, ap, bcp = SSD_CASES[case]
    n = (Bt if case == "batch" else H) // N_RANKS
    part = slice(rank * n, (rank + 1) * n)
    keep_y = (part,) if case == "batch" else (slice(None), slice(None), part)
    keep_s = (part,) if case == "batch" else (slice(None), part)
    g = _rand(rng, *y[keep_y].shape)
    with _as_rank(rank) as mesh:
        places = (xp, dtp, ap, bcp, bcp)
        leaves = [_leaf(t, mesh, p, rank) for t, p in zip((x, dt, A, B, C), places)]
        yd, sd = ssd_scan(*leaves, chunk=chunk)
        assert tuple(yd.placements) == (xp,)
        assert tuple(sd.placements) == ((Shard(0),) if case == "batch" else (Shard(1),))
        _close(yd.to_local(), y[keep_y], "y")
        _close(sd.to_local(), S[keep_s], "state")
        (yd.to_local() * g).sum().backward()
        want = _grads(lambda *t: ssd_chunked_batched(*t, chunk=chunk), (x, dt, A, B, C), keep_y,
                      g)
        _check_grads(leaves, places, want, xp, rank)


def test_ssd_scan_refuses_other_placements():
    rng = np.random.default_rng(3)
    x, dt, A = _rand(rng, 2, 16, 4, 4), _rand(rng, 2, 16, 4), _rand(rng, 4)
    B = _rand(rng, 2, 16, 8)
    with _as_rank(0) as mesh:
        d = lambda t, p: DTensor.from_local(t, mesh, [p], run_check=False)  # noqa: E731
        heads = (d(x, Shard(2)), d(dt, Shard(2)), d(A, Shard(0)))
        with pytest.raises(ValueError, match="B placed"):  # B sharded beside the heads
            ssd_scan(*heads, d(B, Shard(0)), d(B, Replicate()), chunk=8)
        with pytest.raises(ValueError, match="dt placed"):
            ssd_scan(heads[0], d(dt, Replicate()), heads[2], d(B, Replicate()),
                     d(B, Replicate()), chunk=8)
        with pytest.raises(ValueError, match="does not run on local shards"):
            ssd_scan(d(x, Shard(3)), *heads[1:], d(B, Replicate()), d(B, Replicate()), chunk=8)


@pytest.mark.parametrize("rank", range(N_RANKS))
def test_moe_expert_parallel_runs_each_ranks_experts(rank):
    from repro_torch.configs import get_reduced_config

    cfg = get_reduced_config("granite_moe_1b_a400m")
    p = moe.moe_init(torch.Generator().manual_seed(0), cfg)
    specs = moe._moe_specs(p)
    x = _rand(np.random.default_rng(4), 2, 4, cfg.d_model)
    paths = list(specs)
    whole = [moe._leaf(p, path) for path in paths]
    places = [Replicate() if specs[path][0] is None else Shard(specs[path][0])
              for path in paths]

    mine = [_shard(t, pl, rank) for t, pl in zip(whole, places)]

    def partial(x, *leaves):  # this rank's experts' term of the layer's output
        local = moe._with_leaves(dict(zip(paths, leaves)))
        local["router"]["w"] = local["router"]["w"].float()
        y = moe._moe_local(local, cfg, x.float().reshape(-1, x.shape[-1]), rank, N_RANKS,
                           cfg.compute_dtype)
        return y.reshape(x.shape).to(x.dtype)

    want = partial(x, *mine)
    g = _rand(np.random.default_rng(5), *want.shape)
    with _as_rank(rank) as mesh:
        xd = _leaf(x, mesh, Replicate(), rank)
        leaves = [_leaf(t, mesh, pl, rank) for t, pl in zip(whole, places)]
        y = moe.moe_apply(moe._with_leaves(dict(zip(paths, leaves))), cfg, xd, mesh=mesh)
        assert tuple(y.placements) == (Replicate(),)
        _close(y.to_local(), want, "output")
        (y.to_local() * g).sum().backward()
    want_grads = _grads(partial, [x] + mine, (slice(None),), g)
    # the router is whole on model: its gradient a partial sum; x's is summed
    # over model (an all-reduce, nothing moved in a fake world) by the
    # hint that places x whole there
    assert tuple(xd.grad.placements) == (Replicate(),)
    _close(xd.grad.to_local(), want_grads[0], "grad x")
    for leaf, pl, w in zip(leaves, places, want_grads[1:]):
        assert tuple(leaf.grad.placements) == ((Partial(),) if pl == Replicate() else (pl,))
        _close(leaf.grad.to_local(), w, f"grad {pl}")
