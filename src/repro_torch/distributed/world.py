"""Memory nodes as processes on one machine: start a ``torch.distributed``
world, run one function on every rank, and end it.

``join_from_env`` joins the world's group from a launcher's variables
(``torchrun``'s), the way ``launch/train.py`` and ``routing.
ProcessGroupMesh.from_env`` join one.

``spawn(fn, world_size, args, timeout=...)`` starts ``world_size``
processes by the ``spawn`` start method; each joins one process group over
a loopback TCP store on a free port (``init_process_group`` with
``tcp://127.0.0.1:<port>``), runs ``fn(rank, world_size, *args)`` and
leaves the group.  The caller waits at most ``timeout`` seconds: a rank
that raises ends the world (the others are terminated, wherever they
wait) and ``spawn`` raises ``RuntimeError`` with its traceback; a world
still running at the timeout is killed and ``spawn`` raises
``TimeoutError``.  Nothing is caught and passed over.

``all_gather`` and ``all_reduce_sum`` are the collectives of the port's
expert-parallel MoE (``models/moe.py``), through host copies where the
group is Gloo and the tensor on the card (``on_host``; a meta tensor stays
on meta), and differentiable where their input requires grad (a training
step's: the gather's backward is a reduce-scatter, which Gloo lacks).  ``broadcast_object``,
``broadcast`` and ``scatter`` carry rank 0's objects and tensors to the
other ranks of a Gloo group through the host: the call headers, arenas and
replica rows a served group's rank 0 sends the ranks that follow it
(``serving/memory_node.py``).

``first_ranks(n)`` is the process group of the world's ranks ``0 .. n - 1``,
the group a served traversal mesh of ``n`` memory nodes runs its
collectives on; the world (the default group) carries the served group's
call headers, so a world of ``2P`` ranks can serve on the first ``P`` and
cut over to all ``2P`` (or back) at a live reshard.

``fn`` must be importable by the new processes: a function at the top
level of a module, or of the script that calls ``spawn`` (which must then
guard its own work with ``if __name__ == "__main__"``).  Gloo runs on the
CPU and, through host copies, on CUDA tensors; NCCL refuses two ranks on
one card, so the ranks of a world on one card use Gloo.
"""

from __future__ import annotations

import datetime
import os
import socket
import time

import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def free_port() -> int:
    """A TCP port on the loopback interface that was free a moment ago."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


LAUNCHER_ENV = ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")


def join_from_env(backend: str = "gloo") -> bool:
    """Join the world's process group as a launcher (``torchrun``) sets it
    out: ``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR`` and ``MASTER_PORT``.  A
    process that already has a group (``spawn``'s ranks) keeps it.  Returns
    whether this process is in a group: False, and nothing joined, where
    none of the variables is set; a partial set raises."""
    if dist.is_initialized():
        return True
    env = os.environ
    have = [k for k in LAUNCHER_ENV if k in env]
    if not have:
        return False
    if len(have) < len(LAUNCHER_ENV):
        raise ValueError(f"the launcher's variables are partly set: {have} of {LAUNCHER_ENV}")
    dist.init_process_group(backend, init_method=f"tcp://{env['MASTER_ADDR']}:"
                            f"{env['MASTER_PORT']}", rank=int(env["RANK"]),
                            world_size=int(env["WORLD_SIZE"]))
    return True


def _rank_main(rank: int, fn, world_size: int, port: int, backend: str, timeout: float,
               args: tuple, launcher_env: bool = False) -> None:
    if launcher_env:  # as torchrun starts a rank: the variables set, no group joined
        os.environ.update(RANK=str(rank), LOCAL_RANK=str(rank), WORLD_SIZE=str(world_size),
                          LOCAL_WORLD_SIZE=str(world_size), MASTER_ADDR="127.0.0.1",
                          MASTER_PORT=str(port))
    else:
        dist.init_process_group(backend, init_method=f"tcp://127.0.0.1:{port}", rank=rank,
                                world_size=world_size,
                                timeout=datetime.timedelta(seconds=timeout))
    try:
        fn(rank, world_size, *args)
    finally:
        _FIRST.clear()
        if dist.is_initialized():
            dist.destroy_process_group()


def spawn(fn, world_size: int, args: tuple = (), *, timeout: float, backend: str = "gloo",
          launcher_env: bool = False):
    """Run ``fn(rank, world_size, *args)`` on ``world_size`` ranks of one
    process group and wait for them, at most ``timeout`` seconds (see the
    module's docstring).  With ``launcher_env`` each rank starts as
    ``torchrun`` starts one: the launcher's variables (``LAUNCHER_ENV``,
    ``LOCAL_RANK`` and ``LOCAL_WORLD_SIZE``) set and no group joined, for ``fn`` to join
    (``join_from_env``).  Returns the seconds the world took."""
    t0 = time.monotonic()
    ctx = mp.start_processes(_rank_main, args=(fn, world_size, free_port(), backend, timeout,
                                               tuple(args), launcher_env),
                             nprocs=world_size, join=False, start_method="spawn")
    try:
        while not ctx.join(timeout=0.2):
            if time.monotonic() - t0 > timeout:
                raise TimeoutError(f"a world of {world_size} ranks was still running after "
                                   f"{timeout:.0f} s; every rank was killed")
    except mp.ProcessRaisedException as e:
        raise RuntimeError(f"a rank of the world of {world_size} raised:\n{e}") from None
    except mp.ProcessExitedException as e:
        raise RuntimeError(f"a rank of the world of {world_size} exited: {e}") from None
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
            p.join()
    return time.monotonic() - t0


def on_host(t: torch.Tensor, group=None) -> bool:
    """Whether a collective on ``t`` over ``group`` goes through a host
    copy: a CUDA tensor on a Gloo group (Gloo's transport is the host's)."""
    return t.is_cuda and dist.get_backend(group) == dist.Backend.GLOO


def _all_gather(t: torch.Tensor, group=None) -> list:
    x = (t.cpu() if on_host(t, group) else t).contiguous()
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x, group=group)
    return [part.to(t.device) for part in parts]


def _all_reduce_sum(t: torch.Tensor, group=None) -> torch.Tensor:
    x = t.cpu().clone() if on_host(t, group) else t.clone()
    dist.all_reduce(x, op=dist.ReduceOp.SUM, group=group)
    return x.to(t.device)


class _AllGather(torch.autograd.Function):
    """``all_gather`` for autograd: the backward reduce-scatters the parts'
    gradients, each rank keeping the sum of its own part's (JAX's
    transpose of ``all_gather``, ``psum_scatter``)."""

    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        return tuple(_all_gather(t, group))

    @staticmethod
    def backward(ctx, *grads):
        out = torch.empty_like(grads[0])
        # reduce_scatter_single where this torch has it (reduce_scatter_tensor's new name)
        reduce_scatter = getattr(dist, "reduce_scatter_single", dist.reduce_scatter_tensor)
        reduce_scatter(out, torch.cat([g.contiguous() for g in grads]), group=ctx.group)
        return out, None


class _AllReduceSum(torch.autograd.Function):
    """``all_reduce_sum`` for autograd: the sum is replicated, so each
    rank's part takes the sum's gradient as it is (JAX's transpose of a
    ``psum`` whose result every rank holds)."""

    @staticmethod
    def forward(ctx, t, group):
        return _all_reduce_sum(t, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


def _needs_grad(t: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and t.requires_grad


def all_gather(t: torch.Tensor, group=None) -> list:
    """Every rank's ``t`` in rank order, on ``t``'s device; differentiable
    where ``t`` requires grad (the backward a reduce-scatter)."""
    if _needs_grad(t):
        return list(_AllGather.apply(t, group))
    return _all_gather(t, group)


def all_reduce_sum(t: torch.Tensor, group=None) -> torch.Tensor:
    """The sum of every rank's ``t``, a new tensor on ``t``'s device;
    differentiable where ``t`` requires grad."""
    if _needs_grad(t):
        return _AllReduceSum.apply(t, group)
    return _all_reduce_sum(t, group)


# n -> the process group of the world's ranks 0 .. n - 1, made once a world
_FIRST: dict = {}


def first_ranks(n: int):
    """The process group of the world's ranks ``0 .. n - 1``: None (the
    default group) when ``n`` is the world's size, else a ``dist.new_group``
    made on first use and kept for the world's life.  ``new_group`` is a
    collective of the whole world, so every rank calls this with the same
    ``n`` in the same order, member or not; a rank outside the group gets
    ``GroupMember.NON_GROUP_MEMBER``, on which ``dist.get_rank`` is -1."""
    if n == dist.get_world_size():
        return None
    if n not in _FIRST:
        _FIRST[n] = dist.new_group(list(range(n)))
    return _FIRST[n]


def _root(group=None) -> int:
    """The global rank of ``group``'s rank 0, the root of its broadcasts."""
    return 0 if group is None else dist.get_global_rank(group, 0)


def broadcast_object(obj=None, group=None):
    """Rank 0's ``obj`` (any picklable object; the others pass None) on
    every rank of ``group``."""
    box = [obj]
    dist.broadcast_object_list(box, src=_root(group), group=group)
    return box[0]


def broadcast(t: torch.Tensor | None, shape=None, dtype=None, group=None) -> torch.Tensor:
    """Rank 0's tensor ``t`` on every rank of a Gloo ``group``, on the host:
    rank 0 passes ``t``, the others its ``shape`` and ``dtype``."""
    x = t.cpu().contiguous() if t is not None else torch.empty(shape, dtype=dtype)
    dist.broadcast(x, src=_root(group), group=group)
    return x


def scatter(t: torch.Tensor | None, shape=None, dtype=None, group=None) -> torch.Tensor:
    """Rank ``r``'s ``r``-th of ``world_size`` equal row blocks of rank 0's
    ``t``, on the host, over a Gloo ``group``: rank 0 passes ``t``, the
    others the ``shape`` and ``dtype`` of their block.  No rank receives
    another's rows."""
    parts = None
    if t is not None:
        n = dist.get_world_size(group)
        if t.shape[0] % n:
            raise ValueError(f"{t.shape[0]} rows do not split into {n} equal blocks")
        parts = [b.cpu().contiguous() for b in t.chunk(n)]
        shape, dtype = parts[0].shape, parts[0].dtype
    x = torch.empty(shape, dtype=dtype)
    dist.scatter(x, parts, src=_root(group), group=group)
    return x
