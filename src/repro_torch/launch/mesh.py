"""Production meshes, shaped for H100 nodes.

A mesh here is a description: axis names and sizes (``MeshSpec``), what the
sharding rules and the dry run read.  ``fake_world`` makes one real for a
dry run: a ``DeviceMesh`` over a fake process group, this process its rank
0, on which DTensor issues every collective and none does any work.
Single pod: (data 32, model 8) = 256 GPUs, the model axis inside one
NVLink domain of eight.  Multi-pod: (pod 2, data 32, model 8) = 512 GPUs;
DP/FSDP spans (pod, data), across nodes.  The reference's TPU meshes,
(16, 16) and (2, 16, 16), stay reachable through ``make_test_mesh``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math

import torch


@dataclasses.dataclass(frozen=True)
class MeshSpec:
    axis_sizes: tuple[int, ...]
    axis_names: tuple[str, ...]

    @property
    def shape(self) -> dict:
        """Axis name -> size, as ``jax.sharding.Mesh.shape``."""
        return dict(zip(self.axis_names, self.axis_sizes))

    @property
    def size(self) -> int:
        return math.prod(self.axis_sizes)

    @property
    def name(self) -> str:
        return "x".join(str(n) for n in self.axis_sizes)


def make_production_mesh(*, multi_pod: bool = False) -> MeshSpec:
    if multi_pod:
        return MeshSpec((2, 32, 8), ("pod", "data", "model"))
    return MeshSpec((32, 8), ("data", "model"))


def make_test_mesh(shape=(1, 1), axes=("data", "model")) -> MeshSpec:
    """Any mesh by shape and names; by default one device."""
    return MeshSpec(tuple(shape), tuple(axes))


@contextlib.contextmanager
def fake_world(mesh: MeshSpec, device_type: str = "cuda"):
    """A ``DeviceMesh`` of ``mesh``'s names and sizes over a fake process
    group of ``mesh.size`` ranks, this process rank 0: the reference's
    placeholder devices.  Collectives on it return tensors of the right
    shape and move nothing.  ``device_type`` is the cards' the mesh stands
    for (DTensor picks its collectives by it: on ``"cpu"`` an all-to-all
    is an all-gather and a chunk).  Refuses to start in a process that has
    a process group, and leaves none behind."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh
    from torch.testing._internal.distributed.fake_pg import FakeStore  # registers "fake"

    if dist.is_initialized():
        raise RuntimeError("fake_world: this process already has a process group")
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=mesh.size)
    try:
        yield DeviceMesh(device_type, torch.arange(mesh.size).reshape(mesh.axis_sizes),
                         mesh_dim_names=mesh.axis_names)
    finally:
        dist.destroy_process_group()
