"""Production meshes, shaped for H100 nodes.

A mesh here is a description: axis names and sizes (``MeshSpec``), what the
sharding rules and the dry run read.  Nothing creates a process group.
Single pod: (data 32, model 8) = 256 GPUs, the model axis inside one
NVLink domain of eight.  Multi-pod: (pod 2, data 32, model 8) = 512 GPUs;
DP/FSDP spans (pod, data), across nodes.  The reference's TPU meshes,
(16, 16) and (2, 16, 16), stay reachable through ``make_test_mesh``.
"""

from __future__ import annotations

import dataclasses
import math


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
