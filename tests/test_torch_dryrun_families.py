"""The dry run's collective records on every model family: one reduced
config of each (dense, ssm, moe, hybrid, vlm, encdec) through
``launch.dryrun.run_cell`` on a fake (``data`` 4, ``model`` 2) mesh, its
``train_4k`` and ``decode_32k`` cut to 64 tokens and a batch of 8 (the
JAX tiny-mesh test's length; a batch the data axis divides).

  * the sharded run succeeds, makes nothing on a card and leaves no
    process group behind;
  * the collective term is > 0 (every reduced config shards its
    parameters on this mesh), with all-gathers over ``data`` (the FSDP
    gathers) and, in training, reduce-scatters over ``data``;
  * every other field equals ``rl.analyze`` of the cell's count
    (``count_step``, as the dry run counted before it recorded) without
    records.
"""

import dataclasses

import pytest
import torch
import torch.distributed as dist

from repro_torch.configs import SHAPES
from repro_torch.configs import get_reduced_config as tget
from repro_torch.launch import dryrun
from repro_torch.launch import roofline as rl
from repro_torch.launch.mesh import make_test_mesh
from repro_torch.launch.steps import build_step

FAMILIES = {"dense": "qwen3_0_6b", "ssm": "mamba2_780m", "moe": "granite_moe_1b_a400m",
            "hybrid": "zamba2_7b", "vlm": "internvl2_2b", "encdec": "whisper_large_v3"}
MESH = make_test_mesh((4, 2))
COLLECTIVE_FIELDS = {"collective_bytes", "collective_s", "collective_detail", "dominant", "note"}


def _small(name):
    shape = SHAPES[name]
    return dataclasses.replace(shape, seq_len=64, global_batch=8)


@pytest.mark.parametrize("shape_name", ["train_4k", "decode_32k"])
@pytest.mark.parametrize("family", FAMILIES)
def test_records_on_every_family(family, shape_name):
    arch = FAMILIES[family]
    cfg = tget(arch).replace(compute_dtype=torch.bfloat16)
    shape = _small(shape_name)
    reports, counter, _ = dryrun.run_cell(arch, shape_name, [MESH], cfg=cfg, shape=shape)
    got = reports[MESH.name]
    assert not isinstance(got, Exception), got
    assert not dist.is_initialized()
    assert got.collective_s > 0 and got.collective_bytes > 0
    counts = got.collective_detail["counts"]
    assert counts["all-gather"] > 0
    if shape.kind == "train":
        assert counts["reduce-scatter"] > 0

    _, args, in_sh = build_step(cfg, shape, MESH)
    want = rl.analyze(
        arch=arch, shape_name=shape_name, mesh_name=MESH.name, chips=MESH.size,
        cost={"flops": counter.flops / MESH.size,
              "bytes accessed": counter.total_bytes / MESH.size},
        bytes_per_device=dryrun.arg_bytes_per_device(args, in_sh),
        model_flops=rl.model_flops_for(cfg, shape))
    for field, value in want.to_json().items():
        if field not in COLLECTIVE_FIELDS:
            assert getattr(got, field) == value, field
    assert got.dominant == max([("compute", got.compute_s), ("memory", got.memory_s),
                                ("collective", got.collective_s)], key=lambda kv: kv[1])[0]


def test_records_name_the_axes():
    """Every record's group is a mesh axis of its size; the FSDP gathers
    are over ``data``."""
    cfg = tget("qwen3_0_6b").replace(compute_dtype=torch.bfloat16)
    rec = dryrun.record_collectives(cfg, _small("train_4k"), MESH)
    sizes = MESH.shape
    assert rec.records and rec.real_outputs == 0
    for kind, nbytes, n, axis in rec.records:
        assert kind in rl.KINDS and nbytes > 0 and n == sizes[axis]
    assert {("all-gather", "data"), ("reduce-scatter", "data"), ("all-reduce", "model")} <= {
        (k, a) for k, _, _, a in rec.records}


def test_fake_world_refuses_a_process_with_a_group_and_leaves_none():
    from repro_torch.launch.mesh import fake_world

    with fake_world(MESH) as dm:
        assert dist.get_world_size() == MESH.size and dm.mesh_dim_names == MESH.axis_names
        with pytest.raises(RuntimeError, match="already has a process group"):
            with fake_world(MESH):
                pass
    assert not dist.is_initialized()


def test_placements_follow_the_spec():
    from torch.distributed.tensor import Replicate, Shard

    from repro_torch.distributed.sharding import placements
    from repro_torch.launch.mesh import fake_world

    pod = make_test_mesh((2, 2, 2), ("pod", "data", "model"))
    with fake_world(pod) as dm:
        assert placements((("pod", "data"), "model"), dm) == [Shard(0), Shard(0), Shard(1)]
        assert placements((None, "data"), dm) == [Replicate(), Shard(1), Replicate()]
        assert placements((), dm) == [Replicate()] * 3
        with pytest.raises(ValueError, match="order"):
            placements((("data", "pod"),), dm)
