"""The dry run's collective records (``launch.dryrun.CollectiveRecorder``)
against the reference's HLO parser and against a real process group.

  * three small programs on a mesh of (``data`` 4, ``model`` 2): a forward
    whose weight is FSDP-sharded on ``data``, a row-parallel linear whose
    partial sums are all-reduced on ``model``, and the FSDP gradient
    (``value_and_grad`` of the forward's sum).  The JAX package's side is
    compiled for 8 host devices in one subprocess (this file run as a
    script, ``python tests/test_torch_dryrun_collectives.py jax``, with
    ``XLA_FLAGS`` in its environment alone) on a ``jax.sharding.Mesh``
    with Auto axes, and parsed by ``repro.launch.roofline.
    collective_wire_bytes``; the port's runs the same programs as DTensors
    on a fake world of 8 (``launch.mesh.fake_world``) through the port's
    ``dense_apply``, ``shard_hint`` and ``settle``.  Each kind's count and
    ring wire bytes are equal, but for the FSDP gradient, which DTensor
    reduce-scatters and XLA:CPU all-reduces (``DEPARTURES``: both sides'
    records asserted);
  * a real world of 4 Gloo ranks on the CPU (``data`` 2, ``model`` 2;
    ``distributed.world.spawn``) runs reduced ``qwen3_0_6b``'s train step
    sharded as DTensors: every rank's records equal the fake world's in
    order, kind, bytes and group, and the loss and every updated parameter
    (``full_tensor()``) are within 1e-5 of the largest magnitude of the
    unsharded step's.
"""

import importlib.util
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.configs import SHAPES
from repro_torch.configs import get_reduced_config as tget
from repro_torch.distributed import world
from repro_torch.launch import dryrun
from repro_torch.launch import roofline as trl
from repro_torch.launch.mesh import fake_world, make_test_mesh

ROOT = Path(__file__).resolve().parents[1]
HAS_JAX = importlib.util.find_spec("jax") is not None
needs_jax = pytest.mark.skipif(not HAS_JAX, reason="needs the JAX package")
B, D, F = 8, 16, 32
PROGRAMS = ("fsdp_forward", "row_parallel", "fsdp_grad")
TIMEOUT = 120.0
TOL = 1e-5


def _inputs():
    rng = np.random.default_rng(0)
    return {"x": rng.standard_normal((B, D)).astype(np.float32),
            "xf": rng.standard_normal((B, F)).astype(np.float32),
            "w": rng.standard_normal((D, F)).astype(np.float32),
            "wr": rng.standard_normal((F, D)).astype(np.float32)}


def _jax_script(out_path):
    """Script mode: the three programs compiled for 8 host devices, each
    program's collectives by the reference's parser."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh, NamedSharding
    from jax.sharding import PartitionSpec as P

    from repro.launch import roofline as jrl

    assert jax.device_count() == 8, jax.devices()
    mesh = Mesh(np.array(jax.devices()).reshape(4, 2), ("data", "model"))
    sh = lambda *spec: NamedSharding(mesh, P(*spec))  # noqa: E731
    d = {k: jnp.asarray(v) for k, v in _inputs().items()}

    def loss(w, x):
        return (x @ w).sum()

    progs = {
        "fsdp_forward": (lambda x, w: x @ w, (d["x"], d["w"]),
                         (sh("data", None), sh("data", None)), sh("data", None)),
        "row_parallel": (lambda x, w: x @ w, (d["xf"], d["wr"]),
                         (sh("data", "model"), sh("model", None)), sh("data", None)),
        "fsdp_grad": (jax.value_and_grad(loss), (d["w"], d["x"]),
                      (sh("data", None), sh("data", None)), (sh(), sh("data", None))),
    }
    out = {}
    for name, (fn, args, in_sh, out_sh) in progs.items():
        hlo = jax.jit(fn, in_shardings=in_sh, out_shardings=out_sh).lower(*args).compile()
        out[name] = jrl.collective_wire_bytes(hlo.as_text())
    Path(out_path).write_text(json.dumps(out))


def _port_records(name):
    """One program as DTensors on a fake world of 8 -> its records."""
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    from repro_torch.distributed.sharding import settle, shard_hint
    from repro_torch.models.common import dense_apply

    d = {k: torch.from_numpy(v).to("meta") for k, v in _inputs().items()}
    with fake_world(make_test_mesh((4, 2))) as dm:
        place = lambda t, *p: distribute_tensor(t, dm, list(p))  # noqa: E731
        with dryrun.CollectiveRecorder(dm) as rec:
            if name == "fsdp_forward":
                x, w = place(d["x"], Shard(0), Replicate()), place(d["w"], Shard(0), Replicate())
                shard_hint(dense_apply({"w": w}, x, torch.float32), dm, "dp", None)
            elif name == "row_parallel":
                x = place(d["xf"], Shard(0), Shard(1))
                w = place(d["wr"], Replicate(), Shard(0))
                shard_hint(dense_apply({"w": w}, x, torch.float32), dm, "dp", None)
            else:
                x = place(d["x"], Shard(0), Replicate())
                w = place(d["w"], Shard(0), Replicate()).requires_grad_()
                loss = settle(dense_apply({"w": w}, x, torch.float32).sum())
                (g,) = torch.autograd.grad(loss, [w])
                assert list(g.placements) == [Shard(0), Replicate()]
    return rec.records


def _env(**extra):
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join([str(ROOT / "src"), env.get("PYTHONPATH", "")])
    env.update(extra)
    return env


# Where XLA picks another collective: the FSDP gradient.  DTensor
# reduce-scatters it onto the weight's shards; XLA:CPU all-reduces the whole
# gradient (then slices it), twice the ring bytes, in one all-reduce with
# the loss.  Each side's records, as (kind, count, ring wire bytes): the
# forward's gather, the loss's all-reduce (a scalar over data), the gradient.
GRAD_W = D * F * 4  # the whole gradient's bytes
LOSS_AR = 2 * 4 * 3 / 4
DEPARTURES = {"fsdp_grad": {
    "port": {"all-gather": (1, GRAD_W * 3 / 4), "all-reduce": (1, LOSS_AR),
             "reduce-scatter": (1, GRAD_W / 4 * 3)},
    "jax": {"all-gather": (1, GRAD_W * 3 / 4), "all-reduce": (1, LOSS_AR + 2 * GRAD_W * 3 / 4),
            "reduce-scatter": (0, 0.0)}}}


def _by_kind(parsed):
    return {k: (parsed["counts"][k], parsed[k]) for k in trl.KINDS
            if parsed["counts"][k] or parsed[k]}


@needs_jax
@pytest.mark.parametrize("name", PROGRAMS)
def test_records_equal_the_reference_parser(name, jax_parsed):
    got = trl.collective_wire_bytes(_port_records(name))
    want = jax_parsed[name]
    assert got["total"] > 0
    if name in DEPARTURES:
        assert _by_kind(got) == {k: v for k, v in DEPARTURES[name]["port"].items() if v[0]}
        assert _by_kind(want) == {k: v for k, v in DEPARTURES[name]["jax"].items() if v[0]}
        return
    assert got["counts"] == want["counts"], (got, want)
    for kind in trl.KINDS + ("total",):
        assert got[kind] == pytest.approx(want[kind], rel=1e-12), kind


# ---------------------------- a real process group ----------------------------

MESH = make_test_mesh((2, 2))


def _small_train():
    shape = SHAPES["train_4k"]
    return tget("qwen3_0_6b"), type(shape)(shape.name, seq_len=32, global_batch=4, kind="train")


def _world_rank(rank, world_size, out_dir):
    """The sharded step on this rank of a real (data 2, model 2) mesh."""
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.distributed.checkpoint import tree_leaves
    from repro_torch.launch.steps import build_step, distribute_step_args

    cfg, shape = _small_train()
    dm = init_device_mesh("cpu", MESH.axis_sizes, mesh_dim_names=MESH.axis_names)
    step, args, in_sh = build_step(cfg, shape, MESH, device="cpu", device_mesh=dm)
    args = distribute_step_args(args, in_sh, dm)
    with dryrun.CollectiveRecorder(dm) as rec, implicit_replication():
        state, metrics = step(*args)
    params = [p.full_tensor().numpy() for p in tree_leaves(state["params"])]
    loss = float(metrics["loss"].full_tensor())
    if rank == 0:
        np.savez(Path(out_dir) / "params.npz", *params)
    (Path(out_dir) / f"rank{rank}.json").write_text(json.dumps(
        {"records": rec.records, "loss": loss}))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The JAX subprocess, started first, and the real world beside it."""
    tmp = tmp_path_factory.mktemp("coll")
    jax_proc = subprocess.Popen(
        [sys.executable, str(Path(__file__)), "jax", str(tmp / "jax.json")],
        env=_env(XLA_FLAGS="--xla_force_host_platform_device_count=8", JAX_PLATFORMS="cpu"),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True) if HAS_JAX else None
    try:
        world.spawn(_world_rank, MESH.size, (str(tmp),), timeout=TIMEOUT)
    finally:
        log = jax_proc.communicate(timeout=TIMEOUT)[0] if jax_proc else ""
    ranks = [json.loads((tmp / f"rank{r}.json").read_text()) for r in range(MESH.size)]
    with np.load(tmp / "params.npz") as z:
        params = [z[f"arr_{i}"] for i in range(len(z.files))]
    return dict(jax=jax_proc and (jax_proc.returncode, log, tmp / "jax.json"),
                ranks=ranks, params=params)


@pytest.fixture(scope="module")
def jax_parsed(runs):
    code, log, path = runs["jax"]
    assert code == 0, log
    return json.loads(path.read_text())


def test_real_world_records_equal_the_fake_worlds(runs):
    ranks = runs["ranks"]
    cfg, shape = _small_train()
    fake = [list(r) for r in dryrun.record_collectives(cfg, shape, MESH, "cpu").records]
    assert not torch.distributed.is_initialized()  # fake_world leaves no group
    assert fake and {k for k, *_ in fake} >= {"all-gather", "reduce-scatter", "all-reduce"}
    for r in ranks:
        assert r["records"] == fake


def test_sharded_step_matches_the_unsharded_one(runs):
    from repro_torch.distributed.checkpoint import tree_leaves
    from repro_torch.launch.steps import build_step

    ranks, params = runs["ranks"], runs["params"]
    cfg, shape = _small_train()
    step, args, _ = build_step(cfg, shape, MESH, device="cpu")
    state, metrics = step(*args)
    want = float(metrics["loss"])
    for r in ranks:
        assert abs(r["loss"] - want) <= TOL * max(1.0, abs(want))
    leaves = tree_leaves(state["params"])
    assert len(leaves) == len(params)
    for got, w in zip(params, leaves):
        w = w.detach().float().numpy()
        np.testing.assert_allclose(got, w, rtol=0, atol=TOL * max(1.0, float(np.abs(w).max())))


if __name__ == "__main__":
    _jax_script(sys.argv[2])
