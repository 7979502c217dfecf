"""Port parity: the MoE's expert-parallel path (``models/moe.py`` under a
``torch.distributed`` ``DeviceMesh``) against the JAX package's
``shard_map`` body (``src/repro/models/moe.py:121-203``).

One MoE layer of reduced ``granite_moe_1b_a400m`` and of reduced
``kimi_k2_1t_a32b`` (which has a shared expert), the JAX init carried
across, on seeded tokens (4 x 16):

  * the port on Gloo worlds of the CPU (this file run as a script, ``python
    tests/test_torch_moe_ep.py world SHAPE IN.npz OUT_DIR``), one rank a
    device of a ``DeviceMesh`` of (``model`` 2) and of (``data`` 2,
    ``model`` 2): each rank cuts its shard (``shard_moe_params``) and runs
    ``moe_apply(..., mesh=)`` on its dp rank's tokens;
  * the JAX package's ``moe_apply`` on a ``jax.sharding.Mesh`` (its axes
    Auto: ``jax.make_mesh``'s Explicit axes break the reference's sharding
    hints) of 2 and of 4 host devices, in one subprocess (``python
    tests/test_torch_moe_ep.py jax OUT.npz``) with four host devices in its
    environment alone.

Tolerances, of each output's largest magnitude: 2e-5 against the JAX
package (``tests/test_torch_moe.py``'s: the same f32 arithmetic with sums
in another order); 1e-6 against the port's single-shard ``moe_apply`` (only
the order of the f32 partial sums differs).  A ``MeshSpec`` or no mesh
keeps the single-shard result bit for bit."""

import importlib.util
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.configs import get_reduced_config as tget
from repro_torch.distributed import world
from repro_torch.launch.mesh import make_test_mesh
from repro_torch.models import moe as tmoe

ROOT = Path(__file__).resolve().parents[1]
HAS_JAX = importlib.util.find_spec("jax") is not None
needs_jax = pytest.mark.skipif(not HAS_JAX, reason="needs the JAX package")
ARCHS = ["granite_moe_1b_a400m", "kimi_k2_1t_a32b"]
# (id, DeviceMesh shape, its dim names)
MESHES = [("model2", (2,), ("model",)), ("data2_model2", (2, 2), ("data", "model"))]
B, T = 4, 16
TOL_JAX = 2e-5
TOL_ONE = 1e-6
TIMEOUT = 90.0


def _leaves(p, prefix=()):
    for k, v in p.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _nest(flat):
    out = {}
    for path, v in flat.items():
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = v
    return out


def write_inputs(path):
    """Each arch's layer (the JAX init) and tokens, into ``path``."""
    import jax

    from repro.configs import get_reduced_config as jget
    from repro.models import moe as jmoe

    arrays = {}
    for i, arch in enumerate(ARCHS):
        jp = jmoe.moe_init(jax.random.PRNGKey(i), jget(arch))
        for leaf, v in _leaves(jp):
            arrays[f"{arch}/p/{'/'.join(leaf)}"] = np.asarray(v)
        arrays[f"{arch}/x"] = np.random.default_rng(i).standard_normal(
            (B, T, jget(arch).d_model)).astype(np.float32)
    np.savez(path, **arrays)


def _params(d, arch, torch_tensors=True):
    pre = f"{arch}/p/"
    flat = {tuple(k[len(pre):].split("/")): (torch.from_numpy(v) if torch_tensors else v)
            for k, v in d.items() if k.startswith(pre)}
    return _nest(flat)


def _world_rank(rank, world_size, shape, names, in_path, out_dir):
    from torch.distributed.device_mesh import init_device_mesh

    d = dict(np.load(in_path))
    mesh = init_device_mesh("cpu", shape, mesh_dim_names=names)
    arrays = {}
    dp = mesh["data"] if "data" in names else None
    dp_size, dp_rank = (dp.size(), dp.get_local_rank()) if dp is not None else (1, 0)
    for arch in ARCHS:
        cfg = tget(arch)
        mine = tmoe.shard_moe_params(_params(d, arch), mesh)
        x = torch.from_numpy(d[f"{arch}/x"])
        rows = B // dp_size
        y = tmoe.moe_apply(mine, cfg, x[dp_rank * rows:(dp_rank + 1) * rows], mesh=mesh)
        arrays[f"{arch}/y"] = y.numpy()
        for leaf, v in _leaves(mine):
            arrays[f"{arch}/shard/{'/'.join(leaf)}"] = v.numpy()
    arrays["coords"] = np.asarray([dp_rank, mesh["model"].get_local_rank()])
    np.savez(Path(out_dir) / f"rank{rank}.npz", **arrays)


def _jax_script(in_path, out_path):
    """Script mode: each arch's layer through the JAX package's
    ``moe_apply`` on meshes of 2 and of 4 host devices."""
    import jax
    import jax.numpy as jnp

    from repro.configs import get_reduced_config as jget
    from repro.models import moe as jmoe

    assert jax.device_count() == 4, jax.devices()
    d = dict(np.load(in_path))
    arrays = {}
    for mid, shape, names in MESHES:
        n = int(np.prod(shape))
        mesh = jax.sharding.Mesh(np.array(jax.devices()[:n]).reshape(shape), names)
        for arch in ARCHS:
            jp = jax.tree.map(jnp.asarray, _params(d, arch, torch_tensors=False))
            # jitted: the eager shard_map takes ~14 s a call on the CPU, compiled ~1 s
            run = jax.jit(lambda p, x, cfg=jget(arch), mesh=mesh: jmoe.moe_apply(
                p, cfg, x, mesh=mesh))
            arrays[f"{mid}/{arch}/y"] = np.asarray(run(jp, jnp.asarray(d[f"{arch}/x"])))
    np.savez(out_path, **arrays)


def _env(**extra):
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join([str(ROOT / "src"), env.get("PYTHONPATH", "")])
    env.update(extra)
    return env


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The JAX run and one Gloo world per mesh, started together as
    subprocesses, each waited for with a timeout."""
    if not HAS_JAX:
        pytest.skip("needs the JAX package")
    tmp = tmp_path_factory.mktemp("moe_ep")
    inputs = tmp / "inputs.npz"
    write_inputs(inputs)
    procs = {"jax": subprocess.Popen(
        [sys.executable, str(Path(__file__)), "jax", str(inputs), str(tmp / "jax.npz")],
        env=_env(XLA_FLAGS="--xla_force_host_platform_device_count=4", JAX_PLATFORMS="cpu"),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)}
    for mid, shape, names in MESHES:
        (tmp / mid).mkdir()
        procs[mid] = subprocess.Popen(
            [sys.executable, str(Path(__file__)), "world", mid, str(inputs), str(tmp / mid)],
            env=_env(), stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    for key, proc in procs.items():
        try:
            log, _ = proc.communicate(timeout=TIMEOUT + 60)
        except subprocess.TimeoutExpired:
            proc.kill()
            raise
        assert proc.returncode == 0, f"{key}:\n{log}"
    ranks = {mid: [dict(np.load(tmp / mid / f"rank{r}.npz"))
                   for r in range(int(np.prod(shape)))] for mid, shape, _ in MESHES}
    return dict(inputs=dict(np.load(inputs)), jax=dict(np.load(tmp / "jax.npz")), ranks=ranks)


def _gathered(ranks, arch):
    """The dp ranks' outputs in dp order (each model rank's equal), and
    every model rank's copy."""
    by_dp = {}
    for r in ranks:
        by_dp.setdefault(int(r["coords"][0]), []).append(r[f"{arch}/y"])
    return np.concatenate([by_dp[i][0] for i in sorted(by_dp)]), by_dp


def _close(got, want, tol):
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * max(1.0, float(np.abs(want).max())))


@needs_jax
@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("mesh", MESHES, ids=[m[0] for m in MESHES])
def test_expert_parallel_matches_the_jax_shard_map(mesh, arch, runs):
    """The dp ranks' outputs, in dp order, equal the JAX package's
    expert-parallel ``moe_apply`` within 2e-5 of the largest magnitude;
    every ``model`` rank of a dp rank holds the same sum, bit for bit."""
    y, by_dp = _gathered(runs["ranks"][mesh[0]], arch)
    for copies in by_dp.values():
        for c in copies[1:]:
            np.testing.assert_array_equal(c, copies[0])
    _close(y, runs["jax"][f"{mesh[0]}/{arch}/y"], TOL_JAX)


@needs_jax
@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("mesh", MESHES, ids=[m[0] for m in MESHES])
def test_expert_parallel_matches_the_single_shard_port(mesh, arch, runs):
    """Against the port's own single-shard ``moe_apply`` on the whole
    params, over each dp rank's tokens (a dp rank's capacity and drops are
    its own tokens', as in the reference): within 1e-6 of the largest
    magnitude."""
    d = runs["inputs"]
    _, shape, names = mesh
    x = torch.from_numpy(d[f"{arch}/x"])
    want = torch.cat([tmoe.moe_apply(_params(d, arch), tget(arch), part)
                      for part in x.chunk(shape[0] if "data" in names else 1)])
    y, _ = _gathered(runs["ranks"][mesh[0]], arch)
    _close(y, want.numpy(), TOL_ONE)


@needs_jax
@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("mesh", MESHES, ids=[m[0] for m in MESHES])
def test_shard_moe_params_cuts_as_the_jax_pspec(mesh, arch, runs):
    """Each rank's shard is its block of every leaf: the experts by range
    over ``model``, ``D`` over ``data``, the shared expert's ``F`` over
    ``model``; the blocks tile the whole leaf."""
    _, shape, names = mesh
    d = runs["inputs"]
    whole = dict(_leaves(_params(d, arch, torch_tensors=False)))
    axes = {("router", "w"): (None, 0), ("wi",): (0, 1), ("wg",): (0, 1), ("wo",): (0, 2),
            ("shared", "wi", "w"): (1, 0), ("shared", "wg", "w"): (1, 0),
            ("shared", "wo", "w"): (0, 1)}
    dp_n = shape[0] if "data" in names else 1
    for r in runs["ranks"][mesh[0]]:
        dp_i, m_i = (int(c) for c in r["coords"])
        for leaf, w in whole.items():
            got = r[f"{arch}/shard/{'/'.join(leaf)}"]
            want = w
            for axis, (n, i) in zip(axes[leaf], [(shape[-1], m_i), (dp_n, dp_i)]):
                if axis is not None:
                    size = w.shape[axis] // n
                    want = np.take(want, np.arange(i * size, (i + 1) * size), axis=axis)
            np.testing.assert_array_equal(got, want, err_msg="/".join(leaf))
    assert ("shared", "wi", "w") in whole or arch == "granite_moe_1b_a400m"


@needs_jax
@pytest.mark.parametrize("arch", ARCHS)
def test_mesh_spec_or_none_keeps_the_single_shard_path(arch, tmp_path):
    """``mesh=None`` and the dry run's ``MeshSpec`` (even one with a
    ``model`` axis of 8) give the same tensor, bit for bit."""
    write_inputs(tmp_path / "inputs.npz")
    d = dict(np.load(tmp_path / "inputs.npz"))
    p, x, cfg = _params(d, arch), torch.from_numpy(d[f"{arch}/x"]), tget(arch)
    base = tmoe.moe_apply(p, cfg, x)
    for mesh in (None, make_test_mesh((32, 8)), make_test_mesh((2, 32, 8),
                                                               ("pod", "data", "model"))):
        assert torch.equal(tmoe.moe_apply(p, cfg, x, mesh=mesh), base)


def _main():
    if sys.argv[1] == "world":
        mid, shape, names = next(m for m in MESHES if m[0] == sys.argv[2])
        world.spawn(_world_rank, int(np.prod(shape)), (shape, names, sys.argv[3], sys.argv[4]),
                    timeout=TIMEOUT)
        print(json.dumps({"mesh": mid, "ok": True}))
    else:
        _jax_script(sys.argv[2], sys.argv[3])


if __name__ == "__main__":
    _main()
