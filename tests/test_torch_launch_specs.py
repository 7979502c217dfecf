"""Port parity: the launch tooling's shapes and shardings against the JAX
package's, at full width and with no allocation.

  * ``SHAPES``, ``SKIPPED_CELLS`` and ``all_cells`` equal the JAX
    package's (39 cells);
  * ``param_specs`` for all ten configs at full width on the meshes
    (1, 1), (16, 16), (2, 16, 16), (32, 8) and (2, 32, 8), the port's meta
    params mapped to the JAX layout by shape (``shapes_to_jax``) against
    the JAX ``param_specs`` of ``jax.eval_shape``'s params on an
    ``AbstractMesh``;
  * ``opt_state_specs`` and ``steps._opt_shardings`` (AdamW; Adafactor
    through kimi_k2_1t_a32b) against the ``.spec`` of the JAX shardings;
  * ``batch_sharding``, ``cache_sharding`` (long_500k's batch-1 branch
    included) and ``decode_inputs`` on every cell;
  * ``shard_hint``'s resolved axes against what the reference's hint
    hands ``with_sharding_constraint``.
"""

import dataclasses
import functools

import pytest
import torch

import jax
from jax.sharding import AbstractMesh, PartitionSpec

from repro import configs as jconfigs
from repro.distributed import sharding as jsharding
from repro.launch import specs as jspecs
from repro.launch import steps as jsteps
from repro.models.model_zoo import build_model as jbuild
from repro.training import optimizer as jopt
from repro_torch import configs as tconfigs
from repro_torch.distributed import sharding as tsharding
from repro_torch.launch import specs as tspecs
from repro_torch.launch import steps as tsteps
from repro_torch.launch.mesh import make_production_mesh, make_test_mesh
from repro_torch.models import attention as tattention
from repro_torch.models import transformer as ttransformer
from repro_torch.models.model_zoo import build_model, jax_layout, shapes_to_jax

MESHES = [((1, 1), ("data", "model")), ((16, 16), ("data", "model")),
          ((2, 16, 16), ("pod", "data", "model")), ((32, 8), ("data", "model")),
          ((2, 32, 8), ("pod", "data", "model"))]
ARCHS = tconfigs.ARCH_IDS


def _jtuples(tree):
    """A JAX tree of PartitionSpecs (or shardings) as tuples."""
    def one(x):
        return tuple(x.spec if hasattr(x, "spec") else x)
    return jax.tree.map(one, tree, is_leaf=lambda x: isinstance(x, PartitionSpec)
                        or hasattr(x, "spec"))


def _tspecs(tree):
    return tsharding.map_with_path(lambda _p, x: x.spec if hasattr(x, "spec") else x, tree)


def _stack_specs(specs):
    """A layer stack's per-layer specs as the stacked leaf's spec: the
    leading axis unsharded; a bare ``()`` (``P()``, replicated whatever
    the rank) stays ``()``."""
    assert all(s == specs[0] for s in specs)
    return specs[0] and (None,) + specs[0]


def _to_jax(cfg, spec_tree):
    return jax_layout(cfg, spec_tree, lambda s: s, _stack_specs)


@functools.lru_cache(maxsize=None)
def _jax_state(arch):
    cfg = jconfigs.get_config(arch)
    params = jax.eval_shape(lambda: jbuild(cfg).init(jax.random.PRNGKey(0)))
    ocfg = jopt.OptimizerConfig(name=cfg.optimizer)
    return params, jax.eval_shape(lambda: jopt.opt_init(ocfg, params))


@functools.lru_cache(maxsize=None)
def _port_state(arch):
    cfg = tconfigs.get_config(arch)
    state, _ = tspecs.train_state_struct(cfg)
    return state


def test_shapes_and_cells_equal_the_reference():
    assert list(tconfigs.SHAPES) == list(jconfigs.SHAPES)
    for name, shape in tconfigs.SHAPES.items():
        assert dataclasses.astuple(shape) == dataclasses.astuple(jconfigs.SHAPES[name])
    assert tconfigs.SKIPPED_CELLS == jconfigs.SKIPPED_CELLS
    assert tconfigs.all_cells() == jconfigs.all_cells()
    assert tconfigs.all_cells(include_skipped=True) == jconfigs.all_cells(include_skipped=True)
    assert len(tconfigs.all_cells()) == 39


def test_production_meshes():
    single, multi = make_production_mesh(), make_production_mesh(multi_pod=True)
    assert single.shape == {"data": 32, "model": 8} and single.size == 256
    assert multi.shape == {"pod": 2, "data": 32, "model": 8} and multi.size == 512
    assert (single.name, multi.name) == ("32x8", "2x32x8")
    tpu = make_test_mesh((16, 16))
    assert tpu.axis_names == ("data", "model") and tpu.size == 256


@pytest.mark.parametrize("arch", ARCHS)
def test_param_and_opt_specs_equal_the_reference_at_full_width(arch):
    cfg = tconfigs.get_config(arch)
    jparams, jopt_state = _jax_state(arch)
    state = _port_state(arch)
    leaves = [t for t in torch.utils._pytree.tree_leaves(state)]
    assert leaves and all(t.is_meta for t in leaves)
    assert shapes_to_jax(cfg, state["params"]) == jax.tree.map(lambda s: tuple(s.shape), jparams)
    for shape, axes in MESHES:
        jmesh, tmesh = AbstractMesh(shape, axes), make_test_mesh(shape, axes)
        jp = jsharding.param_specs(jparams, jmesh)
        tp = tsharding.param_specs(state["params"], tmesh)
        assert _to_jax(cfg, tp) == _jtuples(jp), (shape, axes)
        assert (_to_jax(cfg, tsharding.opt_state_specs(state["opt"], tp))
                == _jtuples(jsharding.opt_state_specs(jopt_state, jp)))
        assert (_to_jax(cfg, _tspecs(tsteps._opt_shardings(state["opt"], tp, tmesh)))
                == _jtuples(jsteps._opt_shardings(jopt_state, jp, jmesh)))
        assert (_to_jax(cfg, _tspecs(tsharding.param_shardings(state["params"], tmesh)))
                == _jtuples(jsharding.param_shardings(jparams, jmesh)))
    if cfg.optimizer == "adafactor":  # the factored statistics' own axes were compared
        assert any("vr" in str(p) for p, _ in
                   jax.tree_util.tree_flatten_with_path(jopt_state["v"])[0])


@pytest.mark.parametrize("arch", ARCHS)
def test_batch_cache_and_decode_shardings_equal_the_reference(arch):
    tcfg, jcfg = tconfigs.get_config(arch), jconfigs.get_config(arch)
    for shape_name, shape in tconfigs.SHAPES.items():
        jshape = jconfigs.SHAPES[shape_name]
        tbatch = tspecs.batch_struct(tcfg, shape)
        jbatch = jspecs.batch_struct(jcfg, jshape)
        assert {k: tuple(v.shape) for k, v in tbatch.items()} == {
            k: tuple(v.shape) for k, v in jbatch.items()}
        decode = shape.kind == "decode" and (arch, shape_name) not in tconfigs.SKIPPED_CELLS
        if decode:
            tcache = tspecs.cache_struct(tcfg, shape)
            jcache = jspecs.cache_struct(jcfg, jshape)
            assert {k: tuple(v.shape) for k, v in tcache.items()} == {
                k: tuple(v.shape) for k, v in jcache.items()}
            assert all(v.is_meta for v in tcache.values())
        for mesh_shape, axes in MESHES:
            jmesh, tmesh = AbstractMesh(mesh_shape, axes), make_test_mesh(mesh_shape, axes)
            assert (_tspecs(tspecs.batch_sharding(tcfg, tbatch, tmesh))
                    == _jtuples(jspecs.batch_sharding(jcfg, jbatch, jmesh)))
            assert (tsharding.batch_specs(tbatch, tmesh)
                    == _jtuples(jsharding.batch_specs(jbatch, jmesh)))
            if not decode:
                continue
            assert (_tspecs(tspecs.cache_sharding(tcfg, tcache, tmesh))
                    == _jtuples(jspecs.cache_sharding(jcfg, jcache, jmesh)))
            (tt, tpos), (ts, tps) = tspecs.decode_inputs(tcfg, shape, tmesh)
            (jt, jpos), (js, jps) = jspecs.decode_inputs(jcfg, jshape, jmesh)
            assert (tuple(tt.shape), tuple(tpos.shape)) == (tuple(jt.shape), tuple(jpos.shape))
            assert (ts.spec, tps.spec) == (tuple(js.spec), tuple(jps.spec))


def test_long_500k_shards_the_sequence_over_dp_and_model():
    cfg = tconfigs.get_config("qwen3_0_6b")
    cache = tspecs.cache_struct(cfg, tconfigs.SHAPES["long_500k"])
    sh = tspecs.cache_sharding(cfg, cache, make_production_mesh(multi_pod=True))
    assert sh["k"].spec == (None, None, ("pod", "data", "model"), None, None)
    assert sh["k"].shard_shape(cache["k"].shape)[2] == 524288 // 512


HINTS = [
    ((4, 128, 16, 64), ("dp", None, "model", None)),
    ((4, 128, 20, 64), ("dp", "model", None, None)),
    ((2, 7, 20, 64), ("dp", None, "model", None)),
    ((64, 512, 1024), ("dp", None, None)),
    ((3, 512, 151936), ("dp", None, "model")),
    ((64, 8), (("pod", "data"), "model")),
    ((64, 8), ("pod", None)),
    ((1, 32), ("dp", "model")),
]


@pytest.mark.parametrize("mesh_shape,axes", MESHES)
def test_shard_hint_resolves_as_the_reference(mesh_shape, axes, monkeypatch):
    seen = []
    monkeypatch.setattr(jax.lax, "with_sharding_constraint",
                        lambda x, sharding: seen.append(tuple(sharding.spec)) or x)
    jmesh, tmesh = AbstractMesh(mesh_shape, axes), make_test_mesh(mesh_shape, axes)
    for shape, hint in HINTS:
        seen.clear()
        jsharding.shard_hint(jax.ShapeDtypeStruct(shape, "float32"), jmesh, *hint)
        assert tsharding.hint_axes(shape, tmesh, *hint) == seen[0], (shape, hint)
        x = torch.empty(shape, device="meta")
        assert tsharding.shard_hint(x, tmesh, *hint) is x
    # no mesh, or a rank that is not the hint's: the identity in both
    seen.clear()
    jsharding.shard_hint(jax.ShapeDtypeStruct((4, 8), "float32"), jmesh, "dp")
    jsharding.shard_hint(jax.ShapeDtypeStruct((4, 8), "float32"), None, "dp", None)
    assert seen == []
    assert tsharding.hint_axes((4, 8), tmesh, "dp") is None
    assert tsharding.hint_axes((4, 8), None, "dp", None) is None


def test_build_model_threads_the_mesh_to_the_hints(monkeypatch):
    """A prefill on a mesh hints what the reference's prefill hints."""
    asked = []

    def spy(x, mesh_, *axes):
        assert mesh_ is mesh
        asked.append(tsharding.hint_axes(tuple(x.shape), mesh_, *axes))
        return x

    for mod in (tattention, ttransformer):
        monkeypatch.setattr(mod, "shard_hint", spy)
    cfg = tconfigs.get_reduced_config("qwen3_0_6b")
    mesh = make_test_mesh((1, 1))
    model = build_model(cfg, mesh=mesh)
    params = model.init(torch.Generator().manual_seed(0), device="meta")
    toks = torch.empty((2, 16), dtype=torch.int32, device="meta")
    model.prefill(params, {"tokens": toks}, 16)
    # per layer: the block's input, then q, k and v
    assert len(asked) == 4 * cfg.n_layers and all(a is not None for a in asked)
