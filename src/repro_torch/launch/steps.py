"""Step builders for the dry run and the launchers.

``build_step(cfg, shape, mesh)`` returns ``(step_fn, example_args,
in_shardings)``:
  * train   -> train_step(state, batch)  (loss, grads, optimizer update)
  * prefill -> prefill_step(params, batch) -> logits
  * decode  -> serve_step(params, cache, tokens, pos) -> (logits, cache)
The step functions are the port's ``make_train_step``, ``Model.prefill``
and ``Model.decode_step``, unchanged.  ``example_args`` are meta tensors
(the dry run's; the reference's ``ShapeDtypeStruct`` stand-ins) unless a
device is given: then real ones, drawn from ``seed``.  ``device_mesh`` (a
``torch.distributed`` ``DeviceMesh`` with ``mesh``'s names and sizes) goes
to the model in place of ``mesh``: its sharding hints then redistribute
DTensors, and the MoE runs its expert-parallel body.
``distribute_step_args`` places the arguments on that mesh as
``in_shardings`` say, for the step run as DTensors.
"""

from __future__ import annotations

from repro_torch.configs import ArchConfig, ShapeSpec
from torch.utils._pytree import tree_flatten, tree_unflatten

from repro_torch.distributed.sharding import (
    NamedSharding,
    map_with_path,
    param_specs,
    placements,
    shardings,
)
from repro_torch.launch import specs as S
from repro_torch.models.model_zoo import build_model
from repro_torch.training.train_loop import TrainConfig, make_train_step


def _opt_shardings(opt_state, pspecs, mesh):
    """Optimizer state shardings mirror the params'.  Adafactor's factored
    statistics drop one axis of the param: vr (the mean over the last axis)
    the spec's last entry, vc (over the second-to-last) its second-to-last.
    Replicating them instead makes the gradients replicated too (the
    reference's finding on kimi-k2 train_4k: 107 GB a device a layer of
    all-reduce)."""

    def get(tree, path):
        for k in path:
            tree = tree[k]
        return tree

    out = {}
    for k, v in opt_state.items():
        if k == "step":
            out[k] = ()
        elif k in ("mu", "nu"):
            out[k] = pspecs
        elif k == "v":  # adafactor: a dict of statistics at each param leaf
            def stat_spec(path, spec, v=v):
                if "vr" in get(v, path):
                    return {"vr": spec[:-1], "vc": spec[:-2] + spec[-1:]}
                return {"v": spec}

            out[k] = map_with_path(stat_spec, pspecs)
        else:
            out[k] = map_with_path(lambda _p, _leaf: (), v)
    return shardings(out, mesh)


def build_step(cfg: ArchConfig, shape: ShapeSpec, mesh, *, device="meta", seed: int = 0,
               device_mesh=None):
    model = build_model(cfg, mesh=mesh if device_mesh is None else device_mesh)

    if shape.kind == "train":
        state, ocfg = S.train_state_struct(cfg, model, device=device, seed=seed)
        step = make_train_step(model, TrainConfig(opt=ocfg))
        batch = S.batch_struct(cfg, shape, device=device, seed=seed + 1)
        pspecs = param_specs(state["params"], mesh)
        in_sh = (
            {"params": shardings(pspecs, mesh),
             "opt": _opt_shardings(state["opt"], pspecs, mesh)},
            S.batch_sharding(cfg, batch, mesh),
        )
        return step, (state, batch), in_sh

    if shape.kind == "prefill":
        params = model.init(S.generator(device, seed), device=device)
        batch = S.batch_struct(cfg, shape, device=device, seed=seed + 1)

        def prefill_step(params, batch):
            logits, _cache = model.prefill(params, batch, shape.seq_len)
            return logits

        in_sh = (shardings(param_specs(params, mesh), mesh), S.batch_sharding(cfg, batch, mesh))
        return prefill_step, (params, batch), in_sh

    if shape.kind == "decode":
        params = model.init(S.generator(device, seed), device=device)
        cache = S.cache_struct(cfg, shape, device=device)
        (tok, pos), (tok_sh, pos_sh) = S.decode_inputs(cfg, shape, mesh, device=device,
                                                       seed=seed)

        def serve_step(params, cache, tokens, pos):
            return model.decode_step(params, cache, tokens, pos)

        in_sh = (
            shardings(param_specs(params, mesh), mesh),
            S.cache_sharding(cfg, cache, mesh),
            tok_sh,
            pos_sh,
        )
        return serve_step, (params, cache, tok, pos), in_sh

    raise ValueError(shape.kind)


def distribute_step_args(args, in_shardings, device_mesh):
    """``build_step``'s ``args`` as DTensors on ``device_mesh``, each placed
    as its ``in_shardings`` entry says (``sharding.placements``): the params,
    the optimizer state, the batch, the cache and the decode inputs.  Every
    rank passes its whole tensors; each keeps its own shard."""
    from torch.distributed.tensor import distribute_tensor

    leaves, spec = tree_flatten(args)
    shards, sh_spec = tree_flatten(in_shardings, is_leaf=lambda x: isinstance(x, NamedSharding))
    if spec != sh_spec:
        raise ValueError("the shardings' tree is not the arguments'")
    return tree_unflatten([distribute_tensor(t, device_mesh, placements(sh.spec, device_mesh),
                                             src_data_rank=None)
                           for t, sh in zip(leaves, shards)], spec)
