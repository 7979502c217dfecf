"""Optimizers: AdamW (f32 moments) and Adafactor (factored second moment),
the warmup-cosine schedule and the global-norm clip, the JAX package's
``training/optimizer.py``.

Plain functions over the port's param tree, with the state a tree that
mirrors it (no ``torch.optim``), so it carries across from the JAX package
(``model_zoo.state_from_numpy``) and checkpoints with
``distributed/checkpoint.py``.

Leaf semantics.  The JAX package's leaf is a whole layer stack: the
tensors at one path under a layer stack (``layers``, Whisper's ``enc`` and
``dec``), one per layer, form one *group*, whose shape is the stacked one,
(L,) + the layer's.  So the choices the JAX package makes from a leaf's
shape are made from the group's: weight decay applies where its ``ndim >=
2`` (every stacked norm scale and the ssm's per-head vectors decay;
``final_norm`` does not), and Adafactor factors by its last two dims and
clips by the RMS over the whole group.  The elementwise updates run per
tensor, with no stacked copy.  Every other tensor is a group of its own.

The schedule and the bias corrections are computed in f32 on the device,
as the JAX package computes them; the step counter is a device int32, so a
step reads nothing back to the host.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.distributed.checkpoint import tree_flatten_with_path, tree_leaves, tree_unflatten
from repro_torch.distributed.sharding import in_layer_stack


@dataclasses.dataclass(frozen=True)
class OptimizerConfig:
    name: str = "adamw"  # adamw | adafactor
    lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    # adafactor
    decay_rate: float = 0.8
    factored_min_dim: int = 128


def schedule(cfg: OptimizerConfig, step):
    """Linear warmup to ``lr``, then cosine down to ``min_lr_frac * lr`` at
    ``total_steps``; f32, on ``step``'s device (the CPU for a number)."""
    step = torch.as_tensor(step).float()
    warm = step / max(cfg.warmup_steps, 1)
    prog = (step - cfg.warmup_steps) / max(cfg.total_steps - cfg.warmup_steps, 1)
    prog = prog.clamp(0.0, 1.0)
    cos = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * 0.5 * (1 + torch.cos(math.pi * prog))
    return cfg.lr * torch.where(step < cfg.warmup_steps, warm, cos)


def global_norm(tree):
    sq = [torch.sum(torch.square(g.float())) for g in tree_leaves(tree)]
    return torch.sqrt(torch.stack(sq).sum())


def clip_by_global_norm(grads, max_norm):
    norm = global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    leaves = [(g.float() * scale).to(g.dtype) for g in tree_leaves(grads)]
    return tree_unflatten(grads, leaves), norm


def groups(params):
    """The JAX package's leaves over the port's tree: ``[(stacked, [flat
    index, ...])]`` in flatten order, where ``stacked`` says the group is a
    layer stack (one tensor a layer) and the indices are those of
    ``tree_leaves(params)``."""
    out, where = [], {}
    for i, (path, _) in enumerate(tree_flatten_with_path(params)):
        stacked = in_layer_stack(path, params)
        key = (path[0],) + path[2:] if stacked else path
        if key not in where:
            where[key] = len(out)
            out.append((stacked, []))
        out[where[key]][1].append(i)
    return out


def _group_shape(stacked, tensors):
    return ((len(tensors),) if stacked else ()) + tuple(tensors[0].shape)


def _factored(shape, min_dim):
    return len(shape) >= 2 and shape[-1] >= min_dim and shape[-2] >= min_dim


def _f32_zeros(shape, like):
    return torch.zeros(shape, dtype=torch.float32, device=like.device)


def _step_counter(like):
    return torch.zeros((), dtype=torch.int32, device=like.device)


# -------------------------------- AdamW --------------------------------------


def adamw_init(params):
    zeros = [_f32_zeros(p.shape, p) for p in tree_leaves(params)]
    first = tree_leaves(params)[0]
    return {"mu": tree_unflatten(params, zeros),
            "nu": tree_unflatten(params, [z.clone() for z in zeros]),
            "step": _step_counter(first)}


def adamw_update(cfg: OptimizerConfig, grads, state, params):
    step = state["step"] + 1
    lr = schedule(cfg, step)
    t = step.float()
    bc1 = 1 - cfg.b1 ** t
    bc2 = 1 - cfg.b2 ** t
    P, G = tree_leaves(params), tree_leaves(grads)
    MU, NU = tree_leaves(state["mu"]), tree_leaves(state["nu"])
    new_p, new_mu, new_nu = list(P), list(MU), list(NU)
    for stacked, idx in groups(params):
        decay = len(_group_shape(stacked, [P[i] for i in idx])) >= 2
        for i in idx:
            p, g = P[i], G[i].float()
            mu = cfg.b1 * MU[i] + (1 - cfg.b1) * g
            nu = cfg.b2 * NU[i] + (1 - cfg.b2) * g * g
            step_v = (mu / bc1) / (torch.sqrt(nu / bc2) + cfg.eps)
            if decay:  # decoupled weight decay on (stacked) matrices only
                step_v = step_v + cfg.weight_decay * p.float()
            new_p[i] = (p.float() - lr * step_v).to(p.dtype)
            new_mu[i], new_nu[i] = mu, nu
    return tree_unflatten(params, new_p), {
        "mu": tree_unflatten(state["mu"], new_mu), "nu": tree_unflatten(state["nu"], new_nu),
        "step": step}


# ------------------------------ Adafactor ------------------------------------


def _check_factoring(stacked, tensors, min_dim):
    """A stacked 1-D leaf (L, n) with L and n both >= ``min_dim`` would be
    factored across its layers; no config reaches that, and the port does
    not implement it."""
    if stacked and tensors[0].dim() == 1 and _factored(_group_shape(stacked, tensors), min_dim):
        raise ValueError(
            f"a stacked leaf of shape {_group_shape(stacked, tensors)} would be factored "
            f"across its layers (factored_min_dim={min_dim}); not supported")


def adafactor_init(params, cfg: OptimizerConfig | None = None):
    cfg = cfg or OptimizerConfig(name="adafactor")
    P = tree_leaves(params)
    v = [None] * len(P)
    for stacked, idx in groups(params):
        tensors = [P[i] for i in idx]
        _check_factoring(stacked, tensors, cfg.factored_min_dim)
        factored = _factored(_group_shape(stacked, tensors), cfg.factored_min_dim)
        for i in idx:
            p = P[i]
            v[i] = ({"vr": _f32_zeros(p.shape[:-1], p),
                     "vc": _f32_zeros(p.shape[:-2] + p.shape[-1:], p)}
                    if factored else {"v": _f32_zeros(p.shape, p)})
    return {"v": tree_unflatten(params, v), "step": _step_counter(P[0])}


def adafactor_update(cfg: OptimizerConfig, grads, state, params):
    step = state["step"] + 1
    lr = schedule(cfg, step)
    t = step.float()
    beta2 = 1.0 - t ** (-cfg.decay_rate)
    eps = 1e-30
    P, G = tree_leaves(params), tree_leaves(grads)
    V = _state_dicts(state["v"], params)  # a dict a leaf: {"v"} or {"vr", "vc"}
    new_p, new_v = list(P), list(V)
    for stacked, idx in groups(params):
        tensors = [P[i] for i in idx]
        _check_factoring(stacked, tensors, cfg.factored_min_dim)
        pres, sq, n = {}, [], 0
        for i in idx:
            g = G[i].float()
            g2 = g * g + eps
            v = V[i]
            if "vr" in v:
                vr = beta2 * v["vr"] + (1 - beta2) * g2.mean(dim=-1)
                vc = beta2 * v["vc"] + (1 - beta2) * g2.mean(dim=-2)
                denom = (vr[..., None] * vc[..., None, :]
                         / torch.clamp(vr.mean(dim=-1, keepdim=True)[..., None], min=eps))
                pre = g / torch.sqrt(denom + eps)
                new_v[i] = {"vr": vr, "vc": vc}
            else:
                vv = beta2 * v["v"] + (1 - beta2) * g2
                pre = g / torch.sqrt(vv + eps)
                new_v[i] = {"v": vv}
            pres[i] = pre
            sq.append(torch.sum(pre * pre))
            n += pre.numel()
        # update clipping (Adafactor's RMS rule) over the whole group
        rms = torch.sqrt(torch.stack(sq).sum() / n + eps)
        clip = torch.clamp(rms, min=1.0)
        decay = len(_group_shape(stacked, tensors)) >= 2
        for i in idx:
            p = P[i]
            step_v = pres[i] / clip
            if decay:
                step_v = step_v + cfg.weight_decay * p.float()
            new_p[i] = (p.float() - lr * step_v).to(p.dtype)
    return tree_unflatten(params, new_p), {
        "v": tree_unflatten(params, new_v), "step": step}


def _state_dicts(vtree, params):
    """The per-leaf state dicts of Adafactor's ``v``, in ``params``' flatten
    order (``v`` mirrors ``params`` with a dict at each leaf)."""
    if isinstance(params, torch.Tensor):
        return [vtree]
    if isinstance(params, dict):
        return [d for k in sorted(params) for d in _state_dicts(vtree[k], params[k])]
    return [d for v, p in zip(vtree, params) for d in _state_dicts(v, p)]


# ------------------------------ front door -----------------------------------


def opt_init(cfg: OptimizerConfig, params):
    if cfg.name == "adamw":
        return adamw_init(params)
    if cfg.name == "adafactor":
        return adafactor_init(params, cfg)
    raise ValueError(cfg.name)


def opt_update(cfg: OptimizerConfig, grads, state, params):
    """Clip by the global norm, then one update -> (params, state, norm)."""
    grads, gnorm = clip_by_global_norm(grads, cfg.clip_norm)
    if cfg.name == "adamw":
        new_p, new_s = adamw_update(cfg, grads, state, params)
    elif cfg.name == "adafactor":
        new_p, new_s = adafactor_update(cfg, grads, state, params)
    else:
        raise ValueError(cfg.name)
    return new_p, new_s, gnorm
