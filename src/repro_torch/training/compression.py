"""Gradient compression for the data-parallel all-reduce, with error
feedback, the JAX package's ``training/compression.py``.

  * ``topk``: keep the k largest-|g| entries of each leaf (sparsify before
    the reduce; on the wire an int32 index and an f32 value each);
  * ``int8``: symmetric linear quantisation of each leaf to int8, one f32
    scale a leaf.

The residual of what compression threw away is added back into the next
step (``ef``).  A leaf is the JAX package's: the tensors at one path under
a layer stack form one group (``optimizer.groups``), so k is taken of the
group's whole size and ranked over all of it, and an int8 group has one
scale; the wire bytes follow.  Rounding is half to even, as ``jnp.round``.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.distributed.checkpoint import tree_leaves, tree_unflatten
from repro_torch.training.optimizer import groups


@dataclasses.dataclass(frozen=True)
class CompressionConfig:
    scheme: str = "none"  # none | topk | int8
    topk_frac: float = 0.05


def ef_init(params):
    return tree_unflatten(params, [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                                   for p in tree_leaves(params)])


def _topk_group(flat, frac):
    """The group's kept values (zeros elsewhere) and its k."""
    k = max(1, int(flat.shape[0] * frac))
    _, idx = torch.topk(flat.abs(), k)
    kept = torch.zeros_like(flat)
    kept[idx] = flat[idx]
    return kept, k


def _int8_group(flat):
    scale = torch.clamp(flat.abs().max(), min=1e-12) / 127.0
    q = torch.clamp(torch.round(flat / scale), -127, 127).to(torch.int8)
    return q.float() * scale, q.numel()


def compress(cfg: CompressionConfig, grads, ef):
    """Returns (decompressed grads, new ef, wire bytes): the grads the DP
    all-reduce sees, the compression error moved into the residual."""
    G = tree_leaves(grads)
    if cfg.scheme == "none":
        return grads, ef, sum(g.numel() * 4 for g in G)
    E = tree_leaves(ef)
    new_g, new_ef, wire = list(G), list(E), 0
    for _, idx in groups(grads):
        gf = [G[i].float() + E[i] for i in idx]
        flat = torch.cat([x.reshape(-1) for x in gf])
        if cfg.scheme == "topk":
            kept, k = _topk_group(flat, cfg.topk_frac)
            wire += k * 8  # int32 index + f32 value
        elif cfg.scheme == "int8":
            kept, n = _int8_group(flat)
            wire += n + 4
        else:
            raise ValueError(cfg.scheme)
        parts = torch.split(kept, [x.numel() for x in gf])
        for i, x, part in zip(idx, gf, parts):
            part = part.reshape(x.shape)
            new_g[i] = part.to(G[i].dtype)
            new_ef[i] = x - part
    return tree_unflatten(grads, new_g), tree_unflatten(ef, new_ef), wire
