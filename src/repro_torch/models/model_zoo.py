"""Model factory: ``build_model(cfg)`` -> a ``Model`` bundle, and
``params_from_numpy`` to carry the JAX package's params across.

One interface, as in the JAX package:
  init(gen)                               -> params (on gen's device)
  prefill(params, batch, max_len)         -> (logits, cache)
  decode_step(params, cache, tokens, pos) -> (logits, cache)
  cache_init(batch, max_len, device)      -> cache
The loss comes with the training slice.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import numpy as np
import torch

from repro_torch.models import ssm, transformer


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: Any
    init: Callable
    prefill: Callable
    decode_step: Callable
    cache_init: Callable


def build_model(cfg) -> Model:
    transformer.require_ported(cfg)
    return Model(
        cfg=cfg,
        init=lambda gen: transformer.lm_init(gen, cfg),
        prefill=lambda p, batch, max_len: transformer.prefill(p, cfg, batch["tokens"], max_len),
        decode_step=lambda p, cache, tokens, pos: transformer.decode_step(
            p, cfg, cache, tokens, pos),
        cache_init=lambda batch, max_len, device="cuda": transformer.decode_cache_init(
            cfg, batch, max_len, device=device),
    )


def params_from_numpy(cfg, tree, *, device="cuda"):
    """The port's params from the JAX package's, as numpy arrays.

    ``tree`` is what ``jax.tree.map(np.asarray, model.init(key))`` gives for
    the same ``cfg``: the same nested dicts, with the layer stack on a
    leading L axis, which is split into a list of per-layer dicts (the MoE's
    experts ``(L, E, a, b)`` become ``(E, a, b)`` a layer, with the router
    and the shared expert); the hybrid's ``shared_attn`` is one unstacked
    block and stays whole.  Weights stay ``(in, out)``.  Leaves become
    ``cfg.param_dtype`` (a bf16 leaf passes through f32, exactly), except
    those the JAX init fixes in f32 (the ssm's ``A_log`` and ``dt_bias``).
    """
    transformer.require_ported(cfg)

    def conv(node, index=None, name=""):
        if isinstance(node, dict):
            return {k: conv(v, index, k) for k, v in node.items()}
        a = np.asarray(node) if index is None else np.asarray(node)[index]
        if a.dtype.kind not in "biuf":  # ml_dtypes' bfloat16: through f32, exactly
            a = a.astype(np.float32)
        dtype = torch.float32 if name in ssm.F32_PARAMS else cfg.param_dtype
        return torch.tensor(np.ascontiguousarray(a), dtype=dtype, device=device)

    out = {k: conv(v) for k, v in tree.items() if k != "layers"}
    out["layers"] = [conv(tree["layers"], i) for i in range(cfg.n_layers)]
    return out
