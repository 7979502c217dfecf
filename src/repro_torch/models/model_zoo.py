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

from repro_torch.models import ssm, transformer, whisper


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: Any
    init: Callable
    prefill: Callable
    decode_step: Callable
    cache_init: Callable


def build_model(cfg) -> Model:
    """The encdec family's prefill reads ``batch["frames"]``; a vlm's takes
    ``batch.get("patches")``."""
    if cfg.family == "encdec":
        return Model(
            cfg=cfg,
            init=lambda gen: whisper.whisper_init(gen, cfg),
            prefill=lambda p, batch, max_len: whisper.whisper_prefill(
                p, cfg, batch["tokens"], batch["frames"], max_len),
            decode_step=lambda p, cache, tokens, pos: whisper.whisper_decode_step(
                p, cfg, cache, tokens, pos),
            cache_init=lambda batch, max_len, device="cuda": whisper.whisper_cache_init(
                cfg, batch, max_len, device=device),
        )
    transformer.require_decoder(cfg)
    return Model(
        cfg=cfg,
        init=lambda gen: transformer.lm_init(gen, cfg),
        prefill=lambda p, batch, max_len: transformer.prefill(
            p, cfg, batch["tokens"], max_len, patches=batch.get("patches")),
        decode_step=lambda p, cache, tokens, pos: transformer.decode_step(
            p, cfg, cache, tokens, pos),
        cache_init=lambda batch, max_len, device="cuda": transformer.decode_cache_init(
            cfg, batch, max_len, device=device),
    )


def params_from_numpy(cfg, tree, *, device="cuda"):
    """The port's params from the JAX package's, as numpy arrays.

    ``tree`` is what ``jax.tree.map(np.asarray, model.init(key))`` gives for
    the same ``cfg``: the same nested dicts, with each layer stack on a
    leading axis, which is split into a list of per-layer dicts: ``layers``
    by ``n_layers`` (the MoE's experts ``(L, E, a, b)`` become ``(E, a, b)``
    a layer, with the router and the shared expert), Whisper's ``enc`` and
    ``dec`` by ``n_enc_layers`` and ``n_dec_layers``.  The hybrid's
    ``shared_attn``, the vlm's ``patch_proj`` and Whisper's ``frame_proj``
    are not stacked and stay whole.  Weights stay ``(in, out)``.  Leaves
    become ``cfg.param_dtype`` (a bf16 leaf passes through f32, exactly),
    except those the JAX init fixes in f32 (the ssm's ``A_log`` and
    ``dt_bias``).
    """
    if cfg.family == "encdec":
        stacks = {"enc": cfg.n_enc_layers, "dec": cfg.n_dec_layers}
    else:
        transformer.require_decoder(cfg)
        stacks = {"layers": cfg.n_layers}

    def conv(node, index=None, name=""):
        if isinstance(node, dict):
            return {k: conv(v, index, k) for k, v in node.items()}
        a = np.asarray(node) if index is None else np.asarray(node)[index]
        if a.dtype.kind not in "biuf":  # ml_dtypes' bfloat16: through f32, exactly
            a = a.astype(np.float32)
        dtype = torch.float32 if name in ssm.F32_PARAMS else cfg.param_dtype
        return torch.tensor(np.ascontiguousarray(a), dtype=dtype, device=device)

    out = {k: conv(v) for k, v in tree.items() if k not in stacks}
    for key, n in stacks.items():
        out[key] = [conv(tree[key], i) for i in range(n)]
    return out
