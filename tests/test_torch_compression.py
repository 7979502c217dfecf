"""Port parity: gradient compression (``repro_torch.training.compression``)
against the JAX package's: ``topk`` (5% and 30%) and ``int8`` with error
feedback over three steps on a reduced qwen3_0_6b gradient tree carried
across, the same kept values, codes, residuals and ``wire_bytes``, exactly;
k taken of each stacked leaf as a whole; ``none`` counting every f32."""

import jax
import jax.numpy as jnp
import pytest

from repro.training import compression as jcomp
from repro_torch.configs import get_reduced_config as tget
from repro_torch.models.model_zoo import params_from_numpy, state_to_numpy
from repro_torch.training import compression as tcomp

from test_torch_training import _grads_np, _jax_params, _trees_close  # noqa: E402


@pytest.mark.parametrize("scheme,frac", [("topk", 0.05), ("topk", 0.3), ("int8", 0.0)])
def test_compression_matches_jax(scheme, frac):
    arch = "qwen3_0_6b"
    cfg = tget(arch)
    jc = jcomp.CompressionConfig(scheme=scheme, topk_frac=frac)
    tc = tcomp.CompressionConfig(scheme=scheme, topk_frac=frac)
    params = _jax_params(arch)
    jef = jcomp.ef_init(jax.tree.map(jnp.asarray, params))
    tef = tcomp.ef_init(params_from_numpy(cfg, params, device="cpu"))
    for s in range(3):  # eager: exact (under jit XLA may fold g / scale into a product)
        g = _grads_np(params, seed=10 + s)
        jg, jef, jwire = jcomp.compress(jc, jax.tree.map(jnp.asarray, g), jef)
        tg, tef, twire = tcomp.compress(tc, params_from_numpy(cfg, g, device="cpu"), tef)
        assert int(twire) == int(jwire)
        _trees_close(state_to_numpy(cfg, tg), jg, 0.0)
        _trees_close(state_to_numpy(cfg, tef), jef, 0.0)
    if scheme == "topk":  # k of the whole stacked leaf: 5% of 2 x 64 x 64
        kept = (state_to_numpy(cfg, tg)["layers"]["attn"]["wq"]["w"] != 0).sum()
        assert kept == int(2 * 64 * 64 * frac)


def test_compression_none_counts_every_f32():
    cfg = tget("qwen3_0_6b")
    g = params_from_numpy(cfg, _jax_params("qwen3_0_6b"), device="cpu")
    out, ef, wire = tcomp.compress(tcomp.CompressionConfig(), g, None)
    assert out is g and ef is None
    assert wire == sum(a.size * 4 for a in jax.tree.leaves(_jax_params("qwen3_0_6b")))


