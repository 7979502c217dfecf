"""Port parity: the dense configs beside Qwen3-0.6B (reduced olmo_1b,
non-parametric norms; qwen1_5_4b, QKV bias and rope theta 1e6; qwen3_4b,
qk-norm and GQA) against the JAX package, prefill and decode, with the
JAX init carried across by ``params_from_numpy``.  The QKV biases, zeros
in the init, are drawn at random (the same numbers in both packages) so
that the bias path adds something.

Tolerance: 5e-5 absolute plus 1e-5 relative, the dense family's
(tests/test_torch_models.py)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import get_reduced_config as jget
from repro.models.model_zoo import build_model as jbuild
from repro_torch.configs import get_reduced_config as tget
from repro_torch.models.model_zoo import build_model as tbuild
from repro_torch.models.model_zoo import params_from_numpy

ATOL, RTOL = 5e-5, 1e-5
ARCHS = ["olmo_1b", "qwen1_5_4b", "qwen3_4b"]
BACKENDS = [("xla", "chunked"), ("pallas_interpret", "kernel")]
B, T, MAX_LEN = 2, 16, 24


def _random_biases(tree, rng):
    if isinstance(tree, dict):
        return {k: (jnp.asarray(rng.standard_normal(v.shape).astype(np.float32) * 0.1)
                    if k == "b" else _random_biases(v, rng)) for k, v in tree.items()}
    return tree


@pytest.fixture(scope="module", params=ARCHS)
def ref(request):
    jcfg, tcfg = jget(request.param), tget(request.param)
    jparams = _random_biases(jbuild(jcfg).init(jax.random.PRNGKey(0)),
                             np.random.default_rng(5))
    tparams = params_from_numpy(tcfg, jax.tree.map(np.asarray, jparams), device="cpu")
    toks = np.random.default_rng(4).integers(2, jcfg.vocab, (B, T)).astype(np.int32)
    return jcfg, tcfg, jparams, tparams, toks


def _close(got, want):
    np.testing.assert_allclose(got.detach().cpu().numpy(), np.asarray(want),
                               atol=ATOL, rtol=RTOL)


def test_the_config_s_variant_is_in_the_params(ref):
    _, tcfg, _, tparams, _ = ref
    lp = tparams["layers"][0]
    assert ("scale" in lp["attn_norm"]) == (not tcfg.nonparametric_norm)
    assert ("b" in lp["attn"]["wq"]) == tcfg.qkv_bias
    assert ("q_norm" in lp["attn"]) == tcfg.qk_norm
    if tcfg.qkv_bias:
        assert float(lp["attn"]["wk"]["b"].abs().max()) > 0


@pytest.mark.parametrize("jbackend,tbackend", BACKENDS)
def test_prefill_and_decode_steps_match(ref, jbackend, tbackend):
    jcfg, tcfg, jparams, tparams, toks = ref
    jm = jbuild(jcfg.replace(attn_backend=jbackend))
    tm = tbuild(tcfg.replace(attn_backend=tbackend))
    jl, jc = jm.prefill(jparams, {"tokens": jnp.asarray(toks)}, MAX_LEN)
    tl, tc = tm.prefill(tparams, {"tokens": torch.from_numpy(toks)}, MAX_LEN)
    assert tuple(tl.shape) == (B, T, tcfg.vocab)
    assert tuple(tc["k"].shape) == (tcfg.n_layers, B, MAX_LEN, tcfg.n_kv_heads, tcfg.hd)
    for got, want in ((tl, jl), (tc["k"], jc["k"]), (tc["v"], jc["v"])):
        _close(got, want)
    cur = np.asarray(jl)[:, -1].argmax(-1).astype(np.int32)
    for t in range(T, T + 3):
        pos = np.array([t, t - 3], np.int32)
        jl, jc = jm.decode_step(jparams, jc, jnp.asarray(cur), jnp.asarray(pos))
        tl, tc = tm.decode_step(tparams, tc, torch.from_numpy(cur), torch.from_numpy(pos))
        for got, want in ((tl, jl), (tc["k"], jc["k"]), (tc["v"], jc["v"])):
            _close(got, want)
        cur = np.asarray(jl).argmax(-1).astype(np.int32)
