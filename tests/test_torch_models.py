"""Port parity: the dense decoder (reduced qwen3_0_6b) against the JAX
package, with the JAX package's own init carried across by
``params_from_numpy``.

Tolerance: 5e-5 absolute plus 1e-5 relative on f32 logits (up to ~5 in
size) and K/V caches; the two run the same f32 arithmetic with the sums
in another order (measured differences ~5e-6 on the logits).  The port's
``"kernel"`` route runs its plain version on the CPU and is held against
JAX ``attn_backend="pallas_interpret"``; ``"chunked"`` is held against
``"xla"``."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import get_reduced_config as jget
from repro.models.model_zoo import build_model as jbuild
from repro_torch.configs import get_config as tget_full
from repro_torch.configs import get_reduced_config as tget
from repro_torch.models import transformer as ttransformer
from repro_torch.models.model_zoo import build_model as tbuild
from repro_torch.models.model_zoo import params_from_numpy

ATOL, RTOL = 5e-5, 1e-5
BACKENDS = [("xla", "chunked"), ("pallas_interpret", "kernel")]
B, T, MAX_LEN = 2, 16, 24


@pytest.fixture(scope="module")
def ref():
    """The JAX model's params (built once), the port's copy and a prompt."""
    jcfg, tcfg = jget("qwen3_0_6b"), tget("qwen3_0_6b")
    jparams = jbuild(jcfg).init(jax.random.PRNGKey(0))
    tparams = params_from_numpy(tcfg, jax.tree.map(np.asarray, jparams), device="cpu")
    toks = np.random.default_rng(0).integers(2, jcfg.vocab, (B, T)).astype(np.int32)
    return jcfg, tcfg, jparams, tparams, toks


def _close(got, want):
    np.testing.assert_allclose(got.detach().cpu().numpy(), np.asarray(want),
                               atol=ATOL, rtol=RTOL)


def test_params_from_numpy_splits_the_layer_stack(ref):
    jcfg, tcfg, jparams, tparams, _ = ref
    assert len(tparams["layers"]) == tcfg.n_layers
    for i, lp in enumerate(tparams["layers"]):
        w = lp["attn"]["wq"]["w"]
        assert w.shape == (tcfg.d_model, tcfg.n_heads * tcfg.hd)  # (in, out)
        np.testing.assert_array_equal(w.numpy(), np.asarray(jparams["layers"]["attn"]["wq"]["w"][i]))
        assert lp["attn"]["q_norm"]["scale"].shape == (tcfg.hd,)
    assert tparams["embed"].device.type == "cpu" and tparams["embed"].dtype == torch.float32


def test_init_has_the_jax_package_layout(ref):
    """Same keys and per-layer shapes as the JAX init (values differ: the
    generators differ)."""
    jcfg, tcfg, jparams, _, _ = ref
    gen = torch.Generator().manual_seed(0)
    tparams = tbuild(tcfg).init(gen)
    jshapes = jax.tree.map(lambda a: tuple(a.shape), jparams)

    def shapes(node, n=None):
        if isinstance(node, dict):
            return {k: shapes(v, n) for k, v in node.items()}
        return tuple(node.shape) if n is None else (n,) + tuple(node.shape)

    tshapes = shapes({k: v for k, v in tparams.items() if k != "layers"})
    tshapes["layers"] = shapes(tparams["layers"][0], len(tparams["layers"]))
    assert tshapes == jshapes


@pytest.mark.parametrize("jbackend,tbackend", BACKENDS)
def test_prefill_logits_and_cache_match(ref, jbackend, tbackend):
    jcfg, tcfg, jparams, tparams, toks = ref
    jl, jc = jbuild(jcfg.replace(attn_backend=jbackend)).prefill(
        jparams, {"tokens": jnp.asarray(toks)}, MAX_LEN)
    tl, tc = tbuild(tcfg.replace(attn_backend=tbackend)).prefill(
        tparams, {"tokens": torch.from_numpy(toks)}, MAX_LEN)
    assert tuple(tl.shape) == (B, T, tcfg.vocab)
    assert tuple(tc["k"].shape) == (tcfg.n_layers, B, MAX_LEN, tcfg.n_kv_heads, tcfg.hd)
    _close(tl, jl)
    _close(tc["k"], jc["k"])
    _close(tc["v"], jc["v"])


def test_decode_steps_match(ref):
    jcfg, tcfg, jparams, tparams, toks = ref
    jm, tm = jbuild(jcfg), tbuild(tcfg)
    jl, jc = jm.prefill(jparams, {"tokens": jnp.asarray(toks)}, MAX_LEN)
    _, tc = tm.prefill(tparams, {"tokens": torch.from_numpy(toks)}, MAX_LEN)
    cur = np.asarray(jl)[:, -1].argmax(-1).astype(np.int32)
    for t in range(T, T + 4):
        pos = np.array([t, t - 3], np.int32)  # ragged positions
        jl, jc = jm.decode_step(jparams, jc, jnp.asarray(cur), jnp.asarray(pos))
        tl, tc = tm.decode_step(tparams, tc, torch.from_numpy(cur), torch.from_numpy(pos))
        assert tuple(tl.shape) == (B, tcfg.vocab)
        _close(tl, jl)
        _close(tc["k"], jc["k"])
        _close(tc["v"], jc["v"])
        cur = np.asarray(jl).argmax(-1).astype(np.int32)


def test_backends_agree_and_unknown_backend_raises(ref):
    _, tcfg, _, tparams, toks = ref
    x = torch.from_numpy(toks)
    lk, _ = tbuild(tcfg.replace(attn_backend="kernel")).prefill(tparams, {"tokens": x}, T)
    lc, _ = tbuild(tcfg.replace(attn_backend="chunked")).prefill(tparams, {"tokens": x}, T)
    torch.testing.assert_close(lk, lc, atol=ATOL, rtol=RTOL)
    with pytest.raises(ValueError, match="attn_backend"):
        tbuild(tcfg.replace(attn_backend="xla")).prefill(tparams, {"tokens": x}, T)


@pytest.mark.parametrize("family", ["moe", "ssm", "hybrid", "vlm", "encdec"])
def test_other_families_name_their_roadmap_item(family):
    cfg = tget("qwen3_0_6b").replace(family=family)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tbuild(cfg)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        ttransformer.decode_cache_init(cfg, 1, 8, device="cpu")


def test_configs_match_the_jax_package():
    from repro.configs import get_config as jget_full

    for name in ("arch_id", "family", "n_layers", "d_model", "n_heads", "n_kv_heads", "d_ff",
                 "vocab", "hd", "qk_norm", "qkv_bias", "rope_theta", "attn_chunk",
                 "decode_kv_f32"):
        assert getattr(tget_full("qwen3_0_6b"), name) == getattr(jget_full("qwen3_0_6b"), name)
        assert getattr(tget("qwen3_0_6b"), name) == getattr(jget("qwen3_0_6b"), name)
    assert tget_full("qwen3_0_6b").param_count() == jget_full("qwen3_0_6b").param_count()
    assert tget_full("qwen3-0.6b".replace(".", "_")).arch_id == "qwen3_0_6b"
    with pytest.raises(KeyError, match="ROADMAP"):
        tget_full("mamba2_780m")
