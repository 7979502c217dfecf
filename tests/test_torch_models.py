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
from repro_torch.configs import ARCH_IDS
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


FAMILY_ARCH = {"ssm": "mamba2_780m", "hybrid": "zamba2_7b", "moe": "granite_moe_1b_a400m",
               "vlm": "internvl2_2b", "encdec": "whisper_large_v3"}


@pytest.mark.parametrize("family", ["moe", "ssm", "hybrid", "vlm", "encdec"])
def test_other_families_name_their_roadmap_item(family):
    """Every family of the JAX package is ported and builds its cache: the
    recurrent state (ssm), K/V one a layer (moe, vlm), both with K/V one a
    group (hybrid), or the decoder's self K/V and the cross K/V over the
    audio frames (encdec)."""
    cfg = tget(FAMILY_ARCH[family])
    cache = tbuild(cfg).cache_init(1, 8, device="cpu")
    want = {"ssm": {"S", "conv"}, "moe": {"k", "v"}, "hybrid": {"S", "conv", "k", "v"},
            "vlm": {"k", "v"}, "encdec": {"k", "v", "xk", "xv"}}
    assert set(cache) == want[family]
    if "S" in cache:
        assert cache["S"].dtype == torch.float32 and cache["S"].shape[0] == cfg.n_layers
    n_kv = {"hybrid": cfg.n_layers // max(cfg.hybrid_attn_every, 1),
            "encdec": cfg.n_dec_layers}.get(family, cfg.n_layers)
    if "k" in cache:
        assert tuple(cache["k"].shape) == (n_kv, 1, 8, cfg.n_kv_heads, cfg.hd)
    if "xk" in cache:
        assert tuple(cache["xk"].shape) == (n_kv, 1, cfg.n_audio_frames, cfg.n_kv_heads, cfg.hd)


def _port_fields():
    import dataclasses

    from repro_torch.configs import ArchConfig

    # the backends are named per package ("kernel"/"chunked" here,
    # "pallas"/"xla" there); every other field is the JAX package's
    return [f.name for f in dataclasses.fields(ArchConfig)
            if f.name not in ("attn_backend", "ssm_backend")]


def _as_jax_value(v):
    return getattr(jnp, str(v).removeprefix("torch.")) if isinstance(v, torch.dtype) else v


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_configs_match_the_jax_package(arch):
    """Every ported config, full and reduced, equals the JAX package's field
    by field (dtypes mapped), with the same parameter counts."""
    from repro.configs import get_config as jget_full

    for t, j in ((tget_full(arch), jget_full(arch)), (tget(arch), jget(arch))):
        for name in _port_fields():
            assert _as_jax_value(getattr(t, name)) == getattr(j, name), name
        assert t.hd == j.hd
        assert t.param_count() == j.param_count()
        assert t.active_param_count() == j.active_param_count()
    assert tget_full(arch.replace("_", "-")).arch_id == arch


def test_unported_configs_raise_naming_the_roadmap():
    """Every LM config of the JAX package is ported (``ARCH_IDS`` holds its
    ten, all but ``pulse_paper``); an unknown arch raises ``KeyError``
    naming the known ones, and a decoder-only entry point refuses the
    encdec family."""
    from repro.configs import ARCH_IDS as JAX_ARCH_IDS

    assert set(ARCH_IDS) == set(JAX_ARCH_IDS) - {"pulse_paper"}
    for bad in ("whisper_large_v4", "pulse_paper"):
        with pytest.raises(KeyError, match="unknown arch"):
            tget_full(bad)
        with pytest.raises(KeyError, match="unknown arch"):
            tget(bad)
    with pytest.raises(ValueError, match="decoder-only"):
        ttransformer.decode_cache_init(tget("whisper_large_v3"), 1, 8, device="cpu")


# ------------------------------ ssm family ----------------------------------
# Reduced mamba2_780m.  Tolerance: 2e-4 of each tensor's largest magnitude
# (see tests/test_torch_ssm.py: the JAX init's stacked weights make a
# chunk's cumsum of dt * A reach ~-1600, which f32 keeps to ~1e-4).

SSM_TOL = 2e-4
SSM_BACKENDS = [("xla", "chunked"), ("pallas_interpret", "kernel")]


@pytest.fixture(scope="module")
def ssm_ref():
    jcfg, tcfg = jget("mamba2_780m"), tget("mamba2_780m")
    jparams = jbuild(jcfg).init(jax.random.PRNGKey(0))
    tparams = params_from_numpy(tcfg, jax.tree.map(np.asarray, jparams), device="cpu")
    toks = np.random.default_rng(1).integers(2, jcfg.vocab, (B, T)).astype(np.int32)
    return jcfg, tcfg, jparams, tparams, toks


def _close_scaled(got, want, tol=SSM_TOL):
    want = np.asarray(want)
    np.testing.assert_allclose(got.detach().cpu().numpy(), want, rtol=0,
                               atol=tol * max(1.0, float(np.abs(want).max())))


@pytest.mark.parametrize("jbackend,tbackend", SSM_BACKENDS)
def test_ssm_prefill_and_decode_steps_match(ssm_ref, jbackend, tbackend):
    jcfg, tcfg, jparams, tparams, toks = ssm_ref
    jm = jbuild(jcfg.replace(ssm_backend=jbackend))
    tm = tbuild(tcfg.replace(ssm_backend=tbackend))
    jl, jc = jm.prefill(jparams, {"tokens": jnp.asarray(toks)}, MAX_LEN)
    tl, tc = tm.prefill(tparams, {"tokens": torch.from_numpy(toks)}, MAX_LEN)
    L, (d_inner, H) = tcfg.n_layers, (2 * tcfg.d_model, 2 * tcfg.d_model // tcfg.ssm_head_dim)
    assert tuple(tl.shape) == (B, T, tcfg.vocab)
    assert tuple(tc["S"].shape) == (L, B, H, tcfg.ssm_state, tcfg.ssm_head_dim)
    assert tuple(tc["conv"].shape) == (L, B, 3, d_inner + 2 * tcfg.ssm_state)
    for got, want in ((tl, jl), (tc["S"], jc["S"]), (tc["conv"], jc["conv"])):
        _close_scaled(got, want)
    cur = np.asarray(jl)[:, -1].argmax(-1).astype(np.int32)
    for t in range(T, T + 2):
        pos = np.array([t, t], np.int32)
        jl, jc = jm.decode_step(jparams, jc, jnp.asarray(cur), jnp.asarray(pos))
        tl, tc2 = tm.decode_step(tparams, tc, torch.from_numpy(cur), torch.from_numpy(pos))
        assert tc2 is tc  # the state is written in place
        assert tuple(tl.shape) == (B, tcfg.vocab)
        for got, want in ((tl, jl), (tc["S"], jc["S"]), (tc["conv"], jc["conv"])):
            _close_scaled(got, want)
        cur = np.asarray(jl).argmax(-1).astype(np.int32)


def test_ssm_init_has_the_jax_package_layout(ssm_ref):
    jcfg, tcfg, jparams, tparams, _ = ssm_ref
    jshapes = jax.tree.map(lambda a: tuple(a.shape), jparams)

    def shapes(node, n=None):
        if isinstance(node, dict):
            return {k: shapes(v, n) for k, v in node.items()}
        return tuple(node.shape) if n is None else (n,) + tuple(node.shape)

    for params in (tparams, tbuild(tcfg).init(torch.Generator().manual_seed(0))):
        tshapes = shapes({k: v for k, v in params.items() if k != "layers"})
        tshapes["layers"] = shapes(params["layers"][0], len(params["layers"]))
        assert tshapes == jshapes


def test_params_from_numpy_keeps_f32_leaves_f32():
    """Under a bf16 param_dtype the JAX init keeps A_log and dt_bias in f32;
    so do the port's init and params_from_numpy, which carries every other
    leaf across exactly (bf16 -> f32 -> bf16)."""
    jcfg = jget("mamba2_780m").replace(param_dtype=jnp.bfloat16)
    tcfg = tget("mamba2_780m").replace(param_dtype=torch.bfloat16)
    jparams = jax.tree.map(np.asarray, jbuild(jcfg).init(jax.random.PRNGKey(0)))
    tparams = params_from_numpy(tcfg, jparams, device="cpu")
    own = tbuild(tcfg).init(torch.Generator().manual_seed(0))
    jssm = jparams["layers"]["ssm"]
    for lp, own_lp in zip(tparams["layers"], own["layers"]):
        for name in ("A_log", "dt_bias"):
            assert jssm[name].dtype == np.float32
            assert lp["ssm"][name].dtype == torch.float32 == own_lp["ssm"][name].dtype
        for name in ("conv_w", "D_skip"):
            assert lp["ssm"][name].dtype == torch.bfloat16 == own_lp["ssm"][name].dtype
        assert lp["ssm"]["in_proj"]["w"].dtype == torch.bfloat16
    np.testing.assert_array_equal(tparams["layers"][1]["ssm"]["dt_bias"].numpy(),
                                  jssm["dt_bias"][1])
    np.testing.assert_array_equal(tparams["layers"][1]["ssm"]["conv_w"].float().numpy(),
                                  jssm["conv_w"][1].astype(np.float32))
    assert tparams["embed"].dtype == torch.bfloat16
    logits, _ = tbuild(tcfg).prefill(tparams, {"tokens": torch.zeros((1, 4), dtype=torch.int32)},
                                     8)
    assert torch.isfinite(logits).all()
