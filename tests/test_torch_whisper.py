"""Port parity: the encdec family (reduced whisper_large_v3: 2 encoder and 2
decoder layers, d 64, 4 heads of 16, QKV bias) against the JAX package,
with the JAX init carried across by ``params_from_numpy``.

Tolerance: 5e-4 of each tensor's largest magnitude (measured over six
input seeds, at 16 and 150 frames, on both routes: the worst of the logits
and the four caches 1.4e-5 to 1.5e-4 of its largest magnitude).  The dense
family's 5e-5 + 1e-5 relative does not hold here, by the reference's own
init: ``uniform_scale_init`` takes the stack axis (2 layers) as the
fan-in, so every weight has std 1/sqrt(2) and each dense multiplies its
input by ~0.7 * sqrt(fan-in), 5.6 at 64 and 8 at 128; the residual stream
grows to hundreds, f32 keeps ~1e-7 of it, and the next projection
multiplies that again (K/V reach ~24 in size), and each LayerNorm's mean
subtraction cancels most of the stream's size.  The building blocks,
which have no such weights, are held to 1e-6.

The port's ``"kernel"`` route runs its plain version on the CPU and is held
against the JAX ``"pallas_interpret"`` route where 128-blocks divide the
lengths, and against ``"xla"`` at 150 frames, where the Pallas launcher
raises and the port's kernel route must not; ``"chunked"`` against
``"xla"``."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import get_reduced_config as jget
from repro.models import common as jcommon
from repro.models import whisper as jwhisper
from repro.models.model_zoo import build_model as jbuild
from repro.serving.batching import ContinuousBatcher as JBatcher
from repro.serving.batching import Request as JRequest
from repro_torch.configs import get_reduced_config as tget
from repro_torch.models import common as tcommon
from repro_torch.models import whisper as twhisper
from repro_torch.models.model_zoo import build_model as tbuild
from repro_torch.models.model_zoo import params_from_numpy
from repro_torch.serving.batching import ContinuousBatcher as TBatcher
from repro_torch.serving.batching import Request as TRequest

TOL = 5e-4
BLOCK_TOL = 1e-6
B, L, MAX_LEN = 2, 8, 24
FRAMES = [16, 150]  # the reduced config's, and one 128 does not divide
ROUTES = {"xla": ("chunked", "kernel"), "pallas_interpret": ("kernel",)}  # JAX: port


@pytest.fixture(scope="module")
def ref():
    jcfg, tcfg = jget("whisper_large_v3"), tget("whisper_large_v3")
    jparams = jbuild(jcfg).init(jax.random.PRNGKey(0))
    tparams = params_from_numpy(tcfg, jax.tree.map(np.asarray, jparams), device="cpu")
    return jcfg, tcfg, jparams, tparams


_JAX_PREFILL = {}


def _jax_prefill(ref, n_frames, backend):
    """The JAX prefill of ``_inputs(n_frames)``, once per route and length."""
    jcfg, _, jparams, _ = ref
    key = (n_frames, backend)
    if key not in _JAX_PREFILL:
        toks, frames = _inputs(jcfg, n_frames)
        _JAX_PREFILL[key] = jbuild(jcfg.replace(attn_backend=backend)).prefill(
            jparams, {"tokens": jnp.asarray(toks), "frames": jnp.asarray(frames)}, MAX_LEN)
    return _JAX_PREFILL[key]


def _inputs(jcfg, n_frames, seed=0):
    rng = np.random.default_rng(seed)
    toks = rng.integers(2, jcfg.vocab, (B, L)).astype(np.int32)
    frames = rng.standard_normal((B, n_frames, jcfg.d_model)).astype(np.float32)
    return toks, frames


def _close(got, want, tol=TOL):
    want = np.asarray(want)
    np.testing.assert_allclose(got.detach().cpu().numpy(), want, rtol=0,
                               atol=tol * max(1.0, float(np.abs(want).max())))


def _routes(n_frames):
    """(JAX route, the port's routes held against it); the JAX Pallas route
    only where its 128-blocks divide the lengths."""
    return [(j, t) for j, t in ROUTES.items() if n_frames % min(128, n_frames) == 0 or j == "xla"]


def _shapes(node, n=None):
    if isinstance(node, dict):
        return {k: _shapes(v, n) for k, v in node.items()}
    return tuple(node.shape) if n is None else (n,) + tuple(node.shape)


# ------------------------------ building blocks -----------------------------


@pytest.mark.parametrize("shape,size", [((2, 5, 64), 30.0), ((3, 16), 0.003)])
def test_layernorm_matches_jax(shape, size):
    """At size 0.003 the variance (~1e-5) is the eps's order: eps 1e-5
    (not RMSNorm's 1e-6) shows."""
    rng = np.random.default_rng(1)
    x = (rng.standard_normal(shape) * size).astype(np.float32)
    scale, bias = (rng.standard_normal(shape[-1]).astype(np.float32) for _ in range(2))
    want = jcommon.layernorm_apply({"scale": jnp.asarray(scale), "bias": jnp.asarray(bias)},
                                   jnp.asarray(x))
    got = tcommon.layernorm_apply({"scale": torch.from_numpy(scale),
                                   "bias": torch.from_numpy(bias)}, torch.from_numpy(x))
    _close(got, want, BLOCK_TOL)
    init = tcommon.layernorm_init(7, torch.float32, "cpu")
    assert init["scale"].tolist() == [1.0] * 7 and init["bias"].tolist() == [0.0] * 7


def test_gelu_mlp_matches_jax():
    rng = np.random.default_rng(2)
    p = {"wi": {"w": rng.standard_normal((16, 32)), "b": rng.standard_normal(32)},
         "wo": {"w": rng.standard_normal((32, 16)), "b": rng.standard_normal(16)}}
    p = {k: {n: (a * 0.2).astype(np.float32) for n, a in d.items()} for k, d in p.items()}
    x = rng.standard_normal((2, 3, 16)).astype(np.float32) * 3
    want = jcommon.gelu_mlp_apply(jax.tree.map(jnp.asarray, p), jnp.asarray(x), jnp.float32)
    got = tcommon.gelu_mlp_apply(jax.tree.map(torch.from_numpy, p), torch.from_numpy(x),
                                 torch.float32)
    _close(got, want, BLOCK_TOL)
    init = tcommon.gelu_mlp_init(torch.Generator().manual_seed(0), 16, 32, torch.float32)
    assert _shapes(init) == {"wi": {"w": (16, 32), "b": (32,)}, "wo": {"w": (32, 16), "b": (16,)}}


@pytest.mark.parametrize("length,dim", [(16, 64), (150, 64), (448, 1280), (1500, 1280)])
def test_sinusoidal_positions_match_jax(length, dim):
    """Interleaved sin/cos in f32.  The two packages' f32 ``exp`` differ by
    one ulp on some frequencies, so an angle p * f differs by up to p ulps
    of f: the bound is (length - 1) * 2^-23 (1.8e-4 at 1,500 frames), plus
    one ulp of sin itself."""
    got = tcommon.sinusoidal_positions(length, dim)
    want = np.asarray(jcommon.sinusoidal_positions(length, dim))
    assert got.dtype == torch.float32 and tuple(got.shape) == (length, dim)
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=(length - 1) * 2.0 ** -23 + 2.0 ** -23)


# --------------------------------- the model --------------------------------


def test_init_and_params_from_numpy_have_the_jax_layout(ref):
    """The port's init has the JAX package's keys and per-layer shapes
    (``enc``/``dec`` lists in place of the stacked axes; the values differ:
    the generators differ), and the carried params split each stack by its
    own depth with ``frame_proj``'s bias kept."""
    jcfg, tcfg, jparams, tparams = ref
    jshapes = jax.tree.map(lambda a: tuple(a.shape), jparams)
    for params in (tbuild(tcfg).init(torch.Generator().manual_seed(0)), tparams):
        tshapes = _shapes({k: v for k, v in params.items() if k not in ("enc", "dec")})
        tshapes["enc"] = _shapes(params["enc"][0], len(params["enc"]))
        tshapes["dec"] = _shapes(params["dec"][0], len(params["dec"]))
        assert tshapes == jshapes
    assert len(tparams["enc"]) == tcfg.n_enc_layers and len(tparams["dec"]) == tcfg.n_dec_layers
    assert "unembed" not in tparams and "b" in tparams["frame_proj"]
    assert "b" in tparams["dec"][0]["cross_attn"]["wk"] and "b" not in tparams["enc"][0]["attn"]["wo"]
    np.testing.assert_array_equal(tparams["dec"][1]["cross_attn"]["wq"]["w"].numpy(),
                                  np.asarray(jparams["dec"]["cross_attn"]["wq"]["w"][1]))


@pytest.mark.parametrize("n_frames", FRAMES)
def test_encode_matches_jax(ref, n_frames):
    jcfg, tcfg, jparams, tparams = ref
    _, frames = _inputs(jcfg, n_frames)
    for jbackend, tbackends in _routes(n_frames):
        want = jwhisper.encode(jparams, jcfg.replace(attn_backend=jbackend), jnp.asarray(frames))
        for tbackend in tbackends:
            got = twhisper.encode(tparams, tcfg.replace(attn_backend=tbackend),
                                  torch.from_numpy(frames))
            assert tuple(got.shape) == (B, n_frames, tcfg.d_model)
            _close(got, want)


def test_pallas_route_refuses_150_frames_and_the_kernel_route_takes_them(ref):
    """The reference's finding: its Pallas route raises where 128 does not
    divide the frames; the port's kernel route serves them, as the JAX
    default ``"xla"`` route does."""
    jcfg, tcfg, jparams, tparams = ref
    _, frames = _inputs(jcfg, 150)
    with pytest.raises(ValueError, match="divide"):
        jwhisper.encode(jparams, jcfg.replace(attn_backend="pallas_interpret"),
                        jnp.asarray(frames))
    out = twhisper.encode(tparams, tcfg.replace(attn_backend="kernel"), torch.from_numpy(frames))
    assert bool(torch.isfinite(out).all())


@pytest.mark.parametrize("n_frames", FRAMES)
def test_prefill_logits_and_caches_match(ref, n_frames):
    jcfg, tcfg, jparams, tparams = ref
    toks, frames = _inputs(jcfg, n_frames)
    for jbackend, tbackends in _routes(n_frames):
        jl, jc = _jax_prefill(ref, n_frames, jbackend)
        for tbackend in tbackends:
            tl, tc = tbuild(tcfg.replace(attn_backend=tbackend)).prefill(
                tparams, {"tokens": torch.from_numpy(toks), "frames": torch.from_numpy(frames)},
                MAX_LEN)
            assert tuple(tl.shape) == (B, L, tcfg.vocab)
            want_shapes = {"k": MAX_LEN, "v": MAX_LEN, "xk": n_frames, "xv": n_frames}
            for key, n in want_shapes.items():
                assert tuple(tc[key].shape) == (tcfg.n_dec_layers, B, n, tcfg.n_kv_heads, tcfg.hd)
                _close(tc[key], jc[key])
            _close(tl, jl)


@pytest.mark.parametrize("n_frames", FRAMES)
def test_decode_steps_match(ref, n_frames):
    """4 steps at ragged positions after the prefill, the cross-attention
    over the encoder's K/V."""
    jcfg, tcfg, jparams, tparams = ref
    toks, frames = _inputs(jcfg, n_frames)
    jdecode, tm = jax.jit(jbuild(jcfg).decode_step), tbuild(tcfg)
    jl, jc = _jax_prefill(ref, n_frames, "xla")
    _, tc = tm.prefill(tparams, {"tokens": torch.from_numpy(toks),
                                 "frames": torch.from_numpy(frames)}, MAX_LEN)
    cur = np.asarray(jl)[:, -1].argmax(-1).astype(np.int32)
    for t in range(L, L + 4):
        pos = np.array([t, t - 2], np.int32)
        jl, jc = jdecode(jparams, jc, jnp.asarray(cur), jnp.asarray(pos))
        tl, tc2 = tm.decode_step(tparams, tc, torch.from_numpy(cur), torch.from_numpy(pos))
        assert tc2 is tc and tuple(tl.shape) == (B, tcfg.vocab)
        _close(tl, jl)
        for key in ("k", "v", "xk", "xv"):
            _close(tc[key], jc[key])
        cur = np.asarray(jl).argmax(-1).astype(np.int32)


def test_prefill_refuses_a_max_len_below_the_prompt(ref):
    jcfg, tcfg, _, tparams = ref
    toks, frames = _inputs(jcfg, 16)
    with pytest.raises(ValueError, match="max_len"):
        tbuild(tcfg).prefill(tparams, {"tokens": torch.from_numpy(toks),
                                       "frames": torch.from_numpy(frames)}, L - 1)


MAX_BATCH, SERVE_LEN, MAX_NEW = 2, 24, 5
PROMPT_LENS = [4, 6, 4]


def test_batcher_serves_in_token_mode_as_the_jax_batcher(ref):
    """Both batchers force token mode for the encdec family (no prefill
    call), over the zero cross K/V of ``cache_init``: the same tokens,
    request by request, on both port routes and whatever mode was asked."""
    jcfg, tcfg, jparams, tparams = ref
    rng = np.random.default_rng(0)
    prompts = [rng.integers(2, jcfg.vocab, n).astype(np.int32) for n in PROMPT_LENS]

    def requests(cls):
        return [cls(req_id=i, prompt=p, max_new_tokens=MAX_NEW) for i, p in enumerate(prompts)]

    jreqs = requests(JRequest)
    jb = JBatcher(jbuild(jcfg), max_batch=MAX_BATCH, max_len=SERVE_LEN)
    jb.model_params = jparams
    jm = jb.serve(jreqs)
    assert jb.prefill_mode == "token"
    for backend, mode in (("kernel", "batched"), ("chunked", "token")):
        treqs = requests(TRequest)
        tb = TBatcher(tbuild(tcfg.replace(attn_backend=backend)), max_batch=MAX_BATCH,
                      max_len=SERVE_LEN, prefill_mode=mode)
        tb.model_params = tparams
        tm = tb.serve(treqs)
        assert tb.prefill_mode == "token" and tm.prefill_calls == 0
        assert all(r.finished_step >= 0 for r in treqs)
        assert [r.output for r in treqs] == [r.output for r in jreqs], backend
        assert [r.finished_step for r in treqs] == [r.finished_step for r in jreqs]
        assert tm.steps == jm.steps and tm.tokens_out == jm.tokens_out


def test_serve_launcher_runs_on_the_cpu(capsys):
    from repro_torch.launch import serve

    m, reqs = serve.main(["--arch", "whisper_large_v3", "--reduced", "--device", "cpu",
                          "--requests", "3", "--max-batch", "2", "--max-new", "4"])
    assert all(r.finished_step >= 0 for r in reqs) and m.prefill_calls == 0
    assert "served 3/3 requests" in capsys.readouterr().out
