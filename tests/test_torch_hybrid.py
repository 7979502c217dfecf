"""Port parity: the hybrid decoder (reduced zamba2_7b: mamba2 layers with
one weight-shared attention+MLP block after every 2 of them) against the
JAX package, with the JAX init carried across by ``params_from_numpy``.

At 4 layers the stack is two whole groups; at 5 it has a tail of one
mamba layer after the last group, whose state is concatenated behind the
groups' in the cache.  Tolerance: 2e-4 of each tensor's largest magnitude,
the ssm family's (tests/test_torch_models.py: the JAX init's stacked
weights make a chunk's cumsum of dt * A reach ~-1600, which f32 keeps to
~1e-4).  The port's ``"kernel"`` routes run their plain versions on the CPU
and are held against the JAX ``"pallas_interpret"`` ones; ``"chunked"``
against ``"xla"``."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import get_reduced_config as jget
from repro.models.model_zoo import build_model as jbuild
from repro.serving.batching import ContinuousBatcher as JBatcher
from repro.serving.batching import Request as JRequest
from repro_torch.configs import get_reduced_config as tget
from repro_torch.models import transformer as ttransformer
from repro_torch.models.model_zoo import build_model as tbuild
from repro_torch.models.model_zoo import params_from_numpy
from repro_torch.serving.batching import ContinuousBatcher as TBatcher
from repro_torch.serving.batching import Request as TRequest

TOL = 2e-4
BACKENDS = [("xla", "chunked"), ("pallas_interpret", "kernel")]
B, T, MAX_LEN = 2, 16, 24
DEPTHS = [4, 5]


def _cfgs(n_layers):
    return (jget("zamba2_7b").replace(n_layers=n_layers),
            tget("zamba2_7b").replace(n_layers=n_layers))


@pytest.fixture(scope="module", params=DEPTHS, ids=lambda n: f"L{n}")
def ref(request):
    jcfg, tcfg = _cfgs(request.param)
    jparams = jbuild(jcfg).init(jax.random.PRNGKey(0))
    tparams = params_from_numpy(tcfg, jax.tree.map(np.asarray, jparams), device="cpu")
    toks = np.random.default_rng(2).integers(2, jcfg.vocab, (B, T)).astype(np.int32)
    return jcfg, tcfg, jparams, tparams, toks


def _close(got, want, tol=TOL):
    want = np.asarray(want)
    np.testing.assert_allclose(got.detach().cpu().numpy(), want, rtol=0,
                               atol=tol * max(1.0, float(np.abs(want).max())))


def _shapes(node, n=None):
    if isinstance(node, dict):
        return {k: _shapes(v, n) for k, v in node.items()}
    return tuple(node.shape) if n is None else (n,) + tuple(node.shape)


def test_hybrid_split_and_groups():
    full = ttransformer.hybrid_split(tget("zamba2_7b").replace(n_layers=81, hybrid_attn_every=6))
    assert full == (13, 3)
    for n in DEPTHS:
        _, tcfg = _cfgs(n)
        after = [ttransformer._shared_after(tcfg, i) for i in range(n)]
        assert after[:4] == [None, 0, None, 1] and after[4:] == [None] * (n - 4)


def test_init_has_the_jax_package_layout(ref):
    """The same keys and shapes as the JAX init: the mamba layers stacked
    there, a list here; ``shared_attn`` one unstacked block in both."""
    jcfg, tcfg, jparams, _, _ = ref
    tparams = tbuild(tcfg).init(torch.Generator().manual_seed(0))
    tshapes = _shapes({k: v for k, v in tparams.items() if k != "layers"})
    tshapes["layers"] = _shapes(tparams["layers"][0], len(tparams["layers"]))
    assert tshapes == jax.tree.map(lambda a: tuple(a.shape), jparams)
    assert len(tparams["layers"]) == tcfg.n_layers
    assert tparams["shared_attn"]["attn"]["wq"]["w"].shape == (tcfg.d_model,
                                                              tcfg.n_heads * tcfg.hd)


def test_params_from_numpy_keeps_the_shared_block_whole(ref):
    jcfg, tcfg, jparams, tparams, _ = ref
    assert len(tparams["layers"]) == tcfg.n_layers
    for i, lp in enumerate(tparams["layers"]):
        np.testing.assert_array_equal(lp["ssm"]["in_proj"]["w"].numpy(),
                                      np.asarray(jparams["layers"]["ssm"]["in_proj"]["w"][i]))
        assert lp["ssm"]["A_log"].dtype == torch.float32
    for name in ("wq", "wk", "wv", "wo"):
        np.testing.assert_array_equal(tparams["shared_attn"]["attn"][name]["w"].numpy(),
                                      np.asarray(jparams["shared_attn"]["attn"][name]["w"]))
    np.testing.assert_array_equal(tparams["shared_attn"]["mlp"]["wo"]["w"].numpy(),
                                  np.asarray(jparams["shared_attn"]["mlp"]["wo"]["w"]))


@pytest.mark.parametrize("jbackend,tbackend", BACKENDS)
def test_prefill_logits_and_cache_match(ref, jbackend, tbackend):
    jcfg, tcfg, jparams, tparams, toks = ref
    jl, jc = jbuild(jcfg.replace(attn_backend=jbackend, ssm_backend=jbackend)).prefill(
        jparams, {"tokens": jnp.asarray(toks)}, MAX_LEN)
    tl, tc = tbuild(tcfg.replace(attn_backend=tbackend, ssm_backend=tbackend)).prefill(
        tparams, {"tokens": torch.from_numpy(toks)}, MAX_LEN)
    L, n_groups = tcfg.n_layers, tcfg.n_layers // tcfg.hybrid_attn_every
    H, N, dh = 2 * tcfg.d_model // tcfg.ssm_head_dim, tcfg.ssm_state, tcfg.ssm_head_dim
    assert set(tc) == set(jc) == {"S", "conv", "k", "v"}
    assert tuple(tl.shape) == (B, T, tcfg.vocab)
    assert tuple(tc["S"].shape) == (L, B, H, N, dh)
    assert tuple(tc["conv"].shape) == (L, B, 3, 2 * tcfg.d_model + 2 * N)
    assert tuple(tc["k"].shape) == (n_groups, B, MAX_LEN, tcfg.n_kv_heads, tcfg.hd)
    _close(tl, jl)
    for key in ("S", "conv", "k", "v"):
        _close(tc[key], jc[key])


def test_decode_steps_match_at_ragged_positions(ref):
    jcfg, tcfg, jparams, tparams, toks = ref
    jm, tm = jbuild(jcfg), tbuild(tcfg)
    jl, jc = jm.prefill(jparams, {"tokens": jnp.asarray(toks)}, MAX_LEN)
    _, tc = tm.prefill(tparams, {"tokens": torch.from_numpy(toks)}, MAX_LEN)
    cur = np.asarray(jl)[:, -1].argmax(-1).astype(np.int32)
    for t in range(T, T + 3):
        pos = np.array([t, t - 3], np.int32)
        jl, jc = jm.decode_step(jparams, jc, jnp.asarray(cur), jnp.asarray(pos))
        tl, tc2 = tm.decode_step(tparams, tc, torch.from_numpy(cur), torch.from_numpy(pos))
        assert tc2 is tc  # written in place
        assert tuple(tl.shape) == (B, tcfg.vocab)
        _close(tl, jl)
        for key in ("S", "conv", "k", "v"):
            _close(tc[key], jc[key])
        cur = np.asarray(jl).argmax(-1).astype(np.int32)


@pytest.mark.parametrize("backend", ["chunked", "kernel"])
def test_prefill_then_decode_equals_the_full_prefill(ref, backend):
    """Prefill of T-1 tokens, then one decode step of the last, gives the full
    prefill's last logits (tests/test_models_smoke.py's check, on the
    port): the groups' K/V and every layer's state, the tail's included,
    carry on from the cache."""
    _, tcfg, _, tparams, toks = ref
    tm = tbuild(tcfg.replace(attn_backend=backend, ssm_backend=backend))
    x = torch.from_numpy(toks)
    full, _ = tm.prefill(tparams, {"tokens": x}, MAX_LEN)
    _, cache = tm.prefill(tparams, {"tokens": x[:, :T - 1]}, MAX_LEN)
    dec, _ = tm.decode_step(tparams, cache, x[:, T - 1], torch.full((B,), T - 1))
    np.testing.assert_allclose(dec.numpy(), full[:, -1].numpy(), atol=2e-3, rtol=2e-3)


# ------------------------------- serving ------------------------------------

PROMPT_LENS = [5, 5, 7, 5, 7, 6]
MAX_BATCH, SERVE_LEN, MAX_NEW = 2, 24, 6


def _requests(cls, prompts):
    return [cls(req_id=i, prompt=p, max_new_tokens=MAX_NEW) for i, p in enumerate(prompts)]


def test_batcher_matches_the_jax_batcher_and_token_mode(ref):
    """The batcher needs no change for the hybrid: its caches are
    layers-first (K/V groups-first) with the batch on axis 1.  Batched
    prefill on both routes equals the JAX batcher request by request; token
    mode (each slot's state zeroed first) emits the same tokens."""
    jcfg, tcfg, jparams, tparams, _ = ref
    rng = np.random.default_rng(0)
    prompts = [rng.integers(2, jcfg.vocab, n).astype(np.int32) for n in PROMPT_LENS]
    jreqs = _requests(JRequest, prompts)
    jb = JBatcher(jbuild(jcfg), max_batch=MAX_BATCH, max_len=SERVE_LEN)
    jb.model_params = jparams
    jm = jb.serve(jreqs)
    for backend, mode in (("kernel", "batched"), ("chunked", "batched"), ("kernel", "token")):
        treqs = _requests(TRequest, prompts)
        tb = TBatcher(tbuild(tcfg.replace(attn_backend=backend, ssm_backend=backend)),
                      max_batch=MAX_BATCH, max_len=SERVE_LEN, prefill_mode=mode)
        tb.model_params = tparams
        tm = tb.serve(treqs)
        assert all(r.finished_step >= 0 for r in treqs)
        assert [r.output for r in treqs] == [r.output for r in jreqs], (backend, mode)
        assert [r.finished_step for r in treqs] == [r.finished_step for r in jreqs]
        assert tm.steps == jm.steps and tm.tokens_out == jm.tokens_out
        assert (tm.prefill_calls == jm.prefill_calls) == (mode == "batched")


def test_serve_launcher_runs_on_the_cpu(capsys):
    from repro_torch.launch import serve

    m, reqs = serve.main(["--arch", "zamba2_7b", "--reduced", "--device", "cpu",
                          "--requests", "3", "--max-batch", "2", "--max-new", "4"])
    assert all(r.finished_step >= 0 for r in reqs) and m.prefill_calls >= 2
    assert "served 3/3 requests" in capsys.readouterr().out
