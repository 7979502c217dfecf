"""Port parity: the vlm family (reduced internvl2_2b: the dense backbone with
``patch_proj``, 8 patch embeddings in front of the prompt) against the JAX
package, with the JAX init carried across by ``params_from_numpy``.

Tolerance: 5e-5 of each tensor's largest magnitude (measured over five
input seeds, on both routes: at most 8.8e-6 of it, on the logits).  The
dense family's elementwise 5e-5 + 1e-5 relative (tests/test_torch_models.py)
holds without patches, but not with them: the patches are standard normal,
as the JAX package's ``make_batch`` draws them, so their projected rows are
~20x the token embeddings (std 1/sqrt(vocab)) and K/V reach ~20; the
differences scale with the tensor's size, and the elementwise bound fails
on its small entries (6.2e-5 against 6e-5 on one of 3,072).  The port's
``"kernel"`` route runs its plain version on the CPU and is held against
JAX ``"pallas_interpret"``; ``"chunked"`` against ``"xla"``."""

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
from repro_torch.models.model_zoo import build_model as tbuild
from repro_torch.models.model_zoo import params_from_numpy
from repro_torch.serving.batching import ContinuousBatcher as TBatcher
from repro_torch.serving.batching import Request as TRequest

TOL = 5e-5
BACKENDS = [("xla", "chunked"), ("pallas_interpret", "kernel")]
B, L = 2, 8  # T = n_patches (8) + L = 16
MAX_LENS = [24, 12]  # above T, and below it: the cache is max(max_len, T) long


@pytest.fixture(scope="module")
def ref():
    jcfg, tcfg = jget("internvl2_2b"), tget("internvl2_2b")
    jparams = jbuild(jcfg).init(jax.random.PRNGKey(0))
    tparams = params_from_numpy(tcfg, jax.tree.map(np.asarray, jparams), device="cpu")
    rng = np.random.default_rng(0)
    toks = rng.integers(2, jcfg.vocab, (B, L)).astype(np.int32)
    patches = rng.standard_normal((B, jcfg.n_patches, jcfg.d_model)).astype(np.float32)
    return jcfg, tcfg, jparams, tparams, toks, patches


def _close(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(got.detach().cpu().numpy(), want, rtol=0,
                               atol=TOL * max(1.0, float(np.abs(want).max())))


def _batches(toks, patches):
    jb, tb = {"tokens": jnp.asarray(toks)}, {"tokens": torch.from_numpy(toks)}
    if patches is not None:
        jb["patches"], tb["patches"] = jnp.asarray(patches), torch.from_numpy(patches)
    return jb, tb


def test_init_has_patch_proj_and_the_jax_layout(ref):
    """``lm_init`` adds ``patch_proj`` (d_model -> d_model, no bias) to the
    dense stack; the keys and per-layer shapes are the JAX init's, and the
    carried ``patch_proj`` is the JAX one whole."""
    jcfg, tcfg, jparams, tparams, _, _ = ref
    params = tbuild(tcfg).init(torch.Generator().manual_seed(0))
    D = tcfg.d_model
    assert set(params["patch_proj"]) == {"w"} and tuple(params["patch_proj"]["w"].shape) == (D, D)

    def shapes(node, n=None):
        if isinstance(node, dict):
            return {k: shapes(v, n) for k, v in node.items()}
        return tuple(node.shape) if n is None else (n,) + tuple(node.shape)

    tshapes = shapes({k: v for k, v in params.items() if k != "layers"})
    tshapes["layers"] = shapes(params["layers"][0], len(params["layers"]))
    assert tshapes == jax.tree.map(lambda a: tuple(a.shape), jparams)
    np.testing.assert_array_equal(tparams["patch_proj"]["w"].numpy(),
                                  np.asarray(jparams["patch_proj"]["w"]))


@pytest.mark.parametrize("max_len", MAX_LENS)
@pytest.mark.parametrize("jbackend,tbackend", BACKENDS)
def test_prefill_with_patches_matches(ref, jbackend, tbackend, max_len):
    """The patches' projection in front of the prompt: logits over all T =
    n_patches + L rows, positions over the whole T, and the cache
    max(max_len, T) long."""
    jcfg, tcfg, jparams, tparams, toks, patches = ref
    jb, tb = _batches(toks, patches)
    jl, jc = jbuild(jcfg.replace(attn_backend=jbackend)).prefill(jparams, jb, max_len)
    tl, tc = tbuild(tcfg.replace(attn_backend=tbackend)).prefill(tparams, tb, max_len)
    T = tcfg.n_patches + L
    assert tuple(tl.shape) == (B, T, tcfg.vocab)
    assert tuple(tc["k"].shape) == (tcfg.n_layers, B, max(max_len, T), tcfg.n_kv_heads, tcfg.hd)
    for got, want in ((tl, jl), (tc["k"], jc["k"]), (tc["v"], jc["v"])):
        _close(got, want)


@pytest.mark.parametrize("jbackend,tbackend", BACKENDS)
def test_prefill_without_patches_is_the_dense_backbone(ref, jbackend, tbackend):
    """No ``patches``: the prompt alone, as the batcher's prefill runs it."""
    jcfg, tcfg, jparams, tparams, toks, _ = ref
    jb, tb = _batches(toks, None)
    jl, jc = jbuild(jcfg.replace(attn_backend=jbackend)).prefill(jparams, jb, MAX_LENS[0])
    tl, tc = tbuild(tcfg.replace(attn_backend=tbackend)).prefill(tparams, tb, MAX_LENS[0])
    assert tuple(tl.shape) == (B, L, tcfg.vocab)
    for got, want in ((tl, jl), (tc["k"], jc["k"]), (tc["v"], jc["v"])):
        _close(got, want)


def test_decode_steps_after_the_patch_prefix_match(ref):
    """4 steps at ragged positions after a prefill of patches and prompt."""
    jcfg, tcfg, jparams, tparams, toks, patches = ref
    jm, tm = jbuild(jcfg), tbuild(tcfg)
    jb, tb = _batches(toks, patches)
    jl, jc = jm.prefill(jparams, jb, MAX_LENS[0])
    _, tc = tm.prefill(tparams, tb, MAX_LENS[0])
    jdecode = jax.jit(jm.decode_step)
    T = tcfg.n_patches + L
    cur = np.asarray(jl)[:, -1].argmax(-1).astype(np.int32)
    for t in range(T, T + 4):
        pos = np.array([t, t - 3], np.int32)
        jl, jc = jdecode(jparams, jc, jnp.asarray(cur), jnp.asarray(pos))
        tl, tc = tm.decode_step(tparams, tc, torch.from_numpy(cur), torch.from_numpy(pos))
        assert tuple(tl.shape) == (B, tcfg.vocab)
        for got, want in ((tl, jl), (tc["k"], jc["k"]), (tc["v"], jc["v"])):
            _close(got, want)
        cur = np.asarray(jl).argmax(-1).astype(np.int32)


MAX_BATCH, SERVE_LEN, MAX_NEW = 2, 24, 5
PROMPT_LENS = [5, 7, 5]


def test_batcher_matches_the_jax_batcher(ref):
    """Both batchers prefill tokens only (no patch prefix): the same tokens,
    request by request, on both port routes and in token mode."""
    jcfg, tcfg, jparams, tparams, _, _ = ref
    rng = np.random.default_rng(1)
    prompts = [rng.integers(2, jcfg.vocab, n).astype(np.int32) for n in PROMPT_LENS]

    def requests(cls):
        return [cls(req_id=i, prompt=p, max_new_tokens=MAX_NEW) for i, p in enumerate(prompts)]

    jreqs = requests(JRequest)
    jb = JBatcher(jbuild(jcfg), max_batch=MAX_BATCH, max_len=SERVE_LEN)
    jb.model_params = jparams
    jm = jb.serve(jreqs)
    for backend, mode in (("kernel", "batched"), ("chunked", "batched"), ("kernel", "token")):
        treqs = requests(TRequest)
        tb = TBatcher(tbuild(tcfg.replace(attn_backend=backend)), max_batch=MAX_BATCH,
                      max_len=SERVE_LEN, prefill_mode=mode)
        tb.model_params = tparams
        tm = tb.serve(treqs)
        assert all(r.finished_step >= 0 for r in treqs)
        assert [r.output for r in treqs] == [r.output for r in jreqs], (backend, mode)
        assert tm.steps == jm.steps and tm.tokens_out == jm.tokens_out
        assert (tm.prefill_calls == jm.prefill_calls) == (mode == "batched")


def test_serve_launcher_runs_on_the_cpu(capsys):
    from repro_torch.launch import serve

    m, reqs = serve.main(["--arch", "internvl2_2b", "--reduced", "--device", "cpu",
                          "--requests", "3", "--max-batch", "2", "--max-new", "4"])
    assert all(r.finished_step >= 0 for r in reqs) and m.prefill_calls >= 2
    assert "served 3/3 requests" in capsys.readouterr().out
