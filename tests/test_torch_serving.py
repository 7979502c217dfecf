"""Port parity: continuous batching (``serving/batching.py``) and the
serve launcher on the reduced qwen3_0_6b, against the JAX package's
batcher with the same params (carried by ``params_from_numpy``) and
prompts: every request's token ids and finishing step, and the metrics'
step, token and prefill counts, must be equal."""

import numpy as np
import pytest
import torch

import jax

from repro.configs import get_reduced_config as jget
from repro.models.model_zoo import build_model as jbuild
from repro.serving.batching import ContinuousBatcher as JBatcher
from repro.serving.batching import Request as JRequest
from repro_torch.configs import get_reduced_config as tget
from repro_torch.launch import serve as tserve
from repro_torch.models.model_zoo import build_model as tbuild
from repro_torch.models.model_zoo import params_from_numpy
from repro_torch.serving.batching import ContinuousBatcher as TBatcher
from repro_torch.serving.batching import Request as TRequest

PROMPT_LENS = [5, 5, 7, 5, 7, 6]
MAX_BATCH, MAX_LEN, MAX_NEW = 2, 24, 6
COUNTS = ("steps", "tokens_out", "prefill_calls", "prefill_tokens")


@pytest.fixture(scope="module")
def ref():
    jcfg, tcfg = jget("qwen3_0_6b"), tget("qwen3_0_6b")
    jmodel = jbuild(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    tparams = params_from_numpy(tcfg, jax.tree.map(np.asarray, jparams), device="cpu")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(2, jcfg.vocab, n).astype(np.int32) for n in PROMPT_LENS]
    return jmodel, jparams, tcfg, tparams, prompts, {}


def _jax_run(ref, mode):
    jmodel, jparams, _, _, prompts, memo = ref
    if mode not in memo:
        reqs = [JRequest(req_id=i, prompt=p, max_new_tokens=MAX_NEW)
                for i, p in enumerate(prompts)]
        b = JBatcher(jmodel, max_batch=MAX_BATCH, max_len=MAX_LEN, prefill_mode=mode)
        b.model_params = jparams
        memo[mode] = (b.serve(reqs), reqs)
    return memo[mode]


@pytest.mark.parametrize("mode,backend", [("batched", "kernel"), ("batched", "chunked"),
                                          ("token", "kernel")])
def test_serve_matches_the_jax_batcher(ref, mode, backend):
    _, _, tcfg, tparams, prompts, _ = ref
    jm, jreqs = _jax_run(ref, mode)
    treqs = [TRequest(req_id=i, prompt=p, max_new_tokens=MAX_NEW) for i, p in enumerate(prompts)]
    b = TBatcher(tbuild(tcfg.replace(attn_backend=backend)), max_batch=MAX_BATCH,
                 max_len=MAX_LEN, prefill_mode=mode)
    b.model_params = tparams
    tm = b.serve(treqs)
    assert all(r.finished_step >= 0 for r in treqs)
    assert [r.output for r in treqs] == [r.output for r in jreqs]
    assert [r.finished_step for r in treqs] == [r.finished_step for r in jreqs]
    for name in COUNTS:
        assert getattr(tm, name) == getattr(jm, name), name
    assert (tm.prefill_calls > 0) == (mode == "batched")


def test_serve_needs_params():
    b = TBatcher(tbuild(tget("qwen3_0_6b")), max_batch=1, max_len=8)
    with pytest.raises(RuntimeError, match="model_params"):
        b.serve([])


def test_serve_launcher_runs_on_the_cpu(capsys):
    m, reqs = tserve.main(["--arch", "qwen3_0_6b", "--reduced", "--device", "cpu",
                           "--requests", "3", "--max-batch", "2", "--max-new", "4"])
    assert all(r.finished_step >= 0 for r in reqs) and len(reqs) == 3
    assert m.tokens_out == sum(len(r.output) - 1 for r in reqs)
    assert m.prefill_calls >= 2 and m.prefill_s > 0 and m.decode_s > 0
    assert "served 3/3 requests" in capsys.readouterr().out


def test_serve_launcher_does_not_fall_back_to_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the launcher runs there")
    with pytest.raises(SystemExit, match="no CUDA device"):
        tserve.main(["--arch", "qwen3_0_6b", "--reduced", "--requests", "1"])


# ------------------------------ ssm family ----------------------------------


@pytest.fixture(scope="module")
def ssm_ref():
    """Reduced mamba2_780m, the same six prompts as the dense tests."""
    jcfg, tcfg = jget("mamba2_780m"), tget("mamba2_780m")
    jmodel = jbuild(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    tparams = params_from_numpy(tcfg, jax.tree.map(np.asarray, jparams), device="cpu")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(2, jcfg.vocab, n).astype(np.int32) for n in PROMPT_LENS]
    return jmodel, jparams, tcfg, tparams, prompts, {}


def _torch_run(ref, mode, backend):
    _, _, tcfg, tparams, prompts, _ = ref
    treqs = [TRequest(req_id=i, prompt=p, max_new_tokens=MAX_NEW) for i, p in enumerate(prompts)]
    b = TBatcher(tbuild(tcfg.replace(ssm_backend=backend)), max_batch=MAX_BATCH,
                 max_len=MAX_LEN, prefill_mode=mode)
    b.model_params = tparams
    return b.serve(treqs), treqs


@pytest.mark.parametrize("backend", ["kernel", "chunked"])
def test_ssm_serve_matches_the_jax_batcher(ssm_ref, backend):
    jm, jreqs = _jax_run(ssm_ref, "batched")
    tm, treqs = _torch_run(ssm_ref, "batched", backend)
    assert all(r.finished_step >= 0 for r in treqs)
    assert [r.output for r in treqs] == [r.output for r in jreqs]
    assert [r.finished_step for r in treqs] == [r.finished_step for r in jreqs]
    for name in COUNTS:
        assert getattr(tm, name) == getattr(jm, name), name
    assert tm.prefill_calls > 0


def test_ssm_token_mode_starts_each_request_from_a_zero_state(ssm_ref):
    """The port's token mode zeroes a reused slot's recurrent state before
    feeding the new prompt, so it emits what batched mode emits.  The JAX
    package's token mode carries the previous request's state over: some of
    the requests that reuse a slot (2-5, with two slots) emit other tokens
    than its batched mode does (a reference finding, ROADMAP queue 3)."""
    _, jb_reqs = _jax_run(ssm_ref, "batched")
    _, jt_reqs = _jax_run(ssm_ref, "token")
    tm, tt_reqs = _torch_run(ssm_ref, "token", "kernel")
    assert tm.prefill_calls == 0
    assert [r.output for r in tt_reqs] == [r.output for r in jb_reqs]
    assert [r.finished_step for r in tt_reqs] == [r.finished_step for r in jb_reqs]
    assert [r.output for r in jt_reqs[:MAX_BATCH]] == [r.output for r in jb_reqs[:MAX_BATCH]]
    assert any(t.output != b.output for t, b in zip(jt_reqs[MAX_BATCH:], jb_reqs[MAX_BATCH:]))


def test_ssm_serve_launcher_runs_on_the_cpu(capsys):
    m, reqs = tserve.main(["--arch", "mamba2_780m", "--reduced", "--device", "cpu",
                           "--requests", "3", "--max-batch", "2", "--max-new", "4"])
    assert all(r.finished_step >= 0 for r in reqs) and len(reqs) == 3
    assert m.tokens_out == sum(len(r.output) - 1 for r in reqs)
    assert m.prefill_calls >= 2
    assert "served 3/3 requests" in capsys.readouterr().out
