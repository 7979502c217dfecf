"""Port parity: the MoE layer (``models/moe.py``) and the moe decoder
(reduced granite_moe_1b_a400m; reduced kimi_k2_1t_a32b, with its shared
expert) against the JAX package, with the JAX init carried across by
``params_from_numpy`` (one layer's, directly).

Tolerance: 2e-5 of each tensor's largest magnitude: the two run the same
f32 arithmetic with sums in another order, and the K/V cache of a moe
layer stack reaches ~12, where one element of 3,072 differed by 7e-5
after three decode steps (a relative 1.5e-4 against the dense family's
elementwise 1e-5); the largest difference measured is 3.8e-6 of the
largest magnitude.  Routing is held exactly: the experts each token
picks (``top_e``), the capacity and the copies dropped past it equal the
JAX package's, computed there from its own router."""

import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import get_reduced_config as jget
from repro.models import moe as jmoe
from repro.models.common import dense_apply as jdense_apply
from repro.models.model_zoo import build_model as jbuild
from repro.serving.batching import ContinuousBatcher as JBatcher
from repro.serving.batching import Request as JRequest
from repro_torch.configs import get_reduced_config as tget
from repro_torch.models import moe as tmoe
from repro_torch.models.model_zoo import build_model as tbuild
from repro_torch.models.model_zoo import params_from_numpy
from repro_torch.serving.batching import ContinuousBatcher as TBatcher
from repro_torch.serving.batching import Request as TRequest

TOL = 2e-5
ARCHS = ["granite_moe_1b_a400m", "kimi_k2_1t_a32b"]
BACKENDS = [("xla", "chunked"), ("pallas_interpret", "kernel")]
B, T, MAX_LEN = 2, 16, 24


def _close(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(got.detach().cpu().numpy(), want, rtol=0,
                               atol=TOL * max(1.0, float(np.abs(want).max())))


def _layer(arch, seed=0, **replace):
    """One MoE layer's params from the JAX init (the port's copy beside)
    and a seeded input (B, T, D)."""
    jcfg, tcfg = jget(arch).replace(**replace), tget(arch).replace(**replace)
    jp = jmoe.moe_init(jax.random.PRNGKey(seed), jcfg)
    tp = jax.tree.map(lambda a: torch.from_numpy(np.array(a)), jp)
    x = np.random.default_rng(seed).standard_normal((B, T, jcfg.d_model)).astype(np.float32)
    return jcfg, tcfg, jp, tp, x


def _jax_routing(jcfg, jp, x_flat):
    """The JAX package's router on its own params: (top_e, capacity,
    dropped copies), the drops counted from its stable order by expert."""
    n, K, E = x_flat.shape[0], jcfg.moe_top_k, jcfg.n_experts
    probs = jax.nn.softmax(jdense_apply(jp["router"], jnp.asarray(x_flat), jnp.float32), -1)
    top_e = np.asarray(jax.lax.top_k(probs, K)[1])
    C = max(8, int(math.ceil(n * K / E * jcfg.moe_capacity_factor)))
    seen = np.zeros(E, np.int64)
    dropped = 0
    for e in top_e.reshape(-1):
        dropped += seen[e] >= C
        seen[e] += 1
    return top_e, C, int(dropped)


def _port_routing(tcfg, tp, x_flat):
    _, _, top_e = tmoe.route(tp, tcfg, torch.from_numpy(x_flat))
    C = tmoe.capacity(tcfg, x_flat.shape[0])
    rank = tmoe.rank_in_expert(top_e.reshape(-1), tcfg.n_experts)
    return top_e.numpy(), C, int((rank >= C).sum())


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("drops", [True, False], ids=["capacity-drops", "drop-free"])
def test_moe_apply_matches_the_jax_layer(arch, drops):
    """One layer on 32 tokens: at the config's capacity factor 1.25 the
    capacity (10 slots an expert for 64 copies over 8 experts) drops
    copies; at ``moe_capacity_factor = n_experts`` none is dropped."""
    replace = {} if drops else {"moe_capacity_factor": float(jget(arch).n_experts)}
    jcfg, tcfg, jp, tp, x = _layer(arch, **replace)
    flat = x.reshape(-1, jcfg.d_model)
    j_top, j_cap, j_drop = _jax_routing(jcfg, jp, flat)
    t_top, t_cap, t_drop = _port_routing(tcfg, tp, flat)
    np.testing.assert_array_equal(t_top, j_top)
    assert (t_cap, t_drop) == (j_cap, j_drop)
    assert (t_drop > 0) == drops
    want = jmoe.moe_apply(jp, jcfg, jnp.asarray(x))
    got = tmoe.moe_apply(tp, tcfg, torch.from_numpy(x))
    assert tuple(got.shape) == x.shape
    _close(got, want)
    if "shared" in tp:  # kimi: the shared expert is in the sum
        assert tp["shared"]["wi"]["w"].shape == (tcfg.d_model, tcfg.moe_d_ff)


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_local_summed_over_expert_shards_equals_one_shard(arch):
    """The switch: each of ep = 2 shards keeps the copies its range of
    expert ids owns; the partial outputs sum to the single shard's, drops
    included (a copy's rank is counted over all copies of its expert)."""
    _, tcfg, _, tp, x = _layer(arch, seed=1)
    xf = torch.from_numpy(x.reshape(-1, tcfg.d_model))
    one = tmoe._moe_local(tp, tcfg, xf, 0, 1, torch.float32)
    E_loc = tcfg.n_experts // 2
    parts = []
    for r in range(2):
        pr = dict(tp, **{k: tp[k][r * E_loc:(r + 1) * E_loc] for k in ("wi", "wg", "wo")})
        parts.append(tmoe._moe_local(pr, tcfg, xf, r, 2, torch.float32))
    assert all(float(p.abs().max()) > 0 for p in parts)
    torch.testing.assert_close(parts[0] + parts[1], one, atol=1e-6, rtol=1e-6)


# ----------------------------- the decoder ----------------------------------


@pytest.fixture(scope="module", params=ARCHS)
def ref(request):
    jcfg, tcfg = jget(request.param), tget(request.param)
    jparams = jbuild(jcfg).init(jax.random.PRNGKey(0))
    tparams = params_from_numpy(tcfg, jax.tree.map(np.asarray, jparams), device="cpu")
    toks = np.random.default_rng(3).integers(2, jcfg.vocab, (B, T)).astype(np.int32)
    return jcfg, tcfg, jparams, tparams, toks


def test_init_has_the_jax_package_layout(ref):
    jcfg, tcfg, jparams, tparams, _ = ref
    mine = tbuild(tcfg).init(torch.Generator().manual_seed(0))

    def shapes(node, n=None):
        if isinstance(node, dict):
            return {k: shapes(v, n) for k, v in node.items()}
        return tuple(node.shape) if n is None else (n,) + tuple(node.shape)

    got = shapes({k: v for k, v in mine.items() if k != "layers"})
    got["layers"] = shapes(mine["layers"][0], len(mine["layers"]))
    assert got == jax.tree.map(lambda a: tuple(a.shape), jparams)
    E, D, Fd = tcfg.n_experts, tcfg.d_model, tcfg.moe_d_ff
    assert tuple(tparams["layers"][1]["moe"]["wo"].shape) == (E, Fd, D)
    np.testing.assert_array_equal(tparams["layers"][1]["moe"]["wi"].numpy(),
                                  np.asarray(jparams["layers"]["moe"]["wi"][1]))


@pytest.mark.parametrize("jbackend,tbackend", BACKENDS)
def test_prefill_and_decode_steps_match(ref, jbackend, tbackend):
    jcfg, tcfg, jparams, tparams, toks = ref
    jm = jbuild(jcfg.replace(attn_backend=jbackend))
    tm = tbuild(tcfg.replace(attn_backend=tbackend))
    jl, jc = jm.prefill(jparams, {"tokens": jnp.asarray(toks)}, MAX_LEN)
    tl, tc = tm.prefill(tparams, {"tokens": torch.from_numpy(toks)}, MAX_LEN)
    assert tuple(tl.shape) == (B, T, tcfg.vocab)
    assert tuple(tc["k"].shape) == (tcfg.n_layers, B, MAX_LEN, tcfg.n_kv_heads, tcfg.hd)
    _close(tl, jl)
    _close(tc["k"], jc["k"])
    _close(tc["v"], jc["v"])
    cur = np.asarray(jl)[:, -1].argmax(-1).astype(np.int32)
    for t in range(T, T + 3):
        pos = np.array([t, t - 2], np.int32)
        jl, jc = jm.decode_step(jparams, jc, jnp.asarray(cur), jnp.asarray(pos))
        tl, tc = tm.decode_step(tparams, tc, torch.from_numpy(cur), torch.from_numpy(pos))
        _close(tl, jl)
        _close(tc["k"], jc["k"])
        cur = np.asarray(jl).argmax(-1).astype(np.int32)


def test_batched_serving_matches_the_jax_batcher(ref):
    """Batched prefill as the reference does it: the rows of slots not
    admitted carry token 0, route, and take capacity from the admitted
    rows; the port keeps that.  Every request's tokens and finishing step,
    and the step and prefill counts, equal the JAX batcher's."""
    jcfg, tcfg, jparams, tparams, _ = ref
    rng = np.random.default_rng(0)
    prompts = [rng.integers(2, jcfg.vocab, n).astype(np.int32) for n in [5, 5, 7, 5, 7, 6]]
    jreqs = [JRequest(req_id=i, prompt=p, max_new_tokens=6) for i, p in enumerate(prompts)]
    jb = JBatcher(jbuild(jcfg), max_batch=2, max_len=24)
    jb.model_params = jparams
    jm = jb.serve(jreqs)
    treqs = [TRequest(req_id=i, prompt=p, max_new_tokens=6) for i, p in enumerate(prompts)]
    tb = TBatcher(tbuild(tcfg), max_batch=2, max_len=24)
    tb.model_params = tparams
    tm = tb.serve(treqs)
    assert all(r.finished_step >= 0 for r in treqs)
    assert [r.output for r in treqs] == [r.output for r in jreqs]
    assert [r.finished_step for r in treqs] == [r.finished_step for r in jreqs]
    for name in ("steps", "tokens_out", "prefill_calls", "prefill_tokens"):
        assert getattr(tm, name) == getattr(jm, name), name


def test_prefill_then_decode_equals_the_full_prefill(ref):
    """With drop-free routing (tests/test_models_smoke.py's condition: a
    prefill's capacity would drop copies one decode step keeps), prefill
    of T-1 tokens then one decode step gives the full prefill's last
    logits."""
    _, tcfg, _, tparams, toks = ref
    tm = tbuild(tcfg.replace(moe_capacity_factor=float(tcfg.n_experts)))
    x = torch.from_numpy(toks)
    full, _ = tm.prefill(tparams, {"tokens": x}, MAX_LEN)
    _, cache = tm.prefill(tparams, {"tokens": x[:, :T - 1]}, MAX_LEN)
    dec, _ = tm.decode_step(tparams, cache, x[:, T - 1], torch.full((B,), T - 1))
    np.testing.assert_allclose(dec.numpy(), full[:, -1].numpy(), atol=2e-3, rtol=2e-3)


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_launcher_runs_on_the_cpu(arch, capsys):
    from repro_torch.launch import serve

    m, reqs = serve.main(["--arch", arch, "--reduced", "--device", "cpu",
                          "--requests", "3", "--max-batch", "2", "--max-new", "4"])
    assert all(r.finished_step >= 0 for r in reqs) and m.prefill_calls >= 2
    assert "served 3/3 requests" in capsys.readouterr().out
