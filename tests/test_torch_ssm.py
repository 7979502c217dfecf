"""Port parity: the Mamba2 block (``models/ssm.py``) on the reduced
mamba2_780m against the JAX package's, with the JAX init carried across by
``params_from_numpy``.

The two run the same f32 arithmetic with the sums in another order, so the
tolerance is stated against each tensor's largest magnitude: |port - JAX|
<= TOL[L] * max|JAX|.  At L = 8 that is 1e-5.  At L = 200 it is 2e-4: the
JAX init draws each stacked weight with std 1/sqrt(n_layers) (its
``uniform_scale_init`` takes the stack axis as the fan-in), so in_proj's
dt reaches ~20, a 128-row chunk's cumsum of dt * A reaches ~-1600, and f32
keeps that sum to ~1e-4 (measured: 9.3e-5 of the largest output, in both
routes; JAX's and torch's cumsums each differ from an f64 one by ~1e-4).
The port's ``"kernel"`` route runs its plain version on the CPU and is held
against JAX ``backend="pallas_interpret"``; ``"chunked"`` against
``"xla"``.  L=200 is padded to 256 and scanned in chunks of 128; L=8 runs
with chunk = L."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import get_reduced_config as jget
from repro.models import ssm as jssm
from repro.models.model_zoo import build_model as jbuild
from repro_torch.configs import get_reduced_config as tget
from repro_torch.models import ssm as tssm
from repro_torch.models.model_zoo import build_model as tbuild
from repro_torch.models.model_zoo import params_from_numpy

TOL = {8: 1e-5, 200: 2e-4}  # of each tensor's largest magnitude
BACKENDS = [("xla", "chunked"), ("pallas_interpret", "kernel")]
BATCH = 2


@pytest.fixture(scope="module")
def ref():
    """One layer's params of the JAX init, the port's copy, and inputs."""
    jcfg, tcfg = jget("mamba2_780m"), tget("mamba2_780m")
    jparams = jbuild(jcfg).init(jax.random.PRNGKey(0))
    lp_j = jax.tree.map(lambda a: a[0], jparams["layers"]["ssm"])
    tparams = params_from_numpy(tcfg, jax.tree.map(np.asarray, jparams), device="cpu")
    lp_t = tparams["layers"][0]["ssm"]
    rng = np.random.default_rng(0)
    xs = {L: rng.standard_normal((BATCH, L, jcfg.d_model)).astype(np.float32)
          for L in (8, 200)}
    return jcfg, tcfg, lp_j, lp_t, xs


def _close(got, want, tol):
    want = np.asarray(want)
    np.testing.assert_allclose(got.detach().cpu().numpy(), want, rtol=0,
                               atol=tol * max(1.0, float(np.abs(want).max())))


@pytest.mark.parametrize("L", [8, 200])
@pytest.mark.parametrize("jbackend,tbackend", BACKENDS)
def test_ssm_apply_matches(ref, L, jbackend, tbackend, monkeypatch):
    jcfg, tcfg, lp_j, lp_t, xs = ref
    # on CPU tensors both routes reach the plain scan, the kernel route
    # through ssd_scan's wrapper without a launch
    plain = []
    for mod in (tssm.ssd_ref, tssm.ssd_ops):
        real = mod.ssd_chunked_batched
        monkeypatch.setattr(mod, "ssd_chunked_batched",
                            lambda *a, real=real, mod=mod, **k: plain.append(mod) or real(*a, **k))
    launches = tssm.ssd_ops.ssd_scan.launches
    jout, jst = jssm.ssm_apply(lp_j, jcfg, jnp.asarray(xs[L]), backend=jbackend,
                               return_state=True)
    tout, tst = tssm.ssm_apply(lp_t, tcfg.replace(ssm_backend=tbackend), torch.from_numpy(xs[L]),
                               return_state=True)
    d_inner, H = tssm.ssm_dims(tcfg)
    assert tuple(tout.shape) == (BATCH, L, tcfg.d_model)
    assert tuple(tst["S"].shape) == (BATCH, H, tcfg.ssm_state, tcfg.ssm_head_dim)
    assert tuple(tst["conv"].shape) == (BATCH, tssm.CONV_K - 1, d_inner + 2 * tcfg.ssm_state)
    _close(tout, jout, TOL[L])
    _close(tst["S"], jst["S"], TOL[L])
    _close(tst["conv"], jst["conv"], TOL[L])
    again = tssm.ssm_apply(lp_t, tcfg.replace(ssm_backend=tbackend), torch.from_numpy(xs[L]))
    # two f32 evaluations agree within f32 rounding, 1e-6 of the largest
    # magnitude: a CPU GEMM does not promise bit-equal results from call to
    # call when other processes compete for the cores
    _close(again, tout.numpy(), 1e-6)
    route = tssm.ssd_ops if tbackend == "kernel" else tssm.ssd_ref
    assert plain == [route, route] and tssm.ssd_ops.ssd_scan.launches == launches


def test_ssm_decode_apply_matches(ref):
    jcfg, tcfg, lp_j, lp_t, xs = ref
    _, jst = jssm.ssm_apply(lp_j, jcfg, jnp.asarray(xs[8]), return_state=True)
    _, tst = tssm.ssm_apply(lp_t, tcfg, torch.from_numpy(xs[8]), return_state=True)
    x1 = np.random.default_rng(1).standard_normal((BATCH, 1, jcfg.d_model)).astype(np.float32)
    for _ in range(2):
        jout, jst = jssm.ssm_decode_apply(lp_j, jcfg, jnp.asarray(x1), jst)
        S_in = tst["S"].clone()
        tout, tst = tssm.ssm_decode_apply(lp_t, tcfg, torch.from_numpy(x1), tst)
        assert tuple(tout.shape) == (BATCH, 1, tcfg.d_model)
        _close(tout, jout, TOL[8])
        _close(tst["S"], jst["S"], TOL[8])
        _close(tst["conv"], jst["conv"], TOL[8])
        assert not torch.equal(S_in, tst["S"])
        x1 = np.asarray(jout)


@pytest.mark.parametrize("T", [7, 130])
@pytest.mark.parametrize("backend", ["kernel", "chunked"])
def test_prefill_then_decode_equals_longer_prefill(T, backend):
    """A prefill of T tokens and one decode step give the logits of a
    prefill of T+1 tokens at its last position, and the same state (the
    recurrence against the chunked scan, in f32: 1e-4)."""
    cfg = tget("mamba2_780m").replace(ssm_backend=backend)
    model = tbuild(cfg)
    params = model.init(torch.Generator().manual_seed(0))
    toks = torch.from_numpy(
        np.random.default_rng(T).integers(2, cfg.vocab, (BATCH, T + 1)).astype(np.int32))
    _, cache = model.prefill(params, {"tokens": toks[:, :T]}, T + 8)
    step, cache = model.decode_step(params, cache, toks[:, T], torch.full((BATCH,), T))
    full, fcache = model.prefill(params, {"tokens": toks}, T + 8)
    torch.testing.assert_close(step, full[:, -1], atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(cache["S"], fcache["S"], atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(cache["conv"], fcache["conv"], atol=1e-4, rtol=1e-4)


def test_init_has_the_jax_package_layout(ref):
    jcfg, tcfg, lp_j, _, _ = ref
    lp = tssm.ssm_init(torch.Generator().manual_seed(0), tcfg)
    jshapes = jax.tree.map(lambda a: (tuple(a.shape), str(a.dtype)), lp_j)

    def shapes(node):
        if isinstance(node, dict):
            return {k: shapes(v) for k, v in node.items()}
        return tuple(node.shape), str(node.dtype).replace("torch.", "")

    assert shapes(lp) == jshapes
    A = -torch.exp(lp["A_log"])
    assert bool((A <= -1.0).all() and (A >= -16.0).all())
    assert bool((lp["dt_bias"] >= np.log(1e-3)).all() and (lp["dt_bias"] <= np.log(1e-1)).all())


def test_unknown_ssm_backend_raises(ref):
    _, tcfg, _, lp_t, xs = ref
    with pytest.raises(ValueError, match="ssm_backend"):
        tssm.ssm_apply(lp_t, tcfg.replace(ssm_backend="xla"), torch.from_numpy(xs[8]))
