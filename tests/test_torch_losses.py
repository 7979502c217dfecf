"""Port parity: the training losses against the JAX package's.

  * ``cross_entropy_loss`` and ``chunked_softmax_xent`` (a chunk that does
    not divide the length, so padding; a mask; ``z_loss``), values and
    gradients against ``jax.value_and_grad`` of the JAX functions;
  * ``Model.loss`` and its gradient on every family at reduced size (dense
    qwen3_0_6b, ssm mamba2_780m, hybrid zamba2_7b, moe granite_moe_1b_a400m,
    vlm internvl2_2b with patches, encdec whisper_large_v3) against the JAX
    model's loss and ``jax.grad`` (the JAX routes "xla", which its training
    runs; the port's "kernel" routes, the ``autograd.Function``s over the
    plain versions on the CPU), on two sets of weights:
      - the port's init, restacked into the JAX layout by ``state_to_numpy``:
        loss and every gradient leaf within 1e-5 of its largest magnitude
        (measured: at most 1.1e-6);
      - the JAX init, carried across by ``params_from_numpy``.  Its stacked
        fan-in draws every layer weight of a reduced config with std
        1/sqrt(n_layers) = 0.71, so without qk-norm the attention scores
        reach ~100-140 and the softmax is saturated, and the two packages'
        f32 roundings part further in the backward.  Loss within 1e-5 (5e-4
        for Whisper, as its forward parity); gradients within 1e-5 of each
        leaf's largest magnitude for qwen3_0_6b (qk-norm; measured 1.4e-6),
        1e-4 for the ssm families (the ssm forward's tolerance; measured
        1.3e-5), 2e-4 for granite and internvl (measured 9.7e-5 and 3.6e-5)
        and 2e-3 for Whisper (measured 1.1e-3; the port's own two attention
        routes differ by 2.2e-4 there);
  * ``remat`` "none", "dots" and "full" give the same loss and gradients
    within 1e-6 of each leaf's largest magnitude (two f32 CPU evaluations,
    never bit for bit: a CPU GEMM under load can differ in the last bits).
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import get_reduced_config as jget
from repro.models import common as jcommon
from repro.models.model_zoo import build_model as jbuild
from repro_torch.configs import get_reduced_config as tget
from repro_torch.distributed.checkpoint import tree_flatten_with_path, tree_unflatten
from repro_torch.models import common as tcommon
from repro_torch.models.model_zoo import build_model as tbuild
from repro_torch.models.model_zoo import params_from_numpy, state_to_numpy

B, L = 2, 16
FAMILIES = ["qwen3_0_6b", "mamba2_780m", "zamba2_7b", "granite_moe_1b_a400m", "internvl2_2b",
            "whisper_large_v3"]
LOSS_TOL = {"whisper_large_v3": 5e-4}
GRAD_TOL = {"mamba2_780m": 1e-4, "zamba2_7b": 1e-4, "granite_moe_1b_a400m": 2e-4,
            "internvl2_2b": 2e-4, "whisper_large_v3": 2e-3}


def _rel_close(got, want, tol):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = max(1.0, float(np.abs(want).max())) if want.size else 1.0
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * scale)


def _batch(cfg, seed=0, mask=False):
    rng = np.random.default_rng(seed)
    toks = rng.integers(1, cfg.vocab, (B, L)).astype(np.int32)
    batch = {"tokens": toks, "labels": np.roll(toks, -1, axis=1)}
    if cfg.family == "vlm":
        batch["patches"] = rng.standard_normal((B, cfg.n_patches, cfg.d_model)).astype(np.float32)
    if cfg.family == "encdec":
        batch["frames"] = rng.standard_normal(
            (B, cfg.n_audio_frames, cfg.d_model)).astype(np.float32)
    if mask:
        batch["mask"] = (rng.random((B, L)) < 0.7).astype(np.float32)
    return batch


def _torch_batch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def value_and_grad(model, params, batch):
    """The port's loss and its gradient tree (a leaf for each param)."""
    leaves = [p.detach().requires_grad_() for _, p in tree_flatten_with_path(params)]
    loss = model.loss(tree_unflatten(params, leaves), batch)
    grads = torch.autograd.grad(loss, leaves)
    return float(loss.detach()), tree_unflatten(params, list(grads))


def _assert_grads_close(cfg, tgrads, jgrads, tol):
    got = state_to_numpy(cfg, tgrads)
    want = jax.tree.map(np.asarray, jgrads)
    flat_g = jax.tree_util.tree_flatten_with_path(got)[0]
    flat_w = jax.tree_util.tree_flatten_with_path(want)[0]
    assert [p for p, _ in flat_g] == [p for p, _ in flat_w]
    for (path, g), (_, w) in zip(flat_g, flat_w):
        assert g.shape == w.shape, path
        try:
            _rel_close(g, w, tol)
        except AssertionError as e:
            raise AssertionError(f"{jax.tree_util.keystr(path)}: {e}") from None


# ------------------------------ the losses ----------------------------------


@pytest.mark.parametrize("z_loss", [0.0, 1e-4])
@pytest.mark.parametrize("mask", [False, True])
def test_cross_entropy_loss_matches_jax(z_loss, mask):
    rng = np.random.default_rng(1)
    logits = (rng.standard_normal((3, 7, 50)) * 3).astype(np.float32)
    labels = rng.integers(0, 50, (3, 7)).astype(np.int32)
    m = (rng.random((3, 7)) < 0.6).astype(np.float32) if mask else None
    jv, jg = jax.value_and_grad(lambda x: jcommon.cross_entropy_loss(
        x, jnp.asarray(labels), z_loss=z_loss, mask=None if m is None else jnp.asarray(m)))(
        jnp.asarray(logits))
    x = torch.from_numpy(logits).requires_grad_()
    tv = tcommon.cross_entropy_loss(x, torch.from_numpy(labels), z_loss=z_loss,
                                    mask=None if m is None else torch.from_numpy(m))
    tv.backward()
    _rel_close(float(tv.detach()), float(jv), 1e-6)
    _rel_close(x.grad.numpy(), np.asarray(jg), 1e-6)


@pytest.mark.parametrize("chunk", [16, 5, 512])  # divides; pads 16 -> 20; one chunk
@pytest.mark.parametrize("z_loss,mask", [(0.0, False), (1e-4, True)])
def test_chunked_softmax_xent_matches_jax(chunk, z_loss, mask):
    rng = np.random.default_rng(2)
    h = rng.standard_normal((2, 16, 24)).astype(np.float32)
    w = (rng.standard_normal((24, 40)) / 5).astype(np.float32)
    labels = rng.integers(0, 40, (2, 16)).astype(np.int32)
    m = (rng.random((2, 16)) < 0.6).astype(np.float32) if mask else None

    def jloss(h, w):
        return jcommon.chunked_softmax_xent(h, w, jnp.asarray(labels), chunk=chunk,
                                            z_loss=z_loss,
                                            mask=None if m is None else jnp.asarray(m))

    jv, (jgh, jgw) = jax.value_and_grad(jloss, argnums=(0, 1))(jnp.asarray(h), jnp.asarray(w))
    th, tw = torch.from_numpy(h).requires_grad_(), torch.from_numpy(w).requires_grad_()
    tv = tcommon.chunked_softmax_xent(th, tw, torch.from_numpy(labels), chunk=chunk,
                                      z_loss=z_loss,
                                      mask=None if m is None else torch.from_numpy(m))
    tv.backward()
    tv = float(tv.detach())
    _rel_close(tv, float(jv), 1e-6)
    _rel_close(th.grad.numpy(), np.asarray(jgh), 1e-6)
    _rel_close(tw.grad.numpy(), np.asarray(jgw), 1e-6)
    # and the unchunked loss on the same rows
    full = tcommon.cross_entropy_loss(th.detach() @ tw.detach(), torch.from_numpy(labels),
                                      z_loss=z_loss,
                                      mask=None if m is None else torch.from_numpy(m))
    _rel_close(tv, float(full), 1e-6)


def test_chunked_xent_holds_one_chunk_of_logits_for_the_backward():
    """The chunk body is recomputed in the backward: what autograd keeps
    for it is its inputs, not its (B, chunk, V) logits."""
    h = torch.randn(2, 64, 8, requires_grad=True)
    w = torch.randn(8, 1000, requires_grad=True)
    labels = torch.randint(0, 1000, (2, 64))
    saved = []

    def pack(t):
        saved.append(t.numel())
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        tcommon.chunked_softmax_xent(h, w, labels, chunk=16)
    assert max(saved) < 2 * 16 * 1000


# ----------------------------- Model.loss -----------------------------------


@functools.lru_cache(maxsize=None)
def _family(arch):
    jcfg, tcfg = jget(arch), tget(arch)
    if arch == "qwen3_0_6b":  # a CE chunk that pads: 16 rows in chunks of 6
        jcfg, tcfg = jcfg.replace(ce_chunk=6), tcfg.replace(ce_chunk=6)
    jparams = jbuild(jcfg).init(jax.random.PRNGKey(0))
    tparams = params_from_numpy(tcfg, jax.tree.map(np.asarray, jparams), device="cpu")
    return jcfg, tcfg, jparams, tparams


@functools.lru_cache(maxsize=None)
def _jax_value_and_grad(arch):
    """The JAX model's loss and gradient, compiled once for both inits."""
    return jax.jit(jax.value_and_grad(jbuild(_family(arch)[0]).loss))


def check_model_loss(arch, init):
    """``Model.loss`` and its gradient against the JAX model's on ``init``'s
    weights ("port" or "jax")."""
    jcfg, tcfg, jparams, tparams = _family(arch)
    if init == "port":
        tparams = tbuild(tcfg).init(torch.Generator().manual_seed(0))
        jparams = jax.tree.map(jnp.asarray, state_to_numpy(tcfg, tparams))
    batch = _batch(tcfg, seed=3, mask=arch == "qwen3_0_6b")
    jloss, jgrads = _jax_value_and_grad(arch)(jparams, jax.tree.map(jnp.asarray, batch))
    tloss, tgrads = value_and_grad(tbuild(tcfg), tparams, _torch_batch(batch))
    _rel_close(tloss, float(jloss), 1e-5 if init == "port" else LOSS_TOL.get(arch, 1e-5))
    _assert_grads_close(tcfg, tgrads, jgrads, 1e-5 if init == "port" else GRAD_TOL.get(arch, 1e-5))


def check_remat(arch, remat):
    """``remat`` gives the loss and gradients of "none"."""
    _, tcfg, _, tparams = _family(arch)
    batch = _torch_batch(_batch(tcfg, seed=4))
    base_loss, base = value_and_grad(tbuild(tcfg), tparams, batch)
    loss, grads = value_and_grad(tbuild(tcfg.replace(remat=remat)), tparams, batch)
    _rel_close(loss, base_loss, 1e-6)
    for (path, g), (_, w) in zip(tree_flatten_with_path(grads), tree_flatten_with_path(base)):
        _rel_close(g.numpy(), w.numpy(), 1e-6)


# the dense, moe and vlm families here; the ssm, hybrid and encdec ones in
# test_torch_losses_ssm_encdec.py (--dist loadfile spreads the two files)
HERE = ["qwen3_0_6b", "granite_moe_1b_a400m", "internvl2_2b"]


@pytest.mark.parametrize("init", ["port", "jax"])
@pytest.mark.parametrize("arch", HERE)
def test_model_loss_and_grads_match_jax(arch, init):
    check_model_loss(arch, init)


@pytest.mark.parametrize("remat", ["dots", "full"])
@pytest.mark.parametrize("arch", HERE)
def test_remat_gives_the_same_loss_and_grads(arch, remat):
    check_remat(arch, remat)


def test_remat_recomputes_the_blocks_in_the_backward():
    """"full" runs each block's forward again in the backward, "dots" too
    (it keeps only the unbatched products), "none" does not: counted by the
    calls of the attention's plain version."""
    cfg = tget("qwen3_0_6b")
    params = tbuild(cfg).init(torch.Generator().manual_seed(0))
    batch = _torch_batch(_batch(cfg, seed=5))
    from repro_torch.kernels.flash_attention import ops

    counts = {}
    real = ops.mha_reference
    for remat in ("none", "dots", "full"):
        calls = []
        ops.mha_reference = lambda *a, **k: calls.append(1) or real(*a, **k)
        try:
            value_and_grad(tbuild(cfg.replace(remat=remat)), params, batch)
        finally:
            ops.mha_reference = real
        counts[remat] = len(calls)
    L = cfg.n_layers  # forward, then the backward's recompute in the Function
    assert counts == {"none": 2 * L, "dots": 3 * L, "full": 3 * L}


def test_unknown_remat_raises():
    cfg = tget("qwen3_0_6b").replace(remat="some")
    params = tbuild(cfg).init(torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="remat"):
        value_and_grad(tbuild(cfg), params, _torch_batch(_batch(cfg)))
