"""Port parity: the optimizers (``repro_torch.training.optimizer``) and
bfloat16 checkpoints against the JAX package's.

  * AdamW and Adafactor, one and three updates (clip included) on reduced
    qwen3_0_6b and mamba2_780m trees carried across, params and state
    within 1e-6 of each leaf's largest magnitude; the stacked-leaf
    semantics: every layer's norm scale and the ssm's per-head vectors
    decay and ``final_norm`` does not, Adafactor clips over the whole stack,
    and a stacked 1-D leaf that would be factored raises;
  * ``schedule`` and ``clip_by_global_norm``;
  * a bfloat16 leaf: its round trip, and its ``.npy`` member byte for byte
    the JAX package's.

Compression is ``test_torch_compression.py``'s; the train step, the loop,
resume and the launcher are ``test_torch_train_loop.py``'s.
"""

import functools
import json
import zipfile

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import get_reduced_config as jget
from repro.distributed import checkpoint as jckpt
from repro.models.model_zoo import build_model as jbuild
from repro.training import optimizer as jopt
from repro_torch.configs import get_reduced_config as tget
from repro_torch.distributed import checkpoint as tckpt
from repro_torch.models.model_zoo import params_from_numpy, state_to_numpy
from repro_torch.training import optimizer as topt

ARCHS = ["qwen3_0_6b", "mamba2_780m"]


def _close(got, want, tol, what=""):
    want = np.asarray(want, np.float64)
    np.testing.assert_allclose(np.asarray(got, np.float64), want, rtol=0,
                               atol=tol * max(1.0, float(np.abs(want).max())) if want.size
                               else tol, err_msg=what)


def _trees_close(got_np, want, tol):
    """``got_np`` (the port's, restacked to numpy) against the JAX tree."""
    fg = jax.tree_util.tree_flatten_with_path(got_np)[0]
    fw = jax.tree_util.tree_flatten_with_path(jax.tree.map(np.asarray, want))[0]
    assert [p for p, _ in fg] == [p for p, _ in fw]
    for (path, g), (_, w) in zip(fg, fw):
        assert np.shape(g) == np.shape(w), path
        _close(g, w, tol, jax.tree_util.keystr(path))


@functools.lru_cache(maxsize=None)
def _jax_params(arch):
    return jax.tree.map(np.asarray, jbuild(jget(arch)).init(jax.random.PRNGKey(0)))


def _grads_np(params_np, seed, zero=()):
    """Random gradients in the JAX layout (leaves named in ``zero`` zero)."""
    rng = np.random.default_rng(seed)
    flat, treedef = jax.tree_util.tree_flatten_with_path(params_np)
    leaves = [np.zeros_like(a) if any(z in jax.tree_util.keystr(p) for z in zero)
              else rng.standard_normal(a.shape).astype(np.float32) for p, a in flat]
    return jax.tree_util.tree_unflatten(treedef, leaves)


# ------------------------------- optimizer -----------------------------------

OPT_KW = dict(lr=1e-2, warmup_steps=2, total_steps=10, weight_decay=0.5)


@pytest.mark.parametrize("steps", [1, 3])
@pytest.mark.parametrize("name", ["adamw", "adafactor"])
@pytest.mark.parametrize("arch", ARCHS)
def test_optimizer_matches_jax(arch, name, steps):
    cfg = tget(arch)
    kw = dict(OPT_KW, name=name) | ({"factored_min_dim": 8} if name == "adafactor" else {})
    jcfg, tcfg = jopt.OptimizerConfig(**kw), topt.OptimizerConfig(**kw)
    jp = jax.tree.map(jnp.asarray, _jax_params(arch))
    tp = params_from_numpy(cfg, _jax_params(arch), device="cpu")
    js, ts = jopt.opt_init(jcfg, jp), topt.opt_init(tcfg, tp)
    jupdate = jax.jit(functools.partial(jopt.opt_update, jcfg))
    for s in range(steps):
        g = _grads_np(_jax_params(arch), seed=s, zero=("norm",))
        jp, js, jn = jupdate(jax.tree.map(jnp.asarray, g), js, jp)
        tp, ts, tn = topt.opt_update(tcfg, params_from_numpy(cfg, g, device="cpu"), ts, tp)
        _close(float(tn), float(jn), 1e-6, "grad norm")
    _trees_close(state_to_numpy(cfg, tp), jp, 1e-6)
    jstate = {k: v for k, v in js.items() if k != "step"}
    tstate = {k: v for k, v in ts.items() if k != "step"}
    _trees_close(state_to_numpy(cfg, tstate), jstate, 1e-6)
    assert int(ts["step"]) == int(js["step"]) == steps and ts["step"].dtype == torch.int32


@pytest.mark.parametrize("name", ["adamw", "adafactor"])
def test_stacked_leaves_decay_and_final_norm_does_not(name):
    """Zero gradients on the norms: only the decay moves them.  Every
    layer's norm scale is a stacked (L, D) leaf in the JAX package, so it
    decays; ``final_norm`` is (D,) and does not; the ssm's per-head vectors
    are (L, H) and decay too."""
    for arch in ARCHS:
        cfg = tget(arch)
        ocfg = topt.OptimizerConfig(**OPT_KW, name=name)
        tp = params_from_numpy(cfg, _jax_params(arch), device="cpu")
        zero = ("norm", "A_log", "dt_bias", "D_skip")
        g = params_from_numpy(cfg, _grads_np(_jax_params(arch), 0, zero=zero), device="cpu")
        new, _, _ = topt.opt_update(ocfg, g, topt.opt_init(ocfg, tp), tp)
        lr = float(topt.schedule(ocfg, 1))
        assert torch.equal(new["final_norm"]["scale"], tp["final_norm"]["scale"])
        for old_l, new_l in zip(tp["layers"], new["layers"]):
            scale = "attn_norm" if arch == "qwen3_0_6b" else "norm"
            torch.testing.assert_close(new_l[scale]["scale"],
                                       old_l[scale]["scale"] * (1 - lr * OPT_KW["weight_decay"]))
            if arch == "mamba2_780m":
                for k in ("A_log", "D_skip"):
                    torch.testing.assert_close(
                        new_l["ssm"][k], old_l["ssm"][k] * (1 - lr * OPT_KW["weight_decay"]))


def test_adafactor_refuses_a_stacked_vector_it_would_factor():
    cfg = tget("qwen3_0_6b")  # 2 layers: attn_norm is a (2, 64) leaf
    tp = params_from_numpy(cfg, _jax_params("qwen3_0_6b"), device="cpu")
    with pytest.raises(ValueError, match="factored across its layers"):
        topt.opt_init(topt.OptimizerConfig(name="adafactor", factored_min_dim=2), tp)


def test_schedule_and_clip_match_jax():
    for kw in (dict(lr=1.0, warmup_steps=10, total_steps=100, min_lr_frac=0.1),
               dict(lr=3e-4, warmup_steps=5, total_steps=8), dict(lr=1e-3, warmup_steps=0)):
        jc, tc = jopt.OptimizerConfig(**kw), topt.OptimizerConfig(**kw)
        for s in (0, 1, 3, 5, 7, 8, 10, 55, 100, 101):
            got, want = topt.schedule(tc, torch.tensor(s, dtype=torch.int32)), jopt.schedule(jc, s)
            assert got.dtype == torch.float32
            _close(float(got), float(want), 1e-7, f"{kw} step {s}")
    g = _grads_np(_jax_params("qwen3_0_6b"), 3)
    for max_norm in (1.0, 1e6):
        jg, jn = jopt.clip_by_global_norm(jax.tree.map(jnp.asarray, g), max_norm)
        tg, tn = topt.clip_by_global_norm(
            params_from_numpy(tget("qwen3_0_6b"), g, device="cpu"), max_norm)
        _close(float(tn), float(jn), 1e-6)
        _trees_close(state_to_numpy(tget("qwen3_0_6b"), tg), jg, 1e-6)


# ------------------------------ bf16 leaves ------------------------------------


def test_bf16_leaf_round_trips_and_its_bytes_are_the_jax_packages(tmp_path):
    vals = np.random.default_rng(0).standard_normal((3, 5)).astype(np.float32)
    t = torch.from_numpy(vals).to(torch.bfloat16)
    tree = {"w": t, "n": torch.arange(4, dtype=torch.int32)}
    tck = tckpt.CheckpointManager(tmp_path / "port", async_save=False)
    tck.save(tree, 1)
    back, _, _ = tck.restore({"w": torch.zeros(1), "n": torch.zeros(1)})
    assert back["w"].dtype == torch.bfloat16 and torch.equal(back["w"].view(torch.int16),
                                                             t.view(torch.int16))
    assert torch.equal(back["n"], tree["n"])
    jck = jckpt.CheckpointManager(tmp_path / "jax", async_save=False)
    jck.save({"w": jnp.asarray(vals, jnp.bfloat16), "n": jnp.arange(4, dtype=jnp.int32)}, 1)
    members = {}
    for who in ("port", "jax"):
        d = tmp_path / who / "step_00000001"
        with zipfile.ZipFile(d / "shard_0.npz") as z:
            members[who] = {n: z.read(n) for n in z.namelist()}
        members[who]["manifest"] = json.loads((d / "manifest.json").read_text())
    assert members["port"] == members["jax"]
    # and the port restores the JAX package's file by its manifest
    jback, _, _ = tckpt.CheckpointManager(tmp_path / "jax").restore(
        {"w": torch.zeros(1), "n": torch.zeros(1)})
    assert torch.equal(jback["w"].view(torch.int16), t.view(torch.int16))


