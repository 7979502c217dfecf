"""Port parity: the train step, the loop and the launcher
(``repro_torch.training.train_loop``, ``launch/train.py``) against the JAX
package's.

  * ``make_train_step`` at 1 and 2 microbatches (and with ``topk``) over
    three steps against the JAX step, and a run carried across mid-way
    both ways (``state_from_numpy``/``state_to_numpy``): losses and params
    within 1e-5 of each leaf's largest magnitude;
  * ``StragglerPolicy`` flags on a fixed sequence as the JAX one does;
  * exact resume through the port's ``CheckpointManager``, bit for bit on
    the CPU, by hand and through ``TrainLoop``'s own checkpoints;
  * ``launch.train.main`` with ``--device cpu`` on every reduced config (the
    loss finite; falling on qwen3_0_6b) and ``--resume`` continuing an
    uninterrupted run exactly.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import get_reduced_config as jget
from repro.data import pipeline as jpipe
from repro.models.model_zoo import build_model as jbuild
from repro.training import compression as jcomp
from repro.training import optimizer as jopt
from repro.training import train_loop as jloop
from repro_torch.configs import ARCH_IDS
from repro_torch.configs import get_reduced_config as tget
from repro_torch.data import pipeline as tpipe
from repro_torch.distributed import checkpoint as tckpt
from repro_torch.launch import train as tlaunch
from repro_torch.models.model_zoo import build_model as tbuild
from repro_torch.models.model_zoo import state_from_numpy, state_to_numpy
from repro_torch.training import compression as tcomp
from repro_torch.training import optimizer as topt
from repro_torch.training import train_loop as tloop

from test_torch_training import _close, _trees_close  # noqa: E402


# -------------------------------- the step ------------------------------------

SEQ, BATCH = 16, 4


def _configs(micro=1, scheme="none"):
    okw = dict(lr=1e-3, warmup_steps=2, total_steps=20)
    j = jloop.TrainConfig(opt=jopt.OptimizerConfig(**okw),
                          compression=jcomp.CompressionConfig(scheme=scheme, topk_frac=0.2),
                          microbatches=micro)
    t = tloop.TrainConfig(opt=topt.OptimizerConfig(**okw),
                          compression=tcomp.CompressionConfig(scheme=scheme, topk_frac=0.2),
                          microbatches=micro)
    return j, t


def _data(vocab):
    kw = dict(vocab=vocab, seq_len=SEQ, global_batch=BATCH)
    return (jpipe.DataIterator(jpipe.DataConfig(**kw)),
            tpipe.DataIterator(tpipe.DataConfig(**kw), device="cpu"))


@functools.lru_cache(maxsize=None)
def _jax_step(micro, scheme):
    return jax.jit(jloop.make_train_step(jbuild(jget("qwen3_0_6b")), _configs(micro, scheme)[0]))


@pytest.mark.parametrize("micro,scheme", [(1, "none"), (2, "none"), (1, "topk")])
def test_train_step_matches_jax(micro, scheme):
    jcfg, tcfg = _configs(micro, scheme)
    cfg = tget("qwen3_0_6b")
    jstate = jloop.init_state(jbuild(jget("qwen3_0_6b")), jcfg, jax.random.PRNGKey(0))
    tstate = state_from_numpy(cfg, tcfg, jax.tree.map(np.asarray, jstate), device="cpu")
    jstep, tstep = _jax_step(micro, scheme), tloop.make_train_step(tbuild(cfg), tcfg)
    jdata, tdata = _data(cfg.vocab)
    for _ in range(3):
        jstate, jm = jstep(jstate, next(jdata))
        tstate, tm = tstep(tstate, next(tdata))
        _close(float(tm["loss"]), float(jm["loss"]), 1e-5, "loss")
        _close(float(tm["grad_norm"]), float(jm["grad_norm"]), 1e-5, "grad norm")
        if scheme != "none":
            assert int(tm["wire_bytes"]) == int(jm["wire_bytes"])
    _trees_close(state_to_numpy(cfg, tstate["params"]), jstate["params"], 1e-5)
    _trees_close(state_to_numpy(cfg, tstate["opt"]), jstate["opt"], 1e-5)


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_training_continues_across_packages(direction):
    """Two steps in one package, the state carried across, a third in the
    other, against three steps in the JAX package."""
    jcfg, tcfg = _configs()
    cfg = tget("qwen3_0_6b")
    jstep, tstep = _jax_step(1, "none"), tloop.make_train_step(tbuild(cfg), tcfg)
    j0 = jloop.init_state(jbuild(jget("qwen3_0_6b")), jcfg, jax.random.PRNGKey(0))
    jdata, tdata = _data(cfg.vocab)
    jbatches = [next(jdata) for _ in range(3)]
    tbatches = [next(tdata) for _ in range(3)]
    want = j0
    for b in jbatches:
        want, wm = jstep(want, b)
    if direction == "jax_to_port":
        s = j0
        for b in jbatches[:2]:
            s, _ = jstep(s, b)
        t = state_from_numpy(cfg, tcfg, jax.tree.map(np.asarray, s), device="cpu")
        t, tm = tstep(t, tbatches[2])
        got = state_to_numpy(cfg, t)
    else:
        t = state_from_numpy(cfg, tcfg, jax.tree.map(np.asarray, j0), device="cpu")
        for b in tbatches[:2]:
            t, _ = tstep(t, b)
        s = jax.tree.map(jnp.asarray, state_to_numpy(cfg, t))
        s, tm = jstep(s, jbatches[2])
        got = jax.tree.map(np.asarray, s)
    _close(float(tm["loss"]), float(wm["loss"]), 1e-5, "loss")
    _trees_close(got["params"], want["params"], 1e-5)
    assert int(got["opt"]["step"]) == 3


def test_state_round_trips_through_numpy():
    cfg = tget("mamba2_780m")
    _, tcfg = _configs(scheme="int8")
    state = tloop.init_state(tbuild(cfg), tcfg, torch.Generator().manual_seed(0))
    back = state_from_numpy(cfg, tcfg, state_to_numpy(cfg, state), device="cpu")
    for a, b in zip(tckpt.tree_leaves(state), tckpt.tree_leaves(back)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert state_to_numpy(cfg, state)["params"]["layers"]["ssm"]["A_log"].shape == (2, 8)


def test_straggler_policy_matches_jax():
    dts = [0.1] * 6 + [0.5, 0.1, 0.12, 0.9, 0.1] + [0.2] * 25 + [1.0]
    for kw in (dict(deadline_factor=2.0, window=10), dict()):
        tp, jp = tloop.StragglerPolicy(**kw), jloop.StragglerPolicy(**kw)
        flags = [(tp.observe(s, dt), jp.observe(s, dt)) for s, dt in enumerate(dts)]
        assert all(a == b for a, b in flags)
        assert tp.flagged_steps == jp.flagged_steps and tp.flagged_steps


# --------------------------------- resume --------------------------------------


def test_resume_is_bitwise_exact(tmp_path):
    """The JAX package's ``test_resume_is_bitwise_exact`` on the port: six
    steps with a checkpoint after three; a fresh state restored from it and
    the data iterator reloaded replay the last three bit for bit."""
    cfg = tget("qwen3_0_6b")
    model = tbuild(cfg)
    tcfg = tloop.TrainConfig(opt=topt.OptimizerConfig(lr=1e-3, warmup_steps=2, total_steps=50))
    dcfg = tpipe.DataConfig(vocab=cfg.vocab, seq_len=16, global_batch=2)
    data = tpipe.DataIterator(dcfg, device="cpu")
    ckpt = tckpt.CheckpointManager(tmp_path / "ckpt", async_save=False)
    step_fn = tloop.make_train_step(model, tcfg)
    state = tloop.init_state(model, tcfg, torch.Generator().manual_seed(0))
    losses_a = []
    for s in range(6):
        if s == 3:
            ckpt.save(state, s, extra=data.state_dict())
        state, m = step_fn(state, next(data))
        losses_a.append(float(m["loss"]))
    state_b = tloop.init_state(model, tcfg, torch.Generator().manual_seed(42))
    state_b, extra, step = ckpt.restore(state_b)
    assert step == 3
    data_b = tpipe.DataIterator(dcfg, device="cpu")
    data_b.load_state_dict(extra)
    for s in range(3, 6):
        state_b, m = step_fn(state_b, next(data_b))
        assert float(m["loss"]) == losses_a[s]
    for a, b in zip(tckpt.tree_leaves(state), tckpt.tree_leaves(state_b)):
        assert torch.equal(a, b)


def test_train_loop_checkpoints_and_resumes_exactly(tmp_path):
    cfg = tget("mamba2_780m")
    model = tbuild(cfg)
    tcfg = tloop.TrainConfig(opt=topt.OptimizerConfig(lr=1e-3, warmup_steps=2, total_steps=8),
                             compression=tcomp.CompressionConfig(scheme="int8"))
    dcfg = tpipe.DataConfig(vocab=cfg.vocab, seq_len=16, global_batch=2)
    ckpt = tckpt.CheckpointManager(tmp_path / "ckpt")
    loop = tloop.TrainLoop(model, tcfg, tpipe.DataIterator(dcfg, device="cpu"),
                           ckpt_manager=ckpt, ckpt_every=3)
    state = tloop.init_state(model, tcfg, torch.Generator().manual_seed(0))
    _, log = loop.run(state, 0, 6)
    ckpt.wait()
    assert sorted(ckpt.all_steps()) == [3, 6] and [r["step"] for r in log] == list(range(6))
    assert all(np.isfinite(r["loss"]) and r["wire_bytes"] > 0 and r["dt"] > 0 for r in log)
    restored, _, step = ckpt.restore(tloop.init_state(model, tcfg, torch.Generator()), 3)
    loop_b = tloop.TrainLoop(model, tcfg, tpipe.DataIterator(dcfg, start_step=3, device="cpu"))
    _, log_b = loop_b.run(restored, step, 3)
    assert [r["loss"] for r in log_b] == [r["loss"] for r in log[3:]]


def test_fault_hook_stops_the_loop():
    cfg = tget("qwen3_0_6b")
    tcfg = tloop.TrainConfig()
    loop = tloop.TrainLoop(tbuild(cfg), tcfg, tpipe.DataIterator(
        tpipe.DataConfig(vocab=cfg.vocab, seq_len=8, global_batch=2), device="cpu"))

    def hook(step):
        if step == 1:
            raise RuntimeError("node lost")

    state = tloop.init_state(tbuild(cfg), tcfg, torch.Generator().manual_seed(0))
    with pytest.raises(RuntimeError, match="node lost"):
        loop.run(state, 0, 3, fault_hook=hook)


# ------------------------------- the launcher -----------------------------------


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_launcher_trains_every_reduced_config_on_the_cpu(arch, capsys):
    """Three steps of every reduced config; on qwen3_0_6b sixteen steps of 8
    x 32 tokens, a fresh batch a step, where the loss falls (the mean of
    the last four below the mean of the first four)."""
    steps, shape = (16, ["--seq", "32", "--batch", "8"]) if arch == "qwen3_0_6b" else (
        3, ["--seq", "16", "--batch", "2"])
    log = tlaunch.main(["--arch", arch, "--reduced", "--device", "cpu", "--steps", str(steps),
                        "--lr", "3e-3", *shape])
    assert [r["step"] for r in log] == list(range(steps))
    assert all(np.isfinite(r["loss"]) and np.isfinite(r["grad_norm"]) for r in log)
    if arch == "qwen3_0_6b":
        losses = [r["loss"] for r in log]
        assert np.mean(losses[-4:]) < np.mean(losses[:4]) - 0.1, losses
    assert "done:" in capsys.readouterr().out


def test_launcher_resume_continues_exactly(tmp_path, capsys):
    base = ["--arch", "qwen3_0_6b", "--reduced", "--device", "cpu", "--seq", "16", "--batch", "2"]
    full = tlaunch.main(base + ["--steps", "8"])
    first = tlaunch.main(base + ["--steps", "4", "--ckpt-dir", str(tmp_path)])
    rest = tlaunch.main(base + ["--steps", "8", "--ckpt-dir", str(tmp_path), "--resume"])
    assert "resumed from step 4" in capsys.readouterr().out
    assert [r["loss"] for r in first + rest] == [r["loss"] for r in full]
    assert [r["step"] for r in rest] == [4, 5, 6, 7]


def test_launcher_refuses_cuda_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="no CUDA device"):
        tlaunch.main(["--arch", "qwen3_0_6b", "--reduced"])


@pytest.mark.parametrize("name", ["adamw", "adafactor"])
def test_a_train_step_leaves_no_tensor_in_a_reference_cycle(name):
    """Everything a step drops is freed at once, not when the garbage
    collector next runs: on the card a step's gradients and the old
    params held in a cycle would stay allocated meanwhile."""
    import gc

    cfg = tget("qwen3_0_6b")
    tcfg = tloop.TrainConfig(opt=topt.OptimizerConfig(name=name, factored_min_dim=8))
    data = tpipe.DataIterator(tpipe.DataConfig(vocab=cfg.vocab, seq_len=16, global_batch=2),
                              device="cpu")
    step = tloop.make_train_step(tbuild(cfg), tcfg)
    state = tloop.init_state(tbuild(cfg), tcfg, torch.Generator().manual_seed(0))
    state, _ = step(state, next(data))
    gc.collect()
    gc.disable()
    gc.set_debug(gc.DEBUG_SAVEALL)
    try:
        state, _ = step(state, next(data))
        gc.collect()
        cyclic = [o for o in gc.garbage if isinstance(o, torch.Tensor)]
    finally:
        gc.garbage.clear()
        gc.set_debug(0)
        gc.enable()
    assert not cyclic, f"{len(cyclic)} tensors left in reference cycles"
