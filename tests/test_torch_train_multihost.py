"""Port parity: ``launch/train.py`` on a process group (several hosts)
against the JAX package's multi-host semantics (``src/repro/launch/
train.py``: each host trains its own copy of the same seeded state on its
rows of every global batch, ``DataConfig(num_hosts, host_id)``).

A world of 2 Gloo ranks on the CPU (``distributed.world.spawn`` with the
launcher's variables set, as ``torchrun`` starts a rank; each rank joins
the group from them) runs ``launch.train.main`` on reduced ``qwen3_0_6b``,
global batch 4 (2 rows a rank) x 16 tokens: 3 steps with a checkpoint at
the end, then ``--resume`` to 5 steps.

  * rank r's losses equal the JAX ``TrainLoop`` run in this process on the
    port's initial weights (carried across by ``state_to_numpy``) with
    ``DataConfig(num_hosts=2, host_id=r)``, within 1e-5
    (``tests/test_torch_training.py``'s tolerance); the two ranks' losses
    differ;
  * no collective is issued inside the loop (a dispatch mode around
    ``TrainLoop.run`` counts every c10d op);
  * only rank 0 writes the checkpoint (a departure from the reference,
    whose hosts all write ``shard_0`` and race): the step's directory holds
    ``shard_0.npz`` alone; the resume restores rank 0's state and data step
    on both ranks, so rank r's steps 3-4 equal the JAX run from host 0's
    state after 3 steps on host r's rows of steps 3-4;
  * with none of the variables set, no group is joined;
  * the backend is NCCL only where each of a host's ranks has a card of
    its own (``backend_for``).
"""

import importlib.util
import json
import threading
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.configs import get_reduced_config as tget
from repro_torch.distributed import world
from repro_torch.launch import train as tlaunch
from repro_torch.models.model_zoo import build_model as tbuild
from repro_torch.models.model_zoo import state_to_numpy
from repro_torch.training import train_loop as tloop

from test_torch_training import _close  # noqa: E402

HAS_JAX = importlib.util.find_spec("jax") is not None
needs_jax = pytest.mark.skipif(not HAS_JAX, reason="needs the JAX package")
WORLD = 2
BATCH, SEQ, STEPS, MORE = 4, 16, 3, 5
TIMEOUT = 120.0


def _argv(ckpt_dir, steps, *more):
    return ["--arch", "qwen3_0_6b", "--reduced", "--device", "cpu", "--batch", str(BATCH),
            "--seq", str(SEQ), "--steps", str(steps), "--lr", "1e-3",
            "--ckpt-dir", str(ckpt_dir), "--ckpt-every", "100", *more]


class _CountCollectives(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func.namespace in ("c10d", "_c10d_functional", "c10d_functional"):
            self.n += 1
        return func(*args, **(kwargs or {}))


def _rank(rank, world_size, out_dir):
    """Both runs on this rank, the collectives inside each loop counted."""
    counts = []
    run = tloop.TrainLoop.run

    def counted(self, *a, **kw):
        with _CountCollectives() as mode:
            out = run(self, *a, **kw)
        counts.append(mode.n)
        return out

    tloop.TrainLoop.run = counted
    ckpt = Path(out_dir) / "ckpt"
    first = tlaunch.main(_argv(ckpt, STEPS))
    assert dist.is_initialized() and dist.get_world_size() == world_size
    rest = tlaunch.main(_argv(ckpt, MORE, "--resume"))
    (Path(out_dir) / f"rank{rank}.json").write_text(json.dumps(
        {"first": first, "rest": rest, "collectives": counts}))


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """The world, run on a thread (it waits on its processes) while this
    process computes the JAX runs."""
    out = tmp_path_factory.mktemp("multihost")
    failed = []

    def run():
        try:
            world.spawn(_rank, WORLD, (str(out),), timeout=TIMEOUT, launcher_env=True)
        except BaseException as e:  # noqa: BLE001 -- raised below, in the test's thread
            failed.append(e)

    thread = threading.Thread(target=run)
    thread.start()
    jax_logs = _jax_runs() if HAS_JAX else None
    thread.join()
    if failed:
        raise failed[0]
    return out, [json.loads((out / f"rank{r}.json").read_text())
                 for r in range(WORLD)], jax_logs


def _port_initial_state():
    """The launcher's initial state (``--seed 0``, its train config)."""
    cfg = tget("qwen3_0_6b")
    args = tlaunch.parser().parse_args(_argv("", STEPS))
    gen = torch.Generator().manual_seed(0)
    return cfg, tloop.init_state(tbuild(cfg), tlaunch.train_config(cfg, args), gen)


def _jax_runs():
    """Per host r: the JAX loop's 3 steps from the port's weights, and its
    steps 3-4 from host 0's state after 3 steps."""
    import jax
    import jax.numpy as jnp

    from repro.configs import get_reduced_config as jget
    from repro.data import pipeline as jpipe
    from repro.models.model_zoo import build_model as jbuild
    from repro.training import optimizer as jopt
    from repro.training import train_loop as jloop

    cfg, tstate = _port_initial_state()
    state0 = jax.tree.map(jnp.asarray, state_to_numpy(cfg, tstate))
    jcfg = jloop.TrainConfig(opt=jopt.OptimizerConfig(
        name=cfg.optimizer, lr=1e-3, warmup_steps=5, total_steps=STEPS))
    model = jbuild(jget("qwen3_0_6b"))

    def data(host, start=0):
        return jpipe.DataIterator(jpipe.DataConfig(
            vocab=cfg.vocab, seq_len=SEQ, global_batch=BATCH, num_hosts=WORLD, host_id=host),
            start_step=start)

    loop = jloop.TrainLoop(model, jcfg, None)  # one jitted step for every run
    firsts, states = [], []
    for host in range(WORLD):
        loop.data_iter = data(host)
        state, log = loop.run(state0, 0, STEPS)
        firsts.append([r["loss"] for r in log])
        states.append(state)
    rests = []
    for host in range(WORLD):
        loop.data_iter = data(host, STEPS)
        _, log = loop.run(states[0], STEPS, MORE - STEPS)
        rests.append([r["loss"] for r in log])
    return firsts, rests


@needs_jax
def test_each_rank_trains_on_its_rows_as_the_jax_host(ranks):
    _, logs, (firsts, _) = ranks
    for r, log in enumerate(logs):
        assert [row["step"] for row in log["first"]] == list(range(STEPS))
        _close([row["loss"] for row in log["first"]], np.asarray(firsts[r]), 1e-5,
               f"rank {r}")
    assert logs[0]["first"][0]["loss"] != logs[1]["first"][0]["loss"]


def test_no_collective_in_the_loop(ranks):
    _, logs, _ = ranks
    assert [log["collectives"] for log in logs] == [[0, 0]] * WORLD


@needs_jax
def test_rank0_alone_writes_and_every_rank_resumes_from_it(ranks):
    out, logs, (_, rests) = ranks
    steps = sorted(p.name for p in (out / "ckpt").glob("step_*"))
    assert steps == [f"step_{STEPS:08d}", f"step_{MORE:08d}"]
    for step in steps:
        assert sorted(p.name for p in (out / "ckpt" / step).iterdir()) == [
            "manifest.json", "shard_0.npz"]
    assert (out / "ckpt" / "LATEST").read_text() == str(MORE)
    for r, log in enumerate(logs):
        assert [row["step"] for row in log["rest"]] == list(range(STEPS, MORE))
        _close([row["loss"] for row in log["rest"]], np.asarray(rests[r]), 1e-5,
               f"rank {r} resumed")


def test_without_the_variables_no_group_is_joined(monkeypatch, tmp_path, capsys):
    for key in world.LAUNCHER_ENV:
        monkeypatch.delenv(key, raising=False)
    log = tlaunch.main(_argv(tmp_path, 2))
    assert not dist.is_initialized()
    assert [row["step"] for row in log] == [0, 1]
    assert "done:" in capsys.readouterr().out
    monkeypatch.setenv("RANK", "0")
    with pytest.raises(ValueError, match="partly set"):
        world.join_from_env()


@pytest.mark.parametrize("device, local, cards, want", [
    ("cpu", "2", 0, "gloo"),
    ("cuda", "2", 1, "gloo"),  # two ranks on one card: NCCL refuses them
    ("cuda", "2", 2, "nccl"),
    ("cuda:0", "2", 2, "gloo"),  # every rank on the card named
    ("cuda:0", "1", 1, "nccl"),
])
def test_backend_follows_the_ranks_and_cards(monkeypatch, device, local, cards, want):
    monkeypatch.setenv("LOCAL_WORLD_SIZE", local)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    assert tlaunch.backend_for(torch.device(device)) == want
