"""Training loop: microbatched gradient accumulation, the compression hook,
metrics, the JAX package's ``training/train_loop.py``.

``make_train_step`` builds the step; ``TrainLoop`` drives it with
checkpoints (``distributed/checkpoint.CheckpointManager``), straggler
deadlines and fault-injection hooks.  The step is plain eager torch: no
``torch.compile`` and no CUDA graph.  Its phases run inside the profiler
spans ``train.forward``, ``train.backward`` (which holds the kernels'
``flash_attention.backward`` and ``ssd_scan.backward``) and
``train.optimizer``.
"""

from __future__ import annotations

import dataclasses
import time

import torch

from repro_torch.distributed.checkpoint import tree_leaves, tree_unflatten
from repro_torch.training import compression as comp_mod
from repro_torch.training import optimizer as opt_mod


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    opt: opt_mod.OptimizerConfig = dataclasses.field(default_factory=opt_mod.OptimizerConfig)
    compression: comp_mod.CompressionConfig = dataclasses.field(
        default_factory=comp_mod.CompressionConfig)
    microbatches: int = 1  # grad accumulation steps per train step


def _value_and_grad(model, params, batch):
    leaves = [p.detach().requires_grad_() for p in tree_leaves(params)]
    with torch.profiler.record_function("train.forward"):
        loss = model.loss(tree_unflatten(params, leaves), batch)
    with torch.profiler.record_function("train.backward"):
        grads = torch.autograd.grad(loss, leaves)
    return loss.detach(), grads


def make_train_step(model, tcfg: TrainConfig):
    """Returns ``train_step(state, batch) -> (state, metrics)``.

    state = {params, opt, ef?}; each batch leaf has the global batch on its
    first axis.  With ``microbatches`` n > 1 the batch is split into n
    equal slices, their f32 gradients summed and divided by n, and the
    loss reported is the slices' mean (peak activation memory 1/n)."""
    use_ef = tcfg.compression.scheme != "none"

    def train_step(state, batch):
        params = state["params"]
        n_micro = tcfg.microbatches
        if n_micro > 1:
            acc, losses = None, []
            for j in range(n_micro):
                mb = {k: v.reshape((n_micro, v.shape[0] // n_micro) + v.shape[1:])[j]
                      for k, v in batch.items()}
                loss, g = _value_and_grad(model, params, mb)
                g = [x.float() for x in g]
                acc = g if acc is None else [a + b for a, b in zip(acc, g)]
                losses.append(loss)
            grads = tree_unflatten(params, [a / n_micro for a in acc])
            loss = torch.stack(losses).mean()
        else:
            loss, g = _value_and_grad(model, params, batch)
            grads = tree_unflatten(params, list(g))

        metrics = {"loss": loss}
        if use_ef:
            grads, new_ef, wire = comp_mod.compress(tcfg.compression, grads, state["ef"])
            metrics["wire_bytes"] = wire
        with torch.profiler.record_function("train.optimizer"):
            new_params, new_opt, gnorm = opt_mod.opt_update(tcfg.opt, grads, state["opt"],
                                                            params)
        metrics["grad_norm"] = gnorm
        new_state = {"params": new_params, "opt": new_opt}
        if use_ef:
            new_state["ef"] = new_ef
        return new_state, metrics

    return train_step


def init_state(model, tcfg: TrainConfig, gen: torch.Generator):
    """Fresh params from ``gen`` (on its device), the optimizer's state and,
    with compression, a zero error feedback."""
    params = model.init(gen)
    state = {"params": params, "opt": opt_mod.opt_init(tcfg.opt, params)}
    if tcfg.compression.scheme != "none":
        state["ef"] = comp_mod.ef_init(params)
    return state


@dataclasses.dataclass
class StragglerPolicy:
    """Deadline-based straggler detection: a step slower than
    ``deadline_factor`` x the rolling median of the last ``window`` steps
    (once 5 are seen) is flagged and returned to the caller."""

    deadline_factor: float = 3.0
    window: int = 20
    history: list = dataclasses.field(default_factory=list)
    flagged_steps: list = dataclasses.field(default_factory=list)

    def observe(self, step: int, dt: float) -> bool:
        self.history.append(dt)
        hist = self.history[-self.window:]
        med = sorted(hist)[len(hist) // 2]
        slow = len(hist) >= 5 and dt > self.deadline_factor * med
        if slow:
            self.flagged_steps.append(step)
        return slow


def _synchronize(state):
    """Wait for the card, where the state lives on one: honest step times."""
    leaf = tree_leaves(state["params"])[0]
    if leaf.is_cuda:
        torch.cuda.synchronize(leaf.device)


class TrainLoop:
    """Drives the train step with checkpoint/restart and straggler
    accounting."""

    def __init__(self, model, tcfg: TrainConfig, data_iter, *, ckpt_manager=None,
                 ckpt_every: int = 0, straggler: StragglerPolicy | None = None):
        self.model = model
        self.tcfg = tcfg
        self.data_iter = data_iter
        self.ckpt = ckpt_manager
        self.ckpt_every = ckpt_every
        self.straggler = straggler or StragglerPolicy()
        self.step_fn = make_train_step(model, tcfg)

    def run(self, state, start_step: int, num_steps: int, *, fault_hook=None):
        """``num_steps`` steps from ``start_step`` -> (state, a metrics row a
        step: loss, grad_norm, [wire_bytes], step, dt in seconds)."""
        metrics_log = []
        for step in range(start_step, start_step + num_steps):
            batch = next(self.data_iter)
            t0 = time.perf_counter()
            if fault_hook is not None:
                fault_hook(step)  # may raise to simulate a node loss
            state, metrics = self.step_fn(state, batch)
            _synchronize(state)
            dt = time.perf_counter() - t0
            self.straggler.observe(step, dt)
            metrics_log.append({k: float(v) for k, v in metrics.items()}
                               | {"step": step, "dt": dt})
            if self.ckpt is not None and self.ckpt_every and (step + 1) % self.ckpt_every == 0:
                self.ckpt.save(state, step + 1)
        return state, metrics_log
