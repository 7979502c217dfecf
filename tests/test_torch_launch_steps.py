"""The step builders (``repro_torch.launch.steps.build_step``) on the JAX
test's cut (reduced configs, seq 64, batch 2) of qwen3_0_6b, mamba2_780m
and granite_moe_1b_a400m:

  * on the CPU, each of the train, prefill and decode steps gives what the
    direct call gives (``make_train_step``, ``Model.prefill``,
    ``Model.decode_step`` on the same arguments), bit for bit (one thread);
  * on meta, the same step gives outputs of the same shapes, and the same
    FLOPs outside the kernels as ``FlopCounterMode`` counts on the CPU run
    less what the kernels' plain versions did there; the kernels report
    their own work instead (``kernels.work``), and no op makes a real
    tensor.

The full-width steps run on the card in ``chip_smoke.py`` (phase 22).
"""

import contextlib

import pytest
import torch
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.configs import SHAPES, ShapeSpec, get_reduced_config
from repro_torch.kernels import work
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.kernels.ssd_scan import ops as ssd_ops
from repro_torch.launch.dryrun import WorkCounter
from repro_torch.launch.mesh import make_test_mesh
from repro_torch.launch.steps import build_step
from repro_torch.models.model_zoo import build_model
from repro_torch.training.optimizer import OptimizerConfig
from repro_torch.training.train_loop import TrainConfig, make_train_step

ARCHS = ["qwen3_0_6b", "mamba2_780m", "granite_moe_1b_a400m"]
KINDS = {"train": "train_4k", "prefill": "prefill_32k", "decode": "decode_32k"}


def _small(kind):
    shape = SHAPES[KINDS[kind]]
    return ShapeSpec(shape.name, seq_len=64, global_batch=2, kind=shape.kind)


@contextlib.contextmanager
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


def _direct(cfg, kind, args, seq_len):
    model = build_model(cfg)
    if kind == "train":
        return make_train_step(model, TrainConfig(opt=OptimizerConfig(name=cfg.optimizer)))(*args)
    if kind == "prefill":
        return model.prefill(args[0], args[1], seq_len)[0]
    return model.decode_step(*args)


def _clone(tree):
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_clone(v) for v in tree)
    return tree.clone() if isinstance(tree, torch.Tensor) else tree


@pytest.mark.parametrize("kind", list(KINDS))
@pytest.mark.parametrize("arch", ARCHS)
def test_step_equals_the_direct_call_on_the_cpu(arch, kind):
    cfg, shape = get_reduced_config(arch), _small(kind)
    step, args, in_sh = build_step(cfg, shape, make_test_mesh(), device="cpu", seed=3)
    assert all(t.device.type == "cpu" for t in tree_leaves(args))
    assert len(tree_leaves(args)) == len(tree_leaves(
        in_sh, is_leaf=lambda x: hasattr(x, "spec")))
    with _one_thread():
        want = _direct(cfg, kind, _clone(args), shape.seq_len)
        got = step(*args)
    got, want = tree_leaves(got), tree_leaves(want)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == w.dtype
        assert torch.equal(g, w)


class _PlainFlops:
    """Counts, in a FlopCounterMode of its own, what the kernels' plain
    versions compute on the CPU."""

    def __init__(self, monkeypatch):
        self.flops = 0
        for mod in (flash_ops, ssd_ops):
            monkeypatch.setattr(mod, "_forward", self._wrap(mod._forward))

    def _wrap(self, forward):
        def counted(*args):
            with FlopCounterMode(display=False) as inner:
                out = forward(*args)
            self.flops += inner.get_total_flops()
            return out
        return counted


@pytest.mark.parametrize("kind", list(KINDS))
@pytest.mark.parametrize("arch", ARCHS)
def test_meta_step_counts_what_the_cpu_step_runs(arch, kind, monkeypatch):
    cfg, shape = get_reduced_config(arch), _small(kind)
    step, args, _ = build_step(cfg, shape, make_test_mesh())
    assert all(t.is_meta for t in tree_leaves(args))
    with WorkCounter() as counter:
        meta_out = step(*args)
    assert counter.real_outputs == 0
    assert all(t.is_meta for t in tree_leaves(meta_out))

    step, args, _ = build_step(cfg, shape, make_test_mesh(), device="cpu")
    plain = _PlainFlops(monkeypatch)
    with _one_thread(), FlopCounterMode(display=False) as cpu:
        cpu_out = step(*args)
    assert [t.shape for t in tree_leaves(meta_out)] == [t.shape for t in tree_leaves(cpu_out)]
    assert counter.aten_flops == cpu.get_total_flops() - plain.flops
    assert counter.aten_flops > 0 and counter.bytes > 0

    kernel = "ssd_scan" if cfg.family == "ssm" else "flash_attention"
    uses_kernel = kind != "decode"
    assert set(counter.kernels) == ({kernel} if uses_kernel else set())
    if uses_kernel:
        assert counter.kernels[kernel]["calls"] == cfg.n_layers
        assert plain.flops > counter.kernels[kernel]["flops"] > 0


def test_meta_kernels_report_their_own_work_not_the_plain_versions():
    B, H, Hk, L, D = 2, 8, 2, 256, 64
    q = torch.empty((B, H, L, D), device="meta", dtype=torch.bfloat16)
    k = torch.empty((B, Hk, L, D), device="meta", dtype=torch.bfloat16)
    before = flash_ops.flash_attention.launches
    with WorkCounter() as counter:
        o = flash_ops.flash_attention(q, k, k, True)
    assert o.shape == q.shape and o.dtype == q.dtype and o.is_meta
    assert counter.aten_flops == 0 and counter.bytes == 0
    assert counter.kernels == {"flash_attention": dict(
        calls=1, **dict(zip(("flops", "bytes"), work.flash_work(B, H, Hk, L, L, D, True, 2))))}
    # the causal pairs only: just over half the plain version's square
    assert counter.kernels["flash_attention"]["flops"] == 4 * D * B * H * L * (L + 1) // 2
    assert flash_ops.flash_attention.launches == before

    Bt, H, dh, N, chunk = 2, 4, 16, 8, 32
    x = torch.empty((Bt, L, H, dh), device="meta")
    dt = torch.empty((Bt, L, H), device="meta")
    Bm = torch.empty((Bt, L, N), device="meta")
    with WorkCounter() as counter:
        y, S = ssd_ops.ssd_scan(x, dt, torch.empty((H,), device="meta"), Bm, Bm, chunk=chunk)
    assert y.shape == x.shape and S.shape == (Bt, H, N, dh) and S.dtype == torch.float32
    assert counter.aten_flops == 0
    assert counter.kernels["ssd_scan"]["flops"] == work.ssd_work(Bt, L, H, dh, N, chunk)[0]
    assert not work.COUNTERS
