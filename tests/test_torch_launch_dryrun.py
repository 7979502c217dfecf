"""The dry run's pieces against the JAX package's: the ring model against
``collective_wire_bytes`` on the JAX test's HLO, ``analyze`` and
``model_flops_for`` against the reference's formulas with the H100
constants, ``report.render`` byte for byte against the JAX ``render`` on
the same JSON; and full-width dry runs on the meta device that make no
real tensor and leave no state off meta."""

import json

import pytest
import torch
from torch.utils._pytree import tree_leaves

from repro import configs as jconfigs
from repro.launch import report as jreport
from repro.launch import roofline as jrl
from repro_torch import configs as tconfigs
from repro_torch.launch import dryrun
from repro_torch.launch import report as treport
from repro_torch.launch import roofline as trl
from repro_torch.launch.mesh import make_production_mesh

# tests/test_dryrun_machinery.py's HLO, and the same collectives as records
HLO = """
  %ar = f32[1024,256]{1,0} all-reduce(f32[1024,256] %x), replica_groups=[16,16]<=[256], to_apply=%add
  %ag = bf16[512,128]{1,0} all-gather(bf16[32,128] %y), replica_groups={{0,1,2,3}}, dimensions={0}
  %cp = f32[64]{0} collective-permute(f32[64] %z), source_target_pairs={{0,1}}
  %aa = f32[8,64]{1,0} all-to-all(f32[8,64] %w), replica_groups=[2,8]<=[16]
  %s = f32[128]{0} all-gather-start(f32[32] %x), replica_groups={{0,1,2,3}}
  %d = f32[128]{0} all-gather-done(f32[128] %s)
  %rs = f32[64,8]{1,0} reduce-scatter(f32[512,8] %v), replica_groups=[32,8]<=[256], dimensions={0}
"""
RECORDS = [("all-reduce", 1024 * 256 * 4, 16), ("all-gather", 512 * 128 * 2, 4),
           ("collective-permute", 64 * 4, 0), ("all-to-all", 8 * 64 * 4, 8),
           ("all-gather", 128 * 4, 4), ("reduce-scatter", 64 * 8 * 4, 8)]


def test_ring_model_equals_the_reference_parser():
    assert trl.collective_wire_bytes(RECORDS) == jrl.collective_wire_bytes(HLO)
    assert trl.collective_wire_bytes([]) == jrl.collective_wire_bytes("")
    with pytest.raises(ValueError):
        trl.ring_wire_bytes("broadcast", 8, 2)


def test_collective_seconds_by_axis():
    recs = [("all-reduce", 1e9, 8, "model"), ("all-gather", 1e9, 32, "data"),
            ("all-to-all", 1e6, 2)]
    want = (2e9 * 7 / 8 / trl.NVLINK_BW + 1e9 * 31 / 32 / trl.IB_BW + 1e6 / 2 / trl.IB_BW)
    assert trl.collective_seconds(recs) == pytest.approx(want, rel=1e-12)


@pytest.mark.parametrize("flops,nbytes,model", [(1e15, 1e9, 6e17), (1e9, 1e12, 3e11),
                                                (0.0, 5e8, 1e12)])
def test_analyze_follows_the_reference_formulas(flops, nbytes, model):
    kw = dict(arch="a", shape_name="s", mesh_name="m", chips=256, model_flops=model)
    cost = {"flops": flops, "bytes accessed": nbytes}
    got = trl.analyze(cost=cost, collectives=RECORDS[:2], bytes_per_device=123, **kw)
    want = jrl.analyze(cost=cost, hlo_text=HLO.splitlines()[1] + "\n" + HLO.splitlines()[2],
                       memory_stats=None, **kw)
    assert got.compute_s == flops / trl.PEAK_FLOPS
    assert got.compute_s * trl.PEAK_FLOPS == pytest.approx(want.compute_s * jrl.PEAK_FLOPS)
    assert got.memory_s == nbytes / trl.HBM_BW
    assert got.memory_s * trl.HBM_BW == pytest.approx(want.memory_s * jrl.HBM_BW)
    assert got.collective_bytes == want.collective_bytes
    assert got.collective_detail == want.collective_detail
    assert got.collective_s == trl.collective_seconds(RECORDS[:2])
    for f in ("hlo_flops", "hlo_bytes", "model_flops", "useful_ratio", "chips", "arch"):
        assert getattr(got, f) == getattr(want, f), f
    assert got.dominant == max([("compute", got.compute_s), ("memory", got.memory_s),
                                ("collective", got.collective_s)], key=lambda kv: kv[1])[0]
    assert got.bytes_per_device == 123
    assert set(got.to_json()) == set(want.to_json())


def test_model_flops_equal_the_reference():
    for arch in tconfigs.ARCH_IDS:
        for name, shape in tconfigs.SHAPES.items():
            assert (trl.model_flops_for(tconfigs.get_config(arch), shape)
                    == jrl.model_flops_for(jconfigs.get_config(arch), jconfigs.SHAPES[name]))


def _row(compute, memory, coll, dom, useful, nbytes, **kw):
    return {"ok": True, "compute_s": compute, "memory_s": memory, "collective_s": coll,
            "dominant": dom, "useful_ratio": useful, "bytes_per_device": nbytes, **kw}


def test_report_renders_as_the_reference(tmp_path):
    data = {
        "qwen3_0_6b|train_4k|32x8": _row(0.0297, 0.516, 0.0, "memory", 0.6283, 3.6e7),
        "qwen3_0_6b|train_4k|2x32x8": _row(1.2, 2.5e-4, 0, "compute", 0.05, 999, probeless=True),
        "mamba2_780m|decode_32k|32x8": _row(4e-6, 0.0085, 3.3, "collective", 1.0, 1.9e9),
        "olmo_1b|long_500k|32x8": {"ok": False, "error": "RuntimeError: boom"},
        "zamba2_7b|prefill_32k|32x8": _row(0, 7e-4, 0.2, "collective", 0.0, 4.2e3),
        "whisper_large_v3|long_500k|skipped": {"ok": True, "skipped": "why"},
    }
    path = tmp_path / "dryrun.json"
    path.write_text(json.dumps(data, indent=1))
    for mesh in (None, "32x8", "2x32x8"):
        assert treport.render(str(path), mesh) == jreport.render(str(path), mesh)
    for x in (0, 3e-7, 0.5, 12.0):
        assert treport.fmt_s(x) == jreport.fmt_s(x)
    for x in (0, 12, 3.4e3, 5.6e6, 7.8e9):
        assert treport.fmt_b(x) == jreport.fmt_b(x)


def test_full_width_dry_run_allocates_nothing(tmp_path, capsys):
    """qwen3_0_6b's decode cell through the CLI on both H100 meshes (its
    JSON rendered by both reports alike; its collectives recorded on each
    mesh), then the prefill of each
    kernel's family (flash_attention, ssd_scan): no op
    makes a real tensor, and every argument and output stays on meta."""
    out = tmp_path / "dryrun.json"
    assert dryrun.main(["--arch", "qwen3_0_6b", "--shape", "decode_32k",
                        "--out", str(out)]) == 0
    data = json.loads(out.read_text())
    row = data["qwen3_0_6b|decode_32k|32x8"]
    assert row["ok"] and row["counted_on"] == "meta" and row["temp_bytes"] is None
    # the collectives of the step run as DTensors on a fake world of the mesh
    for mesh_name in ("32x8", "2x32x8"):
        r = data[f"qwen3_0_6b|decode_32k|{mesh_name}"]
        assert r["collective_s"] > 0 and "collectives recorded" in r["note"]
        assert r["collective_detail"]["counts"]["all-gather"] > 0
        assert r["dominant"] == max([("compute", r["compute_s"]), ("memory", r["memory_s"]),
                                     ("collective", r["collective_s"])], key=lambda kv: kv[1])[0]
    assert row["chips"] == 256 and data["qwen3_0_6b|decode_32k|2x32x8"]["chips"] == 512
    assert "whisper_large_v3|long_500k|skipped" in data
    assert treport.render(str(out)) == jreport.render(str(out))
    capsys.readouterr()

    mesh = make_production_mesh()
    for arch, shape_name, kernel in (("qwen3_0_6b", "prefill_32k", "flash_attention"),
                                     ("mamba2_780m", "prefill_32k", "ssd_scan")):
        cfg = dryrun._dryrun_cfg(arch)
        counter, result, args, in_sh = dryrun.count_step(cfg, tconfigs.SHAPES[shape_name], mesh)
        assert counter.real_outputs == 0
        assert all(t.is_meta for t in tree_leaves(args) + tree_leaves(result))
        assert set(counter.kernels) == ({kernel} if kernel else set())
        if kernel:
            assert counter.kernels[kernel]["calls"] == cfg.n_layers
        assert dryrun.arg_bytes_per_device(args, in_sh) > 0
    assert cfg.compute_dtype == torch.bfloat16
