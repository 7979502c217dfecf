"""The port stands alone: nothing under ``src/repro_torch/``, and not
``chip_smoke.py``, imports JAX or the JAX package ``repro``."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
FORBIDDEN = ("jax", "jaxlib", "repro")


def _port_files():
    return sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _imported_modules(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


def test_port_files_exist():
    names = {p.relative_to(PORT).as_posix() for p in PORT.rglob("*.py")}
    for want in ("core/arena.py", "core/engine.py", "core/isa.py", "core/verify.py",
                 "kernels/pulse_chase/kernel.py", "kernels/pulse_chase/ops.py",
                 "kernels/pulse_chase/ref.py", "configs/pulse_paper.py",
                 "kernels/_build.py", "configs/qwen3_0_6b.py",
                 "kernels/flash_attention/kernel.py", "kernels/flash_attention/ops.py",
                 "kernels/flash_attention/ref.py", "kernels/paged_attention/kernel.py",
                 "kernels/paged_attention/ops.py", "kernels/paged_attention/ref.py",
                 "models/common.py", "models/attention.py", "models/transformer.py",
                 "models/model_zoo.py", "serving/batching.py", "serving/kv_cache.py",
                 "launch/serve.py", "configs/mamba2_780m.py", "kernels/ssd_scan/kernel.py",
                 "kernels/ssd_scan/ops.py", "kernels/ssd_scan/ref.py", "models/ssm.py",
                 "core/commit.py", "core/structures/skiplist.py",
                 "kernels/pulse_commit/kernel.py", "kernels/pulse_commit/ops.py",
                 "kernels/pulse_commit/ref.py", "core/faults.py", "core/prng.py",
                 "serving/admission.py", "serving/traversal_service.py",
                 "distributed/sharding.py", "distributed/elastic.py",
                 "distributed/checkpoint.py", "distributed/arena_ft.py", "models/moe.py",
                 "configs/zamba2_7b.py", "configs/granite_moe_1b_a400m.py",
                 "configs/kimi_k2_1t_a32b.py", "configs/olmo_1b.py", "configs/qwen1_5_4b.py",
                 "configs/qwen3_4b.py", "configs/internvl2_2b.py",
                 "configs/whisper_large_v3.py", "models/whisper.py", "data/pipeline.py",
                 "training/optimizer.py", "training/compression.py", "training/train_loop.py",
                 "launch/train.py", "launch/mesh.py", "launch/specs.py", "launch/steps.py",
                 "launch/dryrun.py", "launch/roofline.py", "launch/report.py",
                 "kernels/work.py", "core/scheduler.py", "tools/pulse_verify.py"):
        assert want in names
    for cu in ("pulse_chase.cu", "flash_attention.cu", "paged_attention.cu", "ssd_scan.cu",
               "pulse_commit.cu"):
        assert (PORT / "csrc" / cu).is_file()
    assert (ROOT / "chip_smoke.py").is_file()


@pytest.mark.parametrize("path", _port_files(), ids=lambda p: p.relative_to(ROOT).as_posix())
def test_no_jax_or_reference_import(path):
    for mod in _imported_modules(path):
        top = mod.split(".")[0]
        assert top not in FORBIDDEN, f"{path.relative_to(ROOT)} imports {mod}"


def test_importing_the_port_loads_neither_jax_nor_repro():
    code = (
        "import sys, pkgutil, importlib, repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          env=env, timeout=120, check=False)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"
