"""Build and load the port's CUDA kernels.

Each kernel is one ``.cu`` file under ``src/repro_torch/csrc/`` with a plain
C entry point; the ``.cuh`` headers beside them are shared.  It is compiled
at first use with ``nvcc`` for ``sm_90a`` into ``build/kernels/`` inside the
package (so the package must sit in a writable place: a checkout or an
editable install), keyed by a hash of the source, the headers and the
flags, and loaded with ``ctypes``.  The compiler's
``-Xptxas -v`` report (registers, shared memory, spills) is kept beside the
library as ``.log``.  A build failure raises.
"""

from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

_PACKAGE = Path(__file__).resolve().parents[1]
CSRC = _PACKAGE / "csrc"
BUILD_DIR = _PACKAGE / "build" / "kernels"
COMMON_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-shared",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


def nvcc() -> str:
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin and "
            "PATH): the port's CUDA kernels cannot be built"
        )
    return found


@dataclasses.dataclass(frozen=True)
class KernelSource:
    """One ``.cu`` file and the flags it is compiled with."""

    name: str  # the library's stem
    source: Path
    extra_flags: tuple[str, ...] = ()

    @property
    def flags(self) -> tuple[str, ...]:
        return COMMON_FLAGS + self.extra_flags

    def library_path(self) -> Path:
        """Where the shared library for the current source and flags lives."""
        digest = hashlib.sha256(self.source.read_bytes() + " ".join(self.flags).encode())
        for header in sorted(CSRC.glob("*.cuh")):
            digest.update(header.read_bytes())
        return BUILD_DIR / f"{self.name}_{digest.hexdigest()[:16]}.so"

    def build(self) -> Path:
        """Compile unless a library for this source and these flags exists."""
        return build_all([self])[0]

    def build_log(self) -> str:
        return self.build().with_suffix(".log").read_text()

    def load(self) -> ctypes.CDLL:
        """The built library, loaded (each kernel's module loads it once)."""
        return ctypes.CDLL(str(self.build()))


def build_all(sources) -> list[Path]:
    """Compile every source whose library is missing, one ``nvcc`` process
    each, all started together; returns the libraries' paths in order."""
    sources = list(sources)
    paths = [s.library_path() for s in sources]
    todo = [(s, so) for s, so in zip(sources, paths) if not so.exists()]
    if not todo:
        return paths
    exe = nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = []
    for s, so in todo:
        tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
        procs.append((s, so, tmp, subprocess.Popen(
            [exe, *s.flags, "-o", str(tmp), str(s.source)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )))
    failed = []
    for s, so, tmp, proc in procs:
        out, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc failed to build {s.source} (exit {proc.returncode}):\n{out}")
            continue
        so.with_suffix(".log").write_text(out)
        os.replace(tmp, so)
    if failed:
        raise RuntimeError("\n".join(failed))
    return paths
