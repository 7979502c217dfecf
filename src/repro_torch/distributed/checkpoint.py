"""Atomic, optionally async checkpoints of a tree of tensors.

Layout (one directory per step):
    <dir>/step_000123/
        manifest.json          tree paths, shapes, dtypes, host count, extra
        shard_<host>.npz       this host's leaves, keys a0..aN
    <dir>/LATEST               atomic pointer (written last)

The layout is the JAX package's (``repro.distributed.checkpoint``) exactly:
the leaves follow JAX's flatten order (a dict's keys sorted, a list or
tuple by index, ``None`` an empty subtree), the paths are ``"a/b/0"`` and
the dtypes numpy's names, so a checkpoint written by either package loads
in the other.  A bfloat16 leaf (numpy has none) is written as the JAX
package writes it: its 2-byte words, ``'<V2'`` in the ``.npy`` header and
``"bfloat16"`` in the manifest, and read back by the manifest, bit for bit.

  * atomic commit: the files go into a ``.tmp_save_*`` directory, which is
    renamed into place, then ``LATEST`` flips through ``os.replace``; a
    crash at any point leaves the previous checkpoint restorable, and a
    directory without ``manifest.json`` is ignored;
  * async save: the device-to-host copy happens before ``save`` returns,
    the file write on a thread;
  * restore onto a device: ``restore(like_state, device=...)`` rebuilds
    ``like_state``'s structure from the saved leaves on that device.
"""

from __future__ import annotations

import json
import os
import shutil
import tempfile
import threading
import zipfile
from pathlib import Path

import numpy as np
import torch


def _is_node(x) -> bool:
    return x is None or isinstance(x, (dict, list, tuple))


def _children(x):
    """``(key, child)`` pairs of a container in JAX's flatten order."""
    if x is None:
        return []
    if isinstance(x, dict):
        return [(k, x[k]) for k in sorted(x)]
    return list(enumerate(x))


def tree_flatten_with_path(tree, path=()):
    """``[(path, leaf)]`` in JAX's order (``jax.tree_util.
    tree_flatten_with_path`` on dicts, lists, tuples and None)."""
    if not _is_node(tree):
        return [(path, tree)]
    out = []
    for k, child in _children(tree):
        out.extend(tree_flatten_with_path(child, path + (k,)))
    return out


def tree_leaves(tree) -> list:
    return [leaf for _, leaf in tree_flatten_with_path(tree)]


def tree_paths(tree) -> list[str]:
    """The manifest's ``paths``: each leaf's keys joined by ``/``."""
    return ["/".join(str(k) for k in p) for p, _ in tree_flatten_with_path(tree)]


def tree_unflatten(like, leaves):
    """``like``'s structure with its leaves replaced, in flatten order."""
    return _build(like, iter(leaves))


def _build(x, it):
    # a module function, not a recursive closure: a closure that calls
    # itself is a reference cycle, which would hold ``leaves`` (a train
    # step's gradients, say) until the garbage collector runs
    if not _is_node(x):
        return next(it)
    if x is None:
        return None
    if isinstance(x, dict):
        new = {k: _build(x[k], it) for k in sorted(x)}
        return type(x)((k, new[k]) for k in x)  # the caller's key order
    return type(x)(_build(c, it) for c in x)


BF16_WORDS = np.dtype("V2")  # a bfloat16 leaf on the host: its raw 2-byte words


def _to_host(x) -> np.ndarray:
    """A leaf as a numpy array, copied now (the state may change next step);
    a bfloat16 tensor as its words (``BF16_WORDS``)."""
    if isinstance(x, torch.Tensor):
        x = x.detach()
        words = x.dtype == torch.bfloat16
        host = (x.view(torch.int16) if words else x).cpu().numpy()
        if not x.is_cuda:  # .cpu() of a CPU tensor shares its storage
            host = host.copy()
        return host.view(BF16_WORDS) if words else host
    return np.array(x)


def _dtype_name(x: np.ndarray) -> str:
    return "bfloat16" if x.dtype == BF16_WORDS else str(x.dtype)


def _savez(path: Path, arrays: dict[str, np.ndarray]) -> None:
    """``np.savez``, but a ``BF16_WORDS`` array gets the header the JAX
    package's bfloat16 arrays get (``'<V2'``, ml_dtypes' descriptor), so
    its ``.npy`` member is byte for byte the JAX package's."""
    if not any(a.dtype == BF16_WORDS for a in arrays.values()):
        np.savez(path, **arrays)
        return
    with zipfile.ZipFile(path, mode="w", compression=zipfile.ZIP_STORED,
                         allowZip64=True) as zf:
        for key, a in arrays.items():
            with zf.open(key + ".npy", "w", force_zip64=True) as fid:
                if a.dtype != BF16_WORDS:
                    np.lib.format.write_array(fid, np.asanyarray(a))
                    continue
                np.lib.format.write_array_header_1_0(
                    fid, {"descr": "<V2", "fortran_order": False, "shape": a.shape})
                fid.write(np.ascontiguousarray(a).tobytes())


def _from_host(x: np.ndarray, dtype: str) -> torch.Tensor:
    """A leaf ``np.load`` read (its own array, not a view of the file)."""
    if dtype == "bfloat16":
        return torch.from_numpy(x.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(x)


class CheckpointManager:
    def __init__(self, directory: str | Path, *, host_id: int = 0, num_hosts: int = 1,
                 keep: int = 3, async_save: bool = True):
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.host_id = host_id
        self.num_hosts = num_hosts
        self.keep = keep
        self.async_save = async_save
        self._pending: threading.Thread | None = None

    # ------------------------------ save ------------------------------------

    def _atomic_save(self, step: int, arrays: dict[str, np.ndarray], manifest: dict):
        """The atomic commit of any named-array payload (a tree of tensors
        or an arena snapshot): everything into a temp dir, renamed into
        place, THEN the ``LATEST`` pointer flipped.  A crash at any point
        leaves the previous checkpoint restorable or the new one committed;
        a partial dir has no manifest.json and ``all_steps``/``latest_step``
        ignore it."""
        final = self.dir / f"step_{step:08d}"
        tmp = Path(tempfile.mkdtemp(dir=self.dir, prefix=".tmp_save_"))
        try:
            _savez(tmp / f"shard_{self.host_id}.npz", arrays)
            (tmp / "manifest.json").write_text(json.dumps(manifest))
            if final.exists():
                shutil.rmtree(final)
            os.replace(tmp, final)
            ptr = self.dir / ".LATEST_tmp"
            ptr.write_text(str(step))
            os.replace(ptr, self.dir / "LATEST")
            self._gc()
        finally:
            if tmp.exists():
                shutil.rmtree(tmp, ignore_errors=True)

    def save(self, state, step: int, *, extra: dict | None = None, block: bool = False):
        """``state``: a tree of tensors (dicts, lists, tuples, None).
        ``extra``: a small JSON-able dict (a data iterator's step, ...)."""
        self.wait()  # one save in flight at a time
        host_leaves = [_to_host(x) for x in tree_leaves(state)]
        manifest = {
            "step": step,
            "num_hosts": self.num_hosts,
            "paths": tree_paths(state),
            "shapes": [list(x.shape) for x in host_leaves],
            "dtypes": [_dtype_name(x) for x in host_leaves],
            "extra": extra or {},
        }
        arrays = {f"a{i}": x for i, x in enumerate(host_leaves)}

        def write():
            self._atomic_save(step, arrays, manifest)

        if self.async_save and not block:
            t = threading.Thread(target=write, daemon=True)
            t.start()
            self._pending = t
        else:
            write()

    def wait(self):
        if self._pending is not None:
            self._pending.join()
            self._pending = None

    def _gc(self):
        steps = sorted(self.all_steps())
        for s in steps[: -self.keep]:
            shutil.rmtree(self.dir / f"step_{s:08d}", ignore_errors=True)

    # ----------------------------- restore ----------------------------------

    def all_steps(self):
        return [int(p.name.split("_")[1]) for p in self.dir.glob("step_*")
                if (p / "manifest.json").exists()]

    def latest_step(self) -> int | None:
        ptr = self.dir / "LATEST"
        if ptr.exists():
            s = int(ptr.read_text())
            if (self.dir / f"step_{s:08d}" / "manifest.json").exists():
                return s
        steps = self.all_steps()
        return max(steps) if steps else None

    def restore(self, like_state, step: int | None = None, *, device=None):
        """Restore into the structure of ``like_state`` as tensors on
        ``device`` (None: the device of ``like_state``'s first tensor, the
        CPU when it has none).  Returns ``(state, extra, step)``."""
        step = self.latest_step() if step is None else step
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {self.dir}")
        d = self.dir / f"step_{step:08d}"
        manifest = json.loads((d / "manifest.json").read_text())
        with np.load(d / f"shard_{self.host_id}.npz") as data:
            leaves = [data[f"a{i}"] for i in range(len(manifest["paths"]))]
        like_leaves = tree_leaves(like_state)
        if len(like_leaves) != len(leaves):
            raise ValueError(f"checkpoint has {len(leaves)} leaves, expected {len(like_leaves)}")
        if device is None:
            device = next((x.device for x in like_leaves if isinstance(x, torch.Tensor)), "cpu")
        out = [_from_host(x, dt).to(device) for x, dt in zip(leaves, manifest["dtypes"])]
        return tree_unflatten(like_state, out), manifest["extra"], step
