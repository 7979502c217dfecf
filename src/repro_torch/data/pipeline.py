"""Deterministic synthetic data pipeline with per-host sharding + packing,
the JAX package's ``data/pipeline.py``.

Every host reads a disjoint, deterministic slice keyed by (step, host); a
restart resumes exactly (``state_dict``/``load_state_dict``: no batch
repeated or skipped); first-fit packing keeps padding waste near zero.  The
token source is a counter-hash PRNG (a stand-in corpus with a vocab-shaped
unigram skew, so losses are not trivial), computed in numpy exactly as the
JAX package computes it; the iterator puts each batch on ``device``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab: int
    seq_len: int
    global_batch: int
    num_hosts: int = 1
    host_id: int = 0
    seed: int = 0
    doc_len_mean: int = 512  # for packing


def _hash_u32(x: np.ndarray) -> np.ndarray:
    x = x.astype(np.uint64)
    x = (x ^ (x >> 16)) * np.uint64(0x45D9F3B)
    x = (x ^ (x >> 16)) * np.uint64(0x45D9F3B)
    x = x ^ (x >> 16)
    return (x & np.uint64(0xFFFFFFFF)).astype(np.uint32)


def tokens_for(cfg: DataConfig, step: int) -> np.ndarray:
    """Deterministic (step, host)-keyed batch slice: (local_batch, seq_len)."""
    if cfg.global_batch % cfg.num_hosts:
        raise ValueError("global_batch must divide num_hosts")
    local = cfg.global_batch // cfg.num_hosts
    rows = np.arange(local) + cfg.host_id * local
    pos = np.arange(cfg.seq_len)
    key = (
        np.uint64(cfg.seed) * np.uint64(1_000_003)
        + np.uint64(step) * np.uint64(2_654_435_761)
    )
    grid = key + (rows[:, None].astype(np.uint64) << np.uint64(20)) + pos[None, :].astype(np.uint64)
    h = _hash_u32(grid)
    # unigram skew: square the uniform draw -> Zipf-ish head
    u = h.astype(np.float64) / 2**32
    return (u * u * (cfg.vocab - 2)).astype(np.int32) + 1


def pack_documents(doc_lengths: np.ndarray, seq_len: int):
    """First-fit packing of documents into fixed windows.

    Returns (assignments, waste_fraction): assignments[i] = window of doc i.
    """
    windows: list[int] = []  # remaining space per window
    assign = np.empty(len(doc_lengths), np.int64)
    for i, dl in enumerate(doc_lengths):
        dl = int(min(dl, seq_len))
        for w, rem in enumerate(windows):
            if rem >= dl:
                windows[w] -= dl
                assign[i] = w
                break
        else:
            windows.append(seq_len - dl)
            assign[i] = len(windows) - 1
    waste = sum(windows) / max(len(windows) * seq_len, 1)
    return assign, waste


class DataIterator:
    """Stateful iterator with exact checkpoint/resume semantics.  Each batch
    is ``{"tokens", "labels"}`` (int32 tensors on ``device``; the labels
    the tokens shifted left by one, wrapping) and, for each ``extras``
    entry ``name: fn``, ``fn(step, local_batch)`` (a numpy array is put on
    ``device``)."""

    def __init__(self, cfg: DataConfig, start_step: int = 0, extras=None, *,
                 device="cuda"):
        self.cfg = cfg
        self.step = start_step
        self.extras = extras or {}
        self.device = torch.device(device)

    def __iter__(self):
        return self

    def _put(self, a):
        return torch.as_tensor(a).to(self.device) if isinstance(a, np.ndarray) else a

    def __next__(self):
        toks = tokens_for(self.cfg, self.step)
        self.step += 1
        batch = {
            "tokens": self._put(toks),
            "labels": self._put(np.roll(toks, -1, axis=1)),
        }
        for k, fn in self.extras.items():
            batch[k] = self._put(fn(self.step - 1, toks.shape[0]))
        return batch

    def state_dict(self):
        return {"step": self.step}

    def load_state_dict(self, d):
        self.step = int(d["step"])
