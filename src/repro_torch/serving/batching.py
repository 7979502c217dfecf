"""Continuous batching for serving: slot-based admission + retirement.

Requests arrive with prompts; the scheduler fills free decode slots,
decodes one token per step for all slots, retires sequences on EOS / max
tokens, and immediately backfills freed slots -- the vLLM-style serving
loop on top of the model zoo's ``prefill``/``decode_step``.  Runs eagerly
on the params' device (the JAX package jits one prefill per distinct
prompt length).  ``DeviceRunner`` and ``QuantumWork`` at the end are the
traversal service's background execution thread.
"""

from __future__ import annotations

import dataclasses
import queue
import threading
import time

import numpy as np
import torch

RECURRENT_STATE = ("S", "conv")  # cache entries a new request starts from zeros


@dataclasses.dataclass
class Request:
    req_id: int
    prompt: np.ndarray  # (L,) int32
    max_new_tokens: int
    arrived_step: int = 0
    # filled by serving
    output: list = dataclasses.field(default_factory=list)
    finished_step: int = -1


@dataclasses.dataclass
class ServeMetrics:
    steps: int = 0
    tokens_out: int = 0
    wall_s: float = 0.0
    prefill_calls: int = 0  # prefill invocations (batched admission)
    prefill_tokens: int = 0  # prompt tokens absorbed through prefill
    # host clock around each call, up to the host reading its result (which
    # waits for the device): prefill calls with their cache merge, and
    # decode steps
    prefill_s: float = 0.0
    decode_s: float = 0.0

    @property
    def tokens_per_s(self):
        return self.tokens_out / self.wall_s if self.wall_s else 0.0


class ContinuousBatcher:
    """Greedy decoding over a fixed slot count with continuous admission.

    ``prefill_mode="batched"`` (default) absorbs every admission's prompts
    in one full-sequence ``model.prefill`` call per distinct prompt length;
    admitted slots' cache entries merge into the live cache, other slots
    are untouched.  ``"token"`` feeds prompt tokens one by one through
    ``decode_step`` (one full-batch decode per prompt token), slot-isolated,
    from a zeroed recurrent state, so it equals ``"batched"``.  The encdec
    family is always served in token mode, as in the JAX package: its
    prefill needs frames, so the encoder never runs here, and the
    cross-attention attends over the zero ``xk``/``xv`` of ``cache_init``.
    Set ``.model_params`` before ``serve``; the batcher runs on their device.
    """

    def __init__(self, model, *, max_batch: int, max_len: int, eos_id: int = 1,
                 prefill_mode: str = "batched"):
        if prefill_mode not in ("batched", "token"):
            raise ValueError(f"unknown prefill_mode {prefill_mode!r}")
        if model.cfg.family == "encdec":
            prefill_mode = "token"
        self.model = model
        self.cfg = model.cfg
        self.max_batch = max_batch
        self.max_len = max_len
        self.eos_id = eos_id
        self.prefill_mode = prefill_mode
        self.model_params = None

    def serve(self, requests: list[Request]) -> ServeMetrics:
        if self.model_params is None:
            raise RuntimeError("set .model_params before serve()")
        t0 = time.perf_counter()
        params = self.model_params
        dev = params["embed"].device
        queue = list(requests)
        B = self.max_batch
        cache = self.model.cache_init(B, self.max_len, device=dev)
        slot_req: list[Request | None] = [None] * B
        pos = np.zeros(B, np.int64)
        cur_tok = np.zeros(B, np.int32)
        metrics = ServeMetrics()

        def admit_token(s: int, req: Request):
            # per-slot prefill: one full-batch decode per prompt token, of
            # which only slot s's cache entries are kept.  The slot's
            # recurrent state (ssm) starts from zeros, as a prefill does; the
            # JAX package's token mode carries the previous request's state
            # over.  KV entries need nothing: the position mask hides them.
            nonlocal cache
            for key in RECURRENT_STATE:
                if key in cache:
                    cache[key][:, s].zero_()
            for t, tok in enumerate(req.prompt):
                scratch = {k: c.clone() for k, c in cache.items()}
                logits, scratch = self.model.decode_step(
                    params, scratch,
                    torch.full((B,), int(tok), dtype=torch.int32, device=dev),
                    torch.full((B,), t, dtype=torch.int32, device=dev),
                )
                cache = _merge_slot(cache, scratch, s)
            pos[s] = len(req.prompt)
            cur_tok[s] = int(logits[s].argmax())
            req.output.append(int(cur_tok[s]))

        def admit():
            nonlocal cache
            admitted: list[tuple[int, Request]] = []
            for s in range(B):
                if slot_req[s] is None and queue:
                    req = queue.pop(0)
                    slot_req[s] = req
                    admitted.append((s, req))
            if not admitted:
                return
            tp = time.perf_counter()
            if self.prefill_mode == "token":
                for s, req in admitted:
                    admit_token(s, req)
                metrics.prefill_s += time.perf_counter() - tp
                return
            # batched prefill: one call per distinct prompt length; rows of
            # slots not admitted carry zeros and their cache entries are
            # discarded by the slot-wise merge
            by_len: dict[int, list[tuple[int, Request]]] = {}
            for s, req in admitted:
                by_len.setdefault(len(req.prompt), []).append((s, req))
            for Lp, group in sorted(by_len.items()):
                toks = np.zeros((B, Lp), np.int32)
                for s, req in group:
                    toks[s] = req.prompt
                logits, cache2 = self.model.prefill(
                    params, {"tokens": torch.from_numpy(toks).to(dev)}, self.max_len)
                slots = np.array([s for s, _ in group])
                cache = _merge_slots(cache, cache2, slots)
                del cache2
                metrics.prefill_calls += 1
                metrics.prefill_tokens += Lp * len(group)
                nxt = logits[torch.from_numpy(slots).to(dev), Lp - 1].argmax(dim=-1).cpu()
                for j, (s, req) in enumerate(group):
                    pos[s] = Lp
                    cur_tok[s] = int(nxt[j])
                    req.output.append(int(cur_tok[s]))
            metrics.prefill_s += time.perf_counter() - tp

        admit()
        while any(r is not None for r in slot_req) or queue:
            td = time.perf_counter()
            logits, cache = self.model.decode_step(
                params, cache, torch.from_numpy(cur_tok).to(dev),
                torch.from_numpy(pos.astype(np.int32)).to(dev),
            )
            nxt = logits.argmax(dim=-1).cpu().numpy()
            metrics.decode_s += time.perf_counter() - td
            metrics.steps += 1
            for s in range(B):
                req = slot_req[s]
                if req is None:
                    continue
                pos[s] += 1
                tok = int(nxt[s])
                req.output.append(tok)
                metrics.tokens_out += 1
                cur_tok[s] = tok
                done = (
                    tok == self.eos_id
                    or len(req.output) >= req.max_new_tokens
                    or pos[s] >= self.max_len - 1
                )
                if done:
                    req.finished_step = metrics.steps
                    slot_req[s] = None
                    pos[s] = 0
            admit()
        metrics.wall_s = time.perf_counter() - t0
        return metrics


def _merge_slot(cache_old, cache_new, slot: int):
    """Takes slot ``slot``'s entries from cache_new into cache_old, in place
    (caches have batch on axis 1, layers first)."""
    for key, a in cache_old.items():
        a[:, slot] = cache_new[key][:, slot]
    return cache_old


def _merge_slots(cache_old, cache_new, slots: np.ndarray):
    """Batched ``_merge_slot``: every slot in ``slots`` from cache_new, in
    place."""
    for key, a in cache_old.items():
        idx = torch.as_tensor(slots, dtype=torch.long, device=a.device)
        a[:, idx] = cache_new[key][:, idx]
    return cache_old


# --------------------------------------------------------------------------
# The device runner (PulseService's background execution thread)
# --------------------------------------------------------------------------


@dataclasses.dataclass
class QuantumWork:
    """One traversal quantum handed to the ``DeviceRunner``.

    ``run`` does the device work (one ``engine.execute`` call) and returns
    its result; ``apply`` consumes that result (the slot state, the fast
    retirement, the emit events).  Both run on the runner thread, strictly
    FIFO, so the order of engine calls, and with it every record, commit
    and arena, is the synchronous loop's."""

    label: str
    run: "callable"
    apply: "callable"


class DeviceRunner:
    """A background thread that issues every engine call, behind a bounded
    queue of ``depth`` quanta.

    The main thread admits and books the next round while this thread
    keeps the current quantum on the card; a submit past ``depth`` blocks
    the producer (backpressure).  Lifecycle: ``start``, any number of
    ``submit``, ``drain`` (a barrier: every submitted quantum ran and was
    applied), ``close``.  An exception on the runner thread is kept and
    raised on the next ``submit`` or ``drain``, tagged with the failing
    work's label when it has a ``label`` of None (a ``ShardFailure``).

    Every CUDA call of the service is made on this thread (the main
    thread's admission stays on the host), so the CUDA-graph capture of a
    device-resident loop, which refuses unsafe CUDA calls from any thread
    in its default mode, never meets one from the main thread."""

    def __init__(self, depth: int = 2):
        if depth < 1:
            raise ValueError("depth must be >= 1")
        self._q: queue.Queue[QuantumWork | None] = queue.Queue(maxsize=depth)
        self._cv = threading.Condition()
        self._unfinished = 0
        self._err: BaseException | None = None
        self._thread: threading.Thread | None = None
        self.quanta_run = 0
        self.max_queue_depth = 0  # high-water mark of the handoff queue

    def start(self) -> DeviceRunner:
        if self._thread is not None:
            raise RuntimeError("runner already started")
        self._thread = threading.Thread(target=self._loop, name="pulse-device-runner",
                                        daemon=True)
        self._thread.start()
        return self

    def _loop(self) -> None:
        while True:
            work = self._q.get()
            if work is None:
                return
            try:
                if self._err is None:  # fail fast after the first error
                    work.apply(work.run())
                    self.quanta_run += 1
            except BaseException as e:  # noqa: BLE001 -- must cross threads
                if getattr(e, "label", "") is None:
                    e.label = work.label
                with self._cv:
                    self._err = e
            finally:
                with self._cv:
                    self._unfinished -= 1
                    self._cv.notify_all()

    def _raise_pending(self) -> None:
        if self._err is not None:
            err, self._err = self._err, None
            raise err

    def submit(self, work: QuantumWork) -> None:
        if self._thread is None:
            raise RuntimeError("runner not started")
        self._raise_pending()
        with self._cv:
            self._unfinished += 1
        self.max_queue_depth = max(self.max_queue_depth,
                                   min(self._q.maxsize, self._q.qsize() + 1))
        self._q.put(work)  # blocks at depth: a bounded handoff

    @property
    def in_flight(self) -> int:
        with self._cv:
            return self._unfinished

    def wait_idle(self) -> None:
        """Block until every submitted quantum has run (or been skipped
        behind an error), raising nothing: a pending error stays for the
        next ``submit`` or ``drain``."""
        with self._cv:
            self._cv.wait_for(lambda: self._unfinished == 0)

    def drain(self) -> None:
        """Barrier: block until every submitted quantum has run and applied."""
        with self._cv:
            self._cv.wait_for(lambda: self._unfinished == 0)
        self._raise_pending()

    def close(self) -> None:
        if self._thread is None:
            return
        self.drain()
        self._q.put(None)
        self._thread.join()
        self._thread = None
