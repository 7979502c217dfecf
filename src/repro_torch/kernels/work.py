"""The work the float kernels' functions need, and where a meta run
reports it.

``flash_work`` and ``ssd_work`` count what the function computes, not
what a plain version computes: ``flash_attention`` only the (query, key)
pairs its causal mask keeps, ``ssd_scan`` the chunked SSD's products over
the pairs j <= i of a chunk.  ``chip_smoke.py`` bounds the kernels by
them; on meta tensors the two functions' wrappers return outputs of the
right shape and ``report`` their work to every counter in ``COUNTERS``
(``launch.dryrun.WorkCounter`` while it is active).
"""

from __future__ import annotations

COUNTERS = []  # the active counters, innermost last: each has add_kernel(name, flops, nbytes)


def report(name: str, flops: int, nbytes: int) -> None:
    for counter in COUNTERS:
        counter.add_kernel(name, flops, nbytes)


def _clamped_sum(lo: int, hi: int, cap: int) -> int:
    """sum(min(max(t, 0), cap) for t in range(lo, hi + 1)), in closed form."""

    def upto(n):  # sum(min(t, cap) for t in range(1, n + 1))
        n = max(n, 0)
        if n <= cap:
            return n * (n + 1) // 2
        return cap * (cap + 1) // 2 + (n - cap) * cap

    return upto(hi) - upto(lo - 1) if hi >= lo else 0


def flash_work(B, H, Hk, Lq, Lk, D, causal, elem_bytes=4):
    """(FLOPs, bytes) the function needs: 4*D per (query, key) pair kept
    (q.k and p.v, a multiply-add each), and q, k, v, o once.  Causal query
    row r (of Lq, aligned to the end of the Lk keys) keeps the keys <=
    Lk - Lq + r."""
    if causal:
        off = Lk - Lq
        pairs = _clamped_sum(off + 1, off + Lq, Lk)
    else:
        pairs = Lq * Lk
    flops = 4 * D * B * H * pairs
    nbytes = (2 * B * H * Lq * D + 2 * B * Hk * Lk * D) * elem_bytes
    return flops, nbytes


def ssd_work(Bt, L, H, dh, N, chunk, elem_bytes=4):
    """(FLOPs, bytes) the function needs: per (batch, chunk) C B^T over the
    pairs j <= i (a multiply-add each per state dim; one B/C group serves
    all heads); per (batch, head, chunk) the intra-chunk product over the
    same pairs, C S and the state update (a multiply-add each); x (and y)
    at ``elem_bytes``, dt, A, B, C and the final state in f32, each once."""
    nc = L // chunk
    pairs = chunk * (chunk + 1) // 2
    flops = 2 * Bt * nc * N * pairs + 2 * Bt * H * nc * (dh * pairs + 2 * chunk * N * dh)
    nbytes = (2 * Bt * L * H * dh * elem_bytes
              + 4 * (Bt * L * H + H + 2 * Bt * L * N + Bt * H * N * dh))
    return flops, nbytes
