"""Port parity: traversal serving's admission (``repro_torch.serving.
admission``) against the JAX package's ``repro.serving.admission``.

Both are host Python: the same submit, admit and requeue sequences (with
the same clock values) must give the same admit lists, shed counts,
pending views and requeue order.  The hand-written cases mirror
``tests/test_serving_traversals.py`` (FIFO within a tenant, EDF across
tenants, fairness, per-structure capacity, the write barriers) and
``tests/test_async_service.py`` (the token bucket, requeue); seeded random
sequences cover the rest."""

import numpy as np
import pytest

from repro.serving import admission as jadm
from repro_torch.serving import admission as tadm

PKGS = (jadm, tadm)


def _req(mod, rid, structure="s", tenant="t", deadline_ms=None, **kw):
    return mod.TraversalRequest(rid, structure, query=rid, tenant=tenant,
                                deadline_ms=deadline_ms, **kw)


def _ids(reqs):
    return [r.req_id for r in reqs]


def _both(fn):
    """``fn(mod)`` for both packages; asserts the results are equal."""
    a, b = (fn(m) for m in PKGS)
    assert a == b
    return b


# ---------------------------- the hand-written cases ----------------------------


def test_fifo_within_a_tenant():
    def run(m):
        ac = m.AdmissionController()
        for i in range(6):
            ac.submit(_req(m, i, tenant="a"), now_s=float(i))
        return _ids(ac.admit({"s": 4})), _ids(ac.admit({"s": 4})), ac.pending()

    assert _both(run) == ([0, 1, 2, 3], [4, 5], 0)


def test_edf_across_tenants():
    def run(m):
        ac = m.AdmissionController()
        ac.submit(_req(m, 0, tenant="lazy"), now_s=0.0)
        ac.submit(_req(m, 1, tenant="urgent", deadline_ms=10.0), now_s=0.0)
        ac.submit(_req(m, 2, tenant="soon", deadline_ms=100.0), now_s=0.0)
        return _ids(ac.admit({"s": 3})), ac.peek_earliest_deadline()

    assert _both(lambda m: run(m)[0]) == [1, 2, 0]


def test_fairness_serves_the_trickle_every_round():
    def run(m):
        ac = m.AdmissionController()
        for i in range(20):
            ac.submit(_req(m, i, tenant="flood"), now_s=0.0)
        for i in range(20, 24):
            ac.submit(_req(m, i, tenant="trickle"), now_s=0.0)
        return [[r.tenant for r in ac.admit({"s": 2})] for _ in range(4)]

    for tenants in _both(run):
        assert set(tenants) == {"flood", "trickle"}


def test_per_structure_capacity_keeps_the_blocked_head():
    def run(m):
        ac = m.AdmissionController()
        ac.submit(m.TraversalRequest(0, "full", 0, tenant="a"), now_s=0.0)
        ac.submit(m.TraversalRequest(1, "free", 1, tenant="b"), now_s=0.0)
        return _ids(ac.admit({"full": 0, "free": 1})), ac.pending(), ac.pending_by_structure()

    assert _both(run)[:2] == ([1], 1)


def test_requeue_restores_the_front_and_the_sequence():
    def run(m):
        ac = m.AdmissionController()
        a, b = m.TraversalRequest(0, "s", 1, tenant="t"), m.TraversalRequest(1, "s", 2, tenant="t")
        assert ac.submit(a, 0.0) and ac.submit(b, 0.0)
        (first,) = ac.admit({"s": 1})
        ac.requeue(a)
        return (first.req_id, ac.pending(), ac.pending_by_structure(),
                _ids(ac.admit({"s": 1})))

    assert _both(run) == (0, 2, {"s": 0}, [0])


def test_token_bucket():
    def run(m):
        rl = m.TenantRateLimiter(rate_rps=10.0, burst=2.0)
        return [rl.allow("a", 0.0), rl.allow("a", 0.0), rl.allow("a", 0.0), rl.allow("a", 0.1),
                rl.allow("b", 0.0)]

    assert _both(run) == [True, True, False, True, True]
    for m in PKGS:
        with pytest.raises(ValueError):
            m.TenantRateLimiter(0.0)


def test_write_barriers_cases():
    """``test_write_barrier_excludes_concurrent_readers``'s five cases."""
    group_of = {"list": "list", "list_ins": "list", "hash": "hash"}
    writes = {"list": False, "list_ins": True, "hash": False}
    group_of2 = {**group_of, "list_del": "list"}
    writes2 = {**writes, "list_del": True}
    free3 = {"list": 4, "list_ins": 4, "hash": 4}
    free4 = {"list": 4, "list_ins": 4, "list_del": 4, "hash": 4}
    cases = [
        (free3, group_of, writes, {"list": False, "list_ins": True, "hash": False}, {},
         {"list": 0, "list_ins": 4, "hash": 4}),
        (free3, group_of, writes, {"list": True, "list_ins": False, "hash": False}, {},
         {"list": 4, "list_ins": 0, "hash": 4}),
        (free3, group_of, writes, {"list": False, "list_ins": False, "hash": False},
         {"list_ins": 2}, {"list": 0, "list_ins": 4, "hash": 4}),
        (free4, group_of2, writes2, {n: False for n in group_of2},
         {"list_ins": 0, "list_del": 5}, {"list": 0, "list_ins": 4, "list_del": 0, "hash": 4}),
        (free4, group_of2, writes2,
         {"list": False, "list_ins": True, "list_del": False, "hash": False}, {"list_del": 2},
         {"list": 0, "list_ins": 4, "list_del": 0, "hash": 4}),
    ]
    for free, gof, wr, occ, pend, want in cases:
        assert _both(lambda m: m.apply_write_barriers(free, gof, wr, occ, pend)) == want


def test_overload_controls_shed_alike():
    def run(m):
        ac = m.AdmissionController(max_pending=3,
                                   rate_limiter=m.TenantRateLimiter(2.0, burst=2.0))
        got = [ac.submit(_req(m, i, tenant=("a", "b")[i % 2]), now_s=0.1 * i) for i in range(12)]
        ac.admit({"s": 2})
        got += [ac.submit(_req(m, 100 + i, tenant="c"), now_s=2.0) for i in range(3)]
        return (got, ac.shed, ac.shed_rate_limited, ac.shed_queue_full, ac.shed_by_tenant,
                ac.pending(), len(ac))

    got = _both(run)
    assert got[1] == got[2] + got[3] and got[2] > 0 and got[3] > 0


# ------------------------------ seeded sequences --------------------------------


def _random_run(m, seed, n_ops=400):
    """A seeded mix of submits (tenants, structures, deadlines, clock
    steps), admits over random free-slot budgets, requeues of admitted
    requests and the views the service reads; returns every observation."""
    g = np.random.default_rng(seed)
    ac = m.AdmissionController(
        max_pending=int(g.integers(4, 40)) if g.random() < 0.5 else None,
        rate_limiter=(m.TenantRateLimiter(float(g.integers(5, 50)), float(g.integers(1, 6)))
                      if g.random() < 0.5 else None))
    structures = ["s0", "s1", "s2"]
    now, rid, admitted, log = 0.0, 0, [], []
    for _ in range(n_ops):
        op = g.random()
        if op < 0.55:
            dl = None if g.random() < 0.5 else float(g.integers(1, 500))
            r = _req(m, rid, structure=structures[g.integers(0, 3)],
                     tenant=f"t{g.integers(0, 4)}", deadline_ms=dl)
            rid += 1
            log.append(("submit", r.req_id, ac.submit(r, now)))
            now += float(g.integers(0, 30)) / 1000.0
        elif op < 0.85:
            free = {s: int(g.integers(0, 4)) for s in structures}
            got = ac.admit(free)
            admitted += got
            log.append(("admit", _ids(got)))
        elif admitted:
            r = admitted.pop(int(g.integers(0, len(admitted))))
            ac.requeue(r)
            log.append(("requeue", r.req_id))
        peek = ac.peek_earliest_deadline()
        log.append((ac.pending(), ac.pending_by_structure(), ac.head_pending_by_structure(),
                    None if peek is None else (peek[0], peek[1].req_id),
                    ac.earliest_deadline_s()))
    log.append((ac.shed, ac.shed_rate_limited, ac.shed_queue_full, ac.shed_by_tenant))
    return log


@pytest.mark.parametrize("seed", range(16))
def test_seeded_sequences_match(seed):
    _both(lambda m: _random_run(m, seed))


@pytest.mark.parametrize("seed", range(8))
def test_seeded_write_barriers_match(seed):
    g = np.random.default_rng(100 + seed)
    names = [f"n{i}" for i in range(8)]
    for _ in range(200):
        group_of = {n: f"g{g.integers(0, 3)}" for n in names}
        writes = {n: bool(g.random() < 0.4) for n in names}
        occupied = {n: bool(g.random() < 0.3) for n in names}
        pending = {n: int(g.integers(0, 50)) for n in names if g.random() < 0.4}
        free = {n: int(g.integers(0, 5)) for n in names}
        _both(lambda m: m.apply_write_barriers(free, group_of, writes, occupied, pending))


@pytest.mark.parametrize("seed", range(4))
def test_seeded_token_buckets_match(seed):
    g = np.random.default_rng(200 + seed)
    rate, burst = float(g.integers(1, 20)), float(g.integers(1, 5))
    steps = [(f"t{g.integers(0, 3)}", float(g.integers(0, 200)) / 1000.0) for _ in range(300)]

    def run(m):
        rl, now, out = m.TenantRateLimiter(rate, burst), 0.0, []
        for tenant, dt in steps:
            now += dt
            out.append(rl.allow(tenant, now))
        return out

    _both(run)


def test_request_latency_and_deadline():
    for m in PKGS:
        r = m.TraversalRequest(0, "s", 1, deadline_ms=5.0)
        assert np.isnan(r.latency_ms) and r.deadline_met is False
        r.arrival_s, r.finish_s = 1.0, 1.004
        assert r.deadline_met is True and abs(r.latency_ms - 4.0) < 1e-9
        assert m.TraversalRequest(1, "s", 1).deadline_met is None
