"""Port parity: arena, builders and address translation.

The same keys go through the JAX package's builders and the torch port's;
the arenas must be equal word for word (``data``, ``bounds``, ``perms``,
``heap``).  Data crosses between the packages as numpy arrays; the port runs
on the CPU."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import arena as jarena
from repro.core import translation as jtrans
from repro.core.structures import bst as jbst
from repro.core.structures import btree as jbtree
from repro.core.structures import hash_table as jhash
from repro.core.structures import linked_list as jlist
from repro_torch.core import arena as tarena
from repro_torch.core import translation as ttrans
from repro_torch.core.structures import bst as tbst
from repro_torch.core.structures import btree as tbtree
from repro_torch.core.structures import hash_table as thash
from repro_torch.core.structures import linked_list as tlist

CPU = "cpu"


def _np_fields(ar):
    return [np.asarray(x) for x in (ar.data, ar.bounds, ar.perms, ar.heap)]


def _t_fields(ar):
    return [x.cpu().numpy() for x in (ar.data, ar.bounds, ar.perms, ar.heap)]


def assert_same_arena(jar, tar):
    assert tar.data.dtype == torch.int32 and tar.data.device.type == CPU
    for name, a, b in zip(("data", "bounds", "perms", "heap"), _np_fields(jar), _t_fields(tar)):
        np.testing.assert_array_equal(a, b, err_msg=name)
        assert a.dtype == b.dtype, name


def _keys(rng, n, hi=10**6):
    return rng.choice(np.arange(hi), size=n, replace=False).astype(np.int32)


@pytest.mark.parametrize("num_shards,policy", [(1, "sequential"), (4, "interleaved")])
def test_list_and_hash_builders_match(num_shards, policy):
    rng = np.random.default_rng(0)
    keys = _keys(rng, 96)
    vals = rng.integers(-(2**31), 2**31 - 1, 96).astype(np.int32)
    jar, jhead = jlist.build(keys, vals, num_shards=num_shards, policy=policy)
    tar, thead = tlist.build(keys, vals, num_shards=num_shards, policy=policy, device=CPU)
    assert jhead == thead
    assert_same_arena(jar, tar)
    for nb in (1, 7, 32, 200):
        jar, jheads = jhash.build(keys, vals, nb, num_shards=num_shards, policy=policy)
        tar, theads = thash.build(keys, vals, nb, num_shards=num_shards, policy=policy,
                                  device=CPU)
        np.testing.assert_array_equal(np.asarray(jheads), theads)
        assert_same_arena(jar, tar)


@pytest.mark.parametrize("n", [1, 2, 9, 64, 257])
def test_bst_builder_matches(n):
    rng = np.random.default_rng(n)
    keys = _keys(rng, n)
    vals = rng.integers(0, 10**6, n).astype(np.int32)
    jar, jroot, jh = jbst.build(keys, vals)
    tar, troot, th = tbst.build(keys, vals, device=CPU)
    assert (jroot, jh) == (troot, th)
    assert_same_arena(jar, tar)


@pytest.mark.parametrize("n", [0, 1, 7, 8, 9, 72, 73, 81, 82, 600, 5000])
def test_btree_vectorised_bulk_load_matches_loop(n):
    """The port lays out each B+tree level with whole-array numpy ops; the
    reference loops per node.  Records must agree bit for bit."""
    rng = np.random.default_rng(n)
    keys = _keys(rng, n, hi=10**7)
    vals = rng.integers(-(2**31), 2**31 - 1, n).astype(np.int32)
    jar, jroot, jh = jbtree.build(keys, vals)
    tar, troot, th = tbtree.build(keys, vals, device=CPU)
    assert (jroot, jh) == (troot, th)
    assert_same_arena(jar, tar)
    assert jbtree.node_estimate(n) == tbtree.node_estimate(n)


def test_pooled_builder_free_then_finish_threads_free_list():
    """Several structures in one pooled heap, then host frees: the LIFO
    free-list threading of ``finish`` must match (heap registers included)."""
    for num_shards, policy in ((1, "sequential"), (2, "sequential"), (4, "interleaved")):
        rng = np.random.default_rng(num_shards)
        keys = _keys(rng, 40)
        vals = rng.integers(0, 100, 40).astype(np.int32)
        out = []
        for mod_arena, mods in ((jarena, (jlist, jhash, jbtree)),
                                (tarena, (tlist, thash, tbtree))):
            b = mod_arena.ArenaBuilder(256, 20, num_shards=num_shards, policy=policy)
            mods[0].build_into(b, keys[:10], vals[:10])
            mods[1].build_into(b, keys[10:25], vals[10:25], 4)
            mods[2].build_into(b, keys[25:], vals[25:])
            b.free([3, 17, 5])
            b.alloc(1)  # pops 5 back off the free list
            b.free(np.array([100, 2], np.int64))
            if mod_arena is jarena:
                out.append(b.finish(perms=[1] * num_shards))
            else:
                out.append(b.finish(perms=[1] * num_shards, device=CPU))
        assert_same_arena(*out)


def test_arena_from_numpy_round_trips_and_make_arena_matches():
    rng = np.random.default_rng(3)
    data = rng.integers(-(2**31), 2**31 - 1, (24, 5)).astype(np.int32)
    jar = jarena.make_arena(data, num_shards=3, perms=[1, 3, 0])
    tar = tarena.arena_from_numpy(*_np_fields(jar), device=CPU)
    assert_same_arena(jar, tar)
    assert (tar.capacity, tar.node_words, tar.num_shards) == (24, 5, 3)
    assert_same_arena(jar, tarena.make_arena(data, num_shards=3, perms=[1, 3, 0], device=CPU))
    back = tarena.arena_from_numpy(*_t_fields(tar), device=CPU)
    for a, b in zip(_t_fields(tar), _t_fields(back)):
        np.testing.assert_array_equal(a, b)


def test_arena_word_helpers_match():
    x = np.array([1.5, -0.0, np.inf, 3.25e-7], np.float32)
    np.testing.assert_array_equal(
        np.asarray(jarena.f2i(x)), tarena.f2i(torch.from_numpy(x)).numpy()
    )
    i = jarena.nf2i(x)
    np.testing.assert_array_equal(
        np.asarray(jarena.i2f(i)), tarena.i2f(torch.from_numpy(i)).numpy()
    )
    data = np.arange(40, dtype=np.int32).reshape(10, 4)
    p = np.array([-1, 0, 3, 9, 10, 77], np.int32)
    np.testing.assert_array_equal(
        np.asarray(jarena.load_node(data, p)),
        tarena.load_node(torch.from_numpy(data), torch.from_numpy(p)).numpy(),
    )
    rec = np.full((2, 4), 7, np.int32)
    q = np.array([2, 12], np.int32)
    np.testing.assert_array_equal(
        np.asarray(jarena.store_node(jnp.asarray(data), jnp.asarray(q), jnp.asarray(rec))),
        tarena.store_node(torch.from_numpy(data), torch.from_numpy(q),
                          torch.from_numpy(rec)).numpy(),
    )


def test_make_arena_limits():
    with pytest.raises(ValueError):
        tarena.make_arena(np.zeros((4, 65), np.int32), device=CPU)
    with pytest.raises(ValueError):
        tarena.make_arena(np.zeros((5, 4), np.int32), num_shards=2, device=CPU)


@pytest.mark.parametrize("bounds,perms", [
    ([0, 64], [3]),
    ([0, 16, 40, 41, 64], [1, 0, 3, 2]),
    ([0, 0, 32, 64], [1, 1, 0]),
])
def test_translation_matches(bounds, perms):
    rng = np.random.default_rng(len(bounds))
    ptr = np.concatenate([
        rng.integers(-5, 80, 200), [-1, 0, 63, 64, 2**31 - 1, -(2**31)]
    ]).astype(np.int32)
    jb, jp = np.asarray(bounds, np.int32), np.asarray(perms, np.int32)
    tb, tp, tptr = torch.from_numpy(jb), torch.from_numpy(jp), torch.from_numpy(ptr)
    jown = np.asarray(jtrans.owner_of(jb, ptr))
    town = ttrans.owner_of(tb, tptr)
    assert town.dtype == torch.int32
    np.testing.assert_array_equal(jown, town.numpy())
    np.testing.assert_array_equal(
        np.asarray(jtrans.local_offset(jb, jown, ptr)),
        ttrans.local_offset(tb, town, tptr).numpy(),
    )
    for want in (jarena.PERM_READ, jarena.PERM_WRITE):
        jtab = np.asarray(jtrans.access_table(jp, want))
        ttab = ttrans.access_table(tp, want)
        np.testing.assert_array_equal(jtab, ttab.numpy())
        np.testing.assert_array_equal(
            np.asarray(jtrans.check_access_table(jtab, jown)),
            ttrans.check_access_table(ttab, town).numpy(),
        )
        np.testing.assert_array_equal(
            np.asarray(jtrans.check_access(jp, jown, want)),
            ttrans.check_access(tp, town, want).numpy(),
        )
    for s in range(len(bounds) - 1):
        np.testing.assert_array_equal(
            np.asarray(jtrans.is_local(jb, s, ptr)), ttrans.is_local(tb, s, tptr).numpy()
        )
