"""Port parity: the paged KV cache whose page tables are PULSE linked
lists (``serving/kv_cache.py``), against the JAX package's
(``tests/test_serving.py``): the page walk against host truth and the JAX
walk, allocation and recycling, and paged write-then-attend against dense
attention over the same KV (f32, 2e-5)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.configs import get_reduced_config as jget
from repro.core.dispatch import count_instructions
from repro.kernels.paged_attention.ops import paged_attention as jpaged
from repro.serving import kv_cache as jkv
from repro_torch.configs import get_reduced_config as tget
from repro_torch.kernels.flash_attention.ref import mha_reference
from repro_torch.kernels.paged_attention.ops import paged_attention as tpaged
from repro_torch.serving import kv_cache as tkv

CPU = "cpu"


def _pair(n_pages, page_size, max_batch):
    return (jkv.PagedKVCache(jget("qwen3_0_6b"), n_pages=n_pages, page_size=page_size,
                             max_batch=max_batch),
            tkv.PagedKVCache(tget("qwen3_0_6b"), n_pages=n_pages, page_size=page_size,
                             max_batch=max_batch, device=CPU))


def _host_chain(cache, b):
    want, p = [], int(cache.heads[b])
    while p != -1:
        want.append(int(cache.builder.data[p, 0]))
        p = int(cache.builder.data[p, 1])
    return want


@pytest.mark.parametrize("lens,max_pages", [([10, 3, 0, 17], 8), ([10, 3, 0, 17], 3),
                                            ([1, 40, 16, 0], 12)])
def test_page_walk_matches_host_truth_and_the_jax_walk(lens, max_pages):
    jc, tc = _pair(n_pages=32, page_size=4, max_batch=4)
    for b, ln in enumerate(lens):
        for c in (jc, tc):
            if ln:
                c.ensure_capacity(b, ln)
            c.lengths[b] = ln
    np.testing.assert_array_equal(tc.builder.data, jc.builder.data)
    tpt, tlen = tc.walk_page_tables(max_pages=max_pages)
    jpt, jlen = jc.walk_page_tables(max_pages=max_pages)
    assert tpt.dtype == torch.int32 and tlen.dtype == torch.int32
    assert tpt.device.type == CPU and tuple(tpt.shape) == (4, max_pages)
    np.testing.assert_array_equal(tpt.numpy(), np.asarray(jpt))
    np.testing.assert_array_equal(tlen.numpy(), np.asarray(jlen))
    assert tlen.tolist() == lens
    for b in range(len(lens)):
        want = _host_chain(tc, b)[:max_pages]
        assert tpt[b, :len(want)].tolist() == want


def test_page_walk_declares_the_reference_instruction_count():
    for max_pages in (1, 8, 33):
        it = tkv.page_walk_iterator(max_pages)
        assert it.n_instructions == count_instructions(jkv.page_walk_iterator(max_pages), 4)
        assert it.scratch_words == 1 + max_pages


def test_page_alloc_free_recycles():
    cache = tkv.PagedKVCache(tget("qwen3_0_6b"), n_pages=9, page_size=4, max_batch=2,
                             device=CPU)
    cache.ensure_capacity(0, 16)  # 4 pages
    cache.ensure_capacity(1, 16)  # 4 pages -> pool exhausted (page 0 reserved)
    with pytest.raises(MemoryError):
        cache.ensure_capacity(0, 20)
    cache.reset_seq(1)
    assert cache.lengths[1] == 0 and cache.heads[1] == -1
    cache.ensure_capacity(0, 20)  # page freed by seq 1 is reusable
    assert cache.n_alloc_pages(0) == 5
    cache.advance([0, 1])
    assert cache.n_alloc_pages(1) == 1


def test_paged_write_then_attend_equals_dense():
    """Write tokens through the paged path, then paged attention must equal
    dense attention over the same logical KV, and the pools and the
    attention must equal the JAX package's."""
    jcfg, tcfg = jget("qwen3_0_6b"), tget("qwen3_0_6b")
    Hk, hd, L, H = tcfg.n_kv_heads, tcfg.hd, tcfg.n_layers, tcfg.n_heads
    B, page, npages, T = 3, 4, 16, 10
    rng = np.random.default_rng(0)
    ks = rng.standard_normal((T, L, B, Hk, hd)).astype(np.float32)
    vs = rng.standard_normal((T, L, B, Hk, hd)).astype(np.float32)
    active = np.ones((T, B), bool)
    active[6:, 2] = False  # slot 2 stops at 6 tokens; its writes go to page 0
    jc = jkv.PagedKVCache(jcfg, n_pages=npages, page_size=page, max_batch=B)
    tc = tkv.PagedKVCache(tcfg, n_pages=npages, page_size=page, max_batch=B, device=CPU)
    for t in range(T):
        for b in range(B):
            if active[t, b]:
                jc.ensure_capacity(b, t + 1)
                tc.ensure_capacity(b, t + 1)
        jc.write_token((jnp.asarray(ks[t]), jnp.asarray(vs[t])), active=active[t])
        tc.write_token((torch.from_numpy(ks[t]), torch.from_numpy(vs[t])), active=active[t])
    # page 0 takes the inactive writes (which one lands is left open): skip it
    np.testing.assert_array_equal(tc.k_pages[:, 1:].numpy(), np.asarray(jc.k_pages[:, 1:]))
    np.testing.assert_array_equal(tc.v_pages[:, 1:].numpy(), np.asarray(jc.v_pages[:, 1:]))
    tpt, tlen = tc.walk_page_tables(max_pages=4)
    jpt, jlen = jc.walk_page_tables(max_pages=4)
    q = rng.standard_normal((B, H, hd)).astype(np.float32)
    for layer in range(L):
        o_paged = tpaged(torch.from_numpy(q), tc.k_pages[layer], tc.v_pages[layer], tpt, tlen)
        o_jax = jpaged(jnp.asarray(q), jc.k_pages[layer], jc.v_pages[layer], jpt, jlen,
                       use_pallas=False)
        np.testing.assert_allclose(o_paged.numpy(), np.asarray(o_jax), atol=2e-5, rtol=2e-5)
        for b in range(B):
            n = int(tlen[b])
            kd = torch.from_numpy(ks[:n, layer, b]).permute(1, 0, 2)[None]  # (1, Hk, n, hd)
            vd = torch.from_numpy(vs[:n, layer, b]).permute(1, 0, 2)[None]
            o_dense = mha_reference(torch.from_numpy(q[b])[None, :, None], kd, vd,
                                    causal=False)[0, :, 0]
            torch.testing.assert_close(o_paged[b], o_dense, atol=2e-5, rtol=2e-5)
