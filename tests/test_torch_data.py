"""Port parity: the synthetic data pipeline (``repro_torch.data.pipeline``)
against the JAX package's, bit for bit: the counter hash, ``tokens_for``
over hosts, seeds and steps, ``pack_documents``' assignments and waste, and
``DataIterator``'s batches (int32 tensors on the asked device, the labels
shifted), its extras and its exact resume."""

import numpy as np
import pytest
import torch

from repro.data import pipeline as jpipe
from repro_torch.data import pipeline as tpipe


@pytest.mark.parametrize("n", [0, 1, 2**20 + 7, 2**40 + 3, 2**63 + 12345])
def test_hash_matches_jax(n):
    x = np.arange(n, n + 257, dtype=np.uint64)
    np.testing.assert_array_equal(tpipe._hash_u32(x), jpipe._hash_u32(x))


@pytest.mark.parametrize("vocab,seq,batch,hosts,seed", [
    (1000, 16, 8, 1, 0), (1000, 16, 8, 2, 0), (151936, 512, 8, 1, 3), (50280, 33, 6, 3, 7)])
def test_tokens_for_matches_jax(vocab, seq, batch, hosts, seed):
    for host in range(hosts):
        kw = dict(vocab=vocab, seq_len=seq, global_batch=batch, num_hosts=hosts, host_id=host,
                  seed=seed)
        for step in (0, 1, 5, 123_456):
            got = tpipe.tokens_for(tpipe.DataConfig(**kw), step)
            want = jpipe.tokens_for(jpipe.DataConfig(**kw), step)
            assert got.dtype == want.dtype == np.int32
            np.testing.assert_array_equal(got, want)
            assert got.min() >= 1 and got.max() <= vocab - 2


def test_tokens_for_refuses_a_batch_the_hosts_do_not_divide():
    with pytest.raises(ValueError, match="divide"):
        tpipe.tokens_for(tpipe.DataConfig(vocab=100, seq_len=4, global_batch=5, num_hosts=2), 0)


@pytest.mark.parametrize("seq_len", [64, 1024])
def test_pack_documents_matches_jax(seq_len):
    lens = np.random.default_rng(seq_len).integers(1, 2 * seq_len, 300)
    got, got_waste = tpipe.pack_documents(lens, seq_len)
    want, want_waste = jpipe.pack_documents(lens, seq_len)
    np.testing.assert_array_equal(got, want)
    assert got_waste == want_waste


def _cfgs(**kw):
    kw = dict(vocab=1000, seq_len=16, global_batch=4) | kw
    return tpipe.DataConfig(**kw), jpipe.DataConfig(**kw)


def test_iterator_batches_match_jax_and_resume_exactly():
    tcfg, jcfg = _cfgs(seed=2)
    extras = {"patches": lambda step, b: np.full((b, 3, 2), step, np.float32)}
    tit = tpipe.DataIterator(tcfg, extras=dict(extras), device="cpu")
    jit_ = jpipe.DataIterator(jcfg, extras=dict(extras))
    for _ in range(4):
        tb, jb = next(tit), next(jit_)
        assert set(tb) == set(jb) == {"tokens", "labels", "patches"}
        for k in tb:
            assert isinstance(tb[k], torch.Tensor) and tb[k].device.type == "cpu"
            np.testing.assert_array_equal(tb[k].numpy(), np.asarray(jb[k]))
        assert tb["tokens"].dtype == tb["labels"].dtype == torch.int32
        np.testing.assert_array_equal(tb["labels"].numpy(), np.roll(tb["tokens"].numpy(), -1, 1))
    snap = tit.state_dict()
    assert snap == jit_.state_dict() == {"step": 4}
    want = [next(tit)["tokens"].numpy() for _ in range(3)]
    resumed = tpipe.DataIterator(tcfg, device="cpu")
    resumed.load_state_dict(snap)
    for w in want:
        np.testing.assert_array_equal(next(resumed)["tokens"].numpy(), w)


def test_iterator_start_step_and_default_device():
    tcfg, jcfg = _cfgs()
    it = tpipe.DataIterator(tcfg, start_step=7, device="cpu")
    np.testing.assert_array_equal(next(it)["tokens"].numpy(), jpipe.tokens_for(jcfg, 7))
    assert tpipe.DataIterator(tcfg).device == torch.device("cuda")  # the card unless asked
