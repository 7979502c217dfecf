"""Port parity on the verifier's fuzz finding: ``fuzz_498861496``.

``tests/test_verify.py::test_hypothesis_accepted_programs_run_clean`` draws,
at seed 3,318,527,983, the program ``LOADN r1 <- NODE[1]; JNE r1, r1 -> 3;
MOVI r1 <- -1; NEXT_ITER r1``: the JAX verifier accepts it, and all four
lanes FAULT on ``NEXT_ITER`` of -1 (the fall-through, since ``r1 == r1``).
Drawn here the same way (that file's ``_random_program`` on
``default_rng(3318527983)``), it goes through both packages'
``analyze_program`` and both engines (``execute_batched``, four lanes on
that file's ``_compatible_arena``, ``max_iters`` 6): the verdicts, the
diagnostics, each lane's status, iteration count, pointer and scratch are
equal."""

import numpy as np
import pytest

from repro.core import isa as jisa
from repro.core import iterator as jiter
from repro.core import verify as jverify
from repro_torch.core import arena as tarena
from repro_torch.core import isa as tisa
from repro_torch.core import iterator as titer
from repro_torch.core import verify as tverify

from test_verify import _compatible_arena, _random_program  # noqa: E402

SEED, NAME = 3318527983, "fuzz_498861496"
CODE = [[jisa.LOADN, 1, 0, 1], [jisa.JNE, 1, 1, 3], [jisa.MOVI, 1, 0, -1],
        [jisa.NEXT_ITER, 1, 0, 0]]


@pytest.fixture(scope="module")
def prog():
    """The program as the fuzz property draws it (the draws until its name)."""
    rng = np.random.default_rng(SEED)
    for _ in range(120):  # the property's max_tries
        p = _random_program(rng)
        if p.name == NAME:
            return p
    pytest.fail(f"{NAME} not drawn from default_rng({SEED})")


def test_fuzz_498861496_is_the_roadmaps_program(prog):
    assert np.asarray(prog.code).tolist() == CODE
    assert (prog.scratch_words, prog.node_words) == (3, 4)


def test_both_verifiers_accept_it_alike(prog):
    tprog = tisa.Program(np.asarray(prog.code), prog.scratch_words, prog.node_words, prog.name)
    jfacts, jdiags = jverify.analyze_program(prog)
    tfacts, tdiags = tverify.analyze_program(tprog)
    assert jdiags == [] and tdiags == []
    assert jfacts is not None and tfacts is not None
    assert tfacts.mutates == jfacts.mutates is False


def test_both_engines_fault_every_lane_alike(prog):
    tprog = tisa.Program(np.asarray(prog.code), prog.scratch_words, prog.node_words, prog.name)
    jar = _compatible_arena()
    tar = tarena.arena_from_numpy(*(np.asarray(getattr(jar, f)) for f in
                                    ("data", "bounds", "perms", "heap")), device="cpu")
    ptr0 = np.asarray([0, 5, 11, 23], np.int32)
    scr0 = np.zeros((4, prog.scratch_words), np.int32)
    jout = jiter.execute_batched(jisa.as_pulse_iterator(prog), jar, ptr0, scr0, max_iters=6)
    tout = titer.execute_batched(tisa.as_pulse_iterator(tprog), tar, ptr0, scr0, max_iters=6)
    for what, j, t in zip(("ptr", "scratch", "status", "iters"), jout, tout):
        np.testing.assert_array_equal(t.numpy(), np.asarray(j), err_msg=what)
    assert (tout[2].numpy() == titer.STATUS_FAULT).all()
    assert titer.STATUS_FAULT == jiter.STATUS_FAULT
