"""Port parity: ``repro_torch.core.scheduler`` (the paper's m:n pipeline
simulator and its area and power fits) against the JAX package's, equal
on a small grid of pipelines, latencies and loads."""

import dataclasses
import itertools

import pytest

from repro.core import scheduler as jsched
from repro_torch.core import scheduler as tsched

GRID = list(itertools.product((1, 2, 4), (1, 3, 4), (50.0, 321.5), (100.0, 877.0)))


@pytest.mark.parametrize("m,n,t_c,t_d", GRID)
def test_simulate_equals_the_reference(m, n, t_c, t_d):
    for kw in (dict(iters_per_request=3, num_requests=17),
               dict(iters_per_request=1, num_requests=0),
               dict(iters_per_request=5, num_requests=40, concurrency=3, network_ns=100.0,
                    scheduler_ns=2.0)):
        got = tsched.simulate(m, n, t_c, t_d, **kw)
        want = jsched.simulate(m, n, t_c, t_d, **kw)
        assert dataclasses.astuple(got) == dataclasses.astuple(want)
        if m == n:
            got = tsched.simulate(m, n, t_c, t_d, coupled=True, **kw)
            want = jsched.simulate(m, n, t_c, t_d, coupled=True, **kw)
            assert dataclasses.astuple(got) == dataclasses.astuple(want)
    assert tsched.staggered_start_times(m, n, t_d) == jsched.staggered_start_times(m, n, t_d)


def test_area_and_power_fits_equal_the_reference():
    for cores in range(1, 9):
        assert tsched.area_coupled(cores) == jsched.area_coupled(cores)
    for m, n in itertools.product(range(1, 6), range(1, 6)):
        assert tsched.area_pulse(m, n) == jsched.area_pulse(m, n)
    tp, jp = tsched.PowerModel(), jsched.PowerModel()
    assert dataclasses.astuple(tp) == dataclasses.astuple(jp)
    for m, n, lu, mu in itertools.product((1, 4), (2, 3), (0.0, 0.37, 1.0), (0.0, 0.81)):
        assert tp.pulse_power_w(m, n, lu, mu) == jp.pulse_power_w(m, n, lu, mu)
        assert tp.pulse_asic_power_w(m, n, lu, mu) == jp.pulse_asic_power_w(m, n, lu, mu)
    for c in range(0, 19):
        assert tp.cpu_power_w(c) == jp.cpu_power_w(c)
        assert tp.arm_power_w(c % 9) == jp.arm_power_w(c % 9)
    assert tsched.PipelineParams(1.0, 2.0) == tsched.PipelineParams(t_c_ns=1.0, t_d_ns=2.0)
    assert (dataclasses.astuple(tsched.PipelineParams(1.0, 2.0))
            == dataclasses.astuple(jsched.PipelineParams(1.0, 2.0)))
