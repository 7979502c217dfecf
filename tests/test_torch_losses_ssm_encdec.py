"""Port parity: ``Model.loss`` and its gradient against the JAX package's
for the ssm (mamba2_780m), hybrid (zamba2_7b) and encdec
(whisper_large_v3) families at reduced size, on the port's init and on the
JAX init, and ``remat`` "dots" and "full" against "none" on the ssm and the
hybrid (Whisper is never rematerialised, as in the JAX package).  The
checks and their tolerances are ``test_torch_losses.py``'s."""

import pytest

from test_torch_losses import check_model_loss, check_remat  # noqa: E402

ARCHS = ["mamba2_780m", "zamba2_7b", "whisper_large_v3"]


@pytest.mark.parametrize("init", ["port", "jax"])
@pytest.mark.parametrize("arch", ARCHS)
def test_model_loss_and_grads_match_jax(arch, init):
    check_model_loss(arch, init)


@pytest.mark.parametrize("remat", ["dots", "full"])
@pytest.mark.parametrize("arch", ARCHS[:2])
def test_remat_gives_the_same_loss_and_grads(arch, remat):
    check_remat(arch, remat)
