"""The async slice for the selection family, part 1: the port's
bounded-staleness async step against the JAX package's
``make_async_step`` (jitted, impl="pallas") on paper-100m-smoke (fp32,
n=8, f=2, sign_flip), raw gradients, over 4 steps of the straggler trace
(quorum 6, max staleness 3: no step pure, so every step runs the masked
kernels K4 (imputed mean) -> K6 -> the selection -> K7 / K12), for cge,
multi_krum and m_krum at their registered defaults.  Losses, aggregates,
post-step parameters and the buffer are held to the slice-1 bars
(test_torch_helpers: loss 1e-5, the rest 1e-4).  mda and bulyan are in
test_torch_async_mda_bulyan.py, sign_sgd in test_torch_slice_sign.py, so
that each file stays short under ``--dist loadfile``."""
import pytest

from test_torch_helpers import check_async


@pytest.mark.parametrize("rule", ["cge", "multi_krum", "m_krum"])
def test_async_step_matches_jax(rule):
    check_async(rule, alpha=0.0)
