"""The slice test for the selection family, part 1: the port's
synchronous robust train step against the JAX package's
``make_train_step`` (impl="pallas") on paper-100m-smoke (fp32, n=8, f=2,
sign_flip, raw gradients) for cge, multi_krum and m_krum at their
registered defaults.  Loss, aggregate and post-step parameters are held
after 1, 2 and 3 steps (bars in test_torch_helpers: loss 1e-5, aggregate
and params 1e-4).  mda and bulyan are in test_torch_slice_mda_bulyan.py,
so that each file stays short under ``--dist loadfile``."""
import pytest

from test_torch_helpers import check_slice


@pytest.mark.parametrize("rule", ["cge", "multi_krum", "m_krum"])
def test_step_matches_jax(rule):
    check_slice(rule, alpha=0.0)
