"""The slice test: the port's synchronous robust train step against the
JAX package's ``make_train_step`` on paper-100m-smoke (fp32, n=8, f=2,
sign_flip), raw gradients, for the three kernel rules.  Loss, aggregate
and post-step parameters are held after 1, 2 and 3 steps (bars in
test_torch_helpers: loss 1e-5, aggregate and params 1e-4)."""
import pytest

from test_torch_helpers import check_slice


@pytest.mark.parametrize("rule", ["trimmed_mean", "coordinate_median",
                                  "krum"])
def test_step_matches_jax(rule):
    check_slice(rule, alpha=0.0)
