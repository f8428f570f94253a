"""The async slice with worker momentum (alpha = 0.9): only the
dispatching agents advance their momentum, and the buffer holds the sent
momentum (bars as in test_torch_async)."""
import pytest

from test_torch_helpers import check_async


@pytest.mark.parametrize("rule", ["trimmed_mean", "coordinate_median",
                                  "krum"])
def test_async_step_with_momentum_matches_jax(rule):
    check_async(rule, alpha=0.9)
