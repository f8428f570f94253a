"""The slice test with worker momentum (alpha = 0.2): the agents send the
fp32 momentum, so the arena the kernels read is fp32 (bars as in
test_torch_slice)."""
import pytest

from test_torch_helpers import check_slice


@pytest.mark.parametrize("rule", ["trimmed_mean", "coordinate_median",
                                  "krum"])
def test_step_with_momentum_matches_jax(rule):
    check_slice(rule, alpha=0.2)
