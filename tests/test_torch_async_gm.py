"""The geometric-median family (geometric_median, rfa, median_of_means)
on the port's async step against the JAX async step: one step each under
the straggler profile (n = 8, quorum 6), the impute-then-scale law
around 32 Weiszfeld iterations.  The bars as in
``test_torch_slice_rules15``; the in-flight buffer within 1e-4."""
import pytest

import test_torch_helpers as H
from test_torch_slice_rules15 import check_step, rule_pair

RULES = ["geometric_median", "rfa", "median_of_means"]


@pytest.mark.parametrize("rule", RULES)
def test_async_step_matches_jax(rule):
    out = H.run_async(rule, 0.0, steps=1,
                      specs=lambda trace: rule_pair(rule))
    check_step(out[0], rule, f"{rule} async", buffers=True)
