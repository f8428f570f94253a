"""The closest-to-center rules and cgc on the port's async step against
the JAX async step: one step each under the straggler profile (n = 8,
quorum 6: six deliveries, staleness up to 2), so each runs its masked
law (phocas and mean_around_median the arrived-window law, cgc the
impute-then-scale law).  The bars and the flip budget as in
``test_torch_slice_rules15``; the in-flight buffer within 1e-4."""
import pytest

import test_torch_helpers as H
from test_torch_slice_rules15 import check_step, rule_pair

RULES = ["phocas", "mean_around_median", "cgc"]


@pytest.mark.parametrize("rule", RULES)
def test_async_step_matches_jax(rule):
    out = H.run_async(rule, 0.0, steps=1,
                      specs=lambda trace: rule_pair(rule))
    check_step(out[0], rule, f"{rule} async", buffers=True)
