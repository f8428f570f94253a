"""The async slice: the port's bounded-staleness async step against the
JAX package's ``make_async_step`` (jitted, impl="pallas") on
paper-100m-smoke (fp32, n=8, f=2, sign_flip), raw gradients, over 4 steps
of the straggler trace (quorum 6, max staleness 3), both started from the
same nonzero in-flight buffer.  Losses, aggregates, post-step parameters
and the buffer are held to the slice-1 bars (test_torch_helpers: loss
1e-5, the rest 1e-4); both steps are built with telemetry on, and their
selection weights are held to each other step by step.  With worker
momentum: test_torch_async_momentum; the elastic bucket path:
test_torch_async_elastic; the loop: test_torch_async_loop."""
import pytest

from test_torch_helpers import check_async


@pytest.mark.parametrize("rule", ["trimmed_mean", "coordinate_median",
                                  "krum"])
def test_async_step_matches_jax(rule):
    check_async(rule, alpha=0.0, telemetry=True)
