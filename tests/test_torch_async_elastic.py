"""The async slice on the elastic bucket path: the elastic trimmed_mean
(f=frac(0.25), n=elastic(8, (4, 6, 8))) over rows 4-7 of the
Churn(rate=0.25, mean_out=2.0) trace (live 6, 7, 4, 3: buckets 6, 8, 4
and 4, with a ghost row in the 8 and the last 4), the port's bucket steps
against the JAX package's (bars as in test_torch_async); then
coordinate_median and krum on the same bucket path."""
import pytest

from test_torch_helpers import check_async


@pytest.mark.parametrize("alpha", [0.0, 0.9])
def test_async_bucket_step_matches_jax(alpha):
    check_async("trimmed_mean", alpha=alpha, trace="churn")


@pytest.mark.parametrize("rule", ["coordinate_median", "krum"])
def test_async_bucket_step_matches_jax_other_rules(rule):
    check_async(rule, alpha=0.0, trace="churn")
