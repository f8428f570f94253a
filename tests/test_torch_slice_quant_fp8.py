"""The compressed exchange on the synchronous step, float8_e4m3fn: as
``test_torch_slice_quant.py`` with fp8 codes (the e4m3 cast of x / scale,
clipped to +-448), for coordinate_median, trimmed_mean, sign_sgd and
krum.  e4m3 moves more codes between the frameworks than int8 does
(ROADMAP.md P14), each by one code step."""
import pytest

from test_torch_helpers import check_quantized

RULES = ["coordinate_median", "trimmed_mean", "sign_sgd", "krum"]


@pytest.mark.parametrize("rule", RULES)
def test_fp8_sync_step_matches_jax(rule):
    check_quantized(rule, "float8_e4m3fn")
