"""The compressed exchange on the synchronous step, int8: the port's
``make_train_step`` with ``ByzantineConfig(agg_dtype="int8")`` against the
JAX package's (impl="pallas") on paper-100m-smoke (fp32, n = 8, f = 2,
sign_flip), for the three rules with a scaled kernel (K18 median and
trimmed mean, K15 sign_sgd on the codes) and krum (the engine-level
dequantization, then K2 -> K3 -> K4).  Quantization moves a few codes
between the frameworks (ROADMAP.md P14), so each step starts from the JAX
side's state (``test_torch_helpers.check_quantized``).

Then the float exchange: ``agg_dtype="bfloat16"`` casts the arena and the
aggregate unravels to bf16 leaves (the port of the bf16 case of
``tests/test_train_e2e.py::test_perf_variants_still_converge``).  The
cast is a rounding too: 4 of the 1,443,072 aggregate coordinates of the
first step sit where an ulp of the fp32 gradient moves the bf16 value
(by up to 3.2e-4, P14).  So each of the 3 steps starts from the JAX
side's state and is held at the slice-1 bars (loss 1e-5, aggregate and
parameters 1e-4) on all but 1e-5 of the coordinates."""
import numpy as np
import pytest

from test_torch_helpers import (GRAD_TOL, LOGIT_TOL, check_quantized,
                                run_slice)

RULES = ["coordinate_median", "trimmed_mean", "sign_sgd", "krum"]


@pytest.mark.parametrize("rule", RULES)
def test_int8_sync_step_matches_jax(rule):
    check_quantized(rule, "int8")


def test_bfloat16_exchange_step_matches_jax():
    for step, (jl, tl, ja, ta, jpar, tpar) in enumerate(
            run_slice("trimmed_mean", 0.0, agg_dtype="bfloat16",
                      resync=True)):
        msg = f"bfloat16 exchange step {step}"
        np.testing.assert_allclose(tl, jl, rtol=LOGIT_TOL, atol=LOGIT_TOL,
                                   err_msg=msg)
        for name, ours, ref in (("aggregate", ta, ja),
                                ("params", tpar, jpar)):
            off = ~np.isclose(ours, ref, rtol=GRAD_TOL, atol=GRAD_TOL)
            assert off.sum() <= 1e-5 * ours.size, (msg, name,
                                                    int(off.sum()))
