"""The coded slice against the JAX package: gradient coding (Draco) on
the training loops of ``paper-100m-smoke``, weights from JAX, the
parallel regime (every agent's batch is agent 0's).

* one synchronous coded step (n = 8, r = 4, f = 1, large_value: the
  Byzantine row sits in group 0 with three honest copies);
* an async run with ``coded_fallback_r = 4`` on a trace whose quorum is
  met on rows 0-1 and missed on rows 2-3: the port computes the coded
  aggregate only on the missed rows, JAX computes both and selects with
  ``jnp.where``;
* one elastic coded step at bucket 6, whose group table (0, 0, 0, 0, 1,
  1) is ragged;
* one int8 coded step: the coded path takes the fake-quantized stack.

Bars: the loss within 1e-5, the aggregate, the parameters and the
in-flight buffer within 1e-4 (the slice bars of
``test_torch_helpers``); the int8 step as the compressed slice is held
(ROADMAP.md P14: a code can move by one step between the frameworks).
"""
import numpy as np

import repro.simulator as JS
import repro_torch.simulator as TS
import test_torch_helpers as H

R = 4


def crash_sims():
    """Stragglers and crash / recover at quorum 6: rows 0-1 meet the
    quorum (6 arrive), rows 2-3 miss it (5 and 3 arrive)."""
    return tuple(mod.SimConfig(
        faults=(mod.Straggler("lognormal", 0.8),
                mod.CrashRecover(rate=0.2, mean_down=2.0)),
        quorum=6, max_staleness=3, seed=0) for mod in (JS, TS))


def assert_step(o, msg, buffers=False):
    jl, tl, ja, ta, jpar, tpar = o[:6]
    np.testing.assert_allclose(tl, jl, rtol=H.LOGIT_TOL, atol=H.LOGIT_TOL,
                               err_msg=msg)
    np.testing.assert_allclose(ta, ja, rtol=H.GRAD_TOL, atol=H.GRAD_TOL,
                               err_msg=msg)
    np.testing.assert_allclose(tpar, jpar, rtol=H.GRAD_TOL, atol=H.GRAD_TOL,
                               err_msg=msg)
    if buffers:
        np.testing.assert_allclose(o[7], o[6], rtol=H.GRAD_TOL,
                                   atol=H.GRAD_TOL, err_msg=msg)


def test_coded_sync_step_matches_jax():
    out = H.run_slice("trimmed_mean", 0.0, steps=1, attack="large_value",
                      f=1, draco_r=R)
    assert_step(out[0], "coded sync step")


def test_coded_fallback_matches_jax_select():
    sims = crash_sims()
    tr = TS.plan_arrivals(sims[1], H.N, 4)
    assert tr.quorum_met.tolist() == [True, True, False, False]
    out = H.run_async("trimmed_mean", 0.0, steps=4, attack="large_value",
                      f=1, fallback_r=R, sims=sims)
    for step, o in enumerate(out):
        assert_step(o, f"coded fallback row {step}", buffers=True)


def test_elastic_coded_step_at_a_ragged_bucket():
    out = H.run_async("trimmed_mean", 0.0, trace="churn", steps=1,
                      attack="large_value", draco_r=R)
    assert_step(out[0], "elastic coded step, bucket 6", buffers=True)


def test_int8_coded_step():
    """The fake-quantized stack: the codes of the two frameworks can move
    by one step where x / scale sits on a rounding boundary (P14), so the
    aggregate and the parameters are held within 1e-4 on all but
    ``AGG_SHARE['int8']`` of the coordinates, the loss within 1e-5."""
    out = H.run_slice("trimmed_mean", 0.0, steps=1, attack="large_value",
                      f=1, draco_r=R, agg_dtype="int8")
    jl, tl, ja, ta, jpar, tpar = out[0]
    np.testing.assert_allclose(tl, jl, rtol=H.LOGIT_TOL, atol=H.LOGIT_TOL)
    for name, ours, ref in (("aggregate", ta, ja), ("params", tpar, jpar)):
        off = ~np.isclose(ours, ref, rtol=H.GRAD_TOL, atol=H.GRAD_TOL)
        assert off.sum() <= H.AGG_SHARE["int8"] * ours.size, (
            name, int(off.sum()))
