"""The port's fault simulator against the JAX package's (both numpy).

One seed must give identical arrays: the fault trace (``alive``,
``drop``, ``delay``, ``adj``, ``roster``) of every fault and membership
spec and of their compositions, the arrival trace (``contrib``,
``staleness``, ``refresh``, ``vclock``, ``quorum_met``, ``roster``) and
its ``summary()``, the staleness weights and the planned arrivals of a
``SimConfig``.  The bar is exact equality.
"""
import numpy as np
import pytest

import repro.simulator as J
import repro_torch.simulator as T

N, H = 8, 24


def spec_cases(mod):
    """Named fault schedules, built from ``mod`` (either package)."""
    return {
        "straggler_lognormal": (mod.Straggler("lognormal", 0.8),),
        "straggler_exp": (mod.Straggler("exp", 1.5, prob=0.5),),
        "straggler_pareto": (mod.Straggler("pareto", 2.0, agents=(1, 5)),),
        "straggler_constant": (mod.Straggler("constant", 3.0,
                                             agents=(0,)),),
        "crash_recover": (mod.CrashRecover(rate=0.2, mean_down=2.0),),
        "permanent_crash": (mod.PermanentCrash(agents=(2, 6), at=5),),
        "message_drop": (mod.MessageDrop(p=0.3),),
        "join": (mod.Join(agents=(6, 7), at=4),),
        "rejoin": (mod.Rejoin(agents=(1,), leave_at=3, rejoin_at=9),),
        "churn": (mod.Churn(rate=0.25, mean_out=2.0),),
        "sampling_uniform": (mod.SamplingPolicy(m=5),),
        "sampling_staleness": (mod.Straggler("exp", 1.0),
                               mod.SamplingPolicy(m=4, policy="staleness",
                                                  round_len=3)),
        "sampling_contribution": (mod.MessageDrop(p=0.4),
                                  mod.SamplingPolicy(m=6,
                                                     policy="contribution",
                                                     temperature=0.5)),
        "partition": (mod.Partition(groups=((0, 1, 2), (3, 4)), start=2,
                                    end=10),),
        "everything": (mod.Straggler("lognormal", 0.5),
                       mod.CrashRecover(rate=0.1),
                       mod.MessageDrop(p=0.1),
                       mod.Join(agents=(7,), at=3),
                       mod.Churn(rate=0.1, mean_out=3.0),
                       mod.Partition(groups=((0, 1),))),
    }


CASES = sorted(spec_cases(J))


def _assert_same(a, b):
    if a is None or b is None:
        assert a is None and b is None
    else:
        np.testing.assert_array_equal(a, b)
        assert a.dtype == b.dtype


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("seed", [0, 7])
def test_fault_trace_is_identical(case, seed):
    jt = J.compile_schedule(spec_cases(J)[case], N, H, seed=seed)
    tt = T.compile_schedule(spec_cases(T)[case], N, H, seed=seed)
    for field in ("alive", "drop", "delay", "adj", "roster"):
        _assert_same(getattr(tt, field), getattr(jt, field))
    assert tt.is_trivial() == jt.is_trivial()
    assert [tt.n_live(v) for v in range(H)] == [jt.n_live(v)
                                                for v in range(H)]


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("quorum,max_staleness", [(None, None), (5, 2),
                                                  (6, None)])
def test_async_trace_and_summary_are_identical(case, quorum, max_staleness):
    steps = H - 1
    ja = J.simulate_arrivals(J.compile_schedule(spec_cases(J)[case], N, H,
                                                seed=3), steps, quorum,
                             max_staleness)
    ta = T.simulate_arrivals(T.compile_schedule(spec_cases(T)[case], N, H,
                                                seed=3), steps, quorum,
                             max_staleness)
    for field in ("contrib", "staleness", "refresh", "vclock",
                  "quorum_met", "roster"):
        _assert_same(getattr(ta, field), getattr(ja, field))
    assert ta.summary() == ja.summary()
    assert ta.is_synchronous() == ja.is_synchronous()


@pytest.mark.parametrize("weighting", ["none", "poly", "exp"])
def test_plan_arrivals_and_staleness_weights_are_identical(weighting):
    kw = dict(quorum=6, max_staleness=3, seed=0, staleness_weighting=weighting,
              staleness_power=1.5, staleness_gamma=0.6)
    jsim = J.SimConfig(faults=(J.Straggler("lognormal", 0.8),
                               J.Churn(rate=0.1)), **kw)
    tsim = T.SimConfig(faults=(T.Straggler("lognormal", 0.8),
                               T.Churn(rate=0.1)), **kw)
    ja, ta = J.plan_arrivals(jsim, N, 12), T.plan_arrivals(tsim, N, 12)
    np.testing.assert_array_equal(ta.contrib, ja.contrib)
    np.testing.assert_array_equal(ta.staleness, ja.staleness)
    jw, tw = J.staleness_weights(jsim, ja), T.staleness_weights(tsim, ta)
    assert tw.dtype == jw.dtype == np.float32
    np.testing.assert_array_equal(tw, jw)


def test_the_straggler_profile_of_the_chip_smoke():
    """The trace chip_smoke.py's async phase relies on: 6 deliveries in
    each of the first 6 steps, max staleness 0, 1, 2, 1, 2, 1, weights in
    {1, 1/2, 1/3}; and the churn trace's live counts 8, 6, 4, 6, 6, 7, 4,
    3 (step 0 pure)."""
    sim = T.SimConfig(faults=(T.Straggler("lognormal", 0.8),), quorum=6,
                      max_staleness=3, seed=0)
    t = T.plan_arrivals(sim, N, 6)
    assert t.contrib.sum(1).tolist() == [6] * 6
    assert t.staleness.max(1).tolist() == [0, 1, 2, 1, 2, 1]
    w = T.staleness_weights(sim, t)
    assert set(np.unique(w[w > 0]).tolist()) <= {1.0, 0.5,
                                                 np.float32(1 / 3)}
    churn = T.plan_arrivals(T.SimConfig(faults=(T.Churn(rate=0.25,
                                                        mean_out=2.0),),
                                        seed=0), N, 8)
    assert churn.roster.sum(1).tolist() == [8, 6, 4, 6, 6, 7, 4, 3]


def test_poisson_arrival_times_are_identical():
    for rate, horizon, mx in ((2.0, 10.0, None), (0.5, 40.0, 7),
                              (0.0, 5.0, None)):
        np.testing.assert_array_equal(
            T.poisson_arrival_times(rate, horizon, seed=4, max_events=mx),
            J.poisson_arrival_times(rate, horizon, seed=4, max_events=mx))
