"""The resilience estimators against the JAX package (n = 10, f = 2, d =
32, 24 trials, on the CPU).

JAX's per-trial draws, ``jax.random.normal(k1, (n, d))`` over the keys of
its ``_trial_keys``, are handed to the port's per-trial cores by value.
JAX's own trial bodies (``_alpha_trials`` / ``_delta_trials``) run
unjitted: jit adds nothing to the values but a compile per rule and
attack.  Bars: the per-trial values within ROADMAP.md's fp32 bar ``TOL``
(relative, and absolute at magnitude 1); alpha and c reduced from them
within 1e-5 relative.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import resilience as JR
from repro.core.aggregators import make_spec as jax_make_spec
from repro.core.attacks import make_byzantine_mask as jax_byz_mask
from repro.core.redundancy.properties import make_redundant_quadratics
from repro_torch.core import resilience as TR
from repro_torch.core.aggregators import make_spec
from repro_torch.core.attacks import get_attack, make_byzantine_mask

torch.set_num_threads(2)
TOL = 3e-6
N, F, D, TRIALS, SIGMA, RHO = 10, 2, 32, 24, 0.2, 1.0
RULES = ("krum", "coordinate_median", "bulyan", "geometric_median", "mean")
ATTACKS = ("sign_flip", "alie", "ipm", "large_value")


def draws(k1s):
    return [torch.from_numpy(np.array(jax.random.normal(k, (N, D))))
            for k in k1s]


def specs(rule):
    return jax_make_spec(rule, f=F), make_spec(rule, f=F)


def g_true():
    return (jnp.ones((D,)) / jnp.sqrt(D),
            torch.ones((D,)) / torch.sqrt(torch.tensor(float(D))))


@pytest.mark.parametrize("attack", ATTACKS)
@pytest.mark.parametrize("rule", RULES)
def test_alpha_trials_match_jax(rule, attack):
    jspec, tspec = specs(rule)
    jg, tg = g_true()
    np.testing.assert_array_equal(tg.numpy(), np.asarray(jg))
    k1s, k2s, _ = JR._trial_keys(jax.random.PRNGKey(0), TRIALS)
    ref = np.asarray(JR._alpha_trials.__wrapped__(
        jspec, attack, (), k1s, k2s, jax_byz_mask(N, F), jg, N, D, SIGMA),
        np.float64)
    ours = TR._alpha_trials(tspec, get_attack(attack), draws(k1s),
                            make_byzantine_mask(N, F), tg, SIGMA)
    assert ours.dtype == np.float64 and ours.shape == (TRIALS,)
    np.testing.assert_allclose(ours, ref, rtol=TOL, atol=TOL)
    # JAX's reduction (repro.core.resilience.estimate_alpha_f)
    e_dot = float(np.mean(ref))
    sin_alpha = min(max(1.0 - e_dot / float(jg @ jg), 0.0), 1.0)
    alpha, ok = TR._alpha_from_dots(ours, float(tg @ tg))
    np.testing.assert_allclose(
        alpha, float(np.degrees(np.arcsin(sin_alpha))), rtol=1e-5)
    assert ok == (e_dot > 0.0)


@pytest.mark.parametrize("rule", RULES)
def test_delta_trials_match_jax(rule):
    """The four attacks in turn, the key running on across them as in
    JAX's estimate_delta_c; c is the worst attack's."""
    jspec, tspec = specs(rule)
    key = jax.random.PRNGKey(0)
    worst = ours_worst = 0.0
    for attack in ATTACKS:
        k1s, k2s, key = JR._trial_keys(key, TRIALS)
        ref = np.asarray(JR._delta_trials.__wrapped__(
            jspec, attack, k1s, k2s, jax_byz_mask(N, F), N, D, F, RHO),
            np.float64)
        ours = TR._delta_trials(tspec, get_attack(attack), draws(k1s),
                                make_byzantine_mask(N, F), D, F, RHO)
        np.testing.assert_allclose(ours, ref, rtol=TOL, atol=TOL,
                                   err_msg=attack)
        # JAX's reduction (repro.core.resilience.estimate_delta_c)
        worst = max(worst, float(np.mean(ref) / max(F / N * RHO ** 2,
                                                    1e-12)))
        ours_worst = max(ours_worst, TR._c_from_errs(ours, F / N, RHO))
    np.testing.assert_allclose(ours_worst, worst, rtol=1e-5)


def test_estimators_hold_the_jax_tests_claims_on_the_cpu():
    """JAX's tests/test_resilience.py, with the port's own draws."""
    for name in ("krum", "coordinate_median", "geometric_median", "bulyan"):
        alpha, ok = TR.estimate_alpha_f(name, n=N, f=F, trials=TRIALS,
                                        device="cpu")
        assert ok and 0.0 <= alpha < 90.0, (name, alpha)
    _, ok = TR.estimate_alpha_f("mean", n=N, f=F, trials=TRIALS,
                                attack="sign_flip",
                                attack_hyper={"scale": 8.0}, device="cpu")
    assert not ok
    c_med = TR.estimate_delta_c("coordinate_median", n=N, f=F, trials=TRIALS,
                                device="cpu")
    c_mean = TR.estimate_delta_c("mean", n=N, f=F, trials=TRIALS,
                                 attacks=("large_value",), device="cpu")
    assert c_mean > 1e3 * c_med


def test_estimators_take_a_spec_and_an_impl():
    """A built spec equals its name; impl= reaches make_spec, and the
    kernel impl's plain versions agree with the gather law here."""
    a = TR.estimate_alpha_f(make_spec("krum", f=F), n=N, f=F, trials=8,
                            device="cpu")
    assert a == TR.estimate_alpha_f("krum", n=N, f=F, trials=8, device="cpu")
    k, g = (TR.estimate_alpha_f("coordinate_median", n=N, f=F, trials=8,
                                device="cpu", impl=impl)
            for impl in ("kernel", "gather"))
    np.testing.assert_allclose(k[0], g[0], rtol=1e-5)
    c = [TR.estimate_delta_c("krum", n=N, f=F, trials=8, device="cpu",
                             impl=impl) for impl in ("kernel", "gather")]
    np.testing.assert_allclose(c[0], c[1], rtol=1e-5)


def test_as_spec_errors_match_jax():
    for jspec, tspec, hyper in (
            (jax_make_spec("krum", f=1), make_spec("krum", f=1), {}),
            (jax_make_spec("krum", f=F), make_spec("krum", f=F),
             {"beta": 0.1})):
        with pytest.raises(ValueError) as jerr:
            JR._as_spec(jspec, F, hyper)
        with pytest.raises(ValueError) as terr:
            TR._as_spec(tspec, F, hyper)
        assert str(terr.value) == str(jerr.value)


def test_measure_f_eps_equals_jax():
    Hs, xs, common = make_redundant_quadratics(8, 4, eps=0.3, seed=2)
    honest = list(range(2, 8))
    for out in (common, common + 0.5, np.zeros(4)):
        ref = JR.measure_f_eps(jnp.asarray(out, jnp.float32), Hs, xs, honest)
        assert TR.measure_f_eps(torch.tensor(out, dtype=torch.float32), Hs,
                                xs, honest) == ref
