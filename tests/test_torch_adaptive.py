"""The defense-aware attacks (``spec_alie``, ``min_max``, ``slow_drift``)
against the JAX package.

* ``calibrate_alie_z``: JAX evaluates ``ndtri`` in float32; the port
  computes it operation for operation, each Horner step one fused
  multiply-add, as XLA's CPU compiles ``jnp.polyval``.  Equal bit for bit
  where the probability lies in (exp(-2), 1 - exp(-2)); in the tails the
  rational approximation takes a logarithm, and XLA's CPU logarithm is
  not correctly rounded while PyTorch's is, so z may part by a few ulp
  there (ROADMAP.md P16): held within 1e-6 relative.  The exact half
  holds where the installed XLA fuses the Horner steps (checked first,
  on ``jnp.polyval`` itself); a build that does not is held within 1e-6
  relative everywhere.
* The bisections: each round's survive decision on both sides (JAX's
  ``fori_loop`` recorded round by round, the port's decisions through its
  ``_survives``).  Where every decision agrees, the final ``lo`` is equal
  exactly and the planted rows agree within fp32 rtol = atol = 3e-6 (the
  honest moments reassociate); where one differs, the round that flipped
  must have had a margin under 1e-6 relative (ROADMAP.md P15: a decision
  is discontinuous between frameworks).  Honest rows are bitwise
  untouched on both sides.
* ``slow_drift`` with JAX's Rademacher signs injected, over 3 rounds.
* A JAX law held in torch (``tests/test_attacks.py``
  ``test_centered_clip_holds_under_adaptive_attacks``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.aggregators import make_spec as jax_make_spec
from repro.core.attacks import calibrate_alie_z as jax_z
from repro.core.attacks import make_adaptive_attack as jax_attack
from repro.core.attacks import make_byzantine_mask as jax_byz
from repro_torch.core.aggregators import make_spec
from repro_torch.core.attacks import (ADAPTIVE_ATTACKS, calibrate_alie_z,
                                      is_adaptive_attack,
                                      make_adaptive_attack,
                                      make_byzantine_mask)
from repro_torch.core.attacks import adaptive as tad

torch.set_num_threads(2)
TOL = 3e-6
N, F, D = 8, 2, 96


def test_registry_and_names():
    assert sorted(ADAPTIVE_ATTACKS) == ["min_max", "slow_drift", "spec_alie"]
    assert is_adaptive_attack("min_max") and not is_adaptive_attack("alie")
    with pytest.raises(KeyError):
        make_adaptive_attack("nope", make_spec("mean"))


def _z_grid():
    for n in range(3, 33):
        for f in range(0, (n - 1) // 2 + 1, 2):
            for rule, betas in (("trimmed_mean", (None, 0.25)),
                                ("coordinate_median", (None,))):
                for beta in betas:
                    yield n, f, rule, beta


def jax_fuses_horner():
    """True iff this XLA build computes ``jnp.polyval`` as the port's
    fused Horner steps do, bit for bit, over a grid of ndtri's inputs."""
    x = np.linspace(0.01, 0.25, 4001, dtype=np.float32)
    for coeffs in (tad._P0, tad._Q0, tad._P1, tad._Q1):
        want = np.asarray(jnp.polyval(jnp.asarray(np.float32(coeffs)),
                                      jnp.asarray(x)))
        if not np.array_equal(tad._polyval(coeffs, torch.from_numpy(x))
                              .numpy(), want):
            return False
    return True


@pytest.mark.parametrize("margin", [0.0, 0.25, 1.0])
def test_calibrate_alie_z_matches_jax(margin):
    fused = jax_fuses_horner()
    tails = 0
    for n, f, rule, beta in _z_grid():
        kw = {} if beta is None else {"beta": beta}
        want = jax_z(jax_make_spec(rule, f=f, n=n, **kw), margin)
        got = calibrate_alie_z(make_spec(rule, f=f, n=n, **kw), margin)
        nh = max(n - f, 1)
        b = tad._trim_count(make_spec(rule, f=f, n=n, **kw))
        phi = (min(max((b + margin) / nh, 1e-3), 0.5) if b is not None
               else min(max((nh - (n // 2 + 1 - f)) / nh, 0.5 + 1e-3),
                        1.0 - 1e-6))
        if fused and np.exp(-2.0) < phi < 1.0 - np.exp(-2.0):
            assert got == want, (n, f, rule, beta, got, want)
        else:
            tails += got != want
            assert abs(got - want) <= 1e-6 * abs(want), (n, f, rule, beta)
    assert not fused or tails <= 40


def stack_np(seed, n=N, d=D):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(n, d)) * 0.5 + 1.0).astype(np.float32)


def run_jax(name, rule, g, center, monkeypatch, **hyper):
    """(attacked rows, final lo, decisions) of one JAX attack, eager, its
    bisection rounds recorded."""
    real = jax.lax.fori_loop
    rounds = []

    def recording(lower, upper, body, init):
        if not (isinstance(init, tuple) and len(init) == 2):
            return real(lower, upper, body, init)
        lohi = init
        for i in range(lower, upper):
            new = body(i, lohi)
            rounds.append(bool(new[1] == lohi[1]))      # hi kept: survived
            lohi = new
        rounds_lo.append(float(lohi[0]))
        return lohi

    rounds_lo = []
    monkeypatch.setattr(jax.lax, "fori_loop", recording)
    spec = jax_make_spec(rule, f=F, n=N, **hyper)
    atk = jax_attack(name, spec)
    out, _ = atk(jax.random.PRNGKey(0), jnp.asarray(g), jax_byz(N, F),
                 atk.init_state(),
                 None if center is None else jnp.asarray(center))
    monkeypatch.setattr(jax.lax, "fori_loop", real)
    return np.asarray(out), (rounds_lo[0] if rounds_lo else None), rounds


def run_port(name, rule, g, center, monkeypatch, **hyper):
    real_s, real_b = tad._survives, tad._bisect
    margins, los = [], []

    def survives(shift, need):
        margins.append((float(shift), float(need)))
        return real_s(shift, need)

    def bisect(*a, **k):
        lo = real_b(*a, **k)
        los.append(float(lo))
        return lo

    monkeypatch.setattr(tad, "_survives", survives)
    monkeypatch.setattr(tad, "_bisect", bisect)
    spec = make_spec(rule, f=F, n=N, **hyper)
    atk = make_adaptive_attack(name, spec)
    out, _ = atk(None, torch.from_numpy(g), make_byzantine_mask(N, F),
                 atk.init_state(),
                 None if center is None else torch.from_numpy(center))
    return out.numpy(), (los[0] if los else None), margins


CASES = [("spec_alie", "trimmed_mean", {}),
         ("spec_alie", "coordinate_median", {}),
         ("spec_alie", "centered_clip", {"tau": 0.5}),
         ("min_max", "trimmed_mean", {}),
         ("min_max", "coordinate_median", {}),
         ("min_max", "centered_clip", {"tau": 0.5})]


@pytest.mark.parametrize("name,rule,hyper", CASES)
@pytest.mark.parametrize("seed", [0, 1])
def test_bisections_match_jax(name, rule, hyper, seed, monkeypatch):
    g = stack_np(10 + seed)
    center = None
    if rule == "centered_clip":
        center = (g[F:].mean(0) * 0.9).astype(np.float32)
    jout, jlo, jdec = run_jax(name, rule, g, center, monkeypatch, **hyper)
    tout, tlo, tmargins = run_port(name, rule, g, center, monkeypatch,
                                   **hyper)
    np.testing.assert_array_equal(tout[F:], g[F:])      # honest rows
    np.testing.assert_array_equal(jout[F:], g[F:])
    if name == "spec_alie" and rule == "trimmed_mean":
        assert jlo is None and tlo is None              # calibrated z
    else:
        tdec = [s >= nd for s, nd in tmargins]
        assert len(tdec) == len(jdec) == 14
        if tdec != jdec:
            r = next(i for i, (a, b) in enumerate(zip(tdec, jdec)) if a != b)
            shift, need = tmargins[r]
            assert abs(shift - need) < 1e-6 * max(abs(need), 1e-30), (
                "a survive decision flipped with a margin above 1e-6", r,
                shift, need)
            return
        assert tlo == jlo, (tlo, jlo)
    np.testing.assert_allclose(tout[:F], jout[:F], rtol=TOL, atol=TOL)


def test_slow_drift_matches_jax_with_its_signs():
    g = stack_np(20)
    spec_j = jax_make_spec("trimmed_mean", f=F, n=N)
    signs = jax.random.rademacher(jax.random.PRNGKey(7), (D,), jnp.float32)
    ja = jax_attack("slow_drift", spec_j)
    ta = make_adaptive_attack("slow_drift", make_spec("trimmed_mean", f=F,
                                                      n=N),
                              signs=torch.from_numpy(np.array(signs)))
    jst, tst = ja.init_state(), ta.init_state("cpu")
    for t in range(3):
        gt = stack_np(21 + t)
        jout, jst = ja(jax.random.PRNGKey(t), jnp.asarray(gt),
                       jax_byz(N, F), jst)
        tout, tst = ta(None, torch.from_numpy(gt), make_byzantine_mask(N, F),
                       tst)
        np.testing.assert_array_equal(tout.numpy()[F:], gt[F:])
        np.testing.assert_allclose(tout.numpy(), np.asarray(jout), rtol=TOL,
                                   atol=TOL, err_msg=f"round {t}")
        assert float(tst["t"]) == float(jst["t"]) == t + 1.0


def test_slow_drift_draws_one_locked_pattern():
    """Without ``signs=`` the pattern comes from a generator seeded with
    ``seed``: the same every round, +-1 everywhere."""
    atk = make_adaptive_attack("slow_drift", make_spec("mean"), z0=0.5,
                               rate=0.0)
    g = torch.from_numpy(stack_np(30))
    byz = make_byzantine_mask(N, F)
    mu, sd = tad.honest_moments(g, byz)
    st = atk.init_state("cpu")
    pats = []
    for _ in range(3):
        out, st = atk(None, g, byz, st)
        pats.append(torch.sign(out[0] - mu))
    assert all(torch.equal(p, pats[0]) for p in pats)
    assert bool((pats[0].abs() == 1).all())


def test_centered_clip_holds_under_adaptive_attacks():
    """The JAX law (tests/test_attacks.py) in torch: centered_clip with the
    honest mean as its center keeps the attacked estimate within 2x of
    the clean one under all three attacks, while the undefended mean is
    dragged more than 5x further."""
    an, af = 12, 2
    ag = torch.from_numpy(np.asarray(
        jax.random.normal(jax.random.PRNGKey(3), (an, 32)) * 0.5 + 1.0))
    byz = make_byzantine_mask(an, af)
    hm = torch.sum(torch.where(byz[:, None], 0.0, ag), 0) / (an - af)
    spec = make_spec("centered_clip", f=af, n=an, tau=1.0)
    st = {"server_grad": hm}
    clean = float(torch.linalg.norm(spec.aggregate(ag, state=st) - hm))
    mean_spec = make_spec("mean", f=0, n=an)
    for name in ("spec_alie", "min_max", "slow_drift"):
        atk = make_adaptive_attack(name, spec)
        out, _ = atk(None, ag, byz, atk.init_state("cpu"), hm)
        dev = float(torch.linalg.norm(spec.aggregate(out, state=st) - hm))
        assert dev <= 2.0 * max(clean, 1e-3), (name, dev, clean)
        matk = make_adaptive_attack("min_max", mean_spec)
        out_mean, _ = matk(None, ag, byz, {})
        broken = float(torch.linalg.norm(mean_spec.aggregate(out_mean) - hm))
        assert broken > 5.0 * dev, (name, broken, dev)
