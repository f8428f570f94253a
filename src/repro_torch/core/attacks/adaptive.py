"""Defense-aware (adaptive) Byzantine attacks (counterpart of
``repro.core.attacks.adaptive``).

A static attack perturbs blindly; an adaptive one is built against the
:class:`~repro_torch.core.aggregators.AggregatorSpec` it faces (the rule,
f, its trim / selection hyper and the wrapper chain) and tunes its
perturbation to that rule:

``spec_alie``
    ALIE with the z-score calibrated from the spec's trim window at build
    time (trimmed_mean), or bisected against the defense itself (the
    other rules): the largest z whose poison ``mu - z sd`` still survives.
``min_max``
    Bisects the largest deviation along the reversed honest mean that
    still survives ``spec.aggregate``: the attack runs the defense inside
    its own forward pass.
``slow_drift``
    Stateful: a direction-locked bias ramped slowly across rounds, each
    round inside the honest spread; only a defense with memory sees it.

Protocol: ``attack(gen, g, byz_mask, state, defense_vec=None) -> (g',
state')`` with ``g`` the (n, P) fp32 arena, ``byz_mask`` (n,) bool (True
= Byzantine), ``state`` from ``attack.init_state(device)`` and
``defense_vec`` the defense's carried center (its ``server_grad``) when
the defense is stateful: the omniscient, state-aware threat model.
Honest rows are bitwise untouched.

The bisections keep ``lo`` and ``hi`` on the device and pick each
round's bounds with ``torch.where``, so a round needs no host sync.  The
probe runs the defense's math on the ``gather`` impl (the rule's law, not
its kernels) over all n rows.  ``slow_drift`` draws its sign pattern from
an explicit generator seeded with ``seed`` (JAX's Rademacher bits cannot
be reproduced); ``signs=`` takes the pattern itself, which is how a test
feeds both packages the same one.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from repro_torch.core.aggregators import trim_count
from repro_torch.core.attacks.gradient import honest_moments
from repro_torch.device import make_generator
from repro_torch.kernels.ref import fma_f32

ADAPTIVE_ATTACKS: dict = {}


def register_adaptive(name):
    def deco(factory):
        ADAPTIVE_ATTACKS[name] = factory
        return factory
    return deco


def is_adaptive_attack(attack) -> bool:
    """True iff ``attack`` names (or is) a defense-aware attack."""
    if isinstance(attack, DefenseAwareAttack):
        return True
    return isinstance(attack, str) and attack in ADAPTIVE_ATTACKS


@dataclasses.dataclass(frozen=True)
class DefenseAwareAttack:
    """An attack built against one spec.  Under elastic membership each
    bucket's step rebuilds it against the bucket's spec, so the
    calibration tracks the defense's live (n, f) window."""
    name: str
    spec: object                       # the AggregatorSpec being attacked
    apply_fn: Callable = dataclasses.field(repr=False, compare=False,
                                           default=None)
    init_state_fn: Callable = dataclasses.field(repr=False, compare=False,
                                                default=None)

    def init_state(self, device="cpu"):
        """The initial attack state ({} for a stateless attack)."""
        return self.init_state_fn(device) if self.init_state_fn else {}

    def __call__(self, gen, g, byz_mask, state, defense_vec=None):
        return self.apply_fn(gen, g, byz_mask, state, defense_vec)


def make_adaptive_attack(name: str, spec, **hyper) -> DefenseAwareAttack:
    """Build the named defense-aware attack against ``spec``."""
    try:
        factory = ADAPTIVE_ATTACKS[name]
    except KeyError:
        raise KeyError(
            f"unknown adaptive attack {name!r}; registered: "
            f"{sorted(ADAPTIVE_ATTACKS)}") from None
    return factory(spec, **hyper)


# ---------------------------------------------------------------------------
# spec introspection (host side, build time)


def _executing_rule(spec):
    """The rule at the end of the wrapper chain: the one whose selection
    window a row-level perturbation must survive."""
    while getattr(spec, "inner", None) is not None:
        spec = spec.inner
    return spec


def _probe_spec(spec):
    """The spec that simulates the defense inside the attack: the same
    math on the dense ``gather`` impl through the whole chain (the rule's
    law, not its kernels), for any number of rows (the bucket spec of an
    elastic run probes the full in-flight arena, as in JAX)."""
    inner = _probe_spec(spec.inner) if spec.inner is not None else None
    return dataclasses.replace(spec, inner=inner, impl="gather", n=None)


def _probe_state(spec, center):
    """The defense state for probing a stateful spec: every stateful rule
    of the registry keeps its memory under ``server_grad``."""
    if not spec.stateful:
        return None
    st = {"server_grad": center}
    if spec.inner is not None and spec.inner.stateful:
        st["inner"] = _probe_state(spec.inner, center)
    return st


def _trim_count(rule) -> Optional[int]:
    """Per-side trim count of a trimmed_mean spec with a static n (None
    for any other rule)."""
    if rule.name != "trimmed_mean" or not rule.n:
        return None
    return trim_count(rule.n, rule.f, rule.hp("beta", None))


# ---------------------------------------------------------------------------
# the inverse normal CDF in fp32, operation for operation as JAX computes
# it (jax.scipy.special.ndtri, Cephes' piecewise rational approximation):
# each Horner step one fused multiply-add, as XLA's CPU compiles
# jnp.polyval

_P0 = (-5.99633501014107895267E1, 9.80010754185999661536E1,
       -5.66762857469070293439E1, 1.39312609387279679503E1,
       -1.23916583867381258016E0)
_Q0 = (1.0, 1.95448858338141759834E0, 4.67627912898881538453E0,
       8.63602421390890590575E1, -2.25462687854119370527E2,
       2.00260212380060660359E2, -8.20372256168333339912E1,
       1.59056225126211695515E1, -1.18331621121330003142E0)
_P1 = (4.05544892305962419923E0, 3.15251094599893866154E1,
       5.71628192246421288162E1, 4.40805073893200834700E1,
       1.46849561928858024014E1, 2.18663306850790267539E0,
       -1.40256079171354495875E-1, -3.50424626827848203418E-2,
       -8.57456785154685413611E-4)
_Q1 = (1.0, 1.57799883256466749731E1, 4.53907635128879210584E1,
       4.13172038254672030440E1, 1.50425385692907503408E1,
       2.50464946208309415979E0, -1.42182922854787788574E-1,
       -3.80806407691578277194E-2, -9.33259480895457427372E-4)
_P2 = (3.23774891776946035970E0, 6.91522889068984211695E0,
       3.93881025292474443415E0, 1.33303460815807542389E0,
       2.01485389549179081538E-1, 1.23716634817820021358E-2,
       3.01581553508235416007E-4, 2.65806974686737550832E-6,
       6.23974539184983293730E-9)
_Q2 = (1.0, 6.02427039364742014255E0, 3.67983563856160859403E0,
       1.37702099489081330271E0, 2.16236993594496635890E-1,
       1.34204006088543189037E-2, 3.28014464682127739104E-4,
       2.89247864745380683936E-6, 6.79019408009981274425E-9)


def _f32(x):
    return torch.tensor(x, dtype=torch.float32)


def _polyval(coeffs, x):
    y = torch.zeros((), dtype=torch.float32)
    for c in coeffs:
        y = fma_f32(y, x, _f32(c))
    return y


def ndtri_f32(p: float) -> float:
    """``jax.scipy.special.ndtri`` of a Python float, which JAX evaluates
    in float32.  Equal to JAX's bit for bit where p lies in (exp(-2), 1 -
    exp(-2)); below or above that, the tail branch takes a logarithm, and
    XLA's CPU logarithm is not correctly rounded (PyTorch's is), so the
    two can part by a few ulp there (ROADMAP.md P16)."""
    import numpy as np
    p = _f32(p)
    mcp = torch.where(p > _f32(-np.expm1(-2.0)), 1.0 - p, p)
    mcp = torch.where(mcp == 0.0, _f32(0.5), mcp)
    w = mcp - 0.5
    ww = w * w
    big = w + w * ww * (_polyval(_P0, ww) / _polyval(_Q0, ww))
    big = big * -_f32(np.sqrt(2.0 * np.pi))
    z = torch.sqrt(-2.0 * torch.log(mcp))
    first = z - torch.log(z) / z
    iz = 1.0 / z
    small = first - _polyval(_P2, iz) / _polyval(_Q2, iz) / z
    other = first - _polyval(_P1, iz) / _polyval(_Q1, iz) / z
    x = torch.where(mcp > _f32(np.exp(-2.0)), big,
                    torch.where(z >= 8.0, small, other))
    x = torch.where(p > _f32(1.0 - np.exp(-2.0)), x, -x)
    x = torch.where(p == 0.0, -torch.inf, torch.where(p == 1.0, torch.inf, x))
    return float(x)


def calibrate_alie_z(spec, margin: float = 0.25) -> float:
    """z-score tailored to ``spec``'s selection window: for trimmed_mean,
    ``mu - z sd`` with more than b (+ margin) honest rows expected below
    it, just inside the kept window; for the majority-selection rules the
    classical ALIE supporter count."""
    rule = _executing_rule(spec)
    n = rule.n or spec.n
    if not n:
        raise ValueError(
            "spec_alie needs a spec with static n (make_spec(..., n=...)) "
            "to calibrate its z-score")
    f = rule.f
    n_h = max(n - f, 1)
    b = _trim_count(rule)
    if b is not None:
        phi = min(max((b + margin) / n_h, 1e-3), 0.5)
        z = -ndtri_f32(phi)
    else:
        s = n // 2 + 1 - f
        phi = max((n_h - s) / n_h, 0.5 + 1e-3)
        z = ndtri_f32(min(phi, 1.0 - 1e-6))
    return max(z, 0.1)


def _plant(g, byz_mask, bad_row):
    """Byzantine rows replaced by ``bad_row``; honest rows bitwise kept."""
    return torch.where(byz_mask[:, None], bad_row[None, :].to(g.dtype), g)


def _norm(x):
    return torch.sqrt(torch.sum(x * x))


def _survives(shift, need):
    """One bisection decision: the aggregate moved along the attack
    direction by at least ``need`` (the share rho of a plain mean's
    shift), so the defense accepted the poison."""
    return shift >= need


def _bisect(survives, hi, iters, device):
    """The largest value in [0, hi] that ``survives``, by ``iters`` rounds
    of bisection with ``lo`` and ``hi`` kept on the device."""
    lo = torch.zeros((), dtype=torch.float32, device=device)
    hi = torch.full((), hi, dtype=torch.float32, device=device)
    for _ in range(iters):
        mid = 0.5 * (lo + hi)
        ok = survives(mid)
        lo, hi = torch.where(ok, mid, lo), torch.where(ok, hi, mid)
    return lo


def _setup(g, byz_mask, defense_vec, probe):
    """(fp32 rows, honest mean, honest std, Byzantine count, n as a
    device scalar, probe state) of one call."""
    g32 = g.float()
    mu, sd = honest_moments(g32, byz_mask)
    fb = torch.sum(byz_mask.float())
    n = torch.tensor(float(g.shape[0]), device=g.device)
    center = (defense_vec.float() if defense_vec is not None
              else torch.zeros_like(mu))
    return g32, mu, sd, fb, n, _probe_state(probe, center)


# ---------------------------------------------------------------------------
# the attacks


@register_adaptive("spec_alie")
def spec_alie(spec, margin: float = 0.25, z: Optional[float] = None,
              z_max: float = 4.0, iters: int = 14, rho: float = 0.5):
    """ALIE with z from the defense's window: trimmed_mean's analytically
    (:func:`calibrate_alie_z`), the other rules' by bisecting the largest
    z whose poison ``mu - z sd`` still survives the defense (the induced
    shift along ``-sd`` keeps at least ``rho`` of a plain mean's)."""
    rule = _executing_rule(spec)
    z_static = (float(z) if z is not None
                else calibrate_alie_z(spec, margin)
                if _trim_count(rule) is not None else None)
    probe = _probe_spec(spec) if z_static is None else None

    def apply(gen, g, byz_mask, state, defense_vec=None):
        if z_static is not None:
            mu, sd = honest_moments(g.float(), byz_mask)
            return _plant(g, byz_mask, mu - z_static * sd), state
        g32, mu, sd, fb, n, pst = _setup(g, byz_mask, defense_vec, probe)
        sn = torch.clamp_min(_norm(sd), 1e-12)
        p = -sd / sn

        def survives(zc):
            att = _plant(g32, byz_mask, mu - zc * sd)
            agg = probe.aggregate(att, state=pst).float()
            del att
            return _survives(torch.dot(agg - mu, p), rho * zc * sn * fb / n)

        lo = _bisect(survives, z_max, iters, g.device)
        return _plant(g, byz_mask, mu - lo * sd), state

    return DefenseAwareAttack(name="spec_alie", spec=spec, apply_fn=apply)


@register_adaptive("min_max")
def min_max(spec, lam_max: float = 10.0, iters: int = 14, rho: float = 0.5):
    """The largest reversed-mean deviation ``mu + lam |mu| p`` (p the unit
    reversed honest mean) surviving ``spec.aggregate``: the aggregate's
    shift along p keeps at least ``rho`` of the shift a plain mean would
    grant the f rows."""
    probe = _probe_spec(spec)

    def apply(gen, g, byz_mask, state, defense_vec=None):
        g32, mu, sd, fb, n, pst = _setup(g, byz_mask, defense_vec, probe)
        norm = torch.clamp_min(_norm(mu), 1e-12)
        p = -mu / norm

        def survives(lam):
            att = _plant(g32, byz_mask, mu + lam * norm * p)
            agg = probe.aggregate(att, state=pst).float()
            del att
            return _survives(torch.dot(agg - mu, p),
                             rho * lam * norm * fb / n)

        lo = _bisect(survives, lam_max, iters, g.device)
        return _plant(g, byz_mask, mu + lo * norm * p), state

    return DefenseAwareAttack(name="min_max", spec=spec, apply_fn=apply)


@register_adaptive("slow_drift")
def slow_drift(spec, z0: float = 0.3, rate: float = 0.02,
               z_cap: float = 1.5, seed: int = 7, signs=None):
    """Round t plants ``mu + z_t sd signs`` with ``z_t = min(z0 + rate t,
    z_cap)`` and one fixed sign pattern (drawn from a generator seeded
    with ``seed``, or ``signs`` itself), so the per-round bias
    accumulates instead of averaging out."""
    def init_state(device):
        return {"t": torch.zeros((), dtype=torch.float32, device=device)}

    def apply(gen, g, byz_mask, state, defense_vec=None):
        mu, sd = honest_moments(g.float(), byz_mask)
        sg = signs
        if sg is None:
            bits = torch.randint(0, 2, (g.shape[1],),
                                 generator=make_generator(seed, g.device),
                                 device=g.device)
            sg = bits.float() * 2.0 - 1.0
        z_t = torch.clamp_max(z0 + rate * state["t"], z_cap)
        out = _plant(g, byz_mask, mu + z_t * sd * sg.to(g.device))
        return out, {"t": state["t"] + 1.0}

    return DefenseAwareAttack(name="slow_drift", spec=spec, apply_fn=apply,
                              init_state_fn=init_state)


__all__ = ["ADAPTIVE_ATTACKS", "DefenseAwareAttack", "make_adaptive_attack",
           "is_adaptive_attack", "calibrate_alie_z", "register_adaptive"]
