"""Resilience notations as measurement harnesses — survey §3.5
(counterpart of ``repro.core.resilience``).

(f, eps)-resilience [68]: deterministic-algorithm output within eps of the
true (honest-aggregate) minimum — measured directly on quadratic systems.

(alpha, f)-Byzantine resilience [6]: a property of an aggregation rule under
iid vectors — estimated by Monte Carlo: (i) E<V, g> >= (1 - sin(alpha)) ||g||^2
and a bounded-moments condition.

(delta_max, c)-robust aggregator [60]: E||V - mean(honest)||^2 <= c*delta*rho^2
— the constant c is estimated empirically over attacks.

Both Monte-Carlo estimators take either a registered aggregator name or an
:class:`~repro_torch.core.aggregators.AggregatorSpec`.  Where JAX vmaps the
trials, the port loops over them: each trial is one (n, d) stack through
``spec.aggregate`` (on the card, the rule's kernels).  The noise of a trial
is an (n, d) standard normal draw from a ``torch.Generator`` seeded with
``seed``; the per-trial cores (:func:`_alpha_trials`, :func:`_delta_trials`)
take the draws by value, so a caller can hand them any stream.  alpha and
c are reduced in float64 numpy from the per-trial values, as in JAX."""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.aggregators import AggregatorSpec, make_spec
from repro_torch.core.attacks import get_attack, make_byzantine_mask
from repro_torch.core.redundancy.properties import quadratic_argmin
from repro_torch.device import make_generator, resolve_device


def measure_f_eps(output, Hs, xstars, honest_idx):
    """dist(output, argmin sum_{i in H} Q_i) — eq. (29)."""
    true_min = quadratic_argmin(np.asarray(Hs), np.asarray(xstars),
                                honest_idx)
    if isinstance(output, torch.Tensor):
        output = output.detach().cpu().numpy()
    return float(np.linalg.norm(np.asarray(output) - true_min))


def _as_spec(name_or_spec, f: int, hyper: dict) -> AggregatorSpec:
    if isinstance(name_or_spec, AggregatorSpec):
        spec = name_or_spec
        # the trial harness corrupts f rows and splits honest rows at f —
        # a spec built for a different f would measure a configuration
        # nobody asked for
        if spec.f != f:
            raise ValueError(
                f"spec {spec.describe()} was built for f={spec.f} but the "
                f"estimator was called with f={f}")
        if hyper:
            raise ValueError(
                "pass hyper-parameters when BUILDING the spec, not to the "
                f"estimator (got {sorted(hyper)})")
        return spec
    return make_spec(name_or_spec, f=f, **hyper)


def _noise(gen, trials: int, n: int, d: int):
    """The trials' (n, d) standard normal draws, one at a time."""
    for _ in range(trials):
        yield torch.randn((n, d), generator=gen, device=gen.device)


def _alpha_trials(spec, attack_fn, noises, mask, g_true, sigma, gen=None):
    """<V, g> of each trial, V the aggregate of g + sigma * noise after the
    attack -> (trials,) float64 numpy."""
    dots = []
    for z in noises:
        G = attack_fn(gen, g_true[None, :] + sigma * z, mask)
        dots.append(spec.aggregate(G) @ g_true)
    return torch.stack(dots).cpu().numpy().astype(np.float64)


def _alpha_from_dots(dots, gg: float):
    """(alpha_hat_deg, ok) from the per-trial <V, g> and ||g||^2."""
    e_dot = float(np.mean(dots))
    ratio = e_dot / gg
    sin_alpha = min(max(1.0 - ratio, 0.0), 1.0)
    alpha = float(np.degrees(np.arcsin(sin_alpha)))
    return alpha, e_dot > 0.0


def estimate_alpha_f(filter_name, n: int, f: int, d: int = 32,
                     trials: int = 64, sigma: float = 0.2,
                     attack: str = "sign_flip", attack_hyper: dict = None,
                     seed: int = 0, device=None, **hyper):
    """Monte-Carlo estimate of the angle alpha of (alpha, f)-resilience:
    returns (alpha_hat_deg, ok) where ok = E<V,g> > 0 for all trials'
    average.  alpha_hat from  E<V, g> = (1 - sin alpha) ||g||^2.

    ``filter_name`` may be a registered name or an AggregatorSpec.  Runs
    on ``device`` (None: the card; raises without CUDA unless the caller
    passes ``device="cpu"``)."""
    dev = resolve_device(device)
    spec = _as_spec(filter_name, f, hyper)
    g_true = torch.ones((d,), device=dev) / torch.sqrt(
        torch.tensor(float(d), device=dev))
    mask = make_byzantine_mask(n, f, device=dev)
    gen = make_generator(seed, dev)
    dots = _alpha_trials(spec, get_attack(attack, **(attack_hyper or {})),
                         _noise(gen, trials, n, d), mask, g_true, sigma, gen)
    return _alpha_from_dots(dots, float(g_true @ g_true))


def _delta_trials(spec, attack_fn, noises, mask, d, f, rho, gen=None):
    """||V - mean(honest)||^2 of each trial, the honest rows scaled to
    pairwise E||V_i - V_j||^2 = rho^2 -> (trials,) float64 numpy."""
    errs = []
    for z in noises:
        G = z * float(rho / np.sqrt(2.0)) / float(np.sqrt(d))
        v = spec.aggregate(attack_fn(gen, G, mask))
        errs.append(torch.sum(torch.square(v - torch.mean(G[f:], dim=0))))
    return torch.stack(errs).cpu().numpy().astype(np.float64)


def _c_from_errs(errs, delta: float, rho: float) -> float:
    """c_hat of one attack from its per-trial ||V - mean(honest)||^2."""
    return float(np.mean(errs) / max(delta * rho ** 2, 1e-12))


def estimate_delta_c(filter_name, n: int, f: int, d: int = 32,
                     trials: int = 64, rho: float = 1.0,
                     attacks=("sign_flip", "alie", "ipm", "large_value"),
                     seed: int = 0, device=None, **hyper):
    """Estimate the constant c of a (delta_max, c)-robust aggregator:
    c_hat = max over attacks of  E||V - mean_honest||^2 / (delta * rho^2),
    delta = f/n.  Honest vectors: iid with pairwise E||V_i - V_j||^2 = rho^2
    (i.e. per-vector variance rho^2/2).

    ``filter_name`` may be a registered name or an AggregatorSpec; one
    generator seeded with ``seed`` runs on through the attacks.  Runs on
    ``device`` as :func:`estimate_alpha_f` does."""
    dev = resolve_device(device)
    spec = _as_spec(filter_name, f, hyper)
    mask = make_byzantine_mask(n, f, device=dev)
    gen = make_generator(seed, dev)
    worst = 0.0
    for attack in attacks:
        errs = _delta_trials(spec, get_attack(attack),
                             _noise(gen, trials, n, d), mask, d, f, rho, gen)
        worst = max(worst, _c_from_errs(errs, f / n, rho))
    return worst
