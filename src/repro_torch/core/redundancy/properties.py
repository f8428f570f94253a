"""Executable redundancy theory (counterpart of
``repro.core.redundancy.properties``; survey §3.2, solvability).

2f-redundancy (Gupta & Vaidya, Def. 1) and (2f, eps)-redundancy (Liu et
al., Def. 2) are properties of the agents' cost functions.  They are
checkable here for quadratic costs Q_i(x) = 1/2 (x - x_i*)^T H_i (x -
x_i*) with H_i PSD, whose subset aggregate has the single argmin (sum_S
H_i)^-1 (sum_S H_i x_i*), so the Hausdorff distance between argmin sets
is the euclidean distance (the general finite-set Hausdorff distance is
:func:`hausdorff_distance`, appendix A.1).  Small host arithmetic: torch
on the CPU for the distances, numpy for the linear solves, as in the JAX
package."""
from __future__ import annotations

import itertools

import numpy as np
import torch


def hausdorff_distance(X, Y):
    """Finite point sets X: (a, d), Y: (b, d) -> a 0-dim tensor (survey
    appendix A.1)."""
    X = torch.atleast_2d(torch.as_tensor(X))
    Y = torch.atleast_2d(torch.as_tensor(Y))
    d = torch.sqrt(torch.clamp_min(
        torch.sum(torch.square(X[:, None] - Y[None]), dim=-1), 0.0))
    return torch.maximum(torch.max(torch.min(d, dim=1).values),
                         torch.max(torch.min(d, dim=0).values))


def quadratic_argmin(Hs, xstars, subset=None):
    """argmin_x sum_{i in subset} 1/2 (x - x_i*)^T H_i (x - x_i*)."""
    Hs, xstars = np.asarray(Hs), np.asarray(xstars)
    idx = np.asarray(subset) if subset is not None else np.arange(len(Hs))
    H = Hs[idx].sum(0)
    rhs = np.einsum("ijk,ik->j", Hs[idx], xstars[idx])
    return np.linalg.solve(H, rhs)


def _subsets(n, size, limit):
    combos = itertools.combinations(range(n), size)
    out = list(itertools.islice(combos, limit + 1))
    if len(out) > limit:
        # a deterministic subsample keeps the check tractable
        rng = np.random.default_rng(0)
        all_combos = list(itertools.combinations(range(n), size))
        pick = rng.choice(len(all_combos), size=limit, replace=False)
        out = [all_combos[i] for i in sorted(pick)]
    return out


def check_2f_redundancy(Hs, xstars, f: int, tol: float = 1e-6,
                        max_subsets: int = 2000):
    """Def. 1: every subset of size >= n - 2f has the argmin of the full
    set.  Returns (holds, worst violation)."""
    n = len(Hs)
    full = quadratic_argmin(Hs, xstars)
    worst = 0.0
    for size in range(n - 2 * f, n + 1):
        for S in _subsets(n, size, max_subsets):
            x = quadratic_argmin(Hs, xstars, S)
            worst = max(worst, float(np.linalg.norm(x - full)))
    return worst <= tol, worst


def check_2f_eps_redundancy(Hs, xstars, f: int, max_subsets: int = 2000):
    """Def. 2: the smallest eps for which (2f, eps)-redundancy holds, the
    largest argmin distance over pairs S (|S| = n - f) containing Shat
    (|Shat| >= n - 2f)."""
    n = len(Hs)
    eps = 0.0
    for S in _subsets(n, n - f, max_subsets):
        xS = quadratic_argmin(Hs, xstars, S)
        inner_budget = max(max_subsets // max(len(S), 1), 50)
        for size in range(n - 2 * f, n - f + 1):
            if size > len(S):
                continue
            for Shat in _subsets(len(S), size, inner_budget):
                sub = [S[j] for j in Shat]
                xh = quadratic_argmin(Hs, xstars, sub)
                eps = max(eps, float(np.linalg.norm(xS - xh)))
    return eps


def make_redundant_quadratics(n: int, d: int, eps: float = 0.0,
                              seed: int = 0):
    """n quadratic agents sharing a common minimizer (exact 2f-redundancy),
    each minimizer moved by radius eps ((2f, O(eps))-redundancy)."""
    rng = np.random.default_rng(seed)
    common = rng.normal(size=(d,))
    Hs, xs = [], []
    for _ in range(n):
        A = rng.normal(size=(d, d))
        Hs.append(A @ A.T + np.eye(d))
        delta = rng.normal(size=(d,))
        delta = eps * delta / max(np.linalg.norm(delta), 1e-12)
        xs.append(common + delta)
    return np.stack(Hs), np.stack(xs), common
