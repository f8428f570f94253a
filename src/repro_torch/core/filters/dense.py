"""Gradient filters on dense stacks ``g: (n, d)`` — the gather path.

Counterpart of ``repro.core.filters.dense`` for the rules ported so far
(mean, coordinate_median, trimmed_mean, krum, multi_krum, m_krum, mda,
cge, bulyan, sign_sgd, sparse_mean) and their helpers.
Uniform signature ``filter(g, f, **hyper) -> (d,)``.  These are the
paper-faithful dense laws, ``impl="gather"`` of the spec engine, and the
oracle the kernel path is held against.
"""
from __future__ import annotations

import math

import torch

FILTERS: dict = {}


def register(name):
    def deco(fn):
        FILTERS[name] = fn
        return fn
    return deco


# ---------------------------------------------------------------------------
# helpers


def _pair_dot(a, b):
    """<a, b> of two (d,) rows, rounded to fp32: the elementwise fp32
    product (a fresh contiguous tensor) summed in fp64.  The result
    depends only on the two rows' values, never on where they sit in the
    stack, so bitwise-equal rows get bitwise-equal entries on any device
    (a library matrix product need not: ROADMAP.md P12)."""
    return torch.sum(a * b, dtype=torch.float64).float()


def pairwise_sq_dists(g):
    """(n, d) -> (n, n) squared euclidean distances (Gram form),
    d2_ij = G_ii + G_jj - 2 G_ij with each Gram entry one fixed-order dot
    per pair (:func:`_pair_dot`).  The diagonal is exactly zero, the
    matrix is bitwise symmetric (the iterative selections' pair tie needs
    d2(i, j) == d2(j, i)), and bitwise-equal rows (the f identical rows
    of sign_flip) have bitwise-equal distances to every other row, so an
    exact Krum tie between them is broken by index, as the kernel path
    breaks it."""
    n = g.shape[0]
    gram = torch.empty((n, n), dtype=torch.float32, device=g.device)
    for i in range(n):
        for j in range(i, n):
            gram[i, j] = gram[j, i] = _pair_dot(g[i], g[j])
    sq = torch.diagonal(gram)
    d2 = torch.triu(torch.clamp_min(sq[:, None] + sq[None, :] - 2.0 * gram,
                                    0.0), 1)
    return d2 + d2.T


def krum_scores(d2, f, mask=None, k=None):
    """Krum score s(i) = sum of the distances to the k closest others
    (k defaults to the classic n - f - 2, clamped to [1, n - 1]).

    ``mask``: (n,) bool — unavailable agents get +inf distance and +inf
    score (the iterative selections of m-Krum and Bulyan).  Iterative
    callers shrink ``k`` with the remaining candidate count, or every
    score collapses to inf and the pick falls back to index order."""
    n = d2.shape[0]
    eye = torch.eye(n, dtype=torch.bool, device=d2.device)
    d2 = d2.masked_fill(eye, math.inf)                       # exclude self
    if mask is not None:
        d2 = d2.masked_fill(~mask[None, :], math.inf)
    k = (n - f - 2) if k is None else int(k)
    k = max(min(k, n - 1), 1)
    smallest, _ = torch.topk(d2, k, dim=-1, largest=False)
    scores = torch.sum(smallest, dim=-1)
    if mask is not None:
        scores = scores.masked_fill(~mask, math.inf)
    return scores


def masked_row_sums(d2, mask):
    """Full-degree score: the sum of a candidate's distances to ALL
    remaining candidates (+inf for removed rows) — the tie-break secondary
    of the iterative selections."""
    n = d2.shape[0]
    off = ~torch.eye(n, dtype=torch.bool, device=d2.device)
    s = torch.sum(torch.where(mask[None, :] & off, d2,
                              torch.zeros((), device=d2.device)), dim=-1)
    return s.masked_fill(~mask, math.inf)


def _ascending(values, k):
    """Indices of the k smallest values, ties by first index (the order
    of ``jax.lax.top_k(-values, k)``)."""
    return torch.sort(values, stable=True)[1][:k]


def _take_row(g, i):
    """Row ``i`` (a 0-dim index tensor) of g, without a host sync."""
    return g.index_select(0, i.reshape(1))[0]


def argmin_tiebreak(primary, secondary):
    """Index of the minimum of ``primary``, EXACT ties broken by
    ``secondary`` (then by first index)."""
    tied = primary == torch.min(primary)
    return torch.argmin(torch.where(tied, secondary,
                                    torch.full_like(secondary, math.inf)))


def nan_sign(x):
    """``jnp.sign``'s law: -1, 0 or +1, and NaN for a NaN (``torch.sign``
    gives 0 for a NaN, which would let a NaN row vote 0 instead of
    poisoning its column)."""
    return torch.where(torch.isnan(x), x, torch.sign(x))


# ---------------------------------------------------------------------------
# rules


@register("mean")
def mean(g, f=0):
    """No defence (Blanchard et al.: cannot tolerate one Byzantine agent)."""
    return torch.mean(g, dim=0)


@register("krum")
def krum(g, f):
    s = krum_scores(pairwise_sq_dists(g), f)
    return g[torch.argmin(s)]


@register("coordinate_median")
def coordinate_median(g, f=0):
    """``jnp.median`` law: (s[(n-1)//2] + s[n//2]) * 0.5 of the sorted
    column, NaN wherever the column holds a NaN."""
    n = g.shape[0]
    s, _ = torch.sort(g, dim=0)
    med = (s[(n - 1) // 2] + s[n // 2]) * 0.5
    return torch.where(torch.isnan(g).any(dim=0),
                       torch.full_like(med, math.nan), med)


@register("trimmed_mean")
def trimmed_mean(g, f, beta: float | None = None):
    """Drop the smallest/largest beta-fraction per coordinate (beta
    defaults to f/n)."""
    n = g.shape[0]
    b = int(math.ceil((beta if beta is not None else f / n) * n)) if n else 0
    b = min(b, (n - 1) // 2)
    s, _ = torch.sort(g, dim=0)
    kept = s[b:n - b] if b else s
    return torch.mean(kept, dim=0)


@register("multi_krum")
def multi_krum(g, f, m: int = 2):
    """Average of the m smallest-score vectors (one score pass)."""
    s = krum_scores(pairwise_sq_dists(g), f)
    return torch.mean(g[_ascending(s, m)], dim=0)


@register("m_krum")
def m_krum(g, f, m: int = 2):
    """Iterative Krum: scores recomputed after each removal, the
    neighbour count shrinking with the remaining candidate set."""
    n = g.shape[0]
    d2 = pairwise_sq_dists(g)
    mask = torch.ones((n,), dtype=torch.bool, device=g.device)
    rows = torch.arange(n, device=g.device)
    acc = torch.zeros_like(g[0])
    for it in range(m):
        s = krum_scores(d2, f, mask=mask, k=max(n - it - f - 2, 1))
        i = argmin_tiebreak(s, masked_row_sums(d2, mask))
        mask = mask & (rows != i)
        acc = acc + _take_row(g, i)
    return acc / m


@register("mda")
def mda(g, f):
    """Minimum-diameter averaging: the mean of the (n-f)-subset with the
    smallest diameter, equal diameters broken by the subset perimeter."""
    from repro_torch.core.aggregators import mda_combos   # lazy: no cycle
    n = g.shape[0]
    combos = torch.as_tensor(mda_combos(n, f), device=g.device)
    d2 = pairwise_sq_dists(g)
    sub = d2[combos[:, :, None], combos[:, None, :]]      # (C, n-f, n-f)
    diam = torch.amax(sub, dim=(1, 2))
    best = _take_row(combos, argmin_tiebreak(diam, torch.sum(sub,
                                                             dim=(1, 2))))
    return torch.mean(g[best], dim=0)


@register("cge")
def cge(g, f, normalize: bool = True):
    """Comparative gradient elimination: keep the n-f smallest-norm
    vectors; the raw sum (normalize=False) or their average."""
    n = g.shape[0]
    norms = torch.linalg.vector_norm(g, dim=-1)
    out = torch.sum(g[_ascending(norms, n - f)], dim=0)
    return out / (n - f) if normalize else out


@register("bulyan")
def bulyan(g, f, base: str = "krum"):
    """Bulyan: (1) select theta = n-2f vectors by iterating ``base``,
    (2) per coordinate, average the beta = max(theta-2f, 1) values closest
    to the median of the selected set."""
    n = g.shape[0]
    theta = n - 2 * f
    if theta < 1:
        raise ValueError("Bulyan needs n > 2f (and n >= 4f+3 for its "
                         "guarantees)")
    base_fn = FILTERS[base]
    d2 = pairwise_sq_dists(g) if base == "krum" else None
    rows = torch.arange(n, device=g.device)
    mask = torch.ones((n,), dtype=torch.bool, device=g.device)
    for it in range(theta):
        if base == "krum":
            s = krum_scores(d2, f, mask=mask, k=max(n - it - f - 2, 1))
            i = argmin_tiebreak(s, masked_row_sums(d2, mask))
        else:
            # the generic base runs on the available rows, the removed
            # ones replaced by the available rows' mean
            avail_mean = (torch.sum(torch.where(mask[:, None], g, 0.0),
                                    dim=0)
                          / torch.clamp_min(torch.sum(mask), 1))
            out = base_fn(torch.where(mask[:, None], g, avail_mean[None]), f)
            d = torch.sum(torch.square(g - out[None]), dim=-1)
            i = torch.argmin(d.masked_fill(~mask, math.inf))
        mask = mask & (rows != i)
    sel = ~mask
    beta = max(theta - 2 * f, 1)
    med = _masked_median(g, sel)
    dist = torch.where(sel[:, None], torch.abs(g - med[None]),
                       torch.full((), math.inf, device=g.device))
    idx = torch.sort(dist, dim=0, stable=True)[1][:beta]   # (beta, d)
    return torch.mean(torch.gather(g, 0, idx), dim=0)


@register("sign_sgd")
def sign_sgd(g, f=0):
    """signSGD with majority vote: each agent sends sign(g_i), the server
    returns the per-coordinate sign of the vote.  The fp32 sum of +-1 / 0
    is exact (n < 2^24), so every impl gives the same bits; the output is
    bounded to [-1, 1] per coordinate; a NaN value makes its column NaN,
    as in the JAX law."""
    return nan_sign(torch.sum(nan_sign(g).float(), dim=0))


@register("sparse_mean")
def sparse_mean(g, f=0):
    """Sparse / dropout-aware mean: a zero coordinate means NOT SENT, so
    each coordinate averages only the rows that carry it, agg_c = sum_i
    [g_ic != 0] g_ic / sum_i [g_ic != 0], with an explicit 0 where nobody
    sent the coordinate.  Per-agent weights (staleness discounts) enter
    through the spec engine's weighted path; this dense oracle is the
    unit-weight case."""
    sent = (g != 0).float()
    den = torch.sum(sent, dim=0)
    num = torch.sum(g.float() * sent, dim=0)
    pos = den > 0
    return torch.where(pos, num / torch.where(pos, den, 1.0), 0.0)


def _masked_median(g, mask):
    """Median over the rows where ``mask`` is True (unselected rows sort
    last as +inf)."""
    cnt = torch.sum(mask)
    padded = torch.where(mask[:, None], g,
                         torch.full((), math.inf, device=g.device))
    s, _ = torch.sort(padded, dim=0)
    lo = torch.div(cnt - 1, 2, rounding_mode="floor")
    hi = torch.div(cnt, 2, rounding_mode="floor")
    return 0.5 * (_take_row(s, lo) + _take_row(s, hi))
