"""Gradient filters on dense stacks ``g: (n, d)`` — the gather path.

Counterpart of ``repro.core.filters.dense``: every rule of the survey's
Table 2 (krum, multi_krum, m_krum, coordinate_median, trimmed_mean,
phocas, mean_around_median, geometric_median, median_of_means, mda,
cgc, cge, bulyan), the mean, zeno, rfa, sign_sgd and sparse_mean, their
helpers, and the parallel ensemble :func:`compose`.
Uniform signature ``filter(g, f, **hyper) -> (d,)``.  These are the
paper-faithful dense laws, ``impl="gather"`` of the spec engine, and the
oracle the kernel path is held against.
"""
from __future__ import annotations

import functools
import math

import torch

FILTERS: dict = {}


def register(name):
    def deco(fn):
        FILTERS[name] = fn
        return fn
    return deco


def get_filter(name: str, **hyper):
    fn = FILTERS[name]
    return functools.partial(fn, **hyper) if hyper else fn


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


def _top_k_order(values, k):
    """Indices of the k largest of the (n,) ``values`` in the order of
    ``jax.lax.top_k(values, k)``: descending in IEEE's total order, where a
    NaN with its sign bit clear lies above +inf and one with it set below
    -inf, equal values by the lower index."""
    nan = torch.isnan(values)
    cls = torch.where(nan, torch.where(torch.signbit(values), 0, 2), 1)
    by_value = torch.sort(values.masked_fill(nan, 0.0), descending=True,
                          stable=True).indices
    by_class = torch.sort(cls[by_value], descending=True, stable=True).indices
    return by_value[by_class][:k]


def _take_row(g, i):
    """Row ``i`` (a 0-dim index tensor) of g, without a host sync."""
    return g.index_select(0, i.reshape(1))[0]


def argmin_tiebreak(primary, secondary):
    """Index of the minimum of ``primary``, EXACT ties broken by
    ``secondary`` (then by first index)."""
    tied = primary == torch.min(primary)
    return torch.argmin(torch.where(tied, secondary,
                                    torch.full_like(secondary, math.inf)))


def iterated_krum_picks(d2, f, count):
    """The ``count`` shrinking-k iterative Krum picks on the distances
    ``d2`` (m-Krum, Bulyan's selection stage), in pick order: 0-dim index
    tensors.  The neighbour count shrinks with the remaining candidates,
    so every pick is a genuine Krum selection."""
    n = d2.shape[0]
    mask = torch.ones((n,), dtype=torch.bool, device=d2.device)
    rows = torch.arange(n, device=d2.device)
    picks = []
    for it in range(count):
        s = krum_scores(d2, f, mask=mask, k=max(n - it - f - 2, 1))
        i = argmin_tiebreak(s, masked_row_sums(d2, mask))
        mask = mask & (rows != i)
        picks.append(i)
    return picks


def mda_subset(d2, f):
    """MDA's chosen (n - f,) rows: the subset of least diameter, equal
    diameters broken by the subset perimeter, then enumeration order."""
    from repro_torch.core.aggregators import mda_combos   # lazy: no cycle
    combos = torch.as_tensor(mda_combos(d2.shape[0], f), device=d2.device)
    sub = d2[combos[:, :, None], combos[:, None, :]]      # (C, n-f, n-f)
    diam = torch.amax(sub, dim=(1, 2))
    return _take_row(combos, argmin_tiebreak(diam, torch.sum(sub,
                                                             dim=(1, 2))))


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
    acc = torch.zeros_like(g[0])
    for i in iterated_krum_picks(pairwise_sq_dists(g), f, m):
        acc = acc + _take_row(g, i)
    return acc / m


@register("mda")
def mda(g, f):
    """Minimum-diameter averaging: the mean of the (n-f)-subset with the
    smallest diameter, equal diameters broken by the subset perimeter."""
    return torch.mean(g[mda_subset(pairwise_sq_dists(g), f)], dim=0)


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
    rows = torch.arange(n, device=g.device)
    mask = torch.ones((n,), dtype=torch.bool, device=g.device)
    if base == "krum":
        for i in iterated_krum_picks(pairwise_sq_dists(g), f, theta):
            mask = mask & (rows != i)
    else:
        for _ in range(theta):
            # the generic base runs on the available rows, the removed
            # ones replaced by the available rows' mean
            avail_mean = (torch.sum(torch.where(mask[:, None], g, 0.0),
                                    dim=0)
                          / torch.clamp_min(torch.sum(mask), 1))
            out = FILTERS[base](torch.where(mask[:, None], g,
                                            avail_mean[None]), f)
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


# ---------------------------------------------------------------------------
# the closest-to-center means (Phocas, mean-around-median)

_CLOSEST_CHUNK = 1 << 22    # columns per sort: (n, 4M) keys and indices


@register("phocas")
def phocas(g, f):
    """Phocas: the mean of the n-f values per coordinate closest to the
    trimmed mean."""
    return _mean_closest(g, trimmed_mean(g, f), g.shape[0] - f)


@register("mean_around_median")
def mean_around_median(g, f):
    """The per-coordinate mean of the n-f values closest to the median."""
    return _mean_closest(g, coordinate_median(g), g.shape[0] - f)


def _mean_closest(g, center, k):
    """Per-coordinate mean of the k values closest to ``center``, in the
    order of ``jax.lax.top_k(-dist, k)``: the distances ascending, equal
    distances by the lower row (a stable sort; equal distances on the two
    sides of the center hold different values, so the tie order is part
    of the law), a NaN distance last (|NaN| has its sign bit clear, so
    its negation sorts below -inf in top_k's total order); the k values
    summed in that order.  Sorted a column chunk at a time, so that no
    (n, P) sort (and its int64 indices) exists at once; columns are
    independent, so the chunks change no bit."""
    out = torch.empty((g.shape[1],), dtype=g.dtype, device=g.device)
    for c in range(0, g.shape[1], _CLOSEST_CHUNK):
        x = g[:, c:c + _CLOSEST_CHUNK]
        dist = torch.abs(x - center[None, c:c + _CLOSEST_CHUNK])
        idx = torch.sort(dist, dim=0, stable=True).indices[:k]
        out[c:c + _CLOSEST_CHUNK] = row_sum(torch.gather(x, 0, idx)) / k
    return out


def row_sum(x):
    """The (d,) sum of the rows of an (n, d) stack, added in row order
    from row 0: the same bits whatever the width and device (a library
    reduction's order may depend on both)."""
    acc = x[0].clone()
    for i in range(1, x.shape[0]):
        acc += x[i]
    return acc


# ---------------------------------------------------------------------------
# median based


@register("geometric_median")
def geometric_median(g, f=0, iters: int = 32, eps: float = 1e-8):
    """Weiszfeld's fixed-point iteration for the geometric median, from
    the mean: y <- sum_i w_i g_i / sum_i w_i, w_i = 1 / max(||g_i - y||,
    eps)."""
    y = torch.mean(g, dim=0)
    for _ in range(iters):
        diff = g - y[None]
        d = torch.sqrt(torch.sum(diff.square_(), dim=-1))
        del diff
        w = 1.0 / torch.clamp_min(d, eps)
        y = torch.sum(w[:, None] * g, dim=0) / torch.sum(w)
    return y


@register("rfa")
def rfa(g, f=0, iters: int = 32, nu: float = 1e-6):
    """RFA: the smoothed Weiszfeld iteration (federated robust
    aggregation)."""
    return geometric_median(g, f, iters=iters, eps=nu)


@register("median_of_means")
def median_of_means(g, f, num_groups: int | None = None):
    """Partition the rows into k > 2f consecutive groups (k grown until
    it divides n), then the geometric median of the group means."""
    n = g.shape[0]
    k = num_groups if num_groups else min(n, 2 * f + 1) if f else n
    while n % k:
        k += 1
    means = torch.mean(g.reshape(k, n // k, -1), dim=1)
    return geometric_median(means, 0)


# ---------------------------------------------------------------------------
# norm based


@register("cgc")
def cgc(g, f, normalize: bool = True):
    """Comparative gradient clipping: scale the f largest norms down to
    the (n-f)-th smallest norm and keep every row (survey eq. 24); the
    raw sum (normalize=False) or divided by n."""
    n = g.shape[0]
    norms = torch.linalg.vector_norm(g, dim=-1)
    tau = torch.sort(norms).values[n - f - 1]
    scale = torch.clamp_max(tau / torch.clamp_min(norms, 1e-30), 1.0)
    out = torch.sum(scale[:, None] * g, dim=0)
    return out / n if normalize else out


# ---------------------------------------------------------------------------
# Zeno (server-validation based)


@register("zeno")
def zeno(g, f, server_grad=None, rho: float = 1e-3, lr: float = 1.0):
    """Zeno: the suspicion score of a server-held validation gradient v,
    score_i = lr <v, g_i> - rho ||g_i||^2; the mean of the n-f highest, in
    ``jax.lax.top_k`` order (:func:`_top_k_order`)."""
    if server_grad is None:
        raise ValueError("zeno requires server_grad")
    n = g.shape[0]
    score = lr * (g @ server_grad) - rho * torch.sum(torch.square(g), dim=-1)
    return torch.mean(g[_top_k_order(score, n - f)], dim=0)


# ---------------------------------------------------------------------------
# filter combinators


def compose(*names_or_fns, f_each=None):
    """The parallel ensemble (sequential composition is ill-typed, (n, d)
    -> (d,)): run each filter, then the coordinate-wise median of their
    outputs."""
    fns = [FILTERS[x] if isinstance(x, str) else x for x in names_or_fns]

    def ensemble(g, f):
        return coordinate_median(torch.stack([fn(g, f) for fn in fns],
                                             dim=0))
    return ensemble
