"""Gradient filters on dense stacks ``g: (n, d)`` — the gather path.

Counterpart of ``repro.core.filters.dense`` for the rules of the first
slice (mean, coordinate_median, trimmed_mean, krum) and their helpers.
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


def pairwise_sq_dists(g):
    """(n, d) -> (n, n) squared euclidean distances (Gram form).  The
    diagonal is exactly zero."""
    n = g.shape[0]
    sq = torch.sum(torch.square(g), dim=-1)
    gram = g @ g.T
    d2 = torch.clamp_min(sq[:, None] + sq[None, :] - 2.0 * gram, 0.0)
    eye = torch.eye(n, dtype=torch.bool, device=g.device)
    return d2.masked_fill(eye, 0.0)


def krum_scores(d2, f, k=None):
    """Krum score s(i) = sum of the distances to the k closest others
    (k defaults to the classic n - f - 2, clamped to [1, n - 1])."""
    n = d2.shape[0]
    eye = torch.eye(n, dtype=torch.bool, device=d2.device)
    d2 = d2.masked_fill(eye, math.inf)                       # exclude self
    k = (n - f - 2) if k is None else int(k)
    k = max(min(k, n - 1), 1)
    smallest, _ = torch.topk(d2, k, dim=-1, largest=False)
    return torch.sum(smallest, dim=-1)


def argmin_tiebreak(primary, secondary):
    """Index of the minimum of ``primary``, EXACT ties broken by
    ``secondary`` (then by first index)."""
    tied = primary == torch.min(primary)
    return torch.argmin(torch.where(tied, secondary,
                                    torch.full_like(secondary, math.inf)))


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
