"""Filter-level compositions of the kernels (counterpart of
``repro.kernels.ops``): the Krum pipeline Gram -> selection -> weighted
sum, and the selection family (CGE, multi-Krum, m-Krum, MDA, Bulyan) off
the same Gram, each plain and masked (over the mean-imputed stack, which
is never built: the mean is computed once and every stage imputes in its
own load); the selection telemetry of those rules off the same kernels
(:func:`kernel_selection_weights`); and the legacy sort paths, the median and trimmed mean read
off K23's sorted stack and the pairwise distances off K2's Gram (no
aggregation path calls them).  The JAX package pads d to its TPU tile
(``_pad_d``); the CUDA kernels mask their own ragged edge, so nothing is
padded here.  Its ``_drop_unselected`` where-copy is fused into the
weighted-sum and ordered-application kernels (and their plain versions)
instead: they never read a row they did not select."""
from __future__ import annotations

import functools
import math

import torch

from repro_torch.kernels import ref
from repro_torch.kernels.coord_stats import coord_sort
from repro_torch.kernels.pairwise import gram, imputed_mean, masked_gram
from repro_torch.kernels.select import (bulyan_coord, cge_select, gram_d2,
                                        iterative_order, krum_select,
                                        masked_bulyan_coord, multi_krum_order)
from repro_torch.kernels.wsum import (cge_weighted_sum,
                                      masked_cge_weighted_sum,
                                      masked_ordered_apply,
                                      masked_weighted_sum, ordered_apply,
                                      weighted_sum)


def kernel_coordinate_median(g, f=0):
    """(n, d) -> (d,) fp32: the median off K23's sorted stack."""
    return ref.median_from_sorted(coord_sort(g))


def kernel_trimmed_mean(g, b: int):
    """(n, d) -> (d,) fp32: the mean of ranks [b, n - b) of K23's sorted
    stack."""
    return ref.trimmed_mean_from_sorted(coord_sort(g), b)


def kernel_pairwise_sq_dists(g):
    """(n, d) -> (n, n) fp32 squared distances off K2's Gram, max(G_ii +
    G_jj - 2 G_ij, 0) (a NaN stays NaN, as ``jnp.maximum`` keeps it)."""
    gr = gram(g)
    sq = torch.diagonal(gr)
    return torch.maximum(sq[:, None] + sq[None, :] - 2.0 * gr,
                         torch.zeros((), device=gr.device))


def kernel_krum(g, f: int):
    """Krum, fully on the kernel path; a one-hot application is exactly
    the selected row's values."""
    w = krum_select(gram(g), f)
    return weighted_sum(w, g)


def _imputed_gram(g, mask, wn):
    """(mean, Gram) of the mean-imputed stack: the (d,) mean computed ONCE
    (through K4) and shared by K6 and the masked stage that follows."""
    mean = imputed_mean(g, wn)
    return mean, masked_gram(g, mask, wn, mean)


def kernel_krum_masked(g, mask, wn, f: int):
    """Masked Krum = Krum over the mean-imputed stack (the gather law),
    without building it: K4 (mean) -> K6 -> K3 -> K7, and the one-hot
    application returns exactly the selected imputed row (the live row,
    or the mean upcast for a ghost).  K3's output is {0,1} by
    construction: K7's precondition w >= 0."""
    mean, gr = _imputed_gram(g, mask, wn)
    return masked_weighted_sum(krum_select(gr, f), g, mask, mean)


def kernel_cge(g, f: int, normalize: bool = True):
    """CGE: the Gram (K2), then one launch of CGE's apply: K8's keep-mask of
    the n - f smallest norms off its diagonal, the kept rows summed as K4
    sums them, in row order; normalization divides after the sum, like the
    dense law (in the apply's store)."""
    n = g.shape[0]
    return cge_weighted_sum(gram(g), g, n - f,
                            div=n - f if normalize else None)


def kernel_multi_krum(g, f: int, m: int = 2):
    """multi-Krum: one Krum score pass (K9), the m smallest averaged in
    score order (K11)."""
    return ordered_apply(multi_krum_order(gram(g), f, m), g, m, div=m)


def kernel_m_krum(g, f: int, m: int = 2):
    """m-Krum: m shrinking-k iterative Krum picks (K10), averaged in pick
    order (K11)."""
    return ordered_apply(iterative_order(gram(g), f, m), g, m, div=m)


@functools.lru_cache(maxsize=None)
def _combos(n: int, f: int, device: torch.device):
    """The (C, n - f) subset table of MDA on ``device``, copied there once
    per (n, f, device): no step copies it from the host."""
    from repro_torch.core.aggregators import mda_combos     # lazy: no cycle
    return torch.as_tensor(mda_combos(n, f), dtype=torch.int64,
                           device=device)


def mda_order(d2, n: int, f: int):
    """MDA's subset selection on the (n, n) distances (:func:`gram_d2`,
    the diagonal 0 for a finite row), as plain torch with
    no d dependence: the least diameter over the (n-f)-subsets, ties by
    the subset perimeter, then enumeration order (``argmin_tiebreak``);
    NaN diameters order last.  Returns the (n,) int32 order: the chosen
    rows get their position in the subset, the rest n.  No host sync."""
    from repro_torch.core.filters.dense import argmin_tiebreak
    combos = _combos(n, f, d2.device)
    sub = d2[combos[:, :, None], combos[:, None, :]]
    inf = torch.full((), math.inf, device=d2.device)
    diam = torch.amax(sub, dim=(1, 2))
    diam = torch.where(torch.isnan(diam), inf, diam)
    per = torch.sum(sub, dim=(1, 2))
    per = torch.where(torch.isnan(per), inf, per)
    best = combos.index_select(0, argmin_tiebreak(diam, per).reshape(1))[0]
    order = torch.full((n,), n, dtype=torch.int32, device=d2.device)
    return order.scatter(0, best, torch.arange(n - f, dtype=torch.int32,
                                               device=d2.device))


def kernel_mda(g, f: int):
    """Minimum-diameter averaging off the Gram (K2): the subset selection
    is plain torch on the (n, n) distances, the chosen rows averaged in
    index order (K11)."""
    n = g.shape[0]
    order = mda_order(gram_d2(gram(g)), n, f)
    return ordered_apply(order, g, n - f, div=n - f)


def _bulyan_theta(n: int, f: int) -> int:
    theta = n - 2 * f
    if theta < 1:
        raise ValueError("Bulyan needs n > 2f (and n >= 4f+3 for its "
                         "guarantees)")
    return theta


def kernel_bulyan(g, f: int):
    """Bulyan: theta = n - 2f shrinking-k iterative Krum picks (K2 ->
    K10), then the fused per-coordinate stage (K13); no (n, d) sorted or
    distance copy is made."""
    theta = _bulyan_theta(g.shape[0], f)
    order = iterative_order(gram(g), f, theta)
    return bulyan_coord(g, (order < theta).float(), theta, f)


def kernel_cge_masked(g, mask, wn, f: int, normalize: bool = True):
    """Masked CGE: K4 (mean) -> K6 -> the masked CGE apply: K8's keep-mask
    on the imputed Gram, the kept rows of the imputed stack summed as K7
    sums them (a kept ghost adds the mean), then divided in its store."""
    n = g.shape[0]
    mean, gr = _imputed_gram(g, mask, wn)
    return masked_cge_weighted_sum(gr, g, mask, mean, n - f,
                                   div=n - f if normalize else None)


def kernel_multi_krum_masked(g, mask, wn, f: int, m: int = 2):
    """Masked multi-Krum: K4 (mean) -> K6 -> K9 -> K12."""
    mean, gr = _imputed_gram(g, mask, wn)
    return masked_ordered_apply(multi_krum_order(gr, f, m), g, mask, mean,
                                m, div=m)


def kernel_m_krum_masked(g, mask, wn, f: int, m: int = 2):
    """Masked m-Krum: K4 (mean) -> K6 -> K10 -> K12."""
    mean, gr = _imputed_gram(g, mask, wn)
    return masked_ordered_apply(iterative_order(gr, f, m), g, mask, mean, m,
                                div=m)


def kernel_mda_masked(g, mask, wn, f: int):
    """Masked MDA: K4 (mean) -> K6 -> :func:`mda_order` on the (n, n)
    distances -> K12."""
    n = g.shape[0]
    mean, gr = _imputed_gram(g, mask, wn)
    return masked_ordered_apply(mda_order(gram_d2(gr), n, f), g, mask, mean,
                                n - f, div=n - f)


def kernel_bulyan_masked(g, mask, wn, f: int):
    """Masked Bulyan: K4 (mean) -> K6 -> K10 (theta picks) -> K14."""
    theta = _bulyan_theta(g.shape[0], f)
    mean, gr = _imputed_gram(g, mask, wn)
    sel = (iterative_order(gr, f, theta) < theta).float()
    return masked_bulyan_coord(g, mask, mean, sel, theta, f)


# the pairwise rules whose selection telemetry reads their kernels
SELECTION_RULES = ("krum", "cge", "multi_krum", "m_krum", "mda", "bulyan")


def kernel_selection_weights(name, g, f: int, hyper: dict, mask=None,
                             wn=None):
    """(n,) fp32 selection weights of the pairwise rule ``name``, read off
    the selection kernels its aggregate launches, so they name the rows
    the aggregate used: K2's Gram (masked: K4's imputed mean, then K6),
    then Krum's one-hot row (K3), CGE's keep-mask (K8) divided by n - f
    when normalized, or 1/k on the first k picks of K9 (multi_krum), K10
    (m_krum, Bulyan's theta picks) or MDA's subset.  ``mask`` (n,) {0,1}
    fp32 and ``wn`` the normalized weights, as for the masked aggregate."""
    n = g.shape[0]
    gr = gram(g) if mask is None else _imputed_gram(g, mask, wn)[1]
    if name == "krum":
        return krum_select(gr, f)
    if name == "cge":
        keep = cge_select(gr, n - f)
        return keep / (n - f) if hyper.get("normalize", True) else keep
    if name == "multi_krum":
        k = hyper.get("m", 2)
        order = multi_krum_order(gr, f, k)
    elif name == "m_krum":
        k = hyper.get("m", 2)
        order = iterative_order(gr, f, k)
    elif name == "bulyan":
        k = _bulyan_theta(n, f)
        order = iterative_order(gr, f, k)
    elif name == "mda":
        k = n - f
        order = mda_order(gram_d2(gr), n, f)
    else:
        raise KeyError(f"{name}: no selection kernels")
    return (order < k).float() / k
