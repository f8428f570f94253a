"""Filter-level compositions of the kernels (counterpart of
``repro.kernels.ops``): the Krum pipeline Gram -> selection -> weighted
sum, plain and masked, and the selection family (CGE, multi-Krum, m-Krum,
MDA, Bulyan) off the same Gram.  The JAX package pads d to its TPU tile
(``_pad_d``); the CUDA kernels mask their own ragged edge, so nothing is
padded here.  Its ``_drop_unselected`` where-copy is fused into the
weighted-sum and ordered-application kernels (and their plain versions)
instead: they never read a row they did not select."""
from __future__ import annotations

import functools
import math

import torch

from repro_torch.kernels.pairwise import gram, imputed_mean, masked_gram
from repro_torch.kernels.select import (bulyan_coord, cge_select, gram_d2,
                                        iterative_order, krum_select,
                                        multi_krum_order)
from repro_torch.kernels.wsum import (masked_weighted_sum, ordered_apply,
                                      weighted_sum)


def kernel_krum(g, f: int):
    """Krum, fully on the kernel path; a one-hot application is exactly
    the selected row's values."""
    w = krum_select(gram(g), f)
    return weighted_sum(w, g)


def kernel_krum_masked(g, mask, wn, f: int):
    """Masked Krum = Krum over the mean-imputed stack (the gather law),
    without building it: the mean is computed ONCE (through K4) and shared
    by K6 and K7, and the one-hot application returns exactly the
    selected imputed row (the live row, or the mean upcast for a ghost).
    K3's output is {0,1} by construction: K7's precondition w >= 0."""
    mean = imputed_mean(g, wn)
    w = krum_select(masked_gram(g, mask, wn, mean), f)
    return masked_weighted_sum(w, g, mask, mean)


def kernel_cge(g, f: int, normalize: bool = True):
    """CGE: norms off the Gram diagonal (K2 -> K8), the kept rows summed by
    K4 in row order; normalization divides after the sum, like the dense
    law."""
    n = g.shape[0]
    out = weighted_sum(cge_select(gram(g), n - f), g)
    return out / (n - f) if normalize else out


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


def kernel_bulyan(g, f: int):
    """Bulyan: theta = n - 2f shrinking-k iterative Krum picks (K2 ->
    K10), then the fused per-coordinate stage (K13); no (n, d) sorted or
    distance copy is made."""
    n = g.shape[0]
    theta = n - 2 * f
    if theta < 1:
        raise ValueError("Bulyan needs n > 2f (and n >= 4f+3 for its "
                         "guarantees)")
    order = iterative_order(gram(g), f, theta)
    return bulyan_coord(g, (order < theta).float(), theta, f)
