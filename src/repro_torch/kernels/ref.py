"""Plain-torch oracles of the masked engine (counterpart of
``repro.kernels.ref``): the laws the gather path runs and the kernels'
plain versions are held to.

* :func:`fma_weighted_sum` — sum_i w_i g_i as the JAX step computes it
  under jit: one fused multiply-add per row, in row order, from 0;
* :func:`masked_impute_ref` — the mean-imputed stack of the pairwise
  family (krum): that weighted mean of the arrived rows, rounded through
  the stack's dtype, selected into the absent rows;
* :func:`arrived_stat_from_sorted` / :func:`masked_stat_ref` — the
  coordinate-wise rules' law: the order statistic over the ARRIVED rows
  only, absent rows being +inf sort sentinels;
* :func:`masked_sign_vote_ref` — the sign family's law: the majority vote
  of the arrived rows only;
* :func:`coord_sort_ref`, :func:`median_from_sorted`,
  :func:`trimmed_mean_from_sorted` — the library sort, and the statistics
  the legacy ``ops`` paths read off a sorted (n, d) stack (K23's).
"""
from __future__ import annotations

import math

import torch

from repro_torch.core.filters.dense import nan_sign
from repro_torch.kernels.coord_stats import stat_from_sorted


def fma_weighted_sum(w, g):
    """(n,), (n, d) -> (d,) fp32: ``acc = fma(w_i, g_i, acc)`` over the
    rows with w_i > 0, in row order, from acc = 0 (so the first term is
    the rounded product, and a one-hot w returns the row exactly).

    This is the arithmetic of the jitted JAX step, whose compiler fuses
    ``sum(g * w[:, None], 0)`` into such a chain, and of the CUDA kernels
    (``__fmaf_rn``), computed exactly by :func:`fma_f32`.  Rows of weight
    <= 0 are never read, so an inf or NaN there cannot leak."""
    wf = w.float()
    acc = None
    for i in torch.nonzero(wf > 0).flatten().tolist():
        acc = fma_f32(wf[i], g[i], acc)
    if acc is None:
        return torch.zeros((g.shape[1],), dtype=torch.float32,
                           device=g.device)
    return acc


def fma_f32(a, x, acc=None):
    """fp32 ``fma(a, x, acc)`` with one rounding, elementwise (``acc=None``
    means the plain rounded product).  The product of two fp32 values is
    exact in fp64; the fp64 sum is rounded to ODD (Knuth's TwoSum gives
    its exact error, and an inexact sum with an even last bit moves one
    ulp toward the exact value), and a round-to-odd value with 29 spare
    bits rounds to fp32 exactly as the exact sum would."""
    p = x.double() * a.double()
    if acc is None:
        return p.float()
    c = acc.double()
    s = p + c
    bp = s - c
    e = (p - bp) + (c - (s - bp))
    fix = (e != 0) & torch.isfinite(e) & ((s.view(torch.int64) & 1) == 0)
    toward = torch.where(e > 0, math.inf, -math.inf)
    return torch.where(fix, torch.nextafter(s, toward), s).float()


def imputed_mean_ref(g, wn):
    """(d,) in g's dtype: the weighted mean of the arrived rows (wn = w /
    tot, 0 on absent rows), rounded to g's dtype."""
    return fma_weighted_sum(wn, g).to(g.dtype)


def masked_impute_ref(g, mask, wn):
    """(n, d) -> (n, d) in g's dtype: absent rows replaced by
    :func:`imputed_mean_ref`."""
    return torch.where(mask.to(torch.bool)[:, None], g,
                       imputed_mean_ref(g, wn)[None])


def arrived_window(mask, n: int, stat: str, b: int = 0):
    """(keep (n, 1) bool over ranks, width fp32, cnt int) of the kept rank
    window for ``cnt`` arrived rows, all on the mask's device:

      * ``median``       — ranks [(cnt-1)//2, cnt - (cnt-1)//2);
      * ``trimmed_mean`` — ranks [b', cnt - b') with b' = min(b,
        (cnt-1)//2), so the window never empties."""
    cnt = torch.sum(mask.float() > 0.5).to(torch.int64)
    if stat == "median":
        lo = torch.div(cnt - 1, 2, rounding_mode="floor")
    elif stat == "trimmed_mean":
        lo = torch.minimum(torch.full_like(cnt, b),
                           torch.div(cnt - 1, 2, rounding_mode="floor"))
    else:
        raise KeyError(stat)
    lo = torch.clamp_min(lo, 0)
    hi = cnt - lo
    ranks = torch.arange(n, device=mask.device)[:, None]
    keep = (ranks >= lo) & (ranks < hi)
    width = torch.clamp_min(hi - lo, 1).float()
    return keep, width, cnt


def arrived_stat_from_sorted(s, mask, stat: str, b: int = 0):
    """``s``: (n, d) fp32, the per-coordinate ascending sort of the stack
    with absent rows replaced by +inf (they take the top n - cnt ranks).
    Returns the (d,) mean of the kept rank window (selected with a
    where, never multiplied by 0); zero arrivals give an exact 0."""
    keep, width, cnt = arrived_window(mask, s.shape[0], stat, b)
    out = torch.sum(torch.where(keep, s, torch.zeros((), device=s.device)),
                    dim=0) / width
    return torch.where(cnt > 0, out, torch.zeros((), device=s.device))


def masked_stat_ref(g, mask, wn, stat: str, b: int = 0):
    """(d,) fp32: the arrived-window law with a library sort (the gather
    path).  ``wn`` is unused, as in the JAX oracle."""
    mb = mask.to(torch.bool)
    sent = torch.where(mb[:, None], g.float(),
                       torch.full((), math.inf, device=g.device))
    s, _ = torch.sort(sent, dim=0)
    return arrived_stat_from_sorted(s, mask, stat, b)


def masked_sign_vote_ref(g, mask):
    """(d,) fp32: sign(sum of sign(g_i) over the ARRIVED rows); an absent
    row casts no vote.  Its signs are selected away, not multiplied by 0
    as the JAX oracle does, so a NaN in an absent row cannot leak into
    the vote (ROADMAP.md P10); zero arrivals give 0."""
    live = (mask.float() > 0.5)[:, None]
    votes = torch.where(live, nan_sign(g.float()),
                        torch.zeros((), device=g.device))
    return nan_sign(torch.sum(votes, dim=0))


def coord_sort_ref(g):
    """(n, d) -> (n, d) fp32, the library sort of each column (NaN last,
    where K23's network spreads a NaN as ``jnp.minimum`` does)."""
    return torch.sort(g.float(), dim=0).values


def median_from_sorted(s):
    """(d,) fp32: 0.5 * (s[(n-1)//2] + s[n//2]) of a sorted (n, d) stack."""
    return stat_from_sorted(s.unbind(0), "median")


def trimmed_mean_from_sorted(s, b: int):
    """(d,) fp32: the mean of ranks [b, n - b) of a sorted (n, d) stack,
    summed in ascending order (JAX's ``jnp.mean`` reassociates: within the
    fp32 bar)."""
    return stat_from_sorted(s.unbind(0), "trimmed_mean", b)
