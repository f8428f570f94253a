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
* :func:`arrived_mean_closest_ref` — phocas' and mean_around_median's
  law: the mean of the arrived values closest to the arrived-window
  center;
* :func:`coord_sort_ref`, :func:`median_from_sorted`,
  :func:`trimmed_mean_from_sorted` — the library sort, and the statistics
  the legacy ``ops`` paths read off a sorted (n, d) stack (K23's).
"""
from __future__ import annotations

import math

import torch

from repro_torch.core.filters.dense import nan_sign, row_sum
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


# the low 29 bits of an fp64 that lies halfway between two normal fp32
# values (53 - 24 spare bits: the first set, the rest clear)
_F32_SPARE = (1 << 29) - 1
_F32_HALF = 1 << 28
_F32_NORMAL = 2.0 ** -125


def fma_f32(a, x, acc=None):
    """fp32 ``fma(a, x, acc)`` with one rounding, elementwise (``acc=None``
    means the plain rounded product).  The product of two fp32 values is
    exact in fp64, so the fp64 sum s is one rounding of the exact sum.
    Rounding s to fp32 gives the exact sum's fp32 rounding unless s sits
    exactly halfway between two fp32 values (the fp32 rounding boundaries
    are fp64 values, so an inexact s can land on one, and its tie then
    rounds to even whatever side the exact sum lies on).  Those elements,
    and every nonzero s below 2^-125 (where fp32's spacing, and so its
    halfway pattern, changes), take :func:`_fma_f32_exact`; the result is
    bit for bit the correctly rounded fma either way."""
    p = x.double() * a.double()
    if acc is None:
        return p.float()
    s = p + acc.double()
    out = s.float()
    hazard = (((s.view(torch.int64) & _F32_SPARE) == _F32_HALF)
              | ((torch.abs(s) < _F32_NORMAL) & (s != 0)))
    if bool(hazard.any()):
        a, x, acc = torch.broadcast_tensors(a, x, acc)
        out[hazard] = _fma_f32_exact(a[hazard], x[hazard], acc[hazard])
    return out


def _fma_f32_exact(a, x, acc):
    """:func:`fma_f32` on every element: the fp64 sum is rounded to ODD
    (Knuth's TwoSum gives its exact error, and an inexact sum with an even
    last bit moves one ulp toward the exact value), and a round-to-odd
    value with 29 spare bits rounds to fp32 exactly as the exact sum
    would."""
    p = x.double() * a.double()
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


_CLOSEST_CHUNK = 1 << 22    # columns per pass: (n, 4M) sorts and ranks


def arrived_mean_closest_ref(g, mask, stat: str, f: int):
    """(d,) fp32: the phocas / mean_around_median trust window over the
    ARRIVED rows only, in two count-windowed stages:

      1. the center: :func:`arrived_stat_from_sorted` on the +inf-sentinel
         sort (``trimmed_mean`` with b = f for phocas, ``median`` for
         mean_around_median);
      2. the window: per coordinate, the mean of the k = clip(cnt - f, 1,
         cnt) arrived values closest to the center.  Absent rows get +inf
         distances, the ranks come from a stable argsort (equal distances
         by the lower row; a NaN distance after every other), and the kept
         values are selected with a where, so an absent row's inf or NaN
         never enters.

    Below f + 1 arrivals the window is the single closest arrived value;
    zero arrivals give an exact 0.  Computed a column chunk at a time, so
    that no (n, P) sort or rank array exists at once; columns are
    independent and every sum runs in row order
    (:func:`~repro_torch.core.filters.dense.row_sum`), so the chunks
    change no bit."""
    mb = mask.to(torch.bool)
    n, d = g.shape
    cnt = torch.sum(mask.float() > 0.5).to(torch.int64)
    k = torch.minimum(torch.clamp_min(cnt - f, 1), torch.clamp_min(cnt, 1))
    b = f if stat == "trimmed_mean" else 0
    inf = torch.full((), math.inf, device=g.device)
    zero = torch.zeros((), device=g.device)
    keep, width, _ = arrived_window(mask, n, stat, b)
    rows = torch.arange(n, device=g.device)[:, None]
    out = torch.empty((d,), dtype=torch.float32, device=g.device)
    for c in range(0, d, _CLOSEST_CHUNK):
        xf = g[:, c:c + _CLOSEST_CHUNK].float()
        s = torch.sort(torch.where(mb[:, None], xf, inf), dim=0).values
        center = row_sum(torch.where(keep, s, zero)) / width
        del s
        dist = torch.where(mb[:, None], torch.abs(xf - center[None]), inf)
        order = torch.sort(dist, dim=0, stable=True).indices
        del dist
        ranks = torch.empty_like(order).scatter_(0, order,
                                                 rows.expand_as(order))
        out[c:c + _CLOSEST_CHUNK] = row_sum(
            torch.where(ranks < k, xf, zero)) / k.float()
    return torch.where(cnt > 0, out, zero)


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
