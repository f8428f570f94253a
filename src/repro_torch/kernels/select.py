"""The selection family on the (n, n) Gram, and Bulyan's coordinate stage.

* K3 :func:`krum_select` replaces the Pallas TPU kernel
  ``repro/kernels/select.py:krum_select`` with ``csrc/krum_select.cu``;
* K8 :func:`cge_select` replaces ``select.py:cge_select`` with
  ``csrc/cge_select.cu``: the keep-mask of the n_keep smallest norms;
* K9 :func:`multi_krum_order` and K10 :func:`iterative_order` replace
  ``select.py:multi_krum_order`` and ``iterative_order`` with
  ``csrc/order.cu``: (n,) int32 pick orders (sentinel n = not picked);
* K13 :func:`bulyan_coord` replaces ``select.py:bulyan_coord`` with
  ``csrc/bulyan_coord.cu``: per coordinate, the mean of the beta selected
  values closest to the selected set's median.

K3, K8, K9 and K10 run one block, one thread per candidate, and share
``csrc/select.cuh`` (distances, row sums, rank).  Each wrapper launches
its kernel for a CUDA tensor and runs its plain version for a CPU tensor;
``<wrapper>.launches`` counts kernel launches.  The plain versions order,
sum and divide as the kernels do, so the two agree exactly.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import build
from repro_torch.kernels.coord_stats import _sort_network

MAX_N = 64


def _rank(values):
    """Exact comparison rank, first index wins ties, NaN ordered last:
    rank[i] = #{j : v_j < v_i or (v_j == v_i and j < i)}."""
    values = torch.where(torch.isnan(values),
                         torch.full_like(values, math.inf), values)
    n = values.shape[0]
    idx = torch.arange(n, device=values.device)
    vi, vj = values[:, None], values[None, :]
    before = (vj < vi) | ((vj == vi) & (idx[None, :] < idx[:, None]))
    return before.sum(dim=1)


def gram_d2(gr):
    """Squared distances off the Gram, max((sq_i + sq_j) - 2 G_ij, 0) with
    NaN -> +inf (the kernels' ``gram_d2``); the diagonal as computed:
    exactly 0 for a finite row, whose Gram diagonal IS its squared
    norm."""
    sq = torch.diagonal(gr)
    d2 = torch.maximum(sq[:, None] + sq[None, :] - 2.0 * gr,
                       torch.zeros((), dtype=gr.dtype, device=gr.device))
    return torch.where(torch.isnan(d2), torch.full_like(d2, math.inf), d2)


def d2_from_gram(gr):
    """:func:`gram_d2` with self excluded (+inf)."""
    eye = torch.eye(gr.shape[0], dtype=torch.bool, device=gr.device)
    return gram_d2(gr).masked_fill(eye, math.inf)


def krum_k(n: int, f: int) -> int:
    return max(n - f - 2, 1)


def _score_sums(d2, k: int):
    """(n, n) distances -> (n,) sums of each row's k smallest, taken in
    ascending order from 0 (the kernels' ``sum_smallest``)."""
    srt, _ = torch.sort(d2, dim=1)
    scores = torch.zeros_like(srt[:, 0])
    for m in range(k):
        scores = scores + srt[:, m]
    return scores


def krum_select_plain(gr, f: int):
    """(n, n) Gram -> (n,) one-hot fp32: the plain version of the kernel
    (row sums of the k smallest distances taken in ascending order)."""
    gr = gr.float()
    scores = _score_sums(d2_from_gram(gr), krum_k(gr.shape[0], f))
    return (_rank(scores) == 0).float()


def cge_select_plain(gr, n_keep: int):
    """(n, n) Gram -> (n,) {0,1} fp32: the n_keep smallest norms
    sqrt(max(G_ii, 0)) (the max keeps a NaN, which ranks last)."""
    sq = torch.diagonal(gr.float())
    norms = torch.sqrt(torch.maximum(sq, torch.zeros_like(sq)))
    return (_rank(norms) < n_keep).float()


def multi_krum_order_plain(gr, f: int, m: int):
    """(n, n) Gram -> (n,) int32: the score rank of the m smallest Krum
    scores (k = n - f - 2 clamped to [1, n - 1]), n elsewhere."""
    gr = gr.float()
    n = gr.shape[0]
    rank = _rank(_score_sums(d2_from_gram(gr), max(min(n - f - 2, n - 1),
                                                   1)))
    return torch.where(rank < m, rank, n).to(torch.int32)


def iterative_order_plain(gr, f: int, k_total: int):
    """(n, n) Gram -> (n,) int32 pick order of k_total rounds of Krum over
    the shrinking candidate set (k = remaining - f - 2, clamped), exact
    ties broken by the full-degree secondary (raw distances to the other
    candidates summed in index order) and then by first index, every
    comparison restricted to the candidates."""
    gr = gr.float()
    n = gr.shape[0]
    inf = torch.full((), math.inf, device=gr.device)
    eye = torch.eye(n, dtype=torch.bool, device=gr.device)
    d2 = gram_d2(gr).masked_fill(eye, 0.0)               # raw, diagonal 0
    idx = torch.arange(n, device=gr.device)
    cand = torch.ones((n,), dtype=torch.bool, device=gr.device)
    order = torch.full((n,), n, dtype=torch.int32, device=gr.device)
    for it in range(k_total):
        k = max(min(max(n - it - f - 2, 1), n - 1), 1)
        other = cand[None, :] & ~eye
        s = _score_sums(torch.where(other, d2, inf), k)
        key = torch.where(cand, s, inf)
        sec = torch.zeros((n,), device=gr.device)
        for j in range(n):
            sec = sec + torch.where(other[:, j], d2[:, j], 0.0)
        tied = (key == torch.min(key)) & cand
        sec_eff = torch.where(tied, sec, inf)
        pool = tied & (sec_eff == torch.min(sec_eff))
        pick = pool & (torch.cumsum(pool.int(), 0) == 1)
        order = torch.where(pick, it, order)
        cand = cand & ~pick
    return order


def bulyan_beta(theta: int, f: int) -> int:
    return max(theta - 2 * f, 1)


def bulyan_coord_plain(g, sel, theta: int, f: int):
    """(n, d), (n,) {0,1} -> (d,) fp32: the plain version of K13.  The
    median of the selected rows from K1's network over the n positions
    (unselected rows +inf); then beta rounds of first-index minimum of
    |x - med| over all rows, an unavailable row counting +inf (a NaN
    minimum extracts nothing and adds 0), summed in extraction order from
    0 and divided by beta (by a tensor: true division on the card too)."""
    n, d = g.shape
    beta = bulyan_beta(theta, f)
    x = g.float()
    selb = sel.float() > 0.5
    inf = torch.full((), math.inf, device=g.device)
    padded = torch.where(selb[:, None], x, inf)
    s = _sort_network(padded.unbind(0))
    med = 0.5 * (s[(theta - 1) // 2] + s[theta // 2])
    del s
    dist = torch.where(selb[:, None], torch.abs(x - med[None]), inf)
    avail = selb[:, None].expand(n, d).clone()
    acc = torch.zeros((d,), device=g.device)
    for _ in range(beta):
        cur = torch.where(avail, dist, inf)
        mn = torch.amin(cur, dim=0)                  # NaN propagates
        pick = torch.argmin(cur, dim=0)              # first index
        ok = ~torch.isnan(mn)
        val = torch.gather(x, 0, pick[None])[0]
        acc = acc + torch.where(ok, val, 0.0)
        taken = torch.gather(avail, 0, pick[None]) & ~ok[None]
        avail.scatter_(0, pick[None], taken)
        del cur
    return acc / torch.tensor(float(beta), device=g.device)


# ---------------------------------------------------------------------------
# wrappers


def _check_gram(name, gr):
    if gr.dim() != 2 or gr.shape[0] != gr.shape[1]:
        raise ValueError(f"{name}: need an (n, n) Gram, got "
                         f"{tuple(gr.shape)}")
    if not 1 <= gr.shape[0] <= MAX_N:
        raise ValueError(f"{name}: n={gr.shape[0]} outside [1, {MAX_N}]")
    if gr.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {gr.device}")
    if gr.device.type == "cuda" and (gr.dtype != torch.float32
                                     or not gr.is_contiguous()):
        raise ValueError(f"{name}: Gram must be contiguous float32")


def krum_select(gr, f: int):
    """gr: (n, n) fp32 Gram -> (n,) one-hot fp32 Krum selection."""
    _check_gram("krum_select", gr)
    n = gr.shape[0]
    if f < 0:
        raise ValueError(f"krum_select: f={f} < 0")
    if gr.device.type == "cpu":
        return krum_select_plain(gr, f)
    out = torch.empty((n,), dtype=torch.float32, device=gr.device)
    rc = build.lib().rt_krum_select(gr.data_ptr(), out.data_ptr(), n, int(f),
                                    build.stream_ptr(gr))
    build.check(rc, "krum_select")
    krum_select.launches += 1
    return out


def cge_select(gr, n_keep: int):
    """gr: (n, n) fp32 Gram -> (n,) {0,1} fp32 keep-mask of the n_keep
    smallest-norm rows (unnormalized: the caller divides after the sum)."""
    _check_gram("cge_select", gr)
    n = gr.shape[0]
    if not 0 <= n_keep <= n:
        raise ValueError(f"cge_select: n_keep={n_keep} outside [0, {n}]")
    if gr.device.type == "cpu":
        return cge_select_plain(gr, n_keep)
    out = torch.empty((n,), dtype=torch.float32, device=gr.device)
    rc = build.lib().rt_cge_select(gr.data_ptr(), out.data_ptr(), n,
                                   int(n_keep), build.stream_ptr(gr))
    build.check(rc, "cge_select")
    cge_select.launches += 1
    return out


def multi_krum_order(gr, f: int, m: int):
    """gr: (n, n) fp32 Gram -> (n,) int32 order of the m smallest-score
    rows (sentinel n = not picked)."""
    _check_gram("multi_krum_order", gr)
    n = gr.shape[0]
    if f < 0 or not 0 <= m <= n:
        raise ValueError(f"multi_krum_order: f={f}, m={m} outside f >= 0, "
                         f"m in [0, {n}]")
    if gr.device.type == "cpu":
        return multi_krum_order_plain(gr, f, m)
    out = torch.empty((n,), dtype=torch.int32, device=gr.device)
    rc = build.lib().rt_multi_krum_order(gr.data_ptr(), out.data_ptr(), n,
                                         int(f), int(m), build.stream_ptr(gr))
    build.check(rc, "multi_krum_order")
    multi_krum_order.launches += 1
    return out


def iterative_order(gr, f: int, k_total: int):
    """gr: (n, n) fp32 Gram -> (n,) int32 pick order of ``k_total``
    shrinking-k iterative Krum selections (m-Krum, Bulyan stage 1)."""
    _check_gram("iterative_order", gr)
    n = gr.shape[0]
    if f < 0 or not 0 <= k_total <= n:
        raise ValueError(f"iterative_order: f={f}, k_total={k_total} "
                         f"outside f >= 0, k_total in [0, {n}]")
    if gr.device.type == "cpu":
        return iterative_order_plain(gr, f, k_total)
    out = torch.empty((n,), dtype=torch.int32, device=gr.device)
    rc = build.lib().rt_iterative_order(gr.data_ptr(), out.data_ptr(), n,
                                        int(f), int(k_total),
                                        build.stream_ptr(gr))
    build.check(rc, "iterative_order")
    iterative_order.launches += 1
    return out


def bulyan_coord(g, sel, theta: int, f: int):
    """g: (n, d) fp32 or bf16, sel: (n,) {0,1} fp32 with theta rows
    selected -> (d,) fp32 Bulyan coordinate stage (beta = max(theta - 2f,
    1))."""
    if g.dim() != 2 or sel.shape != (g.shape[0],):
        raise ValueError(f"bulyan_coord: shapes g {tuple(g.shape)}, sel "
                         f"{tuple(sel.shape)}")
    n, d = g.shape
    if not 1 <= n <= MAX_N:
        raise ValueError(f"bulyan_coord: n={n} outside [1, {MAX_N}]")
    if not 1 <= theta <= n or f < 0:
        raise ValueError(f"bulyan_coord: theta={theta}, f={f} outside "
                         f"theta in [1, {n}], f >= 0")
    if g.device.type == "cpu":
        return bulyan_coord_plain(g, sel, theta, f)
    if g.device.type != "cuda" or sel.device != g.device:
        raise ValueError(f"bulyan_coord: g on {g.device}, sel on "
                         f"{sel.device}")
    if g.stride(1) != 1:
        raise ValueError("bulyan_coord: rows must be contiguous")
    if sel.dtype != torch.float32 or not sel.is_contiguous():
        raise ValueError("bulyan_coord: sel must be contiguous float32")
    code = build.dtype_code(g)
    out = torch.empty((d,), dtype=torch.float32, device=g.device)
    rc = build.lib().rt_bulyan_coord(g.data_ptr(), code, sel.data_ptr(),
                                     out.data_ptr(), n, d, g.stride(0),
                                     int(theta), bulyan_beta(theta, f),
                                     build.stream_ptr(g))
    build.check(rc, "bulyan_coord")
    bulyan_coord.launches += 1
    return out


for _fn in (krum_select, cge_select, multi_krum_order, iterative_order,
            bulyan_coord):
    _fn.launches = 0
