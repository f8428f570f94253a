"""Each CUDA kernel against its plain PyTorch version, on the card.

Marked ``cuda``: skipped where there is no NVIDIA GPU.  On the machine
with the card (no JAX needed):

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Bars: median values (plain and masked), Krum's one-hot and the one-hot
weighted sums (plain and masked, live row or ghost) exact; trimmed means,
Grams (plain and masked), the imputed mean and general weighted sums
within rtol = atol = 3e-6.  The selection family (K8-K14, and CGE's
apply: K4 / K7 under their CGE flag) and the sign votes (K15, K16)
exact: their plain versions order, sum and divide as the kernels do.
The scaled kernels of the compressed exchange (K18-K20, and K15 on int8
/ fp8 codes) exact, trimmed means within 3e-6: the kernels
dequantize with the plain versions' one fp32 multiply.  sparse_mean's
K17 and K21 exact (their plain versions round each product and sum as
the kernel does, in row order), K23's sorted stack exact.  centered_clip's
K22 exact: its plain version sums lam, chains the fused multiply-adds and
adds the center in the kernel's order.
"""
import math

import pytest
import torch

from repro_torch import kernels
from repro_torch.core.flat import quantize_rows
from repro_torch.kernels.coord_stats import coord_sort_plain, coord_stat_plain
from repro_torch.kernels.masked import (masked_coord_stat_plain,
                                        masked_sign_vote_plain,
                                        scaled_coord_stat_plain,
                                        scaled_masked_coord_stat_plain,
                                        scaled_masked_sign_vote_plain,
                                        sign_vote_plain)
from repro_torch.kernels.pairwise import gram_plain, masked_gram_plain
from repro_torch.kernels.ref import imputed_mean_ref
from repro_torch.kernels.select import (bulyan_coord_plain,
                                        cge_select_plain,
                                        iterative_order_plain,
                                        krum_select_plain,
                                        masked_bulyan_coord_plain,
                                        multi_krum_order_plain)
from repro_torch.kernels.wsum import (cge_weighted_sum_plain,
                                      clipped_weighted_sum_plain,
                                      masked_cge_weighted_sum_plain,
                                      masked_ordered_apply_plain,
                                      masked_weighted_sum_plain,
                                      ordered_apply_plain,
                                      scaled_sparse_masked_weighted_mean_plain,
                                      sparse_masked_weighted_mean_plain,
                                      weighted_sum_plain)

TOL = 3e-6
F = 2
HAZARDS = [None, "nan", "inf", "ties", "spots"]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels run only there)")
    return torch.device("cuda")


def stack(n, d, seed, hazard, device, dtype):
    g = torch.randn((n, d), generator=torch.Generator().manual_seed(seed))
    g = g * 2.0
    if hazard == "nan":
        g[1] = math.nan
    elif hazard == "inf":
        g[1], g[4] = math.inf, -math.inf
    elif hazard == "ties":
        g[1] = g[0]
        g[2] = g[0]
        g[5] = torch.round(g[5])
    elif hazard == "spots":
        g[1, 7], g[3, 7], g[5, 11] = math.nan, math.inf, -math.inf
    return g.to(device, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hazard", HAZARDS)
@pytest.mark.parametrize("n", [8, 9, 33])
def test_cuda_kernels_match_plain(cuda_device, n, hazard, dtype):
    d = 4099
    g = stack(n, d, 1, hazard, cuda_device, dtype)
    for stat, b in (("median", 0), ("trimmed_mean", 2)):
        ours, ref = kernels.coord_stat(g, stat, b), coord_stat_plain(g, stat,
                                                                      b)
        tol = 0 if stat == "median" else TOL
        torch.testing.assert_close(ours, ref, rtol=tol, atol=tol,
                                   equal_nan=True)
    gr = kernels.gram(g)
    if hazard in (None, "ties"):
        torch.testing.assert_close(gr, gram_plain(g), rtol=TOL, atol=TOL)
        assert torch.equal(gr, kernels.gram(g))       # repeats bit for bit
    w = kernels.krum_select(gr, F)
    assert torch.equal(w, krum_select_plain(gr, F))
    assert float(w.sum()) == 1.0
    torch.testing.assert_close(kernels.weighted_sum(w, g),
                               weighted_sum_plain(w, g), rtol=0, atol=0,
                               equal_nan=True)
    wg = torch.rand(n, generator=torch.Generator().manual_seed(2)).to(
        cuda_device)
    if hazard in (None, "ties"):
        torch.testing.assert_close(kernels.weighted_sum(wg, g),
                                   weighted_sum_plain(wg, g), rtol=TOL,
                                   atol=TOL)
    torch.cuda.synchronize()


# K1's hazards at any n: tied +-0 (every even column +0 or -0 in each
# row); NaN every 3rd column of row 1 % n and in the first and last row;
# +inf every 4th column of row 0, -inf every 4th (offset 1) of row n - 1,
# and columns of +inf only
ORDER_HAZARDS = ["signed_zero", "nan", "inf"]


def order_stack(n, d, hazard, device, dtype):
    gen = torch.Generator().manual_seed(n)
    g = torch.randn((n, d), generator=gen) * 2.0
    if hazard == "signed_zero":
        neg = torch.rand((n, d), generator=gen) < 0.4
        g[:, ::2] = torch.where(neg[:, ::2], -0.0, 0.0)
    elif hazard == "nan":
        g[1 % n, ::3] = math.nan
        g[0, 5], g[n - 1, 7] = math.nan, math.nan
    elif hazard == "inf":
        g[0, ::4], g[n - 1, 1::4] = math.inf, -math.inf
        g[:, 2::17] = math.inf
    return g.to(device, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hazard", ORDER_HAZARDS)
@pytest.mark.parametrize("n", [1, 4, 8, 9, 16, 17, 33, 64])
def test_cuda_coord_stat_matches_plain_at_every_width(cuda_device, n,
                                                      hazard, dtype):
    """K1 at every register capacity (the order-statistic template or the
    network kernel, as rt_coord_stat routes n): median exact, NaN where
    the plain version has it, trimmed mean (b = min(2, (n - 1) // 2))
    within 3e-6; again on a view offset by one element (rows not aligned
    for the vector loads)."""
    d = 4099
    g = order_stack(n, d, hazard, cuda_device, dtype)
    wide = torch.zeros((n, d + 1), dtype=dtype, device=cuda_device)
    wide[:, 1:] = g
    b = min(2, (n - 1) // 2)
    for x in (g, wide[:, 1:]):
        for stat, bb in (("median", 0), ("trimmed_mean", b)):
            tol = 0 if stat == "median" else TOL
            torch.testing.assert_close(kernels.coord_stat(x, stat, bb),
                                       coord_stat_plain(x, stat, bb),
                                       rtol=tol, atol=tol, equal_nan=True)
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_cuda_launch_counters_count_launches(cuda_device):
    kernels.reset_launch_counts()
    g = torch.randn(8, 1000, device=cuda_device)
    kernels.kernel_krum(g, F)
    kernels.coord_stat(g, "median")
    m = torch.ones(8, device=cuda_device)
    m[3] = 0.0
    kernels.kernel_krum_masked(g, m, m / 7.0, F)
    kernels.masked_coord_stat(g, m, m, "median")
    assert kernels.launch_counts() == {
        "coord_stat": 1, "gram": 1, "krum_select": 2, "weighted_sum": 2,
        "masked_coord_stat": 1, "masked_gram": 1, "masked_weighted_sum": 1,
        "cge_select": 0, "multi_krum_order": 0, "iterative_order": 0,
        "ordered_apply": 0, "masked_ordered_apply": 0, "bulyan_coord": 0,
        "masked_bulyan_coord": 0, "sign_vote": 0, "masked_sign_vote": 0,
        "scaled_coord_stat": 0, "scaled_masked_coord_stat": 0,
        "scaled_masked_sign_vote": 0, "sparse_masked_weighted_mean": 0,
        "scaled_sparse_masked_weighted_mean": 0, "coord_sort": 0,
        "clipped_weighted_sum": 0, "cge_weighted_sum": 0,
        "masked_cge_weighted_sum": 0}
    coord_stat_plain(g, "median")                  # the plain versions
    masked_coord_stat_plain(g, m, m, "median")
    assert kernels.launch_counts()["coord_stat"] == 1
    assert kernels.launch_counts()["masked_coord_stat"] == 1


MASKS = ["most", "one", "none", "all"]


def mask_of(n, case, device):
    """(n,) {0,1} fp32 arrival mask: n - 2 (at least 1), one, none, all."""
    k = {"most": max(n - 2, 1), "one": 1, "none": 0, "all": n}[case]
    m = torch.zeros(n)
    m[torch.randperm(n, generator=torch.Generator().manual_seed(n))[:k]] = 1
    return m.to(device)


def masked_hazard(g, m, hazard):
    live = torch.nonzero(m > 0.5).flatten().tolist()
    absent = torch.nonzero(m <= 0.5).flatten().tolist()
    if hazard == "nan" and live:
        g[live[0]] = math.nan                     # spreads as in JAX
    elif hazard == "absent" and absent:
        g[absent[0], ::2] = math.nan              # never shows
        g[absent[0], 1::2] = math.inf
    elif hazard == "inf" and live:
        g[live[0]], g[live[-1]] = math.inf, -math.inf
    elif hazard == "ties" and live:
        g[live] = g[live[0]].clone()
        g[:, ::3] = torch.round(g[:, ::3])
    return g


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hazard", [None, "nan", "absent", "inf", "ties"])
@pytest.mark.parametrize("n", [3, 4, 6, 8])
def test_cuda_masked_kernels_match_plain(cuda_device, n, hazard, dtype):
    d = 4099
    b = min(1 if n < 8 else 2, (n - 1) // 2)
    for case in MASKS:
        m = mask_of(n, case, cuda_device)
        g = masked_hazard(stack(n, d, 3, None, cuda_device, torch.float32),
                          m, hazard).to(dtype)
        w = m * torch.tensor([1.0, 0.5, 1 / 3] * 22, device=cuda_device)[:n]
        wn = w / torch.clamp_min(w.sum(), 1e-30)
        for stat, bb in (("median", 0), ("trimmed_mean", b)):
            ours = kernels.masked_coord_stat(g, m, wn, stat, bb)
            ref = masked_coord_stat_plain(g, m, wn, stat, bb)
            tol = 0 if stat == "median" else TOL
            torch.testing.assert_close(ours, ref, rtol=tol, atol=tol,
                                       equal_nan=True)
            if hazard == "absent":
                assert torch.isfinite(ours).all()
        if case == "none" or hazard in ("nan", "inf"):
            continue
        mean = kernels.imputed_mean(g, wn)
        torch.testing.assert_close(mean.float(),
                                   imputed_mean_ref(g, wn).float(),
                                   rtol=TOL, atol=TOL)
        gr = kernels.masked_gram(g, m, wn, mean)
        torch.testing.assert_close(gr, masked_gram_plain(g, m, wn, mean),
                                   rtol=TOL, atol=TOL)
        assert torch.equal(gr, kernels.masked_gram(g, m, wn, mean))
        sel = kernels.krum_select(gr, 1)
        for onehot in torch.eye(n, device=cuda_device):
            out = kernels.masked_weighted_sum(onehot, g, m, mean)
            assert torch.equal(out, masked_weighted_sum_plain(onehot, g, m,
                                                              mean))
        sets = (m > 0.5).float()
        sets[torch.nonzero(m <= 0.5).flatten()[:1]] = 1.0
        torch.testing.assert_close(
            kernels.masked_weighted_sum(sets, g, m, mean),
            masked_weighted_sum_plain(sets, g, m, mean), rtol=TOL, atol=TOL)
        assert torch.equal(kernels.kernel_krum_masked(g, m, wn, 1),
                           kernels.masked_weighted_sum(sel, g, m, mean))
    torch.cuda.synchronize()


def same_bits(a, b):
    return torch.equal(a.contiguous().view(torch.int32),
                       b.contiguous().view(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n", [1, 8, 9, 11, 16, 17, 33, 64])
def test_cuda_gram_kernels_match_plain_at_every_width(cuda_device, n, dtype):
    """K2 and K6 at each row-block count of the tensor-core template:
    within 3e-6 of the plain versions, repeated bit for bit, bitwise
    symmetric; rows whose leading stride the 16-byte vectors cannot take
    (d = 4099), a strided stack (d = 4099 in rows of 4112: vectors and a
    scalar tail), an aligned one and d = 1; K6's absent rows NaN-filled
    and never read."""
    m = torch.ones(n, device=cuda_device)
    m[n // 2::3] = 0.0
    wn = m / m.sum().clamp_min(1.0)
    for d, ld in ((4099, 4099), (4099, 4112), (4096, 4096), (1, 1)):
        base = stack(n, ld, n + d, None, cuda_device, dtype)
        g = base[:, :d]
        gr = kernels.gram(g)
        torch.testing.assert_close(gr, gram_plain(g), rtol=TOL, atol=TOL)
        assert same_bits(gr, kernels.gram(g)) and same_bits(gr, gr.T)
        base[m <= 0.5] = math.nan                 # never read by K6
        mean = torch.randn(d, generator=torch.Generator().manual_seed(d))
        mean = mean.to(cuda_device, dtype)
        gr = kernels.masked_gram(g, m, wn, mean)
        assert torch.isfinite(gr).all()
        torch.testing.assert_close(gr, masked_gram_plain(g, m, wn, mean),
                                   rtol=TOL, atol=TOL)
        assert (same_bits(gr, kernels.masked_gram(g, m, wn, mean))
                and same_bits(gr, gr.T))
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_cuda_wrappers_raise_on_bad_input(cuda_device):
    g = torch.randn(8, 100, device=cuda_device)
    with pytest.raises(TypeError):
        kernels.coord_stat(g.half(), "median")
    with pytest.raises(ValueError):
        kernels.gram(g[:, ::2])               # strided rows
    with pytest.raises(ValueError):
        kernels.weighted_sum(torch.ones(8), g)          # w on the CPU


def assert_same(a, b):
    """Bitwise agreement up to the sign of zero, NaN equal to NaN."""
    torch.testing.assert_close(a, b, rtol=0, atol=0, equal_nan=True)


def assert_bits(a, b):
    """Bitwise equality, the sign of zero included; NaN equal to NaN."""
    an, bn = torch.isnan(a), torch.isnan(b)
    assert torch.equal(an, bn)
    assert torch.equal(a[~an].view(torch.int32), b[~bn].view(torch.int32))


def offset_by_one(x):
    """A copy of ``x`` in a view whose rows start one element past a
    16-byte boundary (rows not aligned for the vector loads)."""
    n, d = x.shape
    wide = torch.zeros((n, d + 1), dtype=x.dtype, device=x.device)
    wide[:, 1:] = x
    return wide[:, 1:]


# Bulyan's hazards beyond stack()'s (K13, K14 and the K11 / K12 beside
# them): +-0 on most rows every 5th column (a +-0 median); +-3e38 / +-1e38
# / 2e38 every 3rd column (|x - med| overflows, the all-inf rounds take
# row 0)
BULYAN_HAZARDS = ["signed_zero", "overflow"]


def bulyan_hazard(g, hazard):
    gen = torch.Generator().manual_seed(g.shape[0])
    if hazard == "signed_zero":
        z = g[: g.shape[0] // 2 + 1, ::5]
        z[:] = torch.where(torch.rand(z.shape, generator=gen) < 0.5, 0.0,
                           -0.0).to(g.device)
    elif hazard == "overflow":
        cols = g[:, ::3]
        big = torch.tensor([3e38, -3e38, 1e38, -1e38, 2e38])
        cols[:] = big[torch.randint(0, 5, cols.shape,
                                    generator=gen)].to(g.device)
    return g


def offset_view(t):
    """t's values in a view offset by one element along its last axis: an
    address no vector load takes (the kernels' scalar path)."""
    wide = torch.full(t.shape[:-1] + (t.shape[-1] + 1,), math.nan,
                      dtype=t.dtype, device=t.device)
    wide[..., 1:] = t
    return wide[..., 1:]


def selection_gram(n, hazard, device):
    """The card's Gram of a small stack with ``hazard``: the rows of
    ``stack``'s, ``dup`` (every row equal), ``pair`` (the pair tie that
    K10's secondary breaks, built as tests/test_torch_select.py builds
    it), or ``all_nan`` (a NaN Gram: every distance +inf, every round of
    K10 all-inf)."""
    g = stack(max(n, 8), 4099, 5, hazard if hazard in HAZARDS else None,
              device, torch.float32)[:n].contiguous()
    if hazard == "dup":
        g[:] = g[0].clone()
    elif hazard == "pair" and n >= 3:
        g[n - 2] = g[n - 1] + 1e-3
        g[n - 1] = g[n - 1] + 0.5 * g[0]
    gr = kernels.gram(g)
    return torch.full_like(gr, math.nan) if hazard == "all_nan" else gr


# the n of chip_smoke.py's Gram and selection sweeps
SWEEP_N = tuple(range(1, 18)) + (24, 32, 33, 48, 64)


def same_twice(call, plain):
    """The kernel's result bitwise equal to its plain version and to a
    repeat call."""
    out = call()
    assert_same(out, plain)
    assert torch.equal(out, call())
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("hazard",
                         HAZARDS + ["dup", "pair", "all_nan"])
@pytest.mark.parametrize("n", SWEEP_N)
def test_cuda_selection_kernels_match_plain(cuda_device, n, hazard):
    """K3, K8, K9, K10 on the card's own Gram, which must be bitwise
    symmetric (K10's pair tie relies on it), at every n of the sweep.  f
    in {0, 1, 2, (n - 3) // 4}; K8 keeping n - f and 1, K9 at m in {1, 2,
    3, n - f} (its picks the ranks 0 .. m - 1), K10 at k_total in {1, 2,
    3, theta, n}: k_total = n runs rounds with fewer than k other
    candidates left (+inf keys)."""
    gr = selection_gram(n, hazard, cuda_device)
    assert_same(gr, gr.T)
    for f in sorted({0, 1, 2, max((n - 3) // 4, 0)}):
        w = same_twice(lambda: kernels.krum_select(gr, f),
                       krum_select_plain(gr, f))
        assert float(w.sum()) == 1.0
        for n_keep in sorted({max(n - f, 0), 1}):
            same_twice(lambda: kernels.cge_select(gr, n_keep),
                       cge_select_plain(gr, n_keep))
        for m in sorted({1, min(2, n), min(3, n), max(n - f, 0)}):
            order = same_twice(lambda: kernels.multi_krum_order(gr, f, m),
                               multi_krum_order_plain(gr, f, m))
            assert sorted(order[order < n].tolist()) == list(range(m))
        theta = max(n - 2 * f, 1)
        for k_total in sorted({min(k, n) for k in (1, 2, 3, theta, n)}):
            order = same_twice(
                lambda: kernels.iterative_order(gr, f, k_total),
                iterative_order_plain(gr, f, k_total))
            picked = sorted(order[order < n].tolist())
            assert picked == list(range(k_total))
    torch.cuda.synchronize()


def cge_stack(n, hazard, dtype, device):
    g = stack(max(n, 8), 4099, 9, hazard if hazard in HAZARDS else None,
              device, torch.float32)[:n].contiguous()
    if hazard == "dup":
        g[:] = g[0].clone()
    return g.to(dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hazard", [None, "nan", "inf", "ties", "dup",
                                    "all_nan"])
@pytest.mark.parametrize("n", SWEEP_N)
def test_cuda_cge_apply_matches_the_chain(cuda_device, n, hazard, dtype):
    """CGE's apply, sync and masked (max(n - 2, 1) arrived; with no hazard
    from n = 4 a ghost, whose imputed row is the mean, is kept), n_keep in
    {n - f, 1}, normalized and not: bitwise equal to its plain version, to
    the chain it replaces recomposed from the card's K8 -> K4 (K7) -> a
    division by a device tensor, and to a repeat.  ``nan`` / ``all_nan``
    give NaN norms (ordered last), ``ties`` / ``dup`` equal ones."""
    f = max(2, (n - 3) // 4)
    x = cge_stack(n, hazard, dtype, cuda_device)
    m = mask_of(n, "most", cuda_device)
    wn = m / torch.clamp_min(m.sum(), 1.0)
    mean = kernels.imputed_mean(x, wn)
    grams = {"sync": kernels.gram(x),
             "masked": kernels.masked_gram(x, m, wn, mean)}
    if hazard == "all_nan":
        grams = {k: torch.full_like(v, math.nan) for k, v in grams.items()}
    for n_keep in sorted({max(n - f, 0), 1}):
        keep = {k: kernels.cge_select(gr, n_keep) for k, gr in grams.items()}
        if hazard is None and n >= 4 and n_keep == n - f:
            assert float(keep["masked"][m <= 0.5].sum()) >= 1.0
        for div in (None, n_keep or None):
            chain = {"sync": kernels.weighted_sum(keep["sync"], x),
                     "masked": kernels.masked_weighted_sum(
                         keep["masked"], x, m, mean)}
            if div is not None:
                d = torch.tensor(float(div), device=cuda_device)
                chain = {k: v / d for k, v in chain.items()}
            calls = {
                "sync": (lambda: kernels.cge_weighted_sum(
                    grams["sync"], x, n_keep, div=div),
                    cge_weighted_sum_plain(grams["sync"], x, n_keep, div)),
                "masked": (lambda: kernels.masked_cge_weighted_sum(
                    grams["masked"], x, m, mean, n_keep, div=div),
                    masked_cge_weighted_sum_plain(grams["masked"], x, m,
                                                  mean, n_keep, div))}
            for k, (call, plain) in calls.items():
                out = call()
                assert_bits(out, plain)
                assert_bits(out, chain[k])
                assert_bits(out, call())
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hazard", [None, "nan", "inf", "spots"]
                         + BULYAN_HAZARDS)
@pytest.mark.parametrize("n", [3, 8, 11, 16, 33])
def test_cuda_ordered_apply_and_bulyan_coord_match_plain(cuda_device, n,
                                                         hazard, dtype):
    """K11 with the selection kernels' orders (and a hand-made one), K13
    at each theta a Bulyan step can give, also on a view offset by one
    element; +-inf / NaN rows and spots in and out of the selection, ties
    of equidistant values, +-0 medians and overflowing distances."""
    f = 1 if n < 8 else 2
    g = stack(max(n, 8), 4099, 6, hazard, cuda_device,
              torch.float32)[:n].contiguous()
    g[:, ::5] = torch.round(g[:, ::5])          # equidistant values
    g = bulyan_hazard(g, hazard).to(dtype)
    gv = offset_view(g)
    gr = kernels.gram(g)
    orders = [kernels.multi_krum_order(gr, f, min(3, n)),
              kernels.iterative_order(gr, f, min(3, n))]
    hand = torch.full((n,), n, dtype=torch.int32, device=cuda_device)
    hand[torch.arange(n - 1, -1, -2, device=cuda_device)] = torch.arange(
        (n + 1) // 2, dtype=torch.int32, device=cuda_device)
    orders.append(hand)
    for order in orders:
        k = int((order < n).sum())
        for div in (None, k):
            assert_same(kernels.ordered_apply(order, g, k, div=div),
                        ordered_apply_plain(order, g, k, div=div))
    for theta in sorted({max(n - 2 * f, 1), max(n - 2 * f - 1, 1), n}):
        sel = (kernels.iterative_order(gr, f, theta) < theta).float()
        for ff in (0, f):
            for x in (g, gv):
                assert_same(kernels.bulyan_coord(x, sel, theta, ff),
                            bulyan_coord_plain(x, sel, theta, ff))
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_cuda_selection_compositions_count_their_launches(cuda_device):
    """Each composition launches its kernels once: cge K2 and its apply
    (K4 under the CGE flag, K8 folded in: no K8 and no K4 launch),
    multi_krum K2 K9 K11, m_krum K2 K10 K11, mda K2 K11, bulyan K2 K10
    K13."""
    g = torch.randn(11, 5000, device=cuda_device)
    want = {"cge": ("gram", "cge_weighted_sum"),
            "multi_krum": ("gram", "multi_krum_order", "ordered_apply"),
            "m_krum": ("gram", "iterative_order", "ordered_apply"),
            "mda": ("gram", "ordered_apply"),
            "bulyan": ("gram", "iterative_order", "bulyan_coord")}
    for rule, names in want.items():
        kernels.reset_launch_counts()
        kernels.kernel_aggregate(rule, g, 2)
        counts = kernels.launch_counts()
        assert counts == {k: int(k in names) for k in counts}, rule


@pytest.mark.cuda
def test_cuda_selection_wrappers_raise_on_bad_input(cuda_device):
    g = torch.randn(8, 100, device=cuda_device)
    gr = kernels.gram(g)
    order = torch.zeros(8, dtype=torch.int32, device=cuda_device)
    with pytest.raises(ValueError):
        kernels.cge_select(gr.double(), 6)
    with pytest.raises(ValueError):
        kernels.krum_select(gr.double(), 2)
    with pytest.raises(ValueError):
        kernels.krum_select(gr.T, 2)                  # not contiguous
    with pytest.raises(ValueError):
        kernels.krum_select(gr[:, :7], 2)             # not square
    with pytest.raises(ValueError):
        kernels.iterative_order(gr.T, 2, 4)           # not contiguous
    with pytest.raises(ValueError):
        kernels.ordered_apply(order.long(), g, 3)
    with pytest.raises(ValueError):
        kernels.ordered_apply(order.cpu(), g, 3)
    with pytest.raises(TypeError):
        kernels.bulyan_coord(g.half(), torch.ones(8, device=cuda_device),
                             4, 2)
    with pytest.raises(ValueError):
        kernels.bulyan_coord(g, torch.ones(8, device=cuda_device).bool(),
                             4, 2)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hazard", [None, "nan", "absent", "inf", "ties"]
                         + BULYAN_HAZARDS)
@pytest.mark.parametrize("n", [3, 8, 11, 16, 33])
def test_cuda_masked_selection_kernels_match_plain(cuda_device, n, hazard,
                                                   dtype):
    """K12 with the selection kernels' orders on the imputed Gram (a ghost
    pick included), K14 at each theta a Bulyan step can give, a selected
    ghost included, also on a stack and mean offset by one element; masks
    of n - 2, one and no arrived rows."""
    f = 1 if n < 8 else 2
    for case in ("most", "one", "none"):
        m = mask_of(n, case, cuda_device)
        g = masked_hazard(stack(max(n, 8), 4099, 7, None, cuda_device,
                                torch.float32)[:n].contiguous(), m, hazard)
        g[:, ::5] = torch.round(g[:, ::5])
        g = bulyan_hazard(g, hazard).to(dtype)
        wn = m / torch.clamp_min(m.sum(), 1.0)
        mean = kernels.imputed_mean(g, wn)
        gr = kernels.masked_gram(g, m, wn, mean)
        ghost = torch.nonzero(m <= 0.5).flatten()[:1]
        hand = torch.full((n,), n, dtype=torch.int32, device=cuda_device)
        hand[ghost] = 0
        hand[torch.nonzero(m > 0.5).flatten()[:2]] = torch.tensor(
            [1, 2], dtype=torch.int32, device=cuda_device)[:int((m > 0.5)
                                                              .sum())]
        for order in (kernels.multi_krum_order(gr, f, min(3, n)),
                      kernels.iterative_order(gr, f, min(3, n)), hand):
            k = int((order < n).sum())
            for div in (None, k or None):
                assert_same(
                    kernels.masked_ordered_apply(order, g, m, mean, k,
                                                 div=div),
                    masked_ordered_apply_plain(order, g, m, mean, k, div))
        for theta in sorted({max(n - 2 * f, 1), n}):
            sel = (kernels.iterative_order(gr, f, theta) < theta).float()
            sel[ghost] = 1.0
            theta_s = int(sel.sum())
            for x, mx in ((g, mean), (offset_view(g), offset_view(mean))):
                assert_same(
                    kernels.masked_bulyan_coord(x, m, mx, sel, theta_s, f),
                    masked_bulyan_coord_plain(x, m, mx, sel, theta_s, f))
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hazard", HAZARDS + ["zeros", "absent",
                                             "subnormal"])
@pytest.mark.parametrize("n", [1, 3, 8, 11, 33, 64])
def test_cuda_sign_votes_match_plain(cuda_device, n, hazard, dtype):
    """K15 and K16 exact (NaN where the plain version has NaN); an absent
    row's NaN never shows in K16 (ROADMAP.md P10).  K15 also on a view
    offset by one element (rows not aligned for the vector loads),
    bitwise (the sign of a zero vote included) and repeated bit for
    bit."""
    own = hazard in ("zeros", "absent", "subnormal")
    g = stack(max(n, 8), 4099, 8, None if own else hazard, cuda_device,
              torch.float32)[:n].contiguous()
    if hazard == "zeros":
        g[:, ::2] = 0.0
        g[: n // 2, ::4] = -0.0
    elif hazard == "subnormal":
        g[:, ::3] *= 1e-40 if dtype == torch.float32 else 1e-39
    g = g.to(dtype)
    for x in (g, offset_by_one(g)):
        out = kernels.sign_vote(x)
        assert_bits(out, sign_vote_plain(x))
        assert_bits(out, kernels.sign_vote(x))
    for case in MASKS:
        m = mask_of(n, case, cuda_device)
        gm = masked_hazard(g.clone(), m, hazard)
        out = kernels.masked_sign_vote(gm, m, m)
        assert_same(out, masked_sign_vote_plain(gm, m, m))
        if hazard == "absent":
            assert torch.isfinite(out).all()
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_cuda_masked_compositions_count_their_launches(cuda_device):
    """Each masked composition launches its kernels once: the imputed mean
    (K4) and K6, then cge its masked apply (K7 under the CGE flag, K8
    folded in), multi_krum K9 K12, m_krum K10 K12, mda K12, bulyan K10
    K14; sign_sgd K16 (and K15 unmasked)."""
    g = torch.randn(11, 5000, device=cuda_device)
    m = torch.ones(11, device=cuda_device)
    m[[2, 7]] = 0.0
    wn = m / m.sum()
    imputed = ("weighted_sum", "masked_gram")
    want = {"cge": imputed + ("masked_cge_weighted_sum",),
            "multi_krum": imputed + ("multi_krum_order",
                                     "masked_ordered_apply"),
            "m_krum": imputed + ("iterative_order", "masked_ordered_apply"),
            "mda": imputed + ("masked_ordered_apply",),
            "bulyan": imputed + ("iterative_order", "masked_bulyan_coord"),
            "sign_sgd": ("masked_sign_vote",)}
    for rule, names in want.items():
        kernels.reset_launch_counts()
        kernels.kernel_masked_aggregate(rule, g, m, wn, 2)
        counts = kernels.launch_counts()
        assert counts == {k: int(k in names) for k in counts}, rule
    kernels.reset_launch_counts()
    kernels.kernel_aggregate("sign_sgd", g, 2)
    assert kernels.launch_counts()["sign_vote"] == 1


@pytest.mark.cuda
@pytest.mark.parametrize("qdt", ["int8", "float8_e4m3fn"])
@pytest.mark.parametrize("hazard", [None, "nan", "inf", "zeros",
                                    "signed_zero"])
@pytest.mark.parametrize("n", [1, 3, 8, 9, 12, 17, 33, 64])
def test_cuda_scaled_kernels_match_plain(cuda_device, n, hazard, qdt):
    """K18, K19 (masks of n - 2, 1, 0 and all arrived), K20 and K15 on the
    codes against their plain versions, on codes and scales from
    quantize_rows on the card (an inf row has scale inf; a zero row scale
    1; tiny negative values quantize to -0 fp8 codes beside +0 values),
    and K18 / K19 again on a view of the codes offset by one byte (rows
    not aligned for the vector loads)."""
    g = torch.randn((n, 4099), generator=torch.Generator().manual_seed(n))
    if hazard == "nan":
        g[1 % n, ::3] = math.nan
    elif hazard == "inf":
        g[0, ::4], g[0, 1::4] = math.inf, -math.inf
    elif hazard == "zeros":
        g[n - 1] = 0.0
    elif hazard == "signed_zero":
        g[1 % n, ::2], g[(2 % n), 1::2] = -1e-30, 0.0
    codes, qs = quantize_rows(g.to(cuda_device), qdt)
    wide = torch.zeros((n, 4100), dtype=torch.uint8, device=cuda_device)
    wide[:, 1:] = codes.view(torch.uint8)
    offset = wide[:, 1:].view(codes.dtype)
    b = min(2, (n - 1) // 2)
    for x in (codes, offset):
        for stat, bb in (("median", 0), ("trimmed_mean", b)):
            tol = 0 if stat == "median" else TOL
            torch.testing.assert_close(
                kernels.scaled_coord_stat(x, qs, stat, bb),
                scaled_coord_stat_plain(x, qs, stat, bb), rtol=tol,
                atol=tol, equal_nan=True)
            for case in MASKS:
                m = mask_of(n, case, cuda_device)
                torch.testing.assert_close(
                    kernels.scaled_masked_coord_stat(x, qs, m, m, stat, bb),
                    scaled_masked_coord_stat_plain(x, qs, m, m, stat, bb),
                    rtol=tol, atol=tol, equal_nan=True)
    for case in MASKS:
        m = mask_of(n, case, cuda_device)
        assert_same(kernels.scaled_masked_sign_vote(codes, qs, m, m),
                    scaled_masked_sign_vote_plain(codes, qs, m, m))
    assert_same(kernels.sign_vote(codes), sign_vote_plain(codes))
    torch.cuda.synchronize()


# the classes of row 0's scale that K20's fast path folds in (None,
# negative, overflowing the largest codes to +-inf) or hands to its exact
# law (inf, NaN, 0, tiny)
SIGN_SCALES = [None, "inf_scale", "nan_scale", "zero_scale", "tiny_scale",
               "neg_scale", "overflow"]
SIGN_NS = [1, 3, 8, 11, 33, 64]


def sign_codes(n, qdt, scale_class, device):
    """(codes, scale) of quantize_rows on the card, d = 4099: normal rows
    with +0 / -0 values every 5th column (fp8 -0 codes), fp8 NaN codes
    in row n - 1 every 7th column, and row 0's scale of ``scale_class``
    (``tiny_scale``: 2^-142, and for fp8 row 0's codes +-2^-9 and 0, so
    every product of the row rounds to +-0; ``overflow``: the largest
    codes of row 0 times its scale overflow to +-inf)."""
    g = torch.randn((n, 4099), generator=torch.Generator().manual_seed(n))
    g[:, ::5] = torch.where(g[:, ::5] < 0, -1e-30, 0.0)
    codes, qs = quantize_rows(g.to(device), qdt)
    fp8 = qdt == "float8_e4m3fn"
    raw = codes.view(torch.uint8)
    if fp8:
        raw[n - 1, 3::7] = 0x7f
    if scale_class == "inf_scale":
        qs[0] = math.inf
    elif scale_class == "nan_scale":
        qs[0] = math.nan
    elif scale_class == "zero_scale":
        qs[0] = 0.0
    elif scale_class == "neg_scale":
        qs[0] = -qs[0]
    elif scale_class == "tiny_scale":
        qs[0] = 2.0 ** -142
        if fp8:
            raw[0] = torch.where(g[0].to(device) < 0, 0x81, 0x01).to(
                torch.uint8)
            raw[0, 1::4] = 0
    elif scale_class == "overflow":
        qs[0] = 3.4028234663852886e38 / (340.0 if fp8 else 100.0)
        raw[0, ::3] = 0x7e if fp8 else 0x7f
        raw[0, 1::3] = 0xfe if fp8 else 0x81
    return codes, qs


@pytest.mark.cuda
@pytest.mark.parametrize("qdt", ["int8", "float8_e4m3fn"])
@pytest.mark.parametrize("scale_class", SIGN_SCALES)
@pytest.mark.parametrize("n", SIGN_NS)
def test_cuda_sign_votes_on_codes_match_plain_at_every_scale(
        cuda_device, n, scale_class, qdt):
    """K15 on the codes and K20 at every mask case, on aligned rows and on
    a view offset by one byte, bitwise equal to their plain versions (NaN
    to NaN) and to a repeat."""
    codes, qs = sign_codes(n, qdt, scale_class, cuda_device)
    for x in (codes, offset_by_one(codes)):
        out = kernels.sign_vote(x)
        assert_bits(out, sign_vote_plain(x))
        assert_bits(out, kernels.sign_vote(x))
        for case in MASKS:
            m = mask_of(n, case, cuda_device)
            out = kernels.scaled_masked_sign_vote(x, qs, m, m)
            assert_bits(out, scaled_masked_sign_vote_plain(x, qs, m, m))
            assert_bits(out, kernels.scaled_masked_sign_vote(x, qs, m, m))
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_cuda_scaled_rules_count_their_launches(cuda_device):
    """A quantized arena through the engine: K18 (median, trimmed), K15
    (sign_sgd) synchronous, K19 / K20 masked, once each; krum dequantizes
    and runs its own kernels."""
    from repro_torch.core.aggregators import make_spec
    codes, qs = quantize_rows(torch.randn(8, 5000, device=cuda_device),
                              "int8")
    m = torch.ones(8, dtype=torch.bool, device=cuda_device)
    m[[2, 7]] = False
    want = {"coordinate_median": ("scaled_coord_stat",
                                  "scaled_masked_coord_stat"),
            "trimmed_mean": ("scaled_coord_stat",
                             "scaled_masked_coord_stat"),
            "sign_sgd": ("sign_vote", "scaled_masked_sign_vote")}
    for rule, (sync_k, masked_k) in want.items():
        spec = make_spec(rule, f=F, n=8)
        for mask, name in ((None, sync_k), (m, masked_k)):
            kernels.reset_launch_counts()
            spec.aggregate_flat(codes, mask=mask, scale=qs)
            counts = kernels.launch_counts()
            assert counts == {k: int(k == name) for k in counts}, rule
    kernels.reset_launch_counts()
    make_spec("krum", f=F, n=8).aggregate_flat(codes, scale=qs)
    counts = kernels.launch_counts()
    assert counts["gram"] == counts["krum_select"] == 1
    assert counts["scaled_coord_stat"] == 0


def sparse(g, seed):
    """Half the values of ``g`` set to 0 (not sent), columns 0-6 by every
    row (nobody sent them), -0.0 in every 9th column of the zeros."""
    keep = torch.rand(g.shape, generator=torch.Generator().manual_seed(seed))
    g = torch.where(keep.to(g.device) < 0.5, torch.zeros((), device=g.device),
                    g)
    g[:, :7] = 0.0
    g[:, 9::9] = torch.where(g[:, 9::9] == 0, -0.0, g[:, 9::9])
    return g


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hazard", HAZARDS)
@pytest.mark.parametrize("n", [1, 8, 9, 33])
def test_cuda_sparse_mean_kernel_matches_plain(cuda_device, n, hazard,
                                               dtype):
    """K17 at every mask case, unit and raw staleness weights (a live row
    of weight 0 carrying NaN among them): exact, NaN where the plain
    version has it."""
    g = stack(max(n, 6), 4099, 3, hazard, cuda_device, torch.float32)[:n]
    g = sparse(g, n).to(dtype)
    for case in MASKS:
        m = mask_of(n, case, cuda_device)
        w = m * torch.tensor([1.0, 0.5, 1.0 / 3.0],
                             device=cuda_device).repeat(n)[:n]
        for wt in (m, w):
            ours = kernels.sparse_masked_weighted_mean(g, m, wt)
            assert_same(ours, sparse_masked_weighted_mean_plain(g, m, wt))
            assert not bool(ours[:7].any())
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("qdt", ["int8", "float8_e4m3fn"])
@pytest.mark.parametrize("hazard", [None, "nan", "inf", "zeros"])
@pytest.mark.parametrize("n", [1, 3, 8, 9, 12, 17, 64])
def test_cuda_scaled_sparse_mean_kernel_matches_plain(cuda_device, n,
                                                      hazard, qdt):
    """K21 on codes, exact, at every mask case with unit weights, raw
    staleness weights and a zero weight on a live row, and again on a
    view of the codes offset by one byte (rows not aligned for the vector
    loads); a live inf row (scale inf) of non-zero weight makes every
    column NaN (its 0 codes decode to 0 * inf)."""
    g = sparse(torch.randn((n, 4099),
                           generator=torch.Generator().manual_seed(n)), n)
    if hazard == "nan":
        g[1 % n, ::3] = math.nan
    elif hazard == "inf":
        g[0, 8::4], g[0, 9::4] = math.inf, -math.inf
    elif hazard == "zeros":
        g[n - 1] = 0.0
    codes, qs = quantize_rows(g.to(cuda_device), qdt)
    wide = torch.zeros((n, 4100), dtype=torch.uint8, device=cuda_device)
    wide[:, 1:] = codes.view(torch.uint8)
    offset = wide[:, 1:].view(codes.dtype)
    for case in MASKS:
        m = mask_of(n, case, cuda_device)
        raw = m * torch.tensor([1.0, 0.5, 1.0 / 3.0],
                               device=cuda_device).repeat(n)[:n]
        zero = raw.clone()
        zero[torch.nonzero(m > 0.5).flatten()[-1:]] = 0.0
        for w in (m, raw, zero):
            for x in (codes, offset):
                ours = kernels.scaled_sparse_masked_weighted_mean(x, qs, m, w)
                assert_same(ours, scaled_sparse_masked_weighted_mean_plain(
                    x, qs, m, w))
                if hazard == "inf" and float(w[0]) > 0:
                    assert bool(torch.isnan(ours).all())
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hazard", HAZARDS)
@pytest.mark.parametrize("n", [1, 3, 8, 11, 33, 64])
def test_cuda_coord_sort_matches_plain(cuda_device, n, hazard, dtype):
    g = stack(max(n, 6), 4099, 5, hazard, cuda_device, dtype)[:n]
    assert_same(kernels.coord_sort(g), coord_sort_plain(g))
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_cuda_sparse_mean_and_ops_count_their_launches(cuda_device):
    """sparse_mean through the engine: K17 synchronous and masked, K21 on
    a quantized arena, once each and nothing else; the ops sort paths
    launch K23 (and K2 for the distances)."""
    from repro_torch.core.aggregators import make_spec
    g = torch.randn(8, 5000, device=cuda_device)
    codes, qs = quantize_rows(g, "int8")
    m = torch.ones(8, dtype=torch.bool, device=cuda_device)
    m[[2, 7]] = False
    spec = make_spec("sparse_mean", f=F, n=8)
    for args, name in (((g,), "sparse_masked_weighted_mean"),
                       ((g, m, m.float() * 0.5),
                        "sparse_masked_weighted_mean"),
                       ((codes, None, None, None, qs),
                        "scaled_sparse_masked_weighted_mean"),
                       ((codes, m, None, None, qs),
                        "scaled_sparse_masked_weighted_mean")):
        kernels.reset_launch_counts()
        spec.aggregate_flat(*args)
        counts = kernels.launch_counts()
        assert counts == {k: int(k == name) for k in counts}
    kernels.reset_launch_counts()
    kernels.kernel_coordinate_median(g)
    kernels.kernel_trimmed_mean(g, 2)
    kernels.kernel_pairwise_sq_dists(g)
    counts = kernels.launch_counts()
    assert counts == {k: {"coord_sort": 2, "gram": 1}.get(k, 0)
                      for k in counts}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", ["live", "dead_nonfinite", "all_zero",
                                  "sum_one"])
@pytest.mark.parametrize("n,d", [(1, 1), (3, 4099), (8, 4099), (64, 37)])
def test_cuda_clipped_weighted_sum_matches_plain(cuda_device, n, d, case,
                                                 dtype):
    """K22 against its plain version, bit for bit: a row with lam = 0 is
    never read (its inf / NaN stays out), all lam = 0 returns v, and sum
    lam = 1 drops the center's term to 0 * v."""
    gen = torch.Generator().manual_seed(n * 131 + d)
    g = torch.randn((n, d), generator=gen) * 2.0
    lam = torch.rand(n, generator=gen) / n
    if case == "dead_nonfinite":
        lam[::2] = 0.0
        g[::2, ::3] = math.inf
        g[::2, 1::3] = math.nan
    elif case == "all_zero":
        lam.zero_()
    elif case == "sum_one":
        lam.fill_(1.0 / n)
    v = torch.randn(d, generator=gen)
    g, lam, v = g.to(cuda_device, dtype), lam.to(cuda_device), v.to(
        cuda_device)
    out = kernels.clipped_weighted_sum(lam, g, v)
    assert_same(out, clipped_weighted_sum_plain(lam, g, v))
    assert bool(torch.isfinite(out).all())
    if case == "all_zero":
        assert torch.equal(out, v)
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_cuda_centered_clip_counts_its_launches(cuda_device):
    """centered_clip's kernel impl launches K22 once per iteration and
    nothing else (masked and on int8 codes too); ``auto`` launches none."""
    from repro_torch.core.aggregators import make_spec
    g = torch.randn(8, 5000, device=cuda_device)
    codes, qs = quantize_rows(g, "int8")
    m = torch.ones(8, dtype=torch.bool, device=cuda_device)
    m[[2, 7]] = False
    st = {"server_grad": torch.zeros(5000, device=cuda_device)}
    for impl, want in (("kernel", 5), ("auto", 0)):
        spec = make_spec("centered_clip", f=F, n=8, impl=impl)
        for stack, kw in ((g, {}), (g, dict(mask=m, weights=m * 0.5)),
                          (codes, dict(mask=m, scale=qs))):
            kernels.reset_launch_counts()
            spec.aggregate_flat(stack, state=st, **kw)
            counts = kernels.launch_counts()
            assert counts == {k: want * (k == "clipped_weighted_sum")
                              for k in counts}, (impl, sorted(kw))



# ---------------------------------------------------------------------------
# the coded decode (gradient coding): the vote on K2, the winners on K7


def coded_rows(n, r, d, hazard, dtype, offset, device, gen):
    """(n, d) rows of ``dtype`` on the card: each group's rows equal
    copies of its true row (ragged tables where r does not divide n), the
    first row of every group of three or more Byzantine (1e4 everywhere,
    or +inf / -inf / NaN), held at a one-element offset in rows of d + 1
    when ``offset``."""
    from repro_torch.core.redundancy.coding import coding_groups
    groups = coding_groups(n, r, allow_ragged=True)
    k = int(groups.max()) + 1
    true = torch.randn((k, d), generator=gen, device=device)
    x = true[torch.as_tensor(groups.copy(), device=device)].clone()
    for grp in range(k):
        slots = (groups == grp).nonzero()[0]
        if len(slots) >= 3:
            x[int(slots[0])] = {None: 1e4, "inf": math.inf,
                                "-inf": -math.inf, "nan": math.nan}[hazard]
    x = x.to(dtype)
    if offset:
        big = torch.zeros((n, d + 1), dtype=dtype, device=device)
        big[:, 1:] = x
        x = big[:, 1:]
    return x, groups


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("offset", [False, True])
@pytest.mark.parametrize("hazard", [None, "inf", "-inf", "nan"])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("n,r", [(4, 2), (4, 3), (8, 3), (8, 4), (12, 2),
                                 (12, 3), (12, 4)])
def test_cuda_coded_decode_matches_plain(cuda_device, n, r, masked, hazard,
                                         offset, dtype):
    """flat_draco_aggregate on K2 + K7 against the plain Gram and the
    plain masked weighted sum on the same rows: the same decode weights,
    the aggregate exact and finite (a rejected +-inf / NaN row is never
    read), and a repeat bit for bit."""
    from repro_torch.core.redundancy.coding import (coded_vote_weights,
                                                    flat_draco_aggregate)
    gen = torch.Generator(device=cuda_device).manual_seed(n * 10 + r)
    x, groups = coded_rows(n, r, 4099, hazard, dtype, offset, cuda_device,
                           gen)
    mask = None
    if masked:
        mask = torch.ones(n, dtype=torch.bool, device=cuda_device)
        mask[n - 1] = False
    before = (kernels.gram.launches, kernels.masked_weighted_sum.launches)
    out = flat_draco_aggregate(x, r, mask=mask, groups=groups)
    assert (kernels.gram.launches - before[0],
            kernels.masked_weighted_sum.launches - before[1]) == (1, 1)
    w = coded_vote_weights(gram_plain(x), r, mask=mask, groups=groups)
    assert torch.equal(coded_vote_weights(kernels.gram(x), r, mask=mask,
                                          groups=groups), w)
    m = (torch.ones(n, device=cuda_device) if mask is None
         else mask.float())
    ref = masked_weighted_sum_plain(w, x, m, torch.zeros(
        (x.shape[1],), dtype=dtype, device=cuda_device))
    assert torch.isfinite(out).all()
    assert torch.equal(out, ref)
    assert torch.equal(flat_draco_aggregate(x, r, mask=mask, groups=groups),
                       out)
