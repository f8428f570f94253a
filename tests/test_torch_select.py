"""The selection family's kernel modules (K8-K11, K13) against the JAX
package's Pallas kernels, run in interpret mode as the JAX suite runs
them.  On the CPU each wrapper runs its plain PyTorch version, which is
what is held here; tests/test_torch_cuda.py holds the CUDA kernels to
these plain versions on the card.

Bars: the selections (K8's keep-mask, K9's and K10's pick orders) exact,
fed the SAME fp32 Gram on both sides; K11 exact without a division and
rtol = atol = 3e-6 with one (the reference multiplies by the reciprocal
of its constant divisor, the port divides); K13 exact where beta = 1, else
3e-6 for the same reason.  JAX needs d a multiple of its 512-lane tile, so
the stack is padded on the JAX side only.
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ops import _pad_d
from repro.kernels.pairwise import gram as jax_gram
from repro.kernels.select import bulyan_coord as jax_bulyan_coord
from repro.kernels.select import cge_select as jax_cge_select
from repro.kernels.select import iterative_order as jax_iterative_order
from repro.kernels.select import multi_krum_order as jax_multi_krum_order
from repro.kernels.wsum import ordered_apply as jax_ordered_apply
from repro_torch import kernels
from repro_torch.kernels.select import bulyan_beta

torch.set_num_threads(2)
TOL = 3e-6
F = 2
NS = [8, 9, 11, 12, 16]
# ties: rows 0-2 equal (all their distances 0: exact score ties); dup:
# every row equal (every score, norm and distance tied); the others as in
# tests/test_torch_kernels.py
HAZARDS = [None, "nan", "inf", "ties", "dup", "spots"]


def stack(n, d, seed, hazard=None):
    g = (np.random.default_rng(seed).normal(size=(n, d)) * 2.0).astype(
        np.float32)
    if hazard == "nan":
        g[1] = np.nan
    elif hazard == "inf":
        g[1] = np.inf
        g[4] = -np.inf
    elif hazard == "ties":
        g[1] = g[0]
        g[2] = g[0]
    elif hazard == "dup":
        g[:] = g[0]
    elif hazard == "spots":
        g[1, 7] = np.nan
        g[3, 7] = np.inf
        g[5, 11] = -np.inf
    return g


def same_gram(g):
    """One fp32 Gram for both packages (the JAX kernel's, in interpret
    mode): the selections are compared on identical inputs."""
    gp, _ = _pad_d(jnp.asarray(g))
    gr = jax_gram(gp, interpret=True)
    return gr, torch.from_numpy(np.array(gr))


# ---------------------------------------------------------------------------
# K8, K9, K10 on the (n, n) Gram


@pytest.mark.parametrize("hazard", HAZARDS)
@pytest.mark.parametrize("n", NS)
def test_selection_kernels_plain_match_jax(n, hazard):
    gj, gt = same_gram(stack(n, 300, seed=7 * n, hazard=hazard))
    for n_keep in (n - F, 1):
        ref = np.asarray(jax_cge_select(gj, n_keep, interpret=True))
        ours = kernels.cge_select(gt, n_keep).numpy()
        np.testing.assert_array_equal(ours, ref, err_msg=f"cge {n_keep}")
        assert ours.sum() == n_keep
    for m in (2, 3):
        ref = np.asarray(jax_multi_krum_order(gj, F, m, interpret=True))
        ours = kernels.multi_krum_order(gt, F, m).numpy()
        np.testing.assert_array_equal(ours, ref, err_msg=f"multi_krum {m}")
        assert ours.dtype == np.int32
    theta = n - 2 * F
    for k_total in sorted({3, theta}):
        ref = np.asarray(jax_iterative_order(gj, F, k_total,
                                             interpret=True))
        ours = kernels.iterative_order(gt, F, k_total).numpy()
        np.testing.assert_array_equal(ours, ref,
                                      err_msg=f"iterative {k_total}")
        assert sorted(ours[ours < n]) == list(range(k_total))


@pytest.mark.parametrize("hazard", [None, "ties"])
def test_iterative_order_plain_matches_jax_at_n33(hazard):
    """n = 33, m_krum's 3 picks: past one warp of rows, where the card's
    kernel combines two warps' keys each round.  The Gram is the fp32
    rounding of the exact one (bitwise symmetric), fed to both sides."""
    g = stack(33, 64, seed=33, hazard=hazard).astype(np.float64)
    gr = (g @ g.T).astype(np.float32)
    ref = np.asarray(jax_iterative_order(jnp.asarray(gr), F, 3,
                                         interpret=True))
    ours = kernels.iterative_order(torch.from_numpy(gr), F, 3).numpy()
    np.testing.assert_array_equal(ours, ref)
    assert sorted(ours[ours < 33]) == [0, 1, 2]


def test_iterative_order_breaks_the_pair_tie_by_the_secondary():
    """With one neighbour left the closest pair share one distance, so
    their primary scores are bitwise equal; the full-degree secondary
    (not the row index) decides, on both sides: here rounds 3-6 (k = 1)
    tie rows 0/1, 0/2, 0/6 and 5/6, and the secondary picks 1, 2, 6 and
    5."""
    n = 8
    g = stack(n, 300, seed=3)
    g[6] = g[7] + 1e-3
    g[7] = g[7] + 0.5 * g[0]
    gj, gt = same_gram(g)
    assert torch.equal(gt, gt.T)
    ref = np.asarray(jax_iterative_order(gj, F, n, interpret=True))
    ours = kernels.iterative_order(gt, F, n).numpy()
    np.testing.assert_array_equal(ours, ref)
    np.testing.assert_array_equal(ours, [5, 3, 4, 2, 1, 6, 7, 0])


def test_iterative_order_picks_candidates_in_an_all_inf_round():
    """A NaN-poisoned Gram makes every distance +inf: each round still
    picks a remaining candidate (never a removed row), by first index."""
    gr = torch.full((6, 6), math.nan)
    ours = kernels.iterative_order(gr, 1, 6).numpy()
    np.testing.assert_array_equal(ours, np.arange(6, dtype=np.int32))
    ref = np.asarray(jax_iterative_order(jnp.asarray(gr.numpy()), 1, 6,
                                         interpret=True))
    np.testing.assert_array_equal(ours, ref)


def test_cge_orders_a_nan_norm_last():
    """max(NaN, 0) stays NaN (CUDA's fmaxf would give 0 and keep the
    hostile row first); the rank puts it last."""
    gr = torch.eye(4) * torch.tensor([4.0, math.nan, 1.0, 9.0])
    np.testing.assert_array_equal(kernels.cge_select(gr, 3).numpy(),
                                  [1.0, 0.0, 1.0, 1.0])
    ref = jax_cge_select(jnp.asarray(gr.numpy()), 3, interpret=True)
    np.testing.assert_array_equal(np.asarray(ref), [1.0, 0.0, 1.0, 1.0])


# ---------------------------------------------------------------------------
# K11 ordered_apply


def jax_padded(g):
    gp, d = _pad_d(jnp.asarray(g))
    return gp, d


@pytest.mark.parametrize("hazard", [None, "inf", "nan"])
@pytest.mark.parametrize("n,k", [(8, 3), (8, 6), (11, 7), (16, 16)])
def test_ordered_apply_plain_matches_jax(n, k, hazard):
    """Exact without a division (in pick order, a stacked and a chained
    sum alike), 3e-6 with one; an +-inf or NaN row that is not picked
    never shows."""
    g = stack(n, 771, seed=n + k, hazard=hazard)
    order = np.full(n, n, np.int32)
    rows = np.random.default_rng(k).permutation(n)
    rows = [r for r in rows if hazard is None or r not in (1, 4)][:k]
    order[rows] = np.arange(len(rows), dtype=np.int32)
    gp, d = jax_padded(g)
    ours_t = torch.from_numpy(order)
    for chain in (False, True):
        ref = np.asarray(jax_ordered_apply(jnp.asarray(order), gp, k,
                                           chain=chain,
                                           interpret=True))[:d]
        ours = kernels.ordered_apply(ours_t, torch.from_numpy(g), k).numpy()
        np.testing.assert_array_equal(ours, ref, err_msg=f"chain={chain}")
        ref = np.asarray(jax_ordered_apply(jnp.asarray(order), gp, k,
                                           chain=chain, div=k,
                                           true_div=chain,
                                           interpret=True))[:d]
        ours = kernels.ordered_apply(ours_t, torch.from_numpy(g), k,
                                     div=k).numpy()
        np.testing.assert_allclose(ours, ref, rtol=TOL, atol=TOL)
        assert np.isfinite(ours).all()


def test_ordered_apply_reads_bf16_like_its_fp32_upcast():
    g = torch.from_numpy(stack(8, 515, seed=2)).to(torch.bfloat16)
    order = torch.tensor([2, 8, 0, 8, 1, 8, 8, 8], dtype=torch.int32)
    assert torch.equal(kernels.ordered_apply(order, g, 3, div=3),
                       kernels.ordered_apply(order, g.float(), 3, div=3))


# ---------------------------------------------------------------------------
# K13 bulyan_coord


def bulyan_stack(n, d, seed, hazard):
    """Selected rows with +-inf / NaN values, equidistant values around
    the median, NaN in one selected coordinate, +-0 on most rows every
    5th column (a +-0 median), or +-3e38 / +-1e38 / 2e38 every 3rd column
    (|x - med| overflows to +inf: the all-inf rounds take row 0)."""
    g = stack(n, d, seed)
    rng = np.random.default_rng(seed + 1)
    if hazard == "signed_zero":
        z = g[: n // 2 + 1, ::5]
        z[:] = np.where(rng.random(z.shape) < 0.5, 0.0, -0.0)
    elif hazard == "overflow":
        cols = g[:, ::3]
        cols[:] = rng.choice(np.float32([3e38, -3e38, 1e38, -1e38, 2e38]),
                             size=cols.shape)
    elif hazard == "inf":
        g[0, ::3] = np.inf
        g[2, ::3] = -np.inf
    elif hazard == "nan":
        g[3] = np.nan
    elif hazard == "spot":
        g[2, 5] = np.nan
        g[4, 9] = np.inf
    elif hazard == "equidistant":
        g[:, ::2] = np.round(g[:, ::2])          # |x - med| ties by value
        g[1, 1::4] = g[0, 1::4]
    return g


@pytest.mark.parametrize("hazard", [None, "inf", "nan", "spot",
                                    "equidistant", "signed_zero",
                                    "overflow"])
@pytest.mark.parametrize("n,f", [(8, 2), (11, 2), (12, 1), (16, 3)])
def test_bulyan_coord_plain_matches_jax(n, f, hazard):
    theta = n - 2 * f
    g = bulyan_stack(n, 771, seed=n * 10 + f, hazard=hazard)
    rows = np.random.default_rng(n).permutation(n)[:theta]
    sel = np.zeros(n, np.float32)
    sel[rows] = 1.0
    gp, d = jax_padded(g)
    ref = np.asarray(jax_bulyan_coord(gp, jnp.asarray(sel), theta, f,
                                      interpret=True))[:d]
    ours = kernels.bulyan_coord(torch.from_numpy(g), torch.from_numpy(sel),
                                theta, f).numpy()
    if bulyan_beta(theta, f) == 1:
        np.testing.assert_array_equal(ours, ref)
    else:
        np.testing.assert_allclose(ours, ref, rtol=TOL, atol=TOL,
                                   equal_nan=True)


def test_bulyan_coord_nan_round_adds_nothing():
    """A NaN in a selected coordinate makes the reference's minimum NaN:
    no row is first, that round extracts nothing and adds 0 (not the
    gather law's top-k)."""
    g = np.array([[1.0, 5.0], [2.0, 6.0], [np.nan, 7.0], [4.0, 8.0],
                  [100.0, 100.0]], np.float32)
    sel = np.array([1, 1, 1, 1, 0], np.float32)
    ours = kernels.bulyan_coord(torch.from_numpy(g), torch.from_numpy(sel),
                                4, 0).numpy()
    gp, d = jax_padded(g)
    ref = np.asarray(jax_bulyan_coord(gp, jnp.asarray(sel), 4, 0,
                                      interpret=True))[:d]
    np.testing.assert_allclose(ours, ref, rtol=TOL, atol=TOL,
                               equal_nan=True)
    assert ours[1] == np.float32(26.0) / np.float32(4.0)


# ---------------------------------------------------------------------------
# the wrappers refuse what the kernels cannot take


def test_selection_wrappers_reject_bad_shapes():
    gr = torch.eye(4)
    with pytest.raises(ValueError):
        kernels.cge_select(torch.eye(65), 3)
    with pytest.raises(ValueError):
        kernels.cge_select(gr, 5)
    with pytest.raises(ValueError):
        kernels.multi_krum_order(gr, 1, 5)
    with pytest.raises(ValueError):
        kernels.iterative_order(gr[:3], 1, 2)
    with pytest.raises(ValueError):
        kernels.ordered_apply(torch.zeros(4, dtype=torch.int32),
                              torch.zeros(4, 8), 5)
    with pytest.raises(ValueError):
        kernels.ordered_apply(torch.zeros(4, dtype=torch.int32),
                              torch.zeros(4, 8), 2, div=0)
    with pytest.raises(ValueError):
        kernels.bulyan_coord(torch.zeros(4, 8), torch.ones(4), 5, 0)
    with pytest.raises(ValueError):
        kernels.bulyan_coord(torch.zeros(4, 8), torch.ones(3), 2, 1)


def test_bulyan_beta_one_pick_turns_on_the_last_bit():
    """ROADMAP.md P8: at theta = 4, beta = 1 the coordinate stage keeps
    whichever of the two middle values rounds closer to their midpoint.
    Moving one selected row by one ulp flips that pick in some
    coordinates by the full gap between the two values — in the JAX
    kernel and the port alike (both exact on each input)."""
    n, f, theta = 8, 2, 4
    g = stack(n, 4096, seed=8)
    sel = np.zeros(n, np.float32)
    sel[:theta] = 1.0
    g2 = g.copy()
    g2[0] = np.nextafter(g2[0], np.float32(np.inf))
    outs = []
    for x in (g, g2):
        gp, d = jax_padded(x)
        ref = np.asarray(jax_bulyan_coord(gp, jnp.asarray(sel), theta, f,
                                          interpret=True))[:d]
        ours = kernels.bulyan_coord(torch.from_numpy(x),
                                    torch.from_numpy(sel), theta, f).numpy()
        np.testing.assert_array_equal(ours, ref)
        outs.append(ours)
    jumps = np.abs(outs[0] - outs[1]) > 1e-3
    assert jumps.any()
