"""ROADMAP.md P12: exact ties between bitwise-equal rows.

sign_flip sends the same vector from every Byzantine agent, so their rows
are bitwise equal and, where gradient noise dominates the honest mean,
they are each other's nearest neighbours: their Krum scores tie exactly
and a selection picks among them.  The kernel path (K2's Gram) gives equal
rows equal entries and breaks the tie by first index, as the JAX kernel
does.  The gather law's distances (``dense.pairwise_sq_dists``) are one
fixed-order dot per pair, so they depend only on the rows' values, not on
where the rows sit in memory: equal rows get bitwise-equal distances, and
the gather path breaks the tie the same way.  Held here at n = 11 with two
and three equal rows, on a stack whose rows start at unaligned offsets.
"""
import math

import numpy as np
import pytest
import torch

from repro_torch import kernels
from repro_torch.core.attacks import get_attack, make_byzantine_mask
from repro_torch.core.filters import dense as D

torch.set_num_threads(2)
N, F, DIM = 11, 2, 4099


def flipped_stack(nbyz, seed):
    """(N, DIM) fp32: honest rows of noise around a small mean, the first
    ``nbyz`` rows sign_flip's -mean (bitwise equal), held in a wider
    buffer at an odd offset so each row starts at another alignment."""
    rng = np.random.default_rng(seed)
    g = torch.from_numpy((rng.normal(size=(N, DIM)) * 1e-3 + 2e-5).astype(
        np.float32))
    g = get_attack("sign_flip")(None, g, make_byzantine_mask(N, nbyz))
    big = torch.zeros((N, DIM + 3))
    big[:, 1:DIM + 1] = g
    return big[:, 1:DIM + 1]


def gather_order(d2, k):
    """The gather law's iterative Krum pick order (m-Krum / Bulyan stage
    1): the first k picks."""
    mask = torch.ones((N,), dtype=torch.bool)
    picks = []
    for it in range(k):
        s = D.krum_scores(d2, F, mask=mask, k=max(N - it - F - 2, 1))
        i = int(D.argmin_tiebreak(s, D.masked_row_sums(d2, mask)))
        picks.append(i)
        mask[i] = False
    return picks


@pytest.mark.parametrize("nbyz", [2, 3])
def test_equal_rows_get_equal_distances_and_picks(nbyz):
    x = flipped_stack(nbyz, seed=nbyz)
    assert all(torch.equal(x[i], x[0]) for i in range(nbyz))
    d2 = D.pairwise_sq_dists(x)
    for i in range(1, nbyz):
        assert float(d2[0, i]) == 0.0
        assert torch.equal(d2[i, nbyz:], d2[0, nbyz:])
        assert torch.equal(d2[nbyz:, i], d2[nbyz:, 0])
    assert torch.equal(d2, d2.T)
    # the equal rows are the closest: their scores tie exactly, and both
    # paths take the first of them
    s = D.krum_scores(d2, F)
    assert int(torch.argmin(s)) == 0 and float(s[1]) == float(s[0])
    assert torch.equal(D.krum(x, F), x[0])
    gr = kernels.gram(x)
    assert int(torch.argmax(kernels.krum_select(gr, F))) == 0
    # Bulyan's theta = N - 2F picks: the same order on both paths
    theta = N - 2 * F
    order = kernels.iterative_order(gr, F, theta).long()
    kernel_picks = [int(i) for i in torch.argsort(order)[:theta]]
    assert kernel_picks == gather_order(d2, theta)
    assert kernel_picks[:nbyz] == list(range(nbyz))
    np.testing.assert_array_equal(D.bulyan(x, F).numpy(),
                                  kernels.kernel_bulyan(x, F).numpy())


def test_pairwise_sq_dists_is_the_gram_law():
    """The pair dots stay within the fp32 bar of the exact Gram law (fp64
    on the same rows), relative to the Cauchy-Schwarz scale."""
    x = flipped_stack(2, seed=7)
    d2 = D.pairwise_sq_dists(x).double()
    xd = x.double()
    sq = (xd * xd).sum(1)
    exact = (sq[:, None] + sq[None, :] - 2 * xd @ xd.T).clamp_min(0)
    exact.fill_diagonal_(0)
    scale = sq[:, None] + sq[None, :]
    assert float(((d2 - exact).abs() / scale).max()) <= 3e-6
    assert not math.isnan(float(d2.sum()))
