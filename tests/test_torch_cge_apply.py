"""CGE's apply (K4's and K7's kernels under their CGE flag, K8 folded in:
``kernels.cge_weighted_sum`` / ``masked_cge_weighted_sum``) and the CGE
compositions that launch it, against the JAX package's ``kernel_cge`` /
``kernel_cge_masked`` (Pallas in interpret mode, as the JAX suite runs
it).  On the CPU the wrappers run their plain versions, which is what is
held here; tests/test_torch_cuda.py holds the kernel to them on the card.

Bars: the kept set exact (each side's K8 on its own Gram); the aggregate
within rtol = atol = 3e-6 (JAX applies the mask with one MXU dot, whose
sum is associated differently); the port's fused apply bitwise equal to
the chain it replaces, K8 -> K4 (K7) -> ``/ (n - f)``.  n = 4, 8, 11;
d = 300, not a multiple of JAX's 512-lane tile (padded on the JAX side
only); a NaN row (a NaN norm, ordered last), a +inf row, three equal
rows and (sync) every row equal (norm ties, first index wins); masks with
two absent rows, whose imputed rows (the mean, the least norm) are kept.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ops import _pad_d
from repro.kernels.ops import kernel_cge as jax_kernel_cge
from repro.kernels.ops import kernel_cge_masked as jax_kernel_cge_masked
from repro.kernels.pairwise import gram as jax_gram
from repro.kernels.pairwise import imputed_mean as jax_imputed_mean
from repro.kernels.pairwise import masked_gram as jax_masked_gram
from repro.kernels.select import cge_select as jax_cge_select
from repro_torch import kernels
from repro_torch.kernels.wsum import (cge_weighted_sum_plain,
                                      masked_cge_weighted_sum_plain)

torch.set_num_threads(2)
TOL = 3e-6
D = 300
HAZARDS = [None, "nan", "inf", "ties", "dup"]


def f_of(n):
    return 1 if n < 8 else 2


def stack(n, seed, hazard):
    g = (np.random.default_rng(seed).normal(size=(n, D)) * 2.0).astype(
        np.float32)
    if hazard == "nan":
        g[1] = np.nan
    elif hazard == "inf":
        g[1] = np.inf
    elif hazard == "ties":
        g[1] = g[0]
        g[2] = g[0]
    elif hazard == "dup":
        g[:] = g[0]
    return g


def mask_of(n):
    """Two absent rows (the last two), staleness-like weights on the
    rest."""
    m = np.ones(n, np.float32)
    m[[n - 2, n - 1]] = 0.0
    w = m * np.array([1.0, 0.5, 1.0 / 3.0] * n, np.float32)[:n]
    return m, (w / np.float32(w.sum())).astype(np.float32)


def assert_agg(ours, ref):
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=TOL,
                               atol=TOL, equal_nan=True)


@pytest.mark.parametrize("normalize", [True, False])
@pytest.mark.parametrize("hazard", HAZARDS)
@pytest.mark.parametrize("n", [4, 8, 11])
def test_cge_apply_plain_matches_jax(n, hazard, normalize):
    f = f_of(n)
    g = stack(n, 5 * n, hazard)
    gt = torch.from_numpy(g)
    gp, _ = _pad_d(jnp.asarray(g))
    keep_ref = np.asarray(jax_cge_select(jax_gram(gp, interpret=True), n - f,
                                         interpret=True))
    gr = kernels.gram(gt)
    np.testing.assert_array_equal(kernels.cge_select(gr, n - f).numpy(),
                                  keep_ref)
    div = n - f if normalize else None
    out = kernels.cge_weighted_sum(gr, gt, n - f, div=div)
    assert_agg(out, jax_kernel_cge(jnp.asarray(g), f, normalize))
    # the chain the apply replaces, as the port ran it on the CPU
    chain = kernels.weighted_sum(kernels.cge_select(gr, n - f), gt)
    chain = chain / (n - f) if normalize else chain
    assert torch.equal(out.isnan(), chain.isnan())
    assert torch.equal(out.nan_to_num(), chain.nan_to_num())
    assert torch.equal(kernels.kernel_cge(gt, f, normalize).nan_to_num(),
                       out.nan_to_num())


# every row equal would tie the live norms with the ghosts' (the imputed
# mean, rounded differently by the two packages): kept out of the masked
# cases, which tie three live rows instead
@pytest.mark.parametrize("normalize", [True, False])
@pytest.mark.parametrize("hazard", HAZARDS[:-1])
@pytest.mark.parametrize("n", [4, 8, 11])
def test_masked_cge_apply_plain_matches_jax(n, hazard, normalize):
    f = f_of(n)
    g = stack(n, 7 * n, hazard)
    m, wn = mask_of(n)
    gt, mt, wt = (torch.from_numpy(a) for a in (g, m, wn))
    gp, _ = _pad_d(jnp.asarray(g))
    mean_j = jax_imputed_mean(gp, jnp.asarray(wn))
    keep_ref = np.asarray(jax_cge_select(
        jax_masked_gram(gp, jnp.asarray(m), jnp.asarray(wn), mean_j,
                        interpret=True), n - f, interpret=True))
    mean = kernels.imputed_mean(gt, wt)
    gr = kernels.masked_gram(gt, mt, wt, mean)
    keep = kernels.cge_select(gr, n - f)
    np.testing.assert_array_equal(keep.numpy(), keep_ref)
    if hazard is None:                      # the ghosts: the least norms
        assert float(keep[n - 2]) == 1.0 and float(keep[n - 1]) == 1.0
    div = n - f if normalize else None
    out = kernels.masked_cge_weighted_sum(gr, gt, mt, mean, n - f, div=div)
    assert_agg(out, jax_kernel_cge_masked(jnp.asarray(g), jnp.asarray(m),
                                          jnp.asarray(wn), f, normalize))
    chain = kernels.masked_weighted_sum(keep, gt, mt, mean)
    chain = chain / (n - f) if normalize else chain
    assert torch.equal(out.isnan(), chain.isnan())
    assert torch.equal(out.nan_to_num(), chain.nan_to_num())
    assert torch.equal(
        kernels.kernel_cge_masked(gt, mt, wt, f, normalize).nan_to_num(),
        out.nan_to_num())


def test_cge_apply_checks_its_inputs():
    g = torch.randn(6, 40)
    gr = kernels.gram(g)
    with pytest.raises(ValueError):
        kernels.cge_weighted_sum(gr, g[:5], 4)           # rows != n
    with pytest.raises(ValueError):
        kernels.cge_weighted_sum(gr, g, 7)               # n_keep > n
    with pytest.raises(ValueError):
        kernels.cge_weighted_sum(gr, g, 4, div=0.0)
    with pytest.raises(ValueError):
        kernels.cge_weighted_sum(gr[:, :5], g, 4)        # not square
    m = torch.ones(6)
    with pytest.raises(ValueError):
        kernels.masked_cge_weighted_sum(gr, g, m[:5], g[0], 4)
    with pytest.raises(ValueError):
        kernels.masked_cge_weighted_sum(gr, g, m, g[0].double(), 4)
    assert kernels.launch_counts()["cge_weighted_sum"] == 0   # plain only
    np.testing.assert_array_equal(
        cge_weighted_sum_plain(gr, g, 6, div=6).numpy(),
        masked_cge_weighted_sum_plain(gr, g, m, g[0], 6, div=6).numpy())
