"""The port's kernel modules against the JAX package's Pallas kernels, and
the aggregator registry against the JAX registry.

On the CPU each wrapper runs its plain PyTorch version, which is what is
held against the JAX kernel here (run in interpret mode, as the JAX suite
runs it).  The bars are the JAX suite's own (tests/test_kernels_parity.py):
exact for median values, Krum's one-hot and a one-hot weighted sum; rtol
= atol = 3e-6 in fp32 for trimmed means, Grams and general weighted sums.

The CUDA kernels themselves are held to these plain versions on the card
by tests/test_torch_cuda.py.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.aggregators import make_spec as jax_make_spec
from repro.core.attacks import apply_attack as jax_apply_attack
from repro.core.attacks import get_attack as jax_get_attack
from repro.core.attacks import make_byzantine_mask as jax_byzantine_mask
from repro.core.momentum import worker_momentum as jax_worker_momentum
from repro.kernels.coord_stats import coord_stat as jax_coord_stat
from repro.kernels.ops import _drop_unselected, _pad_d
from repro.kernels.pairwise import gram as jax_gram
from repro.kernels.select import krum_select as jax_krum_select
from repro.kernels.wsum import weighted_sum as jax_weighted_sum
from repro_torch import kernels
from repro_torch.core.aggregators import make_spec
from repro_torch.core.attacks import (apply_attack, get_attack,
                                      make_byzantine_mask)
from repro_torch.core.momentum import worker_momentum
from repro_torch.kernels.coord_stats import coord_stat_plain
from repro_torch.kernels.select import krum_select_plain
from repro_torch.kernels.wsum import weighted_sum_plain

torch.set_num_threads(2)
TOL = 3e-6
F = 2


def stack(n, d, seed, hazard=None):
    """(n, d) fp32 numpy stack, normal * 2, with an optional hazard (its
    rows taken modulo n):
    ``nan`` (a NaN row), ``inf`` (a +inf row and a -inf row), ``ties``
    (rows 0-2 equal, two rows of integers: repeated values in every
    column), ``spots`` (isolated NaN and +-inf coordinates),
    ``signed_zero`` (tied zeros: every even column +0 or -0 in each row,
    every fourth odd column half +-0)."""
    g = (np.random.default_rng(seed).normal(size=(n, d)) * 2.0).astype(
        np.float32)
    if hazard == "nan":
        g[1] = np.nan
    elif hazard == "inf":
        g[1] = np.inf
        g[4 % n] = -np.inf
    elif hazard == "ties":
        g[1] = g[0]
        g[2] = g[0]
        g[5 % n] = np.round(g[5 % n])
        g[6 % n] = np.round(g[6 % n])
    elif hazard == "spots":        # isolated non-finite coordinates
        g[1, 7] = np.nan
        g[3, 7] = np.inf
        g[5 % n, 11] = -np.inf
    elif hazard == "signed_zero":
        rng = np.random.default_rng(seed + 1)
        z = np.where(rng.random((n, d)) < 0.4, np.float32(-0.0),
                     np.float32(0.0))
        g[:, ::2] = z[:, ::2]
        g[:, 1::4] = np.where(rng.random((n, d))[:, 1::4] < 0.5, z[:, 1::4],
                              g[:, 1::4])
    return g


def jax_pad(g):
    gp, d = _pad_d(jnp.asarray(g))
    return gp, d


HAZARDS = [None, "nan", "inf", "ties", "spots"]


# ---------------------------------------------------------------------------
# K1 coord_stat


# ROADMAP.md P17: the medians whose sign of zero differs from JAX's, by
# (hazard, n); none elsewhere (jnp.minimum orders -0 below +0,
# torch.minimum on the CPU keeps one operand of a tied pair)
SIGN_FLIPS = {("signed_zero", 4): 147, ("signed_zero", 8): 190,
              ("signed_zero", 9): 184, ("signed_zero", 16): 205,
              ("signed_zero", 17): 221, ("ties", 8): 1, ("ties", 9): 1,
              ("ties", 16): 1}


@pytest.mark.parametrize("hazard", HAZARDS + ["signed_zero"])
@pytest.mark.parametrize("n", [4, 8, 9, 16, 17])
def test_coord_stat_plain_matches_jax(n, hazard):
    """Median exact (NaN where the JAX network spreads NaN; the sign of a
    zero median as JAX's but for SIGN_FLIPS, all at zero
    medians); trimmed mean (b = min(2, (n - 1) // 2)) within 3e-6, NaN
    and inf at the same places."""
    g = stack(n, 771, seed=n, hazard=hazard)
    gp, d = jax_pad(g)
    med = np.asarray(jax_coord_stat(gp, "median", interpret=True))[:d]
    ours = coord_stat_plain(torch.from_numpy(g), "median").numpy()
    np.testing.assert_array_equal(ours, med)
    flips = (np.signbit(ours) != np.signbit(med)) & ~np.isnan(med)
    assert not (flips & (med != 0)).any()
    assert int(flips.sum()) == SIGN_FLIPS.get((hazard, n), 0)
    b = min(2, (n - 1) // 2)
    tm = np.asarray(jax_coord_stat(gp, "trimmed_mean", b=b,
                                   interpret=True))[:d]
    np.testing.assert_allclose(
        kernels.coord_stat(torch.from_numpy(g), "trimmed_mean", b=b).numpy(),
        tm, rtol=TOL, atol=TOL)


def test_coord_stat_reads_bf16_like_its_fp32_upcast():
    """Exact: a bf16 stack gives the statistic of its exact fp32 upcast."""
    g = torch.from_numpy(stack(8, 300, seed=2)).bfloat16()
    for stat in ("median", "trimmed_mean"):
        assert torch.equal(kernels.coord_stat(g, stat, b=2),
                           kernels.coord_stat(g.float(), stat, b=2))


def test_coord_stat_rejects_what_the_kernel_cannot_take():
    with pytest.raises(ValueError):
        kernels.coord_stat(torch.zeros(65, 4), "median")
    with pytest.raises(ValueError):
        kernels.coord_stat(torch.zeros(4, 4), "trimmed_mean", b=2)
    with pytest.raises(KeyError):
        kernels.coord_stat(torch.zeros(4, 4), "mode")


# ---------------------------------------------------------------------------
# K2 gram


@pytest.mark.parametrize("n,d", [(8, 771), (9, 2048), (13, 130), (11, 515),
                                 (16, 130), (64, 67)])
def test_gram_plain_matches_jax(n, d):
    """Against the exact Gram (numpy fp64, rounded once): rtol 1e-7.
    Against JAX's fp32 Gram: 3e-6 of the Cauchy-Schwarz scale
    sqrt(G_ii G_jj) — JAX's own fp32 dot is off by ~1e-5 on off-diagonal
    entries that cancel, so a bar relative to the entry itself would
    measure the reference's rounding, not the port."""
    g = stack(n, d, seed=d)
    ours = kernels.gram(torch.from_numpy(g)).numpy()
    exact = g.astype(np.float64) @ g.astype(np.float64).T
    np.testing.assert_allclose(ours, exact.astype(np.float32), rtol=1e-7,
                               atol=0)
    gp, _ = jax_pad(g)
    ref = np.asarray(jax_gram(gp, interpret=True))
    scale = np.sqrt(np.outer(np.diag(exact), np.diag(exact)))
    assert np.all(np.abs(ours - ref) <= TOL * scale)


# ---------------------------------------------------------------------------
# K3 krum_select


@pytest.mark.parametrize("hazard", HAZARDS)
@pytest.mark.parametrize("n", [8, 9, 12])
def test_krum_select_plain_matches_jax(n, hazard):
    """Exact one-hot from the same Gram, non-finite rows and exact score
    ties included (first index wins, NaN ordered last)."""
    g = stack(n, 512, seed=3 * n, hazard=hazard)
    gr = jax_gram(jnp.asarray(g), interpret=True)
    ref = np.asarray(jax_krum_select(gr, F, interpret=True))
    ours = kernels.krum_select(torch.from_numpy(np.array(gr)), F).numpy()
    np.testing.assert_array_equal(ours, ref)
    assert ours.sum() == 1.0


def exact_gram(g):
    """The fp32 rounding of the exact (fp64) Gram of a finite stack:
    bitwise symmetric, and no interpret-mode call."""
    g64 = g.astype(np.float64)
    return (g64 @ g64.T).astype(np.float32)


@pytest.mark.parametrize("hazard", [None, "ties"])
def test_krum_select_plain_matches_jax_at_n33(hazard):
    """n = 33: past one warp of rows, where the card's kernel combines two
    warps' minima.  The same exact one-hot as JAX's on the same Gram."""
    gr = exact_gram(stack(33, 64, seed=33, hazard=hazard))
    ref = np.asarray(jax_krum_select(jnp.asarray(gr), F, interpret=True))
    ours = kernels.krum_select(torch.from_numpy(gr), F).numpy()
    np.testing.assert_array_equal(ours, ref)
    assert ours.sum() == 1.0


def test_krum_select_all_tied_picks_the_first_row():
    gr = torch.ones(6, 6)
    np.testing.assert_array_equal(krum_select_plain(gr, 1).numpy(),
                                  np.eye(6, dtype=np.float32)[0])


# ---------------------------------------------------------------------------
# K4 weighted_sum


def test_weighted_sum_plain_matches_jax():
    """General weights: 3e-6.  One-hot weights with non-finite rejected
    rows: exactly the selected row (JAX zeroes the other rows first)."""
    g = stack(8, 771, seed=4)
    gp, d = jax_pad(g)
    w = np.random.default_rng(1).uniform(0.1, 1.0, size=8).astype(np.float32)
    ref = np.asarray(jax_weighted_sum(jnp.asarray(w), gp,
                                      interpret=True))[:d]
    np.testing.assert_allclose(
        kernels.weighted_sum(torch.from_numpy(w), torch.from_numpy(g))
        .numpy(), ref, rtol=TOL, atol=TOL)
    g = stack(8, 771, seed=5, hazard="inf")
    gp, d = jax_pad(g)
    w = np.eye(8, dtype=np.float32)[6]
    ref = np.asarray(jax_weighted_sum(
        jnp.asarray(w), _drop_unselected(jnp.asarray(w), gp),
        interpret=True))[:d]
    ours = weighted_sum_plain(torch.from_numpy(w), torch.from_numpy(g))
    np.testing.assert_array_equal(ours.numpy(), ref)
    np.testing.assert_array_equal(ours.numpy(), g[6])
    assert torch.equal(weighted_sum_plain(torch.zeros(8),
                                          torch.from_numpy(g)),
                       torch.zeros(771))


def fma_inputs(kind):
    """(a, x, acc) for :func:`test_fma_f32_is_its_exact_path`."""
    g = torch.Generator().manual_seed(7)
    if kind in ("normal", "bfloat16"):
        x = torch.randn(65536, generator=g)
        return (torch.tensor(0.37), x.bfloat16() if kind == "bfloat16"
                else x, torch.randn(65536, generator=g))
    if kind == "midpoints":
        # small integers times powers of two: many fp64 sums land exactly
        # halfway between two fp32 values
        def scaled(lo, hi):
            return (torch.randint(lo, hi, (65536,), generator=g).float()
                    * 2.0 ** torch.randint(-30, 30, (65536,), generator=g)
                    .float())
        return torch.tensor(0.25), scaled(-64, 64), scaled(-2 ** 24, 2 ** 24)
    specials = torch.tensor([0.0, -0.0, 1e-45, -1e-45, 1e-40, 2.0 ** -126,
                             2.0 ** -127, 1.17e-38, 3e38, -3e38, 1.0, -0.5,
                             math.inf, -math.inf, math.nan])
    return (torch.tensor(-1.5), specials.repeat_interleave(len(specials)),
            specials.repeat(len(specials)))


@pytest.mark.parametrize("kind", ["normal", "bfloat16", "midpoints",
                                  "specials"])
def test_fma_f32_is_its_exact_path(kind):
    """``ref.fma_f32`` rounds the fp64 sum to fp32 and sends only the sums
    on an fp32 rounding boundary, or below the normal range, through the
    exact round-to-odd path: bit for bit that path on every element (the
    midpoint inputs do take it), 0-dim operands included."""
    from repro_torch.kernels import ref
    a0, x, acc = fma_inputs(kind)
    for a in (a0, torch.tensor(2.0 ** -20), torch.tensor(1.0000001)):
        ours = ref.fma_f32(a, x, acc)
        assert torch.equal(ours.view(torch.int32),
                           ref._fma_f32_exact(a, x, acc).view(torch.int32))
        assert torch.equal(ref.fma_f32(a, x).view(torch.int32),
                           (x.double() * a.double()).float().view(
                               torch.int32))
    if kind == "midpoints":
        s = x.double() * a0.double() + acc.double()
        assert int(((s.view(torch.int64) & ref._F32_SPARE)
                    == ref._F32_HALF).sum()) > 100
    for i in range(0, x.numel(), max(1, x.numel() // 64)):
        assert torch.equal(ref.fma_f32(a, x[i], acc[i]).view(torch.int32),
                           ref._fma_f32_exact(a, x[i], acc[i]).view(
                               torch.int32))


# ---------------------------------------------------------------------------
# the registry: aggregate_flat against JAX impl="pallas" and "gather"


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n", [8, 9])
@pytest.mark.parametrize("rule", ["mean", "coordinate_median",
                                  "trimmed_mean", "krum"])
def test_aggregate_flat_matches_jax(rule, n, dtype):
    """auto (the kernel path) against JAX pallas, gather against JAX
    gather: exact for median and krum, 3e-6 for trimmed mean and mean.
    A bf16 arena is read as its exact fp32 upcast by both packages."""
    g = torch.from_numpy(stack(n, 771, seed=10 + n)).to(
        getattr(torch, dtype))
    gj = jnp.asarray(g.float().numpy())
    exact = rule in ("coordinate_median", "krum")
    pairs = [("gather", "gather")]
    if rule != "mean":
        pairs.append(("auto", "pallas"))
    for ours_impl, ref_impl in pairs:
        spec = make_spec(rule, f=F, impl=ours_impl, n=n)
        if ours_impl == "auto":
            assert spec.impl == "kernel"
        ours = spec.aggregate_flat(g).numpy()
        ref = np.asarray(jax_make_spec(rule, f=F, impl=ref_impl, n=n)
                         .aggregate(gj))
        if exact:
            np.testing.assert_array_equal(ours, ref, err_msg=ours_impl)
        else:
            np.testing.assert_allclose(ours, ref, rtol=TOL, atol=TOL,
                                       err_msg=ours_impl)


def test_aggregate_on_a_tree_unravels_like_jax():
    n = 8
    rng = np.random.default_rng(0)
    tree = {"a": rng.normal(size=(n, 5, 7)).astype(np.float32),
            "b": {"c": rng.normal(size=(n, 11)).astype(np.float32)}}
    ours = make_spec("coordinate_median", f=F).aggregate(
        {"a": torch.from_numpy(tree["a"]),
         "b": {"c": torch.from_numpy(tree["b"]["c"])}})
    ref = jax_make_spec("coordinate_median", f=F, impl="pallas").aggregate(
        jax.tree.map(jnp.asarray, tree))
    np.testing.assert_array_equal(ours["a"].numpy(), np.asarray(ref["a"]))
    np.testing.assert_array_equal(ours["b"]["c"].numpy(),
                                  np.asarray(ref["b"]["c"]))


def test_make_spec_resolves_and_rejects_impls():
    assert make_spec("krum", f=1).impl == "kernel"
    assert make_spec("mean").impl == "gather"
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        make_spec("krum", f=1, impl="fused")
    with pytest.raises(ValueError, match="kernel"):
        make_spec("krum", f=1, impl="pallas")
    with pytest.raises(ValueError):
        make_spec("mean", impl="kernel")
    with pytest.raises(ValueError):
        make_spec("trimmed_mean", f=1, gamma=0.1)
    # scale= goes with a quantized arena (int8 / fp8 codes) only
    with pytest.raises(ValueError, match="quantized"):
        make_spec("krum", f=1).aggregate_flat(torch.zeros(4, 3),
                                              scale=torch.ones(4))


# ---------------------------------------------------------------------------
# attacks and worker momentum


@pytest.mark.parametrize("attack", ["sign_flip", "gaussian", "large_value",
                                    "constant_drift", "alie", "ipm", "mimic",
                                    "zero", "saddle_push"])
def test_static_attacks_match_jax(attack):
    """rtol = atol = 1e-6 (per-coordinate reductions over 8 rows);
    gaussian gets the JAX side's noise injected."""
    n, d = 8, 257
    g = stack(n, d, seed=7)
    key = jax.random.PRNGKey(3)
    mask_j = jnp.arange(n) < F
    ref = np.asarray(jax_get_attack(attack)(key, jnp.asarray(g), mask_j))
    hyper = {}
    if attack == "gaussian":
        hyper["noise"] = torch.from_numpy(np.array(
            jax.random.normal(key, g.shape, jnp.float32)))
    ours = get_attack(attack, **hyper)(
        None, torch.from_numpy(g), make_byzantine_mask(n, F))
    np.testing.assert_allclose(ours.numpy(), ref, rtol=1e-6, atol=1e-6)


def test_apply_attack_and_the_mobile_mask_match_jax():
    """``apply_attack`` by name or function equals the attack itself; the
    mobile Byzantine mask from JAX's permutation (handed over by value)
    is JAX's mask, and one drawn by a torch generator holds f agents."""
    n, d, key = 8, 33, jax.random.PRNGKey(7)
    g = stack(n, d, seed=9)
    jmask = jax_byzantine_mask(n, 3, fixed=False, key=key)
    perm = np.array(jax.random.permutation(key, n))
    ours = make_byzantine_mask(n, 3, fixed=False, perm=torch.from_numpy(perm))
    np.testing.assert_array_equal(ours.numpy(), np.asarray(jmask))
    gen = torch.Generator().manual_seed(0)
    drawn = make_byzantine_mask(n, 3, fixed=False, generator=gen)
    assert int(drawn.sum()) == 3 and not torch.equal(
        drawn, make_byzantine_mask(n, 3))
    assert torch.equal(make_byzantine_mask(n, 3, fixed=False),
                       make_byzantine_mask(n, 3))
    ref = np.asarray(jax_apply_attack("sign_flip", key, jnp.asarray(g),
                                      jmask))
    for attack in ("sign_flip", get_attack("sign_flip")):
        out = apply_attack(attack, None, torch.from_numpy(g), ours)
        np.testing.assert_allclose(out.numpy(), ref, rtol=1e-6, atol=1e-6)


def test_worker_momentum_matches_jax():
    """Exact: the fp32 elementwise law (1 - a) m + a g."""
    rng = np.random.default_rng(2)
    m = rng.normal(size=(4, 33)).astype(np.float32)
    g = rng.normal(size=(4, 33)).astype(np.float32)
    ref, _ = jax_worker_momentum(jnp.asarray(m), jnp.asarray(g), 0.2)
    ours, _ = worker_momentum(torch.from_numpy(m.copy()),
                              torch.from_numpy(g), 0.2)
    np.testing.assert_array_equal(ours.numpy(), np.asarray(ref))
