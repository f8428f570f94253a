"""The selection family's masked kernels (K12 masked_ordered_apply, K14
masked_bulyan_coord) and its masked compositions against the JAX package.

On the CPU each wrapper runs its plain PyTorch version, which is held
against the JAX kernel run in interpret mode (as the JAX suite runs it)
and, through ``spec.aggregate_flat(stack, mask=, weights=)``, against the
jitted JAX engine with impl="pallas".  Both sides get the same stack and
the same (d,) imputed mean, so the comparison is of the masked stage.

Bars (ROADMAP.md's parity bar): K12 exact without a division, and within
rtol = atol = 3e-6 with one (the reference may multiply by the reciprocal
of its constant divisor, the port divides); K14 exact where beta = 1, else
3e-6 for the same reason; the engine's aggregates within 3e-6 in fp32 and
2e-2 in bf16.  Masks: 6, 1 and 0 rows arrived, with a ghost (absent) row
among the picks or the selected rows; n = 3, 4, 8, 11; d = 515, not a
multiple of JAX's 512-lane tile (padded on the JAX side only); NaN / +-inf
in a picked live row and in an absent row (which never shows).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.aggregators import make_spec as jax_make_spec
from repro.kernels.ops import _pad_d
from repro.kernels.select import masked_bulyan_coord as jax_masked_bulyan
from repro.kernels.wsum import masked_ordered_apply as jax_masked_apply
from repro_torch import kernels
from repro_torch.convert import tensor_from_numpy as t
from repro_torch.core.aggregators import make_spec
from repro_torch.kernels.select import bulyan_beta

torch.set_num_threads(2)
TOL, BF16_TOL = 3e-6, 2e-2
D = 515
FAMILY = {"cge": {}, "multi_krum": {"m": 3}, "m_krum": {"m": 3}, "mda": {},
          "bulyan": {}}


def f_of(n):
    return 2 if n >= 8 else 1


def stack(n, d, seed, dtype="float32"):
    g = (np.random.default_rng(seed).normal(size=(n, d)) * 2.0).astype(
        np.float32)
    return g if dtype == "float32" else np.asarray(
        jnp.asarray(g, jnp.bfloat16))


def arrivals(n, arrived, seed):
    """(n,) {0,1} fp32 mask with ``arrived`` rows arrived at random."""
    m = np.zeros(n, np.float32)
    m[np.random.default_rng(seed).permutation(n)[:arrived]] = 1.0
    return m


def picks(n, k, mask, seed):
    """k distinct rows, a ghost among them whenever one exists."""
    rows = list(np.random.default_rng(seed).permutation(n))
    ghosts = [r for r in rows if mask[r] <= 0.5]
    if ghosts:
        rows.remove(ghosts[0])
        rows.insert(seed % k, ghosts[0])
    return rows[:k]


def imputed_mean(g, mask):
    """The (d,) mean both sides take: the port's imputed mean (K4 plain)
    of the arrived rows at staleness-like weights, in g's dtype."""
    w = mask * np.array([1.0, 0.5, 1.0 / 3.0] * g.shape[0],
                        np.float32)[:g.shape[0]]
    wn = w / np.float32(max(float(w.sum()), 1e-30))
    return kernels.imputed_mean(t(g), torch.from_numpy(wn))


def put_hazard(g, mask, rows, hazard):
    g = np.array(g)
    live = [r for r in rows if mask[r] > 0.5]
    absent = np.flatnonzero(mask <= 0.5)
    if hazard == "inf_live" and live:
        g[live[0], ::3] = np.inf
        g[live[-1], 1::3] = -np.inf
    elif hazard == "nan_live" and live:
        g[live[0], 5] = np.nan
    elif hazard == "nonfinite_absent" and absent.size:
        g[absent[0], ::2] = np.nan
        g[absent[-1], 1::2] = np.inf
    elif hazard == "signed_zero":
        z = g[: g.shape[0] // 2 + 1, ::5]
        z[:] = np.where(np.random.default_rng(len(rows)).random(z.shape)
                        < 0.5, 0.0, -0.0)
    elif hazard == "overflow":
        cols = g[:, ::3]
        cols[:] = np.random.default_rng(len(rows)).choice(
            np.float32([3e38, -3e38, 1e38, -1e38, 2e38]), size=cols.shape)
    return g


# every hazard in fp32; bf16 (read as its exact fp32 upcast) plain and
# with a poisoned absent row
CASES = ([("float32", h) for h in (None, "inf_live", "nan_live",
                                   "nonfinite_absent")]
         + [("bfloat16", h) for h in (None, "nonfinite_absent")])


# K14 also on +-0 around the median and on |x - med| overflowing to +inf
# (the all-inf rounds take row 0, imputed where absent), in both dtypes
BULYAN_CASES = [(dt, h) for dt in ("float32", "bfloat16")
                for h in ("signed_zero", "overflow")]


def jax_side(g, m, mean):
    gp, d = _pad_d(jnp.asarray(g))
    meanp = jnp.pad(jnp.asarray(mean), (0, gp.shape[1] - d))
    return gp, jnp.asarray(m), meanp, d


# ---------------------------------------------------------------------------
# K12 masked_ordered_apply


@pytest.mark.parametrize("dtype,hazard", CASES)
@pytest.mark.parametrize("n", [3, 4, 8, 11])
def test_masked_ordered_apply_plain_matches_jax(n, dtype, hazard):
    for arrived in (max(n - 2, 1), 1, 0):
        m = arrivals(n, arrived, seed=n + arrived)
        for k in sorted({min(3, n), n - f_of(n)}):
            rows = picks(n, k, m, seed=k)
            g = put_hazard(stack(n, D, seed=10 * n + k, dtype=dtype), m,
                           rows, hazard)
            mean = imputed_mean(g, m)
            order = np.full(n, n, np.int32)
            order[rows] = np.arange(k, dtype=np.int32)
            gp, mj, meanp, d = jax_side(g, m, mean.float().numpy().astype(
                g.dtype))
            args = (torch.from_numpy(order), t(g), torch.from_numpy(m),
                    mean)
            msg = f"arrived={arrived} k={k}"
            for chain in (False, True):
                ref = np.asarray(jax_masked_apply(
                    jnp.asarray(order), gp, mj, meanp, k, chain=chain,
                    interpret=True))[:d]
                ours = kernels.masked_ordered_apply(*args, k).numpy()
                np.testing.assert_array_equal(ours, ref, err_msg=msg)
                ref = np.asarray(jax_masked_apply(
                    jnp.asarray(order), gp, mj, meanp, k, chain=chain,
                    div=k, true_div=chain, interpret=True))[:d]
                ours = kernels.masked_ordered_apply(*args, k, div=k).numpy()
                np.testing.assert_allclose(ours, ref, rtol=TOL, atol=TOL,
                                           equal_nan=True, err_msg=msg)
            if hazard == "nonfinite_absent":
                assert np.isfinite(ours).all(), msg


def test_masked_ordered_apply_ghost_pick_is_the_mean():
    """A ghost pick contributes exactly the mean's bits (upcast), and its
    own row, however poisoned, is never read; all live is K11."""
    g = torch.from_numpy(stack(6, 40, seed=3))
    g[2] = float("nan")
    mask = torch.tensor([1.0, 1.0, 0.0, 1.0, 1.0, 1.0])
    mean = torch.from_numpy(stack(1, 40, seed=4)[0])
    order = torch.tensor([6, 6, 0, 6, 6, 6], dtype=torch.int32)
    assert torch.equal(kernels.masked_ordered_apply(order, g, mask, mean, 1),
                       mean)
    order = torch.tensor([1, 6, 6, 0, 6, 2], dtype=torch.int32)
    ones = torch.ones(6)
    assert torch.equal(kernels.masked_ordered_apply(order, g, ones, mean, 3,
                                                    div=3),
                       kernels.ordered_apply(order, g, 3, div=3))


# ---------------------------------------------------------------------------
# K14 masked_bulyan_coord


@pytest.mark.parametrize("dtype,hazard", CASES + BULYAN_CASES)
@pytest.mark.parametrize("n", [3, 4, 8, 11])
def test_masked_bulyan_coord_plain_matches_jax(n, dtype, hazard):
    f = 0 if n == 3 else 1 if n < 8 else 2
    theta = n - 2 * f
    for arrived in (max(n - 2, 1), 1, 0):
        m = arrivals(n, arrived, seed=n + 7 * arrived)
        rows = picks(n, theta, m, seed=theta + arrived)
        sel = np.zeros(n, np.float32)
        sel[rows] = 1.0
        g = put_hazard(stack(n, D, seed=n + arrived, dtype=dtype), m, rows,
                       hazard)
        mean = imputed_mean(g, m)
        gp, mj, meanp, d = jax_side(g, m, mean.float().numpy().astype(
            g.dtype))
        ref = np.asarray(jax_masked_bulyan(gp, mj, meanp, jnp.asarray(sel),
                                           theta, f, interpret=True))[:d]
        ours = kernels.masked_bulyan_coord(t(g), torch.from_numpy(m), mean,
                                           torch.from_numpy(sel), theta,
                                           f).numpy()
        msg = f"arrived={arrived} theta={theta}"
        if bulyan_beta(theta, f) == 1:
            np.testing.assert_array_equal(ours, ref, err_msg=msg)
        else:
            np.testing.assert_allclose(ours, ref, rtol=TOL, atol=TOL,
                                       equal_nan=True, err_msg=msg)
        if hazard == "nonfinite_absent":
            assert np.isfinite(ours).all(), msg


def test_masked_bulyan_all_inf_round_reads_the_imputed_row():
    """The reference's all-inf round takes the FIRST row at +inf, even an
    unselected one, and adds its value: under imputation that value is
    the mean for an absent row (the JAX kernel imputes the whole tile
    first), never the absent row's own bits."""
    n, f = 8, 1                          # theta 6, beta 4
    g = stack(n, 3, seed=5)
    g[0] = np.nan                        # row 0: unselected and absent
    g[3:5, 1] = np.inf                   # column 1: 2 finite selected
    g[5:7, 1] = -np.inf                  # values, 4 infinite ones
    m = np.ones(n, np.float32)
    m[0] = 0.0
    sel = np.zeros(n, np.float32)
    sel[1:7] = 1.0
    mean = np.array([0.25, 0.5, -0.75], np.float32)
    ours = kernels.masked_bulyan_coord(
        torch.from_numpy(g), torch.from_numpy(m), torch.from_numpy(mean),
        torch.from_numpy(sel), 6, f).numpy()
    gp, mj, meanp, d = jax_side(g, m, mean)
    ref = np.asarray(jax_masked_bulyan(gp, mj, meanp, jnp.asarray(sel), 6,
                                       f, interpret=True))[:d]
    np.testing.assert_allclose(ours, ref, rtol=TOL, atol=TOL)
    want = (np.float32(g[1, 1]) + np.float32(g[2, 1]) + 0.5 + 0.5) / 4
    np.testing.assert_allclose(ours[1], want, rtol=TOL)


def test_masked_selection_wrappers_reject_bad_shapes():
    g, m = torch.zeros(4, 8), torch.ones(4)
    order = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(ValueError):
        kernels.masked_ordered_apply(order, g, m, torch.zeros(7), 2)
    with pytest.raises(ValueError):
        kernels.masked_ordered_apply(order, g, torch.ones(3),
                                     torch.zeros(8), 2)
    with pytest.raises(ValueError):
        kernels.masked_ordered_apply(order, g, m, torch.zeros(8), 5)
    with pytest.raises(ValueError):
        kernels.masked_bulyan_coord(g, m, torch.zeros(8, dtype=torch.bfloat16),
                                    torch.ones(4), 2, 1)
    with pytest.raises(ValueError):
        kernels.masked_bulyan_coord(g, torch.ones(5), torch.zeros(8),
                                    torch.ones(4), 2, 1)


# ---------------------------------------------------------------------------
# the masked engine: spec.aggregate_flat(stack, mask=, weights=)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("rule", list(FAMILY))
def test_masked_engine_matches_jax(rule, dtype):
    """impl="kernel" (the plain versions on the CPU) against the jitted
    JAX engine with impl="pallas", weighted and unweighted, with 6 and 1
    of n rows arrived (n = 8; bulyan n = 11, its guarantee's least n)."""
    n, f = (11, 2) if rule == "bulyan" else (8, 2)
    spec = make_spec(rule, f=f, n=n, **FAMILY[rule])
    assert spec.impl == "kernel"
    jspec = jax_make_spec(rule, f=f, impl="pallas", n=n, **FAMILY[rule])
    run = jax.jit(lambda x, m, w: jspec.aggregate(x, mask=m, weights=w))
    for arrived in (n - 2, 1):
        mask = arrivals(n, arrived, seed=arrived) > 0.5
        g = stack(n, D, seed=31 + arrived, dtype=dtype)
        for weighted in (False, True):
            w = (np.where(mask, np.random.default_rng(arrived).uniform(
                0.3, 1.0, n), 0.0).astype(np.float32) if weighted
                 else mask.astype(np.float32))
            ours = spec.aggregate_flat(t(g), mask=torch.from_numpy(mask),
                                       weights=torch.from_numpy(w))
            ref = np.asarray(run(jnp.asarray(g), jnp.asarray(mask),
                                 jnp.asarray(w))).astype(np.float32)
            ours = ours.to(getattr(torch, dtype)).float().numpy()
            tol = TOL if dtype == "float32" else BF16_TOL
            np.testing.assert_allclose(ours, ref, rtol=tol, atol=tol,
                                       err_msg=f"{arrived} w={weighted}")


def test_selection_family_survives_nonfinite_adversary_masked():
    """The async half of the JAX suite's
    ``test_selection_family_survives_nonfinite_adversary``: under two
    inf-coordinate hostile rows, with two rows absent and weights in [0.3,
    1), the masked kernel path of the rules that keep fewer than n - f
    rows stays finite (the ghost rows inherit the poisoned delivered
    mean, so mda, which keeps n - f, cannot dodge every hostile row)."""
    n, d, f = 8, 512, 2
    g = torch.from_numpy(stack(n, d, seed=12))
    g[1, 7], g[5, 3] = float("inf"), -float("inf")
    rng = np.random.default_rng(3)
    mask = np.ones(n, bool)
    mask[rng.choice(n, size=f, replace=False)] = False
    w = torch.from_numpy(rng.uniform(0.3, 1.0, n).astype(np.float32))
    for rule, hyper in [("multi_krum", {"m": 3}), ("m_krum", {"m": 3}),
                        ("bulyan", {})]:
        spec = make_spec(rule, f=f, n=n, **hyper)
        assert spec.impl == "kernel"
        out = spec.aggregate_flat(g, mask=torch.from_numpy(mask), weights=w)
        assert bool(torch.isfinite(out).all()), rule
