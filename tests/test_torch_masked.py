"""The port's masked kernels (K5, K6, K7 and the imputed mean) and masked
engine against the JAX package.

On the CPU each wrapper runs its plain PyTorch version, which is held
against the JAX kernel run in interpret mode (as the JAX suite runs it)
and against the JAX engine.  Bars (the JAX suite's own):

* exact: masked median values, Krum's one-hot selection on the masked
  Gram, masked Krum, a one-hot masked weighted sum (live row or ghost);
* rtol = atol = 3e-6 in fp32: masked trimmed means, the imputed mean,
  {0,1} masked weighted sums, the masked mean;
* masked Grams: 3e-6 of the Cauchy-Schwarz scale sqrt(G_ii G_jj) (JAX's
  own fp32 Gram is off by ~1e-5 on entries that cancel);
* bf16 results that are rounded to bf16 after a reassociated fp32 sum:
  rtol = atol = 2e-2 (bf16 resolution).

Masks: most rows arrived (6 of 8), one, none, fewer than 2b + 1 (the
trimmed window clamps), all; staleness weights cycle through {1, 1/2,
1/3}.  Hazards: a NaN in an arrived row (spreads through the network to
the ranks JAX's network spreads it to), NaN and +-inf in an absent row
(never show), +-inf in arrived rows, ties.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.aggregators import make_spec as jax_make_spec
from repro.kernels.masked import masked_coord_stat as jax_masked_coord_stat
from repro.kernels.ops import _pad_d
from repro.kernels.ops import kernel_krum_masked as jax_kernel_krum_masked
from repro.kernels.pairwise import imputed_mean as jax_imputed_mean
from repro.kernels.pairwise import masked_gram as jax_masked_gram
from repro.kernels.select import krum_select as jax_krum_select
from repro.kernels.wsum import masked_weighted_sum as jax_masked_wsum
from repro_torch import kernels
from repro_torch.convert import tensor_from_numpy, tensor_to_numpy
from repro_torch.core.aggregators import make_spec, trim_count
from repro_torch.kernels.select import krum_select_plain

torch.set_num_threads(2)
TOL, BF16_TOL = 3e-6, 2e-2
D = 515                     # not a multiple of JAX's 512-lane tile
NS = [3, 4, 6, 8]
MASKS = ["most", "one", "none", "below_window", "all"]
DISCOUNTS = np.array([1.0, 0.5, 1.0 / 3.0], np.float32)


def f_of(n):
    return 2 if n >= 8 else 1


def stack(n, d, seed, dtype="float32"):
    """(n, d) numpy stack, normal * 2, in fp32 or ml_dtypes bf16."""
    g = (np.random.default_rng(seed).normal(size=(n, d)) * 2.0).astype(
        np.float32)
    return g if dtype == "float32" else np.asarray(
        jnp.asarray(g, jnp.bfloat16))


def mask_of(n, case, seed=0):
    """(n,) bool arrival mask of one named case."""
    b = trim_count(n, f_of(n), None)
    k = {"most": max(n - 2, 1), "one": 1, "none": 0,
         "below_window": max(2 * b, 1), "all": n}[case]
    m = np.zeros(n, bool)
    m[np.random.default_rng(seed).permutation(n)[:k]] = True
    return m


def weights_of(mask):
    """Staleness discounts {1, 1/2, 1/3} on the arrived rows, 0 elsewhere."""
    w = DISCOUNTS[np.arange(mask.size) % 3] * mask
    return w.astype(np.float32)


def wn_of(mask, w):
    tot = max(float(np.float32(w.sum())), 1e-30)
    return (w / np.float32(tot)).astype(np.float32)


def t(a):
    return tensor_from_numpy(a)


def jpad(g):
    return _pad_d(jnp.asarray(g))


def put_hazard(g, mask, hazard):
    """Write a hazard into g (a copy) at rows picked by the mask."""
    g = np.array(g)
    live, absent = np.flatnonzero(mask), np.flatnonzero(~mask)
    if hazard == "nan_arrived" and live.size:
        g[live[0]] = np.nan
    elif hazard == "nonfinite_absent" and absent.size:
        g[absent[0], ::3] = np.nan
        g[absent[0], 1::3] = np.inf
        g[absent[-1], 2::3] = -np.inf
    elif hazard == "inf_arrived" and live.size:
        g[live[0], ::2] = np.inf
        g[live[-1], 1::2] = -np.inf
    elif hazard == "ties" and live.size:
        g[live] = g[live[0]]
        g[:, ::4] = np.round(g[:, ::4])
    return g


# ---------------------------------------------------------------------------
# K5 masked_coord_stat


@pytest.mark.parametrize("hazard", [None, "nan_arrived", "nonfinite_absent",
                                    "inf_arrived", "ties"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n", NS)
def test_masked_coord_stat_plain_matches_jax(n, dtype, hazard):
    """Median exact, trimmed mean 3e-6, NaN and inf where JAX has them,
    for every mask case; a non-finite absent row changes nothing."""
    b = trim_count(n, f_of(n), None)
    for case in MASKS:
        mask = mask_of(n, case, seed=n)
        g = put_hazard(stack(n, D, seed=n, dtype=dtype), mask, hazard)
        m = mask.astype(np.float32)
        wn = wn_of(mask, weights_of(mask))
        gp, d = jpad(g)
        for stat, bb in (("median", 0), ("trimmed_mean", b)):
            ref = np.asarray(jax_masked_coord_stat(
                gp, jnp.asarray(m), jnp.asarray(wn), stat, b=bb,
                interpret=True))[:d]
            ours = kernels.masked_coord_stat(t(g), t(m), t(wn), stat,
                                             b=bb).numpy()
            msg = f"{stat} {case}"
            if stat == "median":
                np.testing.assert_array_equal(ours, ref, err_msg=msg)
            else:
                np.testing.assert_allclose(ours, ref, rtol=TOL, atol=TOL,
                                           err_msg=msg)
            if hazard == "nonfinite_absent":
                clean = stack(n, D, seed=n, dtype=dtype)
                base = kernels.masked_coord_stat(t(clean), t(m), t(wn), stat,
                                                 b=bb).numpy()
                np.testing.assert_array_equal(ours, base, err_msg=msg)
                assert np.isfinite(ours).all()
            if case == "none":
                np.testing.assert_array_equal(ours, np.zeros(D, np.float32))


def test_masked_coord_stat_below_window_is_the_arrived_median():
    """Below 2b + 1 arrivals the trimmed window clamps to the median of
    the arrived rows (exact)."""
    n = 8
    g = stack(n, 64, seed=1)
    mask = np.zeros(n, bool)
    mask[[1, 4, 6]] = True                    # 3 < 2 * 2 + 1
    m = t(mask.astype(np.float32))
    tm = kernels.masked_coord_stat(t(g), m, m, "trimmed_mean", b=2)
    np.testing.assert_array_equal(tm.numpy(), np.median(g[mask], axis=0))


def test_masked_coord_stat_rejects_what_the_kernel_cannot_take():
    with pytest.raises(ValueError):
        kernels.masked_coord_stat(torch.zeros(65, 4), torch.ones(65),
                                  torch.ones(65), "median")
    with pytest.raises(ValueError):
        kernels.masked_coord_stat(torch.zeros(4, 4), torch.ones(3),
                                  torch.ones(4), "median")
    with pytest.raises(KeyError):
        kernels.masked_coord_stat(torch.zeros(4, 4), torch.ones(4),
                                  torch.ones(4), "mode")


# ---------------------------------------------------------------------------
# imputed_mean, K6 masked_gram (and K3 on it)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n", NS)
def test_imputed_mean_and_masked_gram_match_jax(n, dtype):
    for case in ("most", "one", "below_window", "all"):
        mask = mask_of(n, case, seed=2 * n)
        g = stack(n, D, seed=3 * n, dtype=dtype)
        m, wn = mask.astype(np.float32), wn_of(mask, weights_of(mask))
        mean = kernels.imputed_mean(t(g), t(wn))
        ref_mean = np.asarray(jax.jit(jax_imputed_mean)(jnp.asarray(g),
                                                        jnp.asarray(wn)))
        tol = TOL if dtype == "float32" else BF16_TOL
        np.testing.assert_allclose(tensor_to_numpy(mean), ref_mean.astype(
            np.float32), rtol=tol, atol=tol, err_msg=case)
        # the Gram from the SAME mean on both sides
        jmean = jnp.asarray(ref_mean)
        ours = kernels.masked_gram(t(g), t(m), t(wn),
                                   tensor_from_numpy(ref_mean)).numpy()
        gp, d = jpad(g)
        meanp, _ = _pad_d(jmean[None])
        ref = np.asarray(jax_masked_gram(gp, jnp.asarray(m), jnp.asarray(wn),
                                         meanp[0], interpret=True))
        imp = np.where(mask[:, None], np.asarray(g, np.float64),
                       np.asarray(ref_mean, np.float64)[None])
        exact = imp @ imp.T
        np.testing.assert_allclose(ours, exact.astype(np.float32),
                                   rtol=1e-7, atol=0, err_msg=case)
        scale = np.sqrt(np.outer(np.diag(exact), np.diag(exact)))
        assert np.all(np.abs(ours - ref) <= TOL * scale), case
        sel = krum_select_plain(torch.from_numpy(ours), f_of(n)).numpy()
        np.testing.assert_array_equal(
            sel, np.asarray(jax_krum_select(jnp.asarray(ref), f_of(n),
                                            interpret=True)), err_msg=case)


def test_imputed_mean_never_reads_an_absent_row():
    """K4 skips rows of weight 0, so an absent inf/NaN row cannot leak
    (the JAX mean multiplies it by 0 and does leak NaN)."""
    g = stack(6, 40, seed=5)
    g[2] = np.inf
    g[4] = np.nan
    mask = np.array([1, 1, 0, 1, 0, 1], bool)
    mean = kernels.imputed_mean(t(g), t(wn_of(mask, weights_of(mask))))
    assert torch.isfinite(mean).all()


# ---------------------------------------------------------------------------
# K7 masked_weighted_sum


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n", NS)
def test_masked_weighted_sum_plain_matches_jax(n, dtype):
    mask = mask_of(n, "most", seed=n)
    if mask.all():
        mask[0] = False
    g = stack(n, D, seed=7 * n, dtype=dtype)
    live, ghost = np.flatnonzero(mask), np.flatnonzero(~mask)
    wn = wn_of(mask, weights_of(mask))
    mean = kernels.imputed_mean(t(g), t(wn))
    meanj = jnp.asarray(tensor_to_numpy(mean, like=g))
    gp, d = jpad(g)
    meanp = _pad_d(meanj[None])[0][0]
    m = mask.astype(np.float32)
    gf = np.asarray(g, np.float32)

    def both(w):
        ours = kernels.masked_weighted_sum(t(w), t(g), t(m), mean).numpy()
        ref = np.asarray(jax_masked_wsum(jnp.asarray(w), gp, jnp.asarray(m),
                                         meanp, interpret=True))[:d]
        return ours, ref

    # one-hot on a live row and on a ghost: exact, and exactly the row
    for i, want in ((live[0], gf[live[0]]),
                    (ghost[0], tensor_to_numpy(mean.float()))):
        ours, ref = both(np.eye(n, dtype=np.float32)[i])
        np.testing.assert_array_equal(ours, ref)
        np.testing.assert_array_equal(ours, want)
    # a {0,1} set over live rows and a ghost: 3e-6
    w = np.zeros(n, np.float32)
    w[live[::2]] = 1.0
    w[ghost[0]] = 1.0
    ours, ref = both(w)
    np.testing.assert_allclose(ours, ref, rtol=TOL, atol=TOL)


def test_masked_weighted_sum_guards():
    """An inf row outside the selection never shows; a negative weight
    is refused; all-zero weights give zeros."""
    n = 6
    g = stack(n, 40, seed=9)
    mask = np.array([1, 0, 1, 1, 0, 1], bool)
    g[3] = np.inf
    g[4] = -np.inf                           # an absent row
    m = t(mask.astype(np.float32))
    mean = torch.from_numpy(g[0].copy())
    out = kernels.masked_weighted_sum(t(np.eye(n, dtype=np.float32)[2]),
                                      t(g), m, mean)
    np.testing.assert_array_equal(out.numpy(), g[2])
    w = np.zeros(n, np.float32)
    w[[0, 5, 1]] = 1.0
    assert torch.isfinite(kernels.masked_weighted_sum(t(w), t(g), m,
                                                      mean)).all()
    with pytest.raises(ValueError, match=">= 0"):
        kernels.masked_weighted_sum(t(-w), t(g), m, mean)
    assert torch.equal(kernels.masked_weighted_sum(torch.zeros(n), t(g), m,
                                                   mean), torch.zeros(40))


# ---------------------------------------------------------------------------
# kernel_krum_masked


@pytest.mark.parametrize("n", NS)
def test_kernel_krum_masked_matches_jax_exactly(n):
    for case in ("most", "one", "below_window", "all"):
        for seed in (0, 1):
            mask = mask_of(n, case, seed=seed)
            g = stack(n, D, seed=11 * n + seed)
            m, wn = mask.astype(np.float32), wn_of(mask, weights_of(mask))
            ours = kernels.kernel_krum_masked(t(g), t(m), t(wn),
                                              f_of(n)).numpy()
            ref = np.asarray(jax_kernel_krum_masked(
                jnp.asarray(g), jnp.asarray(m), jnp.asarray(wn), f_of(n),
                interpret=True))
            np.testing.assert_array_equal(ours, ref, err_msg=case)


# ---------------------------------------------------------------------------
# the masked engine (module 4): aggregate_flat and aggregate on trees


RULES = ["mean", "coordinate_median", "trimmed_mean", "krum"]


def _pairs(rule):
    """(port impl, JAX impl) pairs: the kernel impl (plain versions on the
    CPU) against JAX pallas, and gather against gather."""
    return [("gather", "gather")] + ([] if rule == "mean"
                                     else [("kernel", "pallas")])


def _jax_engine(rule, impl, n, grads, mask, w):
    """The JAX engine, jitted as the JAX training steps run it (the
    compiler fuses the weighted means into fused multiply-add chains)."""
    spec = jax_make_spec(rule, f=2, impl=impl, n=n)
    if w is None:
        return jax.jit(lambda g, m: spec.aggregate(g, mask=m))(
            grads, jnp.asarray(mask))
    return jax.jit(lambda g, m, w: spec.aggregate(g, mask=m, weights=w))(
        grads, jnp.asarray(mask), jnp.asarray(w))


def _assert_engine(ours, ref, rule, dtype, msg):
    if dtype == "float32" and rule in ("coordinate_median", "krum"):
        np.testing.assert_array_equal(ours, ref, err_msg=msg)
    elif dtype == "float32" or rule == "coordinate_median":
        tol = TOL if dtype == "float32" else 0
        np.testing.assert_allclose(ours, ref, rtol=tol, atol=tol,
                                   err_msg=msg)
    else:
        np.testing.assert_allclose(ours, ref, rtol=BF16_TOL, atol=BF16_TOL,
                                   err_msg=msg)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("rule", RULES)
def test_masked_engine_matches_jax(rule, dtype):
    """spec.aggregate_flat(stack, mask=, weights=) against the (jitted) JAX
    engine on the same stack, for every mask case, weighted and
    unweighted."""
    n = 8
    for case in MASKS:
        mask = mask_of(n, case, seed=3)
        g = stack(n, D, seed=21, dtype=dtype)
        for weighted in (False, True):
            w = weights_of(mask) if weighted else None
            for ours_impl, ref_impl in _pairs(rule):
                spec = make_spec(rule, f=2, impl=ours_impl, n=n)
                ours = spec.aggregate_flat(
                    t(g), mask=torch.from_numpy(mask),
                    weights=None if w is None else t(w))
                ref = _jax_engine(rule, ref_impl, n, jnp.asarray(g), mask, w)
                # the JAX engine returns the leaf dtype; the port's flat
                # engine returns fp32 after the same rounding
                ours = tensor_to_numpy(ours.to(getattr(torch, dtype)))
                _assert_engine(ours.astype(np.float32),
                               np.asarray(ref).astype(np.float32), rule,
                               dtype, f"{ours_impl} {case} w={weighted}")


@pytest.mark.parametrize("rule", RULES)
def test_masked_engine_on_trees_matches_jax(rule):
    """spec.aggregate on a bf16 tree (raveled in bf16, as JAX's masked
    tree path does); a mixed bf16/fp32 tree raises, naming its slice."""
    n = 8
    rng = np.random.default_rng(4)
    mask = mask_of(n, "most", seed=5)
    w = weights_of(mask)
    a = rng.normal(size=(n, 5, 7)).astype(np.float32)
    c = rng.normal(size=(n, 11)).astype(np.float32)
    tree_np = {"a": np.asarray(jnp.asarray(a, jnp.bfloat16)),
               "b": {"c": np.asarray(jnp.asarray(c, jnp.bfloat16))}}
    ttree = {"a": t(tree_np["a"]), "b": {"c": t(tree_np["b"]["c"])}}
    jtree = jax.tree.map(jnp.asarray, tree_np)
    for ours_impl, ref_impl in _pairs(rule):
        spec = make_spec(rule, f=2, impl=ours_impl, n=n)
        ours = spec.aggregate(ttree, mask=torch.from_numpy(mask),
                              weights=t(w))
        ref = _jax_engine(rule, ref_impl, n, jtree, mask, w)
        for o, r in ((ours["a"], ref["a"]), (ours["b"]["c"], ref["b"]["c"])):
            assert str(o.dtype).replace("torch.", "") == str(r.dtype)
            _assert_engine(o.float().numpy(),
                           np.asarray(r).astype(np.float32), rule,
                           "bfloat16", ours_impl)
        mixed = {"a": ttree["a"], "b": {"c": t(c)}}
        with pytest.raises(NotImplementedError, match="slice 4b"):
            spec.aggregate(mixed, mask=torch.from_numpy(mask), weights=t(w))
