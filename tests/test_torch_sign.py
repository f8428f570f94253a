"""signSGD's majority vote in the port: K15 sign_vote, K16 masked_sign_vote,
the dense law and the registry entry, against the JAX package.

On the CPU each wrapper runs its plain PyTorch version, which is held
against the JAX kernel run in interpret mode (as the JAX suite runs it)
and, through ``spec.aggregate_flat``, against the JAX engine with
impl="pallas" (jitted, as the training steps run it).  The vote is a sum
of +-1 / 0, exact in fp32 for n < 2^24, so every bar here is exact
(``assert_array_equal``, which holds NaN equal to NaN and -0 equal to +0:
the sign of a zero vote is no part of the law).  Stacks of n = 3, 4, 8,
11 rows, d = 515 (not a multiple of JAX's 512-lane tile), fp32 and bf16,
with NaN, +-inf and +-0 rows; masks of n - 2, 1 and 0 rows arrived.

ROADMAP.md P10: the JAX law multiplies an absent row's signs by 0, so a
NaN there leaks into the vote (NaN * 0 = NaN); the port's K16 never reads
an absent row, as the law's own "absent rows cast NO vote" says.  The two
agree wherever the absent rows are finite (the async loop's stale
gradients always are).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.aggregators import make_spec as jax_make_spec
from repro.kernels.masked import masked_sign_vote as jax_masked_sign_vote
from repro.kernels.masked import sign_vote as jax_sign_vote
from repro.kernels.ops import _pad_d
from repro_torch import kernels
from repro_torch.convert import tensor_from_numpy as t
from repro_torch.core.aggregators import make_spec
from repro_torch.core.filters import dense as D

torch.set_num_threads(2)
D_ = 515
NS = [3, 4, 8, 11]


def stack(n, d, seed, hazard=None, dtype="float32"):
    g = (np.random.default_rng(seed).normal(size=(n, d)) * 2.0).astype(
        np.float32)
    if hazard == "nan":
        g[1, ::7] = np.nan
    elif hazard == "inf":
        g[0, ::3] = np.inf
        g[n - 1, 1::3] = -np.inf
    elif hazard == "zeros":
        g[:, ::2] = 0.0
        g[: n // 2, ::4] = -0.0
    elif hazard == "ties":
        g[1::2] = -g[0::2][: n // 2]               # opposite pairs: 0 votes
    return g if dtype == "float32" else np.array(
        jnp.asarray(g, jnp.bfloat16))


def arrivals(n, arrived, seed):
    m = np.zeros(n, np.float32)
    m[np.random.default_rng(seed).permutation(n)[:arrived]] = 1.0
    return m


def padded(g):
    gp, d = _pad_d(jnp.asarray(g))
    return gp, d


CASES = [(dt, hz) for dt in ("float32", "bfloat16")
         for hz in (None, "nan", "inf", "zeros", "ties")]


@pytest.mark.parametrize("dtype,hazard", CASES)
@pytest.mark.parametrize("n", NS)
def test_sign_vote_plain_matches_jax(n, dtype, hazard):
    g = stack(n, D_, seed=n, hazard=hazard, dtype=dtype)
    gp, d = padded(g)
    ref = np.asarray(jax_sign_vote(gp, interpret=True))[:d]
    ours = kernels.sign_vote(t(g)).numpy()
    np.testing.assert_array_equal(ours, ref)
    assert ours.dtype == np.float32
    np.testing.assert_array_equal(D.sign_sgd(t(g).float()).numpy(), ref)


@pytest.mark.parametrize("dtype,hazard", CASES)
@pytest.mark.parametrize("n", NS)
def test_masked_sign_vote_plain_matches_jax(n, dtype, hazard):
    """Hazards on the rows as drawn (arrived or not); where a NaN lies in
    an absent row the two laws part (P10), so that input is held by
    test_absent_nan_casts_no_vote instead."""
    for arrived in (max(n - 2, 1), 1, 0):
        m = arrivals(n, arrived, seed=n + arrived)
        g = stack(n, D_, seed=2 * n + arrived, hazard=hazard, dtype=dtype)
        if hazard == "nan" and m[1] <= 0.5:
            g[1] = 0.0
        wn = m / max(float(m.sum()), 1.0)
        gp, d = padded(g)
        ref = np.asarray(jax_masked_sign_vote(gp, jnp.asarray(m),
                                              jnp.asarray(wn),
                                              interpret=True))[:d]
        ours = kernels.masked_sign_vote(t(g), torch.from_numpy(m),
                                        torch.from_numpy(wn)).numpy()
        np.testing.assert_array_equal(ours, ref, err_msg=f"{arrived}")
        if arrived == 0:
            assert not ours.any()


def test_absent_nan_casts_no_vote():
    """P10: a NaN in an absent row poisons the JAX vote (its law computes
    sign(x) * 0); the port's vote is that of the arrived rows, which is
    what the JAX kernel gives once the absent row is dropped."""
    n = 8
    assert make_spec("sign_sgd", n=n).impl == "kernel"
    g = stack(n, D_, seed=3)
    m = np.ones(n, np.float32)
    m[[2, 6]] = 0.0
    g[2, ::5] = np.nan
    wn = m / m.sum()
    gp, d = padded(g)
    jax_out = np.asarray(jax_masked_sign_vote(gp, jnp.asarray(m),
                                              jnp.asarray(wn),
                                              interpret=True))[:d]
    assert np.isnan(jax_out[::5]).all()
    ours = kernels.masked_sign_vote(t(g), torch.from_numpy(m),
                                    torch.from_numpy(wn)).numpy()
    assert np.isfinite(ours).all()
    live = m > 0.5
    arrived_only = np.asarray(jax_sign_vote(padded(g[live])[0],
                                            interpret=True))[:d]
    np.testing.assert_array_equal(ours, arrived_only)
    # the gather law of the port agrees with its kernel path
    for impl in ("kernel", "gather"):
        out = make_spec("sign_sgd", n=n, impl=impl).aggregate_flat(
            t(g), mask=torch.from_numpy(live))
        np.testing.assert_array_equal(out.numpy(), ours, err_msg=impl)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_sign_sgd_engine_matches_jax(dtype):
    """The same arena gives exactly the same votes: sync, and masked with
    n - 2, 1 and 0 rows arrived, unweighted and weighted (the engine
    scales the vote by the mean arrived weight, as JAX's does)."""
    n = 8
    spec = make_spec("sign_sgd", f=2, n=n)
    assert spec.impl == "kernel"
    jspec = jax_make_spec("sign_sgd", f=2, impl="pallas", n=n)
    g = stack(n, D_, seed=9, hazard="zeros", dtype=dtype)
    ours = spec.aggregate_flat(t(g)).numpy()
    ref = np.asarray(jax.jit(jspec.aggregate)(jnp.asarray(g)))
    np.testing.assert_array_equal(ours, ref.astype(np.float32))
    run = jax.jit(lambda x, m, w: jspec.aggregate(x, mask=m, weights=w))
    for arrived in (n - 2, 1, 0):
        mask = arrivals(n, arrived, seed=arrived) > 0.5
        for weighted in (False, True):
            w = (np.where(mask, np.random.default_rng(arrived).uniform(
                0.3, 1.0, n), 0.0) if weighted else mask).astype(np.float32)
            ref = np.asarray(run(jnp.asarray(g), jnp.asarray(mask),
                                 jnp.asarray(w))).astype(np.float32)
            for impl in ("kernel", "gather"):
                ours = make_spec("sign_sgd", f=2, n=n, impl=impl) \
                    .aggregate_flat(t(g), mask=torch.from_numpy(mask),
                                    weights=torch.from_numpy(w))
                ours = ours.to(getattr(torch, dtype)).float().numpy()
                np.testing.assert_array_equal(
                    ours, ref, err_msg=f"{impl} {arrived} w={weighted}")


def test_sign_vote_wrappers_reject_bad_shapes():
    with pytest.raises(ValueError):
        kernels.sign_vote(torch.zeros(65, 4))
    with pytest.raises(ValueError):
        kernels.sign_vote(torch.zeros(4))
    with pytest.raises(ValueError):
        kernels.masked_sign_vote(torch.zeros(4, 8), torch.ones(3),
                                 torch.ones(3))
    with pytest.raises(NotImplementedError, match="slice 4"):
        make_spec("sign_sgd", native_dtype=True)
