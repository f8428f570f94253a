"""sparse_mean, the sparse / dropout-aware mean of the compressed exchange:
K17 sparse_masked_weighted_mean and K21 scaled_sparse_masked_weighted_mean,
the four dispatch entries, ``aggregate_flat`` on both impls and the tree
path, against the JAX package.

A zero coordinate means "not sent": each coordinate is averaged over the
live rows that sent it, weighted by the raw row weights, and is an exact
0 where nobody sent it.  On the CPU each wrapper runs its plain version,
which is held to the JAX gather law (``_sparse_mean_law``, reached here
through the JAX gather engine) within rtol = atol = 3e-6: the plain
version sums in row order, the JAX law reassociates.  The JAX Pallas
kernels are themselves up to 3.6e-7 off that law (ROADMAP.md R1 b), so
they are held to it within the same bar, not bitwise.  bf16 tree leaves
are rounded after that sum: 2e-2.

Hazards: an inf or NaN in a live row of weight 0 (unsent: never read into
the sums), a live NaN (sent: its column is NaN), -0.0 (not sent), an
all-zero column (an exact 0), a dead row of NaN, and under K21 an inf row,
whose scale is inf, so its 0 codes decode to 0 * inf = NaN: sent, and
every column where the row is live is NaN.
"""
import functools

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.core.aggregators import make_spec as jax_make_spec
from repro.core.filters.dense import sparse_mean as jax_dense_sparse_mean
from repro.kernels.dispatch import (pallas_masked_aggregate,
                                    pallas_scaled_masked_aggregate)
from repro_torch import kernels
from repro_torch.convert import tensor_from_numpy, tensor_to_numpy
from repro_torch.core.aggregators import list_aggregators, make_spec
from repro_torch.core.filters.dense import sparse_mean as dense_sparse_mean
from repro_torch.core.flat import quantize_rows
from repro_torch.kernels import dispatch

torch.set_num_threads(2)
TOL, BF16_TOL = 3e-6, 2e-2
N, D = 8, 515                   # d not a multiple of JAX's 512-lane tile
LIVE = [8, 6, 1, 0]
DISCOUNTS = np.array([1.0, 0.5, 1.0 / 3.0], np.float32)
HAZARDS = [None, "unsent_nonfinite", "live_nan", "neg_zero", "dead_nan"]
QDTYPES = ["int8", "float8_e4m3fn"]


def sparse_stack(seed, n=N, d=D):
    """(n, d) fp32: normal * 2 with about half the values 0 (not sent),
    columns 0-6 sent by nobody, column 7 by one row only."""
    rng = np.random.default_rng(seed)
    g = (rng.normal(size=(n, d)) * 2.0).astype(np.float32)
    g[rng.random((n, d)) < 0.5] = 0.0
    g[:, :7] = 0.0
    g[1:, 7] = 0.0
    return g


def mask_of(live, seed, n=N):
    m = np.zeros(n, bool)
    m[np.random.default_rng(seed).permutation(n)[:live]] = True
    return m


def weights_of(mask):
    """Raw staleness discounts {1, 1/2, 1/3} on the live rows, 0 on the
    dead ones."""
    return (DISCOUNTS[np.arange(mask.size) % 3] * mask).astype(np.float32)


def put_hazard(g, mask, w, hazard):
    """(g, w) with a hazard written at rows picked by the mask."""
    g, w = g.copy(), w.copy()
    live, dead = np.flatnonzero(mask), np.flatnonzero(~mask)
    if hazard == "unsent_nonfinite" and live.size:
        w[live[0]] = 0.0
        g[live[0], 8::3], g[live[0], 9::3] = np.inf, np.nan
    elif hazard == "live_nan" and live.size:
        g[live[-1], 8::5] = np.nan
    elif hazard == "neg_zero":
        g[:, 8::2] = np.where(g[:, 8::2] == 0, np.float32(-0.0),
                              g[:, 8::2])
        g[:, 9::4] = -0.0
    elif hazard == "dead_nan" and dead.size:
        g[dead[0]] = np.nan
    return g, w


def t(a):
    return tensor_from_numpy(a)


@functools.lru_cache(maxsize=None)
def _jax_flat_fn(impl, masked):
    """The jitted JAX sparse_mean call, built once per (impl, masked) so
    that the cases of one shape share its compile."""
    spec = jax_make_spec("sparse_mean", f=2, impl=impl)
    if masked:
        return jax.jit(lambda s, m, w, q: spec.aggregate_flat(
            s, mask=m, weights=w, scale=q))
    return jax.jit(lambda s, q: spec.aggregate_flat(s, scale=q))


def jax_flat(stack, mask, w, qs=None, impl="gather"):
    """The JAX engine's sparse_mean on the arena (jitted, as the JAX steps
    run it); ``stack`` numpy (fp32, ml_dtypes bf16 / int8 / fp8)."""
    scale = None if qs is None else jnp.asarray(qs)
    fn = _jax_flat_fn(impl, mask is not None)
    if mask is None:
        return np.asarray(fn(jnp.asarray(stack), scale))
    return np.asarray(fn(jnp.asarray(stack), jnp.asarray(mask),
                         jnp.asarray(w), scale))


def close(ours, ref, tol=TOL, msg=""):
    np.testing.assert_allclose(np.asarray(ours, np.float32),
                               np.asarray(ref, np.float32), rtol=tol,
                               atol=tol, err_msg=msg)


def jax_codes(tc, qdt):
    raw = tc.view(torch.uint8).numpy()
    return raw.view(np.int8) if qdt == "int8" else raw.view(
        ml_dtypes.float8_e4m3fn)


# ---------------------------------------------------------------------------
# K17 and K21 (their plain versions on the CPU)


@pytest.mark.parametrize("hazard", HAZARDS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_sparse_kernel_plain_matches_jax_law(dtype, hazard):
    """K17 against the JAX gather law and the JAX Pallas kernel (interpret
    mode), every live count, unit and raw staleness weights."""
    base = sparse_stack(1)
    for k, live in enumerate(LIVE):
        mask = mask_of(live, 10 + k)
        for weighted in (False, True):
            w = weights_of(mask) if weighted else mask.astype(np.float32)
            g, w = put_hazard(base, mask, w, hazard)
            if dtype == "bfloat16":
                g = np.asarray(jnp.asarray(g, jnp.bfloat16))
            msg = f"{dtype} {hazard} live={live} weighted={weighted}"
            mf = mask.astype(np.float32)
            ours = kernels.sparse_masked_weighted_mean(t(g), t(mf), t(w))
            assert ours.dtype == torch.float32
            law = jax_flat(g, mask, w)
            close(ours.numpy(), law, msg=msg)
            pallas = pallas_masked_aggregate("sparse_mean", jnp.asarray(g),
                                             jnp.asarray(mf), jnp.asarray(w),
                                             2)
            close(np.asarray(pallas), law, msg=msg + " (JAX pallas)")
            # nobody sent columns 0-6: an exact 0, never NaN
            assert not ours[:7].any(), msg
            if hazard == "live_nan" and live:
                assert torch.isnan(ours[8::5]).all(), msg
            if hazard in ("unsent_nonfinite", "dead_nan", "neg_zero"):
                assert torch.isfinite(ours).all(), msg


@pytest.mark.parametrize("hazard", [None, "nan", "inf", "zero_row",
                                    "neg_zero", "zero_scale"])
@pytest.mark.parametrize("qdt", QDTYPES)
def test_scaled_sparse_kernel_plain_matches_jax_law(qdt, hazard):
    """K21 on int8 / fp8 codes against the JAX law on the dequantized
    rows; an inf row (scale inf) poisons every column where it is live
    and changes nothing where it is dead; a -0 code (fp8: tiny negative
    values) and a row of scale 0 (its codes decode to +-0) are not
    sent."""
    g = sparse_stack(2)
    if hazard == "nan":
        g[1, ::3] = np.nan
    elif hazard == "inf":
        g[0, 8::4], g[0, 9::4] = np.inf, -np.inf
    elif hazard == "zero_row":
        g[N - 1] = 0.0
    elif hazard == "neg_zero":
        g[2, 8::3] = -1e-30
    tc, ts = quantize_rows(torch.from_numpy(g), qdt)
    if hazard == "neg_zero" and qdt == "float8_e4m3fn":
        assert (tc.view(torch.uint8)[2, 8::3] == 0x80).all()
    elif hazard == "zero_scale":
        ts[N - 2] = 0.0
    jc = jax_codes(tc, qdt)
    for k, live in enumerate(LIVE):
        mask = mask_of(live, 20 + k)
        if hazard == "inf" and live not in (0, N):
            mask = np.roll(mask, -int(np.flatnonzero(mask)[0]))  # row 0 live
        for weighted in (False, True):
            w = weights_of(mask) if weighted else mask.astype(np.float32)
            mf = mask.astype(np.float32)
            msg = f"{qdt} {hazard} live={live} weighted={weighted}"
            ours = kernels.scaled_sparse_masked_weighted_mean(tc, ts, t(mf),
                                                              t(w))
            law = jax_flat(jc, mask, w, ts.numpy())
            close(ours.numpy(), law, msg=msg)
            pallas = pallas_scaled_masked_aggregate(
                "sparse_mean", jnp.asarray(jc), jnp.asarray(ts.numpy()),
                jnp.asarray(mf), jnp.asarray(w), 2)
            close(np.asarray(pallas), law, msg=msg + " (JAX pallas)")
            if hazard == "inf" and mask[0]:
                assert torch.isnan(ours).all(), msg
            elif hazard != "nan" or not mask[1]:
                assert torch.isfinite(ours).all(), msg
                assert not ours[:7].any(), msg


def test_sparse_hazards_by_hand():
    """The law on a hand-made stack: who sent what."""
    inf, nan = np.inf, np.nan
    g = np.array([[0.0, -0.0, 2.0, 1.0, inf, 3.0],
                  [0.0, 4.0, 0.0, nan, 0.0, 5.0],
                  [0.0, 0.0, 6.0, 1.0, 0.0, nan]], np.float32)
    mask = np.array([1, 1, 0], np.float32)        # row 2 is dead
    w = np.array([1.0, 0.5, 1.0], np.float32)
    out = kernels.sparse_masked_weighted_mean(t(g), t(mask), t(w)).numpy()
    assert out[0] == 0.0 and not np.signbit(out[0])   # nobody sent it
    assert out[1] == 4.0                  # -0.0 is not sent
    assert out[2] == 2.0                  # the dead row's 6 is not read
    assert np.isnan(out[3])               # a live NaN was sent
    assert out[4] == inf                  # a live inf was sent
    assert out[5] == np.float32((3.0 + 2.5) / 1.5)   # the dead NaN is not
    w0 = np.array([0.0, 0.5, 1.0], np.float32)       # row 0 sends nothing
    out = kernels.sparse_masked_weighted_mean(t(g), t(mask), t(w0)).numpy()
    assert out[4] == 0.0 and out[2] == 0.0 and out[5] == 5.0
    np.testing.assert_array_equal(out, jax_flat(g, mask > 0, w0))


def test_dense_oracle_matches_jax():
    g = sparse_stack(3)
    g[2, ::5] = np.nan
    np.testing.assert_allclose(dense_sparse_mean(t(g)).numpy(),
                               np.asarray(jax_dense_sparse_mean(
                                   jnp.asarray(g))), rtol=TOL, atol=TOL)


# ---------------------------------------------------------------------------
# the engine: aggregate_flat on both impls, the dispatch tables


def test_sparse_mean_spec_resolves_to_its_kernels():
    spec = make_spec("sparse_mean", f=2)
    assert spec.impl == "kernel" and spec.flat_capable
    assert list_aggregators("compressed") == ["sparse_mean"]
    for table in (dispatch.KERNEL_RULES, dispatch.KERNEL_MASKED_RULES,
                  dispatch.KERNEL_SCALED_RULES,
                  dispatch.KERNEL_SCALED_MASKED_RULES):
        assert "sparse_mean" in table
    assert dispatch.kernel_scaled_supported("sparse_mean")
    with pytest.raises(ValueError, match="hyper"):
        make_spec("sparse_mean", f=2, beta=0.1)


@pytest.mark.parametrize("mode", ["sync", "masked", "weighted"])
@pytest.mark.parametrize("arena", ["float32", "bfloat16", "int8",
                                   "float8_e4m3fn"])
@pytest.mark.parametrize("impl", ["kernel", "gather"])
def test_aggregate_flat_matches_jax(impl, arena, mode):
    """``aggregate_flat(stack, mask=, weights=, scale=)`` against the JAX
    gather engine on the same arena (codes and scales for int8 / fp8)."""
    g = sparse_stack(4)
    mask = mask_of(6, 4)
    w = weights_of(mask) if mode == "weighted" else None
    if arena in QDTYPES:
        tc, qs = quantize_rows(torch.from_numpy(g), arena)
        ours_in, ref_in, ref_qs = tc, jax_codes(tc, arena), qs.numpy()
    else:
        ref_in = g if arena == "float32" else np.asarray(
            jnp.asarray(g, jnp.bfloat16))
        ours_in, qs, ref_qs = t(ref_in), None, None
    spec = make_spec("sparse_mean", f=2, impl=impl, n=N)
    if mode == "sync":
        ours = spec.aggregate_flat(ours_in, scale=qs)
        ref = jax_flat(ref_in, None, None, ref_qs)
    else:
        ours = spec.aggregate_flat(ours_in, mask=torch.from_numpy(mask),
                                   weights=None if w is None else t(w),
                                   scale=qs)
        ref = jax_flat(ref_in, mask, np.ones(N, np.float32) if w is None
                       else w, ref_qs)
    assert ours.dtype == torch.float32 and ours.shape == (D,)
    close(ours.numpy(), ref, msg=f"{impl} {arena} {mode}")


def test_dispatch_entries_get_raw_weights(monkeypatch):
    """The synchronous entries run K17 / K21 with mask and weights all
    ones; the masked entries get the RAW mask-folded row weights (not w /
    tot), and no other kernel runs."""
    seen = []

    def spy(name):
        real = getattr(dispatch, name)

        def fn(*a):
            seen.append((name, [x.clone() for x in a[-2:]]))
            return real(*a)
        monkeypatch.setattr(dispatch, name, fn)

    spy("sparse_masked_weighted_mean")
    spy("scaled_sparse_masked_weighted_mean")
    g = t(sparse_stack(5))
    tc, qs = quantize_rows(g, "int8")
    mask = torch.from_numpy(mask_of(6, 5))
    w = t(weights_of(mask.numpy()) * 3.0)
    spec = make_spec("sparse_mean", f=2, n=N)
    kernels.reset_launch_counts()
    spec.aggregate_flat(g)
    spec.aggregate_flat(tc, scale=qs)
    spec.aggregate_flat(g, mask=mask, weights=w)
    spec.aggregate_flat(tc, mask=mask, weights=w, scale=qs)
    names = [s[0] for s in seen]
    assert names == ["sparse_masked_weighted_mean",
                     "scaled_sparse_masked_weighted_mean"] * 2
    ones = torch.ones(N)
    for _, (m, wt) in seen[:2]:
        assert torch.equal(m, ones) and torch.equal(wt, ones)
    for _, (m, wt) in seen[2:]:
        assert torch.equal(m, mask.float())
        assert torch.equal(wt, w * mask.float())        # raw, not w / tot
    assert not any(kernels.launch_counts().values())    # plain on the CPU


# ---------------------------------------------------------------------------
# the tree path


def _tree(seed):
    """A {bf16, fp32} tree of sparse leaves (numpy, ml_dtypes bf16)."""
    g = sparse_stack(seed, d=5 * 7 + 11 + 13)
    a = np.asarray(jnp.asarray(g[:, :35].reshape(N, 5, 7), jnp.bfloat16))
    return {"a": a, "b": {"c": g[:, 35:46], "e": np.asarray(
        jnp.asarray(g[:, 46:], jnp.bfloat16))}}


@pytest.mark.parametrize("impl", ["kernel", "gather"])
def test_sparse_mean_tree_matches_jax_gather_tree(impl):
    """``spec.aggregate`` on a mixed bf16 / fp32 tree, synchronous and
    masked with raw weights, leaf for leaf against the JAX gather tree
    path (its per-leaf law): each leaf in its own dtype."""
    tree = _tree(6)
    ttree = {"a": t(tree["a"]), "b": {k: t(v) for k, v in
                                      tree["b"].items()}}
    jtree = jax.tree.map(jnp.asarray, tree)
    mask = mask_of(6, 6)
    w = weights_of(mask)
    spec = make_spec("sparse_mean", f=2, impl=impl, n=N)
    jspec = jax_make_spec("sparse_mean", f=2, impl="gather", n=N)
    kernels.reset_launch_counts()
    for args, jargs in (({}, {}),
                        (dict(mask=torch.from_numpy(mask), weights=t(w)),
                         dict(mask=jnp.asarray(mask),
                              weights=jnp.asarray(w)))):
        ours = spec.aggregate(ttree, **args)
        ref = jax.jit(lambda g: jspec.aggregate(g, **jargs))(jtree)
        for o, r in ((ours["a"], ref["a"]), (ours["b"]["c"], ref["b"]["c"]),
                     (ours["b"]["e"], ref["b"]["e"])):
            assert str(o.dtype).replace("torch.", "") == str(r.dtype)
            assert tuple(o.shape) == r.shape
            tol = TOL if r.dtype == np.float32 else BF16_TOL
            close(tensor_to_numpy(o), np.asarray(r).astype(np.float32), tol,
                  msg=f"{impl} {args.keys()}")
