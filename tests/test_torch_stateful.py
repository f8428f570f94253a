"""The state protocol and the wrapper protocol (the defenses with memory)
against the JAX package: ``init_state`` / ``update_state`` and their
nesting for centered_clip, zeno_pp and server_momentum, the refusals, the
recursion of ``respecialize`` and ``describe`` through a wrapper, and
zeno_pp's law on a tree.

The port keeps ``server_grad`` as one fp32 (P,) vector in the JAX leaf
order; ``repro_torch.convert.agg_state_from_numpy`` / ``_to_numpy`` carry
a JAX state tree onto it and back.  Bars: ema = 1 updates are exact (0 * s
+ 1 * a), zeno_pp's ema = 0.2 and every aggregate within fp32 rtol = atol
= 3e-6 (reassociated sums); zeno_pp's accepted support is exact.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.aggregators import _zeno_pp_weights as jax_zeno_pp_weights
from repro.core.aggregators import elastic as jax_elastic
from repro.core.aggregators import frac as jax_frac
from repro.core.aggregators import make_spec as jax_make_spec
from repro.core.aggregators import server_momentum as jax_server_momentum
from repro_torch.convert import (agg_state_from_numpy, agg_state_to_numpy,
                                 params_from_numpy)
from repro_torch.core.aggregators import (elastic, frac, make_spec,
                                          server_momentum, zeno_pp_weights)

torch.set_num_threads(2)
TOL = 3e-6
N, F = 8, 2


def proto_np():
    """A small single-agent tree (two leaves, jax.tree.flatten order a, b)."""
    return {"b": np.zeros((16,), np.float32),
            "a": np.zeros((4, 8), np.float32)}


def tree_np(seed, n=N, scale=1.0):
    rng = np.random.default_rng(seed)
    return {k: (rng.normal(size=(n,) + v.shape) * scale).astype(np.float32)
            for k, v in proto_np().items()}


def flat(tree):
    return np.concatenate([np.asarray(x).ravel()
                           for x in jax.tree.leaves(tree)])


def specs(name):
    """(jax spec, torch spec) of one of the stateful configurations."""
    if name == "server_momentum(trimmed_mean)":
        return (jax_server_momentum(jax_make_spec("trimmed_mean", f=F, n=N),
                                    beta=0.9),
                server_momentum(make_spec("trimmed_mean", f=F, n=N), beta=0.9))
    if name == "server_momentum(centered_clip)":
        return (jax_server_momentum(jax_make_spec("centered_clip", f=F,
                                                  tau=0.5), beta=0.8),
                server_momentum(make_spec("centered_clip", f=F, tau=0.5),
                                beta=0.8))
    return (jax_make_spec(name, f=F, n=N), make_spec(name, f=F, n=N))


STATEFUL = ["centered_clip", "zeno_pp", "server_momentum(trimmed_mean)",
            "server_momentum(centered_clip)"]


@pytest.mark.parametrize("name", STATEFUL)
def test_init_and_update_state_match_jax(name):
    """The initial state, and three updates from the same aggregates,
    carried onto the port's form; the nesting under "inner"."""
    js, ts = specs(name)
    assert ts.stateful and js.stateful
    jst = js.init_state(jax.tree.map(jnp.asarray, proto_np()))
    tst = ts.init_state(params_from_numpy(proto_np()))
    assert set(tst) == set(jst)
    want = agg_state_from_numpy(jax.tree.map(np.asarray, jst))
    np.testing.assert_array_equal(tst["server_grad"].numpy(),
                                  want["server_grad"].numpy())
    if name == "server_momentum(centered_clip)":
        assert set(tst["inner"]) == {"server_grad"}
    for k in range(3):
        agg = {kk: v[0] for kk, v in tree_np(40 + k, n=1).items()}
        jst = js.update_state(jst, jax.tree.map(jnp.asarray, agg))
        tst = ts.update_state(tst, params_from_numpy(agg))
        want = agg_state_from_numpy(jax.tree.map(np.asarray, jst))
        for path in (("server_grad",), ("inner", "server_grad")):
            if path[0] not in want:
                continue
            got, ref = tst, want
            for p in path:
                got, ref = got[p], ref[p]
            np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=TOL,
                                       atol=TOL, err_msg=f"{name} {path}")
    back = agg_state_to_numpy(tst, proto_np())
    assert jax.tree.structure(back) == jax.tree.structure(
        jax.tree.map(np.asarray, jst))


def test_the_ema_is_arithmetic_even_at_one():
    """(1 - ema) s + ema a at ema = 1: an inf in the carried state gives
    NaN (0 * inf), as in JAX, never a copy of a."""
    js, ts = specs("centered_clip")
    sg = np.full(48, np.inf, np.float32)
    agg = np.ones(48, np.float32)
    jout = js.update_state({"server_grad": jnp.asarray(sg)},
                           jnp.asarray(agg))["server_grad"]
    tout = ts.update_state({"server_grad": torch.from_numpy(sg)},
                           torch.from_numpy(agg))["server_grad"]
    assert np.isnan(np.asarray(jout)).all() and torch.isnan(tout).all()


@pytest.mark.parametrize("name", STATEFUL)
@pytest.mark.parametrize("masked", [False, True])
def test_stateful_tree_aggregate_matches_jax(name, masked):
    """spec.aggregate on a tree with a nonzero carried state (and the inner
    state where it nests): values within the fp32 bar, leaf dtypes as
    JAX's."""
    js, ts = specs(name)
    g = tree_np(5, scale=0.3)
    g["a"][:F] = -2.0 * g["a"][F:].mean(0)
    g["b"][:F] = -2.0 * g["b"][F:].mean(0)
    center = tree_np(6, n=1, scale=0.05)
    jst = {"server_grad": {k: jnp.asarray(v[0]) for k, v in center.items()}}
    if name == "server_momentum(centered_clip)":
        jst["inner"] = {"server_grad": jax.tree.map(lambda x: 0.5 * x,
                                                    jst["server_grad"])}
    tst = agg_state_from_numpy(jax.tree.map(np.asarray, jst))
    m = w = None
    if masked:
        m = np.ones(N, bool)
        m[[3, 6]] = False
        w = np.array([1, .5, 1, 1, 1 / 3, .5, 1, 1], np.float32)
    jout = js.aggregate(jax.tree.map(jnp.asarray, g),
                        None if m is None else jnp.asarray(m),
                        None if w is None else jnp.asarray(w), state=jst)
    tout = ts.aggregate(params_from_numpy(g),
                        None if m is None else torch.from_numpy(m),
                        None if w is None else torch.from_numpy(w),
                        state=tst)
    for k in ("a", "b"):
        assert str(tout[k].dtype).endswith(str(jout[k].dtype)), k
    np.testing.assert_allclose(flat({k: tout[k].numpy() for k in tout}),
                               flat(jout), rtol=TOL, atol=TOL)


# ---------------------------------------------------------------------------
# refusals and the wrapper protocol


def test_refusals_match_jax():
    for mk in (jax_make_spec, make_spec):
        with pytest.raises(ValueError, match="STATE"):
            mk("centered_clip", f=F, server_grad=0.0)
        with pytest.raises(ValueError, match="composition wrapper"):
            mk("server_momentum", f=F)
        with pytest.raises(ValueError, match="takes no inner"):
            mk("trimmed_mean", f=F, inner=mk("mean"))
    g = torch.zeros(N, 12)
    for spec in (make_spec("centered_clip", f=F),
                 server_momentum(make_spec("trimmed_mean", f=F))):
        with pytest.raises(ValueError, match="is stateful"):
            spec.aggregate_flat(g)
        with pytest.raises(ValueError, match="is stateful"):
            spec.aggregate({"a": g})
    with pytest.raises(ValueError, match="impl='kernel'"):
        make_spec("server_momentum", f=F, impl="kernel",
                  inner=make_spec("trimmed_mean", f=F))
    with pytest.raises(ValueError, match="impl='kernel'"):
        make_spec("zeno_pp", f=F, impl="kernel")
    assert make_spec("zeno_pp", f=F).impl == "gather"


def test_respecialize_and_describe_recurse_through_a_wrapper():
    jsp = jax_server_momentum(jax_make_spec(
        "trimmed_mean", f=jax_frac(0.25), n=jax_elastic(8, (4, 6, 8))))
    tsp = server_momentum(make_spec("trimmed_mean", f=frac(0.25),
                                    n=elastic(8, (4, 6, 8))))
    assert tsp.describe() == jsp.describe()
    assert tsp.elastic_n.buckets == jsp.elastic_n.buckets == (4, 6, 8)
    for n_live in range(1, 9):
        jb, tb = jsp.respecialize(n_live), tsp.respecialize(n_live)
        assert tb.describe() == jb.describe(), n_live
        assert (tb.inner.n, tb.inner.f) == (jb.inner.n, jb.inner.f)
        assert tb.inner.elastic is None
        assert tsp.respecialize(n_live) is tb          # cached
        assert tb.respecialize(tb.inner.n) is tb
        assert tb.stateful and not tb.inner.stateful
    assert "server_momentum(f=2, beta=0.9) -> trimmed_mean" in (
        tsp.respecialize(8).describe())


# ---------------------------------------------------------------------------
# zeno_pp: the delay-adaptive score filter


def zeno_case(case):
    """(tree, mask, weights, center tree, hyper) of one branch of the law."""
    rng = np.random.default_rng(70)
    base = {k: rng.normal(size=v.shape).astype(np.float32)
            for k, v in proto_np().items()}
    noise = tree_np(71, scale=0.5)
    g = {k: (base[k][None] + noise[k]).astype(np.float32) for k in base}
    zero = {k: np.zeros_like(v) for k, v in base.items()}
    m = np.ones(N, bool)
    w = np.ones(N, np.float32)
    hyper = {}
    if case == "step0":
        # v = 0; two sign-flipped rows and one scaled (norm-gated) row
        for k in g:
            g[k][:F] = -g[k][F:].mean(0)
            g[k][7] *= 10.0
        return g, m, w, zero, hyper
    if case == "rescue":
        # a stale row (w = 1/3: threshold 1/3) orthogonal to the reference
        # but aligned with the carried EMA v: rescued
        u = tree_np(72, n=1)
        u = {k: v[0] for k, v in u.items()}
        for k in g:
            g[k][5] = u[k] * 1.0
        w[5] = 1.0 / 3.0
        m[2] = False
        return g, m, w, u, hyper
    if case == "nothing_passes":
        # stale rows far off the reference, the fresh row against it:
        # nobody accepted, the norm-sane rows' discounted mean instead
        far = tree_np(73, scale=2.0)
        for k in g:
            g[k] = (base[k][None] + far[k]).astype(np.float32)
            g[k][0] = -base[k]
        w[1:] = 0.2
        return g, m, w, zero, dict(xi=0.99)
    # nothing norm-sane either: the plain discounted mean
    w[3] = 0.5
    return g, m, w, zero, dict(c_norm=0.1)


@pytest.mark.parametrize("case", ["step0", "rescue", "nothing_passes",
                                  "no_sane_row"])
def test_zeno_pp_matches_jax_on_a_tree(case):
    g, m, w, center, hyper = zeno_case(case)
    jspec = jax_make_spec("zeno_pp", f=F, n=N, **hyper)
    tspec = make_spec("zeno_pp", f=F, n=N, **hyper)
    jst = {"server_grad": jax.tree.map(jnp.asarray, center)}
    tst = agg_state_from_numpy({"server_grad": center})
    jg = jax.tree.map(jnp.asarray, g)
    jw = np.asarray(jax_zeno_pp_weights(jspec, jg, jnp.asarray(m),
                                        jnp.asarray(w), jst))
    xf = torch.from_numpy(np.concatenate(
        [np.asarray(l).reshape(N, -1) for l in jax.tree.leaves(g)], 1))
    tw = zeno_pp_weights(tspec, xf, torch.from_numpy(m), torch.from_numpy(w),
                         tst).numpy()
    np.testing.assert_array_equal(tw > 0, jw > 0)     # the accepted support
    np.testing.assert_allclose(tw, jw, rtol=TOL, atol=TOL)
    if case == "step0":
        assert not (jw[:F] > 0).any() and jw[7] == 0 and (jw[F:7] > 0).all()
    if case == "rescue":
        assert jw[5] > 0 and jw[2] == 0
    if case == "nothing_passes":
        np.testing.assert_allclose(jw, w / w.sum(), rtol=TOL)
    jout = jspec.aggregate(jg, jnp.asarray(m), jnp.asarray(w), state=jst)
    tout = tspec.aggregate(params_from_numpy(g), torch.from_numpy(m),
                           torch.from_numpy(w), state=tst)
    np.testing.assert_allclose(flat({k: tout[k].numpy() for k in tout}),
                               flat(jout), rtol=TOL, atol=TOL)
