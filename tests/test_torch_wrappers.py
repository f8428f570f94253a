"""The row-transform wrappers (clipped, bucketed, staleness_discounted)
and zeno against the JAX package.

In JAX the wrappers and zeno are not flat-capable: the JAX loops run
them on the tree engine.  The port gives each a flat law on the (n, P)
arena (the loops' route) and a tree route that is the JAX tree law, and
both are held here against the JAX tree engine: on stacks and on trees
of fp32 and bf16 leaves, synchronous and masked (bucketed refuses a
mask, as in JAX), around kernel rules (trimmed_mean, krum: JAX's
``pallas``, the port's ``kernel``) and a dense one (cgc).  Then zeno's
state protocol, the async loop's refusal of a ``staleness_aware`` spec
(JAX's reason), one synchronous step of each wrapper and one async step
of clipped on ``paper-100m-smoke``, and two async zeno steps carrying
its state, each side's starting state carried across with
``repro_torch.convert``.

Bars: fp32 within rtol = atol = 3e-6 (the clip norm is one sum over the
row in the flat law, a sum of per-leaf sums in JAX's), bf16 leaves within
2e-2; the loop steps within the slice bars (loss 1e-5, the rest 1e-4).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core.aggregators as JA
import repro.simulator as JS
import repro_torch.core.aggregators as TA
import repro_torch.simulator as TS
import test_torch_helpers as H
from repro_torch.convert import agg_state_from_numpy, params_from_numpy

torch.set_num_threads(2)
TOL = 3e-6
BF16_TOL = 2e-2
N, F, DIM = 8, 2, 300


def inner_pair(inner, f=F):
    if inner == "cgc":
        return (JA.make_spec("cgc", f=f, impl="gather"),
                TA.make_spec("cgc", f=f))
    ts = TA.make_spec(inner, f=f)
    assert ts.impl == "kernel"
    return JA.make_spec(inner, f=f, impl="pallas"), ts


def wrap(name, inner, f=F):
    """(jax wrapper spec, torch wrapper spec) of ``name`` around
    ``inner``."""
    ji, ti = inner_pair(inner, f)
    if name == "clipped":
        return JA.clipped(ji, tau=20.0), TA.clipped(ti, tau=20.0)
    if name == "bucketed":
        return JA.bucketed(ji, group_size=2), TA.bucketed(ti, group_size=2)
    return (JA.staleness_discounted(ji, weighting="exp", gamma=0.6),
            TA.staleness_discounted(ti, weighting="exp", gamma=0.6))


def stack_np(seed=0):
    return (np.random.default_rng(seed).normal(size=(N, DIM)) * 2.0).astype(
        np.float32)


def weights_for(name):
    """The mask and weights of a straggler row: discount multipliers, or
    raw staleness rounds for staleness_discounted."""
    m = np.ones(N, bool)
    m[[2, 5]] = False
    if name == "staleness_discounted":
        w = np.array([0, 1, 0, 2, 3, 0, 1, 0], np.float32)
    else:
        w = np.where(m, np.linspace(0.5, 1.0, N), 0.0).astype(np.float32)
    return m, w


CASES = [(w, i) for w in ("clipped", "bucketed", "staleness_discounted")
         for i in ("trimmed_mean", "krum", "cgc")]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name,inner,masked", [
    (w, i, m) for w, i in CASES for m in (False, True)
    if not (m and w == "bucketed")])     # bucketed refuses a mask
def test_wrapper_on_the_arena_matches_jax(name, inner, dtype, masked):
    js, ts = wrap(name, inner)
    assert ts.flat_capable and not js.flat_capable
    g = stack_np()
    kw_j, kw_t = {}, {}
    if masked:
        m, w = weights_for(name)
        kw_j = dict(mask=jnp.asarray(m), weights=jnp.asarray(w))
        kw_t = dict(mask=torch.from_numpy(m), weights=torch.from_numpy(w))
    want = js.aggregate(jnp.asarray(g).astype(dtype), **kw_j)
    ours = ts.aggregate_flat(torch.from_numpy(g).to(getattr(torch, dtype)),
                             **kw_t)
    tol = TOL if dtype == "float32" else BF16_TOL
    np.testing.assert_allclose(ours.numpy(), np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("name,masked", [
    ("clipped", False), ("clipped", True), ("bucketed", False),
    ("staleness_discounted", False), ("staleness_discounted", True)])
def test_wrapper_on_a_tree_matches_jax(name, masked):
    """A tree of an fp32 and a bf16 leaf around trimmed_mean: the leaf
    dtypes and values of the JAX tree law."""
    js, ts = wrap(name, "trimmed_mean")
    g = stack_np(3)
    jt = {"a": jnp.asarray(g[:, :200]).reshape(N, 10, 20),
          "b": jnp.asarray(g[:, 200:]).astype(jnp.bfloat16)}
    tt = {"a": torch.from_numpy(g[:, :200].copy()).reshape(N, 10, 20),
          "b": torch.from_numpy(g[:, 200:].copy()).to(torch.bfloat16)}
    kw_j, kw_t = {}, {}
    if masked:
        m, w = weights_for(name)
        kw_j = dict(mask=jnp.asarray(m), weights=jnp.asarray(w))
        kw_t = dict(mask=torch.from_numpy(m), weights=torch.from_numpy(w))
    want = js.aggregate(jt, **kw_j)
    ours = ts.aggregate(tt, **kw_t)
    assert ours["a"].dtype == torch.float32
    assert ours["b"].dtype == torch.bfloat16
    np.testing.assert_allclose(ours["a"].numpy(), np.asarray(want["a"]),
                               rtol=TOL, atol=TOL)
    np.testing.assert_allclose(ours["b"].float().numpy(),
                               np.asarray(want["b"], np.float32),
                               rtol=BF16_TOL, atol=BF16_TOL)


def test_bucketed_refuses_a_mask():
    js, ts = wrap("bucketed", "trimmed_mean")
    g = stack_np()
    with pytest.raises(ValueError) as je:
        js.aggregate(jnp.asarray(g), mask=jnp.ones(N, bool))
    for call in (lambda: ts.aggregate_flat(torch.from_numpy(g),
                                           mask=torch.ones(N, dtype=bool)),
                 lambda: ts.aggregate({"a": torch.from_numpy(g)},
                                      weights=torch.ones(N))):
        with pytest.raises(ValueError) as te:
            call()
        assert str(te.value) == str(je.value)
    with pytest.raises(ValueError, match="not divisible"):
        TA.bucketed(TA.make_spec("mean"), group_size=3).aggregate_flat(
            torch.from_numpy(g))


def test_wrapper_specs_match_jax():
    """describe(), the caps the loops read and the nesting of state."""
    for name in ("clipped", "bucketed", "staleness_discounted"):
        js, ts = wrap(name, "trimmed_mean")
        assert ts.describe() == js.describe()
        assert ts.staleness_aware == js.staleness_aware
        assert not ts.stateful and ts.init_state(torch.zeros(3)) == {}
    z = TA.clipped(TA.make_spec("zeno", f=F, ema=0.5))
    st = z.init_state(torch.zeros(3))
    assert set(st) == {"inner"} and st["inner"]["server_grad"].shape == (3,)


def test_async_loop_refuses_staleness_aware():
    cfg, jcfg = H.configs()
    js, ts = wrap("staleness_discounted", "trimmed_mean")
    with pytest.raises(ValueError) as je:
        JS.make_async_step(jcfg, H.JaxBz(n_agents=N, f=F, aggregator=js),
                           H.jopt.sgd(H.jopt.constant(0.1)))
    bz = H.ByzantineConfig(n_agents=N, f=F, aggregator=ts)
    ds = H.SyntheticLM(cfg.vocab_size, H.SEQ, N, H.BATCH)
    for call in (lambda: TS.async_train_loop(
            cfg, bz, H.topt.sgd(H.topt.constant(0.1)), ds, steps=1,
            device="cpu"),
                 lambda: TS.make_async_step(cfg, bz, None, device="cpu")):
        with pytest.raises(ValueError) as te:
            call()
        assert str(te.value) == str(je.value)


# ---------------------------------------------------------------------------
# zeno's state protocol


def test_zeno_state_protocol_matches_jax():
    proto = {"b": np.zeros((16,), np.float32),
             "a": np.zeros((4, 8), np.float32)}
    js = JA.make_spec("zeno", f=F, ema=0.3, impl="gather")
    ts = TA.make_spec("zeno", f=F, ema=0.3)
    jst = js.init_state(jax.tree.map(jnp.asarray, proto))
    tst = ts.init_state(params_from_numpy(proto))
    for k in range(3):
        agg = {kk: np.random.default_rng(k).normal(size=v.shape).astype(
            np.float32) for kk, v in proto.items()}
        jst = js.update_state(jst, jax.tree.map(jnp.asarray, agg))
        tst = ts.update_state(tst, params_from_numpy(agg))
        want = agg_state_from_numpy(jax.tree.map(np.asarray, jst))
        np.testing.assert_allclose(tst["server_grad"].numpy(),
                                   want["server_grad"].numpy(), rtol=TOL,
                                   atol=TOL)
    for mod, p in ((JA, jnp.zeros(3)), (TA, torch.zeros(3))):
        with pytest.raises(ValueError, match="ema=0"):
            mod.make_spec("zeno", f=F).init_state(p)
    keep = {"server_grad": torch.ones(3)}
    assert torch.equal(TA.make_spec("zeno", f=F).update_state(
        keep, torch.zeros(3))["server_grad"], keep["server_grad"])


# ---------------------------------------------------------------------------
# the loops


@pytest.mark.parametrize("name", ["clipped", "bucketed",
                                  "staleness_discounted"])
def test_sync_step_matches_jax(name):
    inner = "krum" if name == "bucketed" else "trimmed_mean"
    ji, ti = inner_pair(inner)
    ji = JA.make_spec(inner, f=F, impl="pallas", n=N)
    ti = TA.make_spec(inner, f=F, n=N)
    if name == "clipped":
        specs = JA.clipped(ji, tau=0.05), TA.clipped(ti, tau=0.05)
    elif name == "bucketed":
        specs = JA.bucketed(ji), TA.bucketed(ti)
    else:
        specs = JA.staleness_discounted(ji), TA.staleness_discounted(ti)
    (jl, tl, ja, ta, jpar, tpar), = H.run_slice(None, 0.0, steps=1,
                                                specs=specs)
    np.testing.assert_allclose(tl, jl, rtol=H.LOGIT_TOL, atol=H.LOGIT_TOL)
    np.testing.assert_allclose(ta, ja, rtol=H.GRAD_TOL, atol=H.GRAD_TOL)
    np.testing.assert_allclose(tpar, jpar, rtol=H.GRAD_TOL,
                               atol=H.GRAD_TOL)


def check_async_steps(specs, steps, stateful=False):
    out = H.run_async(None, 0.0, steps=steps, specs=lambda trace: specs)
    for step, o in enumerate(out):
        jl, tl, ja, ta, jpar, tpar, jbuf, tbuf, jsg, tsg = o
        msg = f"{specs[1].describe()} async step {step}"
        np.testing.assert_allclose(tl, jl, rtol=H.LOGIT_TOL,
                                   atol=H.LOGIT_TOL, err_msg=msg)
        pairs = [(ta, ja), (tpar, jpar), (tbuf, jbuf)]
        if stateful:
            assert np.abs(tsg).max() > 0 or step == 0
            pairs.append((tsg, jsg))
        for ours, ref in pairs:
            np.testing.assert_allclose(ours, ref, rtol=H.GRAD_TOL,
                                       atol=H.GRAD_TOL, err_msg=msg)


def test_async_clipped_step_matches_jax():
    check_async_steps((JA.clipped(JA.make_spec("trimmed_mean", f=F,
                                               impl="pallas", n=N),
                                  tau=0.05),
                       TA.clipped(TA.make_spec("trimmed_mean", f=F, n=N),
                                  tau=0.05)), steps=1)


def test_async_zeno_steps_carry_the_state():
    """Two steps: the second starts from the server_grad each side
    carried out of the first (its EMA of the first aggregate)."""
    check_async_steps((JA.make_spec("zeno", f=F, n=N, ema=0.5, rho=1e-3,
                                    impl="gather"),
                       TA.make_spec("zeno", f=F, n=N, ema=0.5, rho=1e-3)),
                      steps=2, stateful=True)
