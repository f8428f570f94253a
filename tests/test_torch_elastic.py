"""Elastic membership in the port against the JAX package: ``ElasticN``,
``elastic``, ``frac``, ``respecialize`` and ``pack``; and the step-build
contract of the async loop under churn.

The bar is equality: per-bucket (n, f) and the packed index arrays equal
JAX's, ``respecialize`` returns the same object for the same bucket, and a
run under ``Churn(rate=0.25, mean_out=2.0)`` builds at most
``len(buckets)`` async steps and at most one synchronous step (the port's
meaning of the JAX package's compile budget,
tests/test_membership_retrace.py:53).  The synchronous bucket step is
held to JAX's within the slice-1 bars.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_helpers as H
from repro.core.aggregators import elastic as jax_elastic
from repro.core.aggregators import frac as jax_frac
from repro.core.aggregators import make_spec as jax_make_spec
from repro.training.step import make_train_step as jax_make_train_step
from repro_torch.configs import get_config
from repro_torch.convert import params_from_numpy, params_to_numpy
from repro_torch.core.aggregators import elastic, frac, make_spec
from repro_torch.data import SyntheticLM
from repro_torch.obs.counters import counter_delta, snapshot
from repro_torch.optim import adamw, constant
from repro_torch.simulator import Churn, SimConfig, async_train_loop
from repro_torch.training import ByzantineConfig, make_train_step

torch.set_num_threads(2)

SPECS = [
    ("trimmed_mean", (0.25, 0), (8, (4, 6, 8))),
    ("coordinate_median", (0.2, 1), (10, 4)),
    ("krum", (0.25, 0), (8, 3)),
    ("trimmed_mean", None, (12, (3, 5, 9, 12))),
]


def both(rule, fr, el):
    n_max, buckets = el
    jf = 2 if fr is None else jax_frac(*fr)
    tf = 2 if fr is None else frac(*fr)
    return (jax_make_spec(rule, f=jf, n=jax_elastic(n_max, buckets)),
            make_spec(rule, f=tf, n=elastic(n_max, buckets)))


@pytest.mark.parametrize("rule,fr,el", SPECS)
def test_respecialize_matches_jax_for_every_live_count(rule, fr, el):
    js, ts = both(rule, fr, el)
    assert ts.f == js.f and ts.n == js.n
    assert ts.elastic.buckets == js.elastic.buckets
    for n_live in range(1, el[0] + 1):
        jb, tb = js.respecialize(n_live), ts.respecialize(n_live)
        assert (tb.n, tb.f) == (jb.n, jb.f), n_live
        assert tb.elastic is None and tb.f_policy is None
        assert ts.respecialize(n_live) is tb            # cached object
        live = np.sort(np.random.default_rng(n_live).permutation(
            el[0])[:n_live])
        jpk, tpk = js.elastic.pack(live), ts.elastic.pack(live)
        assert jpk[0] == tpk[0]
        for a, b in zip(jpk[1:], tpk[1:]):
            np.testing.assert_array_equal(b, a)
            assert b.dtype == a.dtype
    for n_live in range(1, el[0] + 1):                  # same bucket, same obj
        tb = ts.respecialize(n_live)
        assert tb is ts.respecialize(tb.n)
        assert tb == make_spec(rule, f=tb.f, n=tb.n)


def test_the_elastic_trimmed_mean_buckets_and_the_policies():
    """trimmed_mean, f=frac(0.25), n=elastic(8, (4, 6, 8)): f=2 master;
    buckets 4 -> f=1, 6 -> f=1, 8 -> f=2 (as JAX gives)."""
    s = make_spec("trimmed_mean", f=frac(0.25), n=elastic(8, (4, 6, 8)))
    assert s.f == 2
    assert [(s.respecialize(b).n, s.respecialize(b).f)
            for b in (4, 6, 8)] == [(4, 1), (6, 1), (8, 2)]
    for ratio in (0.0, 0.1, 0.2, 0.29, 1 / 3):
        for n in range(1, 101):
            assert frac(ratio, 1).resolve(n) == jax_frac(ratio, 1).resolve(n)
    for n_max in (4, 8, 9, 16):
        for k in (1, 2, 3, 5):
            assert elastic(n_max, k).buckets == jax_elastic(n_max, k).buckets


def test_elastic_validation_matches_jax():
    for bad in (lambda m: m.elastic(8, (4, 4, 8)),
                lambda m: m.elastic(8, (4, 6)),
                lambda m: m.elastic(8, (0, 8)),
                lambda m: m.frac(1.0)):
        import repro.core.aggregators as J
        import repro_torch.core.aggregators as T
        with pytest.raises(ValueError):
            bad(J)
        with pytest.raises(ValueError):
            bad(T)
    s = make_spec("krum", f=1, n=8)
    assert s.respecialize(8) is s
    with pytest.raises(ValueError, match="elastic"):
        s.respecialize(6)
    with pytest.raises(ValueError, match="frac"):
        make_spec("krum", f=frac(0.2))
    with pytest.raises(ValueError):
        elastic(8, (4, 8)).pack([])


def test_async_loop_under_churn_builds_one_step_per_bucket():
    """The step-build budget: at most len(buckets) async steps and one
    synchronous step over a 24-step churn run that visits every bucket."""
    n, buckets = 8, (4, 6, 8)
    cfg = get_config("paper-100m-smoke").replace(vocab_size=32,
                                                 dtype="float32")
    ds = SyntheticLM(vocab_size=32, seq_len=8, n_agents=n,
                     per_agent_batch=1)
    bz = ByzantineConfig(n_agents=n, f=2, aggregator=make_spec(
        "trimmed_mean", f=frac(0.25), n=elastic(n, buckets)),
        attack="sign_flip")
    sim = SimConfig(faults=(Churn(rate=0.25, mean_out=2.0),), seed=0)
    before = snapshot()
    _, hist = async_train_loop(cfg, bz, adamw(constant(1e-3)), ds, steps=24,
                               sim=sim, device="cpu", log_every=1,
                               log_fn=lambda *_: None)
    built = counter_delta(before)
    lives = {h["n_live"] for h in hist}
    assert {elastic(n, buckets).bucket_for(v) for v in lives} == set(buckets)
    assert 1 <= built.get("async_step", 0) <= len(buckets), built
    assert built.get("train_step", 0) <= 1, built
    assert all(math.isfinite(h["loss"]) for h in hist)


@pytest.mark.parametrize("live", [[0, 2, 3, 5, 6], [1, 2, 4, 5, 6, 7, 0]])
def test_sync_bucket_step_matches_jax(live):
    """make_train_step(bucket=) against JAX's: the live roster (5 or 7 of
    8, so a ghost row pads buckets 6 and 8) packed into its bucket, the
    elastic trimmed_mean's bucket spec; loss, aggregate and parameters
    within the slice-1 bars."""
    cfg, jcfg = H.configs()
    jspec = jax_make_spec("trimmed_mean", f=jax_frac(0.25),
                          impl="pallas", n=jax_elastic(H.N, (4, 6, 8)))
    tspec = make_spec("trimmed_mean", f=frac(0.25),
                      n=elastic(H.N, (4, 6, 8)))
    jo = H._jax_recording(H.jopt.adamw(H.jopt.constant(H.LR), eps=H.EPS))
    to = H._torch_recording(H.topt.adamw(H.topt.constant(H.LR), eps=H.EPS))
    b, idx, valid = tspec.elastic.pack(sorted(live))
    jstep = jax.jit(jax_make_train_step(jcfg, H.JaxBz(
        n_agents=H.N, f=jspec.f, aggregator=jspec, attack="sign_flip"), jo,
        bucket=b))
    tstep = make_train_step(cfg, ByzantineConfig(
        n_agents=H.N, f=tspec.f, aggregator=tspec, attack="sign_flip"), to,
        device="cpu", bucket=b)
    jp = jax.tree.map(jnp.asarray, H.jax_params_numpy())
    tp = params_from_numpy(H.jax_params_numpy())
    tb, jb = H.batch_np(500 + b)
    jp, js, _, jm = jstep(jp, jo.init(jp), None, jb, jax.random.PRNGKey(7),
                          jnp.asarray(idx), jnp.asarray(valid))
    tp, ts, _, tm = tstep(tp, to.init(tp), None, tb, None,
                          torch.as_tensor(idx, dtype=torch.int64),
                          torch.as_tensor(valid))
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                               rtol=H.LOGIT_TOL, atol=H.LOGIT_TOL)
    for a, r in ((H.flat_np(params_to_numpy(ts["agg"])), H.flat_np(js["agg"])),
                 (H.flat_np(params_to_numpy(tp)), H.flat_np(jp))):
        np.testing.assert_allclose(a, r, rtol=H.GRAD_TOL, atol=H.GRAD_TOL)
