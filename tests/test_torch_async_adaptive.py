"""The defense-aware attacks on the async loop's state thread against the
JAX loop: spec_alie (under stragglers) and min_max (synchronous trace)
against centered_clip (kernel impl; each attack probes the defense with
the gather impl, reading its carried center), and slow_drift against
server_momentum(trimmed_mean) under both, 4 steps from JAX's weights;
then the elastic centered_clip under churn (the state threaded across
the bucket respecializations) against JAX, and the port's loop under
churn with its step-build budget.

Each step starts from the JAX side's state (``resync``): a bisection's
survive decision is discontinuous between frameworks (ROADMAP.md P15),
so a step is held from one state.  The bisections run ``iters = 6``
rounds on both sides here (14 by default; ``test_torch_adaptive.py``
holds the default at a small width), which keeps the file's CPU time
down.  Bars: :func:`test_torch_async_stateful.check_stateful`'s.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro_torch.simulator as TS
from repro_torch.core.aggregators import elastic, frac, make_spec
from repro_torch.obs.counters import counter_delta, snapshot
from test_torch_async_stateful import check_stateful, spec_pair
from test_torch_helpers import (F, GRAD_TOL, LOGIT_TOL, N, churn_sim,
                                configs, flat_np, jax_params_numpy,
                                run_async)

torch.set_num_threads(2)
ITERS = {"iters": 6}


# each bisecting attack under one trace (the CPU time of a bisection over
# the smoke arena is the file's cost): spec_alie under stragglers, min_max
# on the synchronous trace
@pytest.mark.parametrize("attack,trace", [("spec_alie", "stragglers"),
                                          ("min_max", "sync")])
def test_bisecting_attacks_against_centered_clip_match_jax(attack, trace):
    check_stateful("centered_clip_kernel", trace, attack=attack,
                   hyper=(ITERS, ITERS))


@pytest.mark.parametrize("trace", ["sync", "stragglers"])
def test_slow_drift_against_server_momentum_matches_jax(trace):
    """JAX's Rademacher sign pattern is handed to the port by value."""
    p = flat_np(jax_params_numpy()).size
    signs = np.array(jax.random.rademacher(jax.random.PRNGKey(7), (p,),
                                           jnp.float32))
    check_stateful("server_momentum(trimmed_mean)", trace,
                   attack="slow_drift",
                   hyper=({}, {"signs": torch.from_numpy(signs)}))


def test_elastic_centered_clip_under_churn_matches_jax():
    """Churn rows 4-7 (live 6, 7, 4, 3: buckets 6, 8, 4, 4) with the state
    threaded across the bucket respecializations."""
    out = run_async(None, 0.0, "churn", resync=True,
                    specs=spec_pair("centered_clip_kernel"))
    for step, (jl, tl, ja, ta, jpar, tpar, _, _, jsg, tsg) in enumerate(out):
        np.testing.assert_allclose(tl, jl, rtol=LOGIT_TOL, atol=LOGIT_TOL)
        for ours, ref in ((ta, ja), (tpar, jpar), (tsg, jsg)):
            np.testing.assert_allclose(ours, ref, rtol=GRAD_TOL,
                                       atol=GRAD_TOL, err_msg=str(step))


def test_elastic_centered_clip_builds_one_step_per_bucket():
    """The port's loop under churn (JAX tests/test_membership_retrace.py):
    at most one async step per bucket, none synchronous (a stateful spec
    runs the general step on every row, the pure one included), and the
    {"agg", "atk"} state threads through all of them."""
    from repro_torch.data import SyntheticLM
    from repro_torch.optim import adamw, constant
    from repro_torch.training import ByzantineConfig, train_loop
    cfg, _ = configs()
    spec = make_spec("centered_clip", f=frac(0.25), impl="kernel",
                     n=elastic(N, (4, 6, 8)))
    bz = ByzantineConfig(n_agents=N, f=F, aggregator=spec,
                         attack="slow_drift")
    before = snapshot()
    _, hist = train_loop(cfg, bz, adamw(constant(1e-3)),
                         SyntheticLM(cfg.vocab_size, 16, N, 1), steps=8,
                         sim=churn_sim(TS), device="cpu", log_every=1,
                         log_fn=lambda s: None)
    built = counter_delta(before)
    assert built.get("train_step", 0) == 0
    assert 1 <= built["async_step"] <= 3, built
    assert [h["n_live"] for h in hist] == [8, 6, 4, 6, 6, 7, 4, 3]
    assert all(np.isfinite(h["loss"]) for h in hist)

