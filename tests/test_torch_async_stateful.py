"""The aggregator-state thread of the async loop against the JAX loop: the
defenses with memory (centered_clip on both impls, zeno_pp,
server_momentum(trimmed_mean)), 4 steps from JAX's weights, under the
synchronous trace (with state, every row runs the general async step, as
in JAX) and under stragglers.  The defense-aware attacks on the same
thread, and the elastic centered_clip under churn, are in
``test_torch_async_adaptive.py``.

Each step starts from the JAX side's parameters, optimizer state, buffer
and aggregator state (``resync``), so a step is held from one state.
Bars are the async slice's (``check_async``): loss 1e-5, the aggregate,
the post-step parameters, the in-flight buffer and the carried
``server_grad`` 1e-4 (the per-agent gradients already differ by the
model-level bar).
"""
import numpy as np
import pytest
import torch

from repro.core.aggregators import elastic as jax_elastic
from repro.core.aggregators import frac as jax_frac
from repro.core.aggregators import make_spec as jax_make_spec
from repro.core.aggregators import server_momentum as jax_server_momentum
from repro_torch.core.aggregators import (elastic, frac, make_spec,
                                          server_momentum)
from test_torch_helpers import F, GRAD_TOL, LOGIT_TOL, N, run_async

torch.set_num_threads(2)


def spec_pair(name):
    """trace -> (jax spec, torch spec); the churn trace gets the elastic
    spec (f = frac(0.25), buckets 4, 6, 8)."""
    def build(trace):
        kw_j = dict(f=F, n=N)
        kw_t = dict(f=F, n=N)
        if trace == "churn":
            kw_j = dict(f=jax_frac(0.25), n=jax_elastic(N, (4, 6, 8)))
            kw_t = dict(f=frac(0.25), n=elastic(N, (4, 6, 8)))
        if name == "centered_clip_kernel":
            return (jax_make_spec("centered_clip", impl="pallas", **kw_j),
                    make_spec("centered_clip", impl="kernel", **kw_t))
        if name == "centered_clip":
            return (jax_make_spec("centered_clip", impl="gather", **kw_j),
                    make_spec("centered_clip", impl="gather", **kw_t))
        if name == "zeno_pp":
            return (jax_make_spec("zeno_pp", **kw_j),
                    make_spec("zeno_pp", **kw_t))
        assert name == "server_momentum(trimmed_mean)"
        return (jax_server_momentum(jax_make_spec("trimmed_mean",
                                                  impl="pallas", **kw_j)),
                server_momentum(make_spec("trimmed_mean", **kw_t)))
    return build


def check_stateful(name, trace, attack="sign_flip", hyper=({}, {})):
    """4 resynced steps of ``name`` (a key of :func:`spec_pair`) under
    ``attack`` (its (jax, torch) hyper), each held to the bars."""
    out = run_async(None, 0.0, trace, resync=True, specs=spec_pair(name),
                    attack=attack, attack_hyper=hyper)
    assert len(out) == 4
    for step, (jl, tl, ja, ta, jpar, tpar, jbuf, tbuf, jsg, tsg) in (
            enumerate(out)):
        msg = f"{name} {attack} {trace} step {step}"
        np.testing.assert_allclose(tl, jl, rtol=LOGIT_TOL, atol=LOGIT_TOL,
                                   err_msg=msg)
        assert ta.dtype == np.float32
        for what, ours, ref in (("aggregate", ta, ja), ("params", tpar, jpar),
                                ("buffer", tbuf, jbuf),
                                ("server_grad", tsg, jsg)):
            assert np.isfinite(ours).all(), (msg, what)
            np.testing.assert_allclose(ours, ref, rtol=GRAD_TOL,
                                       atol=GRAD_TOL, err_msg=f"{msg} {what}")
        # the carried center is the aggregate itself at ema = 1
        if name.startswith(("centered_clip", "server_momentum")):
            np.testing.assert_array_equal(tsg, ta)


RULES = ["centered_clip_kernel", "centered_clip", "zeno_pp",
         "server_momentum(trimmed_mean)"]


# the gather impl of centered_clip under stragglers only: the kernel impl
# covers both traces, and the two impls share everything but K22
@pytest.mark.parametrize("name,trace", [
    (name, trace) for name in RULES for trace in ("sync", "stragglers")
    if (name, trace) != ("centered_clip", "sync")])
def test_stateful_rules_match_jax(name, trace):
    check_stateful(name, trace)
