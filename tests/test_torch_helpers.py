"""Shared harness of the port's parity tests (no tests of its own).

Inputs are made with numpy from a seed and handed to both packages; the
JAX package runs on the CPU as its own tests run it (Pallas kernels in
interpret mode).  Weights come from ``repro.models.init_params`` and cross
through ``repro_torch.convert``.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

import repro.optim as jopt
import repro.simulator as JS
import repro_torch.optim as topt
import repro_torch.simulator as TS
from repro.configs import get_config as jax_get_config
from repro.core.aggregators import elastic as jax_elastic
from repro.core.aggregators import frac as jax_frac
from repro.core.aggregators import make_spec as jax_make_spec
from repro.models import init_params as jax_init_params
from repro.training.step import ByzantineConfig as JaxBz
from repro.training.step import make_train_step as jax_make_train_step
from repro_torch.configs import get_config
from repro_torch.convert import (arena_from_numpy, params_from_numpy,
                                 params_to_numpy)
from repro_torch.core.aggregators import elastic, frac, make_spec
from repro_torch.core.momentum import init_momentum
from repro_torch.data import SyntheticLM
from repro_torch.training import ByzantineConfig, make_train_step

# xdist runs several test processes at once: keep each one's torch small
torch.set_num_threads(2)

ARCH = "paper-100m-smoke"
N, F = 8, 2
SEQ, BATCH = 32, 2
# the model-level bars (fp32 smoke config; matmul reassociation between
# XLA and PyTorch)
LOGIT_TOL = 1e-5
GRAD_TOL = 1e-4


def configs():
    """(torch cfg, jax cfg): the fp32 smoke config on both sides."""
    return (get_config(ARCH).replace(dtype="float32"),
            jax_get_config(ARCH).replace(dtype="float32"))


@functools.lru_cache(maxsize=None)
def jax_params_numpy(seed=0):
    _, jcfg = configs()
    return jax.tree.map(np.asarray,
                        jax_init_params(jcfg, jax.random.PRNGKey(seed)))


def leaves_np(tree):
    """Leaves of a numpy/jax tree in jax.tree.flatten order."""
    return [np.asarray(x) for x in jax.tree.leaves(tree)]


def flat_np(tree):
    return np.concatenate([x.ravel() for x in leaves_np(tree)])


def batch_np(seed, n=N):
    """(n, b) starts drawn on the JAX side -> the torch batch and the
    matching JAX batch."""
    cfg, _ = configs()
    starts = np.asarray(jax.random.randint(jax.random.PRNGKey(seed),
                                           (n, BATCH), 0, cfg.vocab_size))
    tb = SyntheticLM(cfg.vocab_size, SEQ, n, BATCH).batch(starts)
    jb = {k: jnp.asarray(v.numpy().astype(np.int32)) for k, v in tb.items()}
    return tb, jb


# AdamW's eps sets how far it amplifies an ulp-level difference of a
# near-zero aggregate coordinate (the update moves by up to lr/eps times
# that difference); eps = 1e-5 keeps that below the bar, the law is
# AdamW's own (test_torch_model holds one update at the default eps).
LR, EPS = 1e-3, 1e-5


def _jax_recording(opt):
    """The JAX optimizer, with the last aggregate kept in its state (the
    jitted step returns the state, so the aggregate comes out too)."""
    def init(p):
        st = opt.init(p)
        st["agg"] = jax.tree.map(jnp.zeros_like, p)
        return st

    def update(g, st, p, _step=None):
        u, st2 = opt.update(g, {k: v for k, v in st.items() if k != "agg"},
                            p)
        st2["agg"] = g
        return u, st2
    return jopt.Optimizer(init, update)


def _torch_recording(opt):
    def update(g, st, p):
        u, st2 = opt.update(g, st, p)
        st2["agg"] = g
        return u, st2
    return topt.Optimizer(opt.init, update)


def run_slice(rule, alpha, steps=3, attack="sign_flip", n=N):
    """Run the JAX step (impl="pallas") and the torch step (impl="auto")
    side by side from the same weights and batches, with ``n`` agents;
    returns per step (jax loss, torch loss, jax agg, torch agg, jax
    params, torch params) as numpy."""
    cfg, jcfg = configs()
    jp = jax.tree.map(jnp.asarray, jax_params_numpy())
    tp = params_from_numpy(jax_params_numpy())
    jo = _jax_recording(jopt.adamw(jopt.constant(LR), eps=EPS))
    to = _torch_recording(topt.adamw(topt.constant(LR), eps=EPS))
    jstep = jax.jit(jax_make_train_step(jcfg, JaxBz(
        n_agents=n, f=F, aggregator=jax_make_spec(rule, f=F, impl="pallas",
                                                  n=n),
        attack=attack, momentum_alpha=alpha), jo))
    spec = make_spec(rule, f=F, n=n)
    assert spec.impl == "kernel"
    tstep = make_train_step(cfg, ByzantineConfig(
        n_agents=n, f=F, aggregator=spec, attack=attack,
        momentum_alpha=alpha), to, device="cpu")
    js, ts = jo.init(jp), to.init(tp)
    jm = tm = None
    if alpha:
        jm = jax.tree.map(lambda p: jnp.zeros((n,) + p.shape, jnp.float32),
                          jp)
        tm = init_momentum(n, int(flat_np(jax_params_numpy()).size), "cpu")
    out = []
    for step in range(steps):
        tb, jb = batch_np(100 + step, n)
        jp, js, jm, jmet = jstep(jp, js, jm, jb, jax.random.PRNGKey(7))
        tp, ts, tm, tmet = tstep(tp, ts, tm, tb)
        out.append((float(jmet["loss"]), float(tmet["loss"]),
                    flat_np(js["agg"]), flat_np(params_to_numpy(ts["agg"])),
                    flat_np(jp), flat_np(params_to_numpy(tp))))
    return out


def check_slice(rule, alpha, n=N):
    for step, (jl, tl, ja, ta, jpar, tpar) in enumerate(
            run_slice(rule, alpha, n=n)):
        msg = f"{rule} alpha={alpha} n={n} step {step}"
        np.testing.assert_allclose(tl, jl, rtol=LOGIT_TOL, atol=LOGIT_TOL,
                                   err_msg=msg)
        # the aggregate is an order statistic / selection of gradients:
        # it is held to the gradient bar
        np.testing.assert_allclose(ta, ja, rtol=GRAD_TOL, atol=GRAD_TOL,
                                   err_msg=msg)
        np.testing.assert_allclose(tpar, jpar, rtol=GRAD_TOL, atol=GRAD_TOL,
                                   err_msg=msg)


# ---------------------------------------------------------------------------
# the async slice: the JAX make_async_step (jitted, impl="pallas") and the
# port's side by side, fed the same trace rows


def straggler_sim(mod):
    """The straggler profile: lognormal(0.8) latencies, quorum 6, max
    staleness 3 (six deliveries per step, staleness up to 2)."""
    return mod.SimConfig(faults=(mod.Straggler("lognormal", 0.8),),
                         quorum=6, max_staleness=3, seed=0)


def churn_sim(mod):
    """Churn(rate=0.25, mean_out=2.0) at seed 0: live 8, 6, 4, 6, 6, 7,
    4, 3 — step 0 is pure; rows 4-7 hit all three buckets of (4, 6, 8),
    and the rosters of 7 and 3 put a ghost row into buckets 8 and 4."""
    return mod.SimConfig(faults=(mod.Churn(rate=0.25, mean_out=2.0),),
                         seed=0)


def in_flight_np(seed, n=N):
    """A nonzero (n, ...) fp32 tree shaped like the parameters: the
    buffer (and momentum) both steps start from."""
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda p: (rng.normal(size=(n,) + p.shape) * 1e-2).astype(
            np.float32), jax_params_numpy())


def run_async(rule, alpha, trace="stragglers", steps=4,
              attack="sign_flip"):
    """Per step (jax loss, torch loss, jax agg, torch agg, jax params,
    torch params, jax buffer, torch buffer) as flat numpy, the two steps
    fed the same trace rows, batches, weights and starting buffer."""
    cfg, jcfg = configs()
    jp = jax.tree.map(jnp.asarray, jax_params_numpy())
    tp = params_from_numpy(jax_params_numpy())
    jo = _jax_recording(jopt.adamw(jopt.constant(LR), eps=EPS))
    to = _torch_recording(topt.adamw(topt.constant(LR), eps=EPS))
    if trace == "churn":
        jspec = jax_make_spec(rule, f=jax_frac(0.25), impl="pallas",
                              n=jax_elastic(N, (4, 6, 8)))
        tspec = make_spec(rule, f=frac(0.25), n=elastic(N, (4, 6, 8)))
        sims = (churn_sim(JS), churn_sim(TS))
        rows = range(4, 4 + steps)
    else:
        jspec = jax_make_spec(rule, f=F, impl="pallas", n=N)
        tspec = make_spec(rule, f=F, n=N)
        sims = (straggler_sim(JS), straggler_sim(TS))
        rows = range(steps)
    assert tspec.impl == "kernel"
    jbz = JaxBz(n_agents=N, f=F, aggregator=jspec, attack=attack,
                momentum_alpha=alpha)
    tbz = ByzantineConfig(n_agents=N, f=F, aggregator=tspec, attack=attack,
                          momentum_alpha=alpha)
    jtr = JS.plan_arrivals(sims[0], N, rows[-1] + 1)
    ttr = TS.plan_arrivals(sims[1], N, rows[-1] + 1)
    jw, tw = (JS.staleness_weights(sims[0], jtr),
              TS.staleness_weights(sims[1], ttr))
    np.testing.assert_array_equal(tw, jw)
    jsteps, tsteps = {}, {}
    js, ts = jo.init(jp), to.init(tp)
    buf0 = in_flight_np(1)
    jbuf = jax.tree.map(jnp.asarray, buf0)
    tbuf = arena_from_numpy(buf0)
    jm = tm = None
    if alpha:
        m0 = in_flight_np(2)
        jm, tm = jax.tree.map(jnp.asarray, m0), arena_from_numpy(m0)
    out = []
    for k, r in enumerate(rows):
        extra_j, extra_t, b = (), (), None
        if trace == "churn":
            live = np.flatnonzero(ttr.roster[r])
            b, idx, valid = tspec.elastic.pack(live)
            jb_, jidx, jvalid = jspec.elastic.pack(live)
            assert jb_ == b
            np.testing.assert_array_equal(idx, jidx)
            extra_j = (jnp.asarray(jidx), jnp.asarray(jvalid))
            extra_t = (torch.as_tensor(idx, dtype=torch.int64),
                       torch.as_tensor(valid))
        if b not in jsteps:
            jsteps[b] = jax.jit(JS.make_async_step(jcfg, jbz, jo, bucket=b))
            tsteps[b] = TS.make_async_step(cfg, tbz, to, device="cpu",
                                           bucket=b)
        tb, jb = batch_np(300 + k)
        refresh = jtr.refresh[r]
        jp, js, jm, jbuf, _, jmet = jsteps[b](
            jp, js, jm, jbuf, {}, jb, jax.random.PRNGKey(7),
            jnp.asarray(refresh), jnp.asarray(jw[r]), jnp.asarray(False),
            *extra_j)
        tp, ts, tm, tbuf, _, tmet = tsteps[b](
            tp, ts, tm, tbuf, {}, tb, None, refresh,
            torch.from_numpy(tw[r]), False, *extra_t)
        out.append((float(jmet["loss"]), float(tmet["loss"]),
                    flat_np(js["agg"]), flat_np(params_to_numpy(ts["agg"])),
                    flat_np(jp), flat_np(params_to_numpy(tp)),
                    np.concatenate([x.reshape(N, -1)
                                    for x in leaves_np(jbuf)], axis=1),
                    tbuf.numpy().copy()))
    return out


def check_async(rule, alpha, trace="stragglers"):
    """Losses, aggregates, post-step parameters and the in-flight buffer
    within the slice-1 bars (loss 1e-5, the rest 1e-4) after each of 4
    steps."""
    for step, (jl, tl, ja, ta, jpar, tpar, jbuf, tbuf) in enumerate(
            run_async(rule, alpha, trace)):
        msg = f"{rule} alpha={alpha} {trace} step {step}"
        np.testing.assert_allclose(tl, jl, rtol=LOGIT_TOL, atol=LOGIT_TOL,
                                   err_msg=msg)
        assert ta.dtype == np.float32       # the fp32 buffer's aggregate
        np.testing.assert_allclose(ta, ja, rtol=GRAD_TOL, atol=GRAD_TOL,
                                   err_msg=msg)
        np.testing.assert_allclose(tpar, jpar, rtol=GRAD_TOL, atol=GRAD_TOL,
                                   err_msg=msg)
        np.testing.assert_allclose(tbuf, jbuf, rtol=GRAD_TOL, atol=GRAD_TOL,
                                   err_msg=msg)
