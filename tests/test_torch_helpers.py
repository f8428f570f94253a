"""Shared harness of the port's parity tests (no tests of its own).

Inputs are made with numpy from a seed and handed to both packages; the
JAX package runs on the CPU as its own tests run it (Pallas kernels in
interpret mode).  Weights come from ``repro.models.init_params`` and cross
through ``repro_torch.convert``.
"""
import dataclasses
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
from repro.core.aggregators import AggregatorSpec as JaxSpec
from repro.core.aggregators import elastic as jax_elastic
from repro.core.aggregators import frac as jax_frac
from repro.core.aggregators import make_spec as jax_make_spec
from repro.models import init_params as jax_init_params
from repro.training.step import ByzantineConfig as JaxBz
from repro.training.step import make_train_step as jax_make_train_step
from repro_torch.configs import get_config
from repro_torch.convert import (agg_state_from_numpy, arena_from_numpy,
                                 params_from_numpy, params_to_numpy)
from repro_torch.core.aggregators import (AggregatorSpec, elastic, frac,
                                          make_spec)
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


def batch_np(seed, n=N, parallel=False):
    """(n, b) starts drawn on the JAX side -> the torch batch and the
    matching JAX batch.  ``parallel``: every agent gets agent 0's batch
    (the gradient-coding regime: the agents of a group compute the same
    shard)."""
    cfg, _ = configs()
    starts = np.asarray(jax.random.randint(jax.random.PRNGKey(seed),
                                           (n, BATCH), 0, cfg.vocab_size))
    if parallel:
        starts = np.repeat(starts[:1], n, axis=0)
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


def recording_specs(jspec, tspec, record):
    """Copies of the two specs whose ``aggregate_flat`` appends, to
    ``record["jax"]`` / ``record["torch"]``, the numpy (arena, row scales
    or None, aggregate) of each call: the JAX side through a debug
    callback out of the jitted step (call ``jax.effects_barrier()`` before
    reading it)."""
    record.setdefault("jax", [])
    record.setdefault("torch", [])

    def raw(a):
        # int8 / fp8 codes as their bytes (numpy has no fp8 of its own)
        return a.view(np.uint8) if a.dtype.itemsize == 1 else a

    class JaxRec(JaxSpec):
        def aggregate_flat(self, stack, mask=None, weights=None, state=None,
                           scale=None):
            out = super().aggregate_flat(stack, mask, weights, state, scale)
            qs = scale if scale is not None else jnp.zeros((0,))
            jax.debug.callback(
                lambda a, q, o: record["jax"].append(
                    (raw(np.asarray(a)), np.asarray(q) if q.size else None,
                     np.asarray(o))), stack, qs, out)
            return out

    class TorchRec(AggregatorSpec):
        def aggregate_flat(self, stack, mask=None, weights=None, state=None,
                           scale=None):
            out = super().aggregate_flat(stack, mask, weights, state, scale)
            record["torch"].append(
                ((stack.view(torch.uint8) if stack.element_size() == 1
                  else stack).numpy().copy(),
                 None if scale is None else scale.numpy().copy(),
                 out.numpy().copy()))
            return out

    return (JaxRec(**{f.name: getattr(jspec, f.name)
                      for f in dataclasses.fields(jspec)}),
            TorchRec(**{f.name: getattr(tspec, f.name)
                        for f in dataclasses.fields(tspec)}))


def resync_state(jp, js):
    """The torch parameters and AdamW state of the JAX side's."""
    return (params_from_numpy(jax.tree.map(np.asarray, jp)),
            {"step": int(js["step"]),
             **{k: params_from_numpy(jax.tree.map(np.asarray, js[k]))
                for k in ("m", "v")}})


def run_slice(rule, alpha, steps=3, attack="sign_flip", n=N, agg_dtype="",
              resync=False, record=None, specs=None, f=F, draco_r=0):
    """Run the JAX step (impl="pallas") and the torch step (impl="auto")
    side by side from the same weights and batches, with ``n`` agents
    and exchange dtype ``agg_dtype``; returns per step (jax loss, torch
    loss, jax agg, torch agg, jax params, torch params) as numpy.
    ``resync``: the torch side starts every step from the JAX side's
    parameters and optimizer state (for the laws that are discontinuous
    in the gradients).  ``record``: a dict that collects both specs'
    ``aggregate_flat`` calls (:func:`recording_specs`).  ``specs``: a
    (jax spec, torch spec) pair in place of the rule's kernel specs,
    built for ``f``; ``draco_r``: the coded step, on the parallel
    regime's batches."""
    cfg, jcfg = configs()
    jp = jax.tree.map(jnp.asarray, jax_params_numpy())
    tp = params_from_numpy(jax_params_numpy())
    jo = _jax_recording(jopt.adamw(jopt.constant(LR), eps=EPS))
    to = _torch_recording(topt.adamw(topt.constant(LR), eps=EPS))
    if specs is None:
        jspec = jax_make_spec(rule, f=f, impl="pallas", n=n)
        spec = make_spec(rule, f=f, n=n)
        assert spec.impl == "kernel"
    else:
        jspec, spec = specs
    if record is not None:
        jspec, spec = recording_specs(jspec, spec, record)
    jstep = jax.jit(jax_make_train_step(jcfg, JaxBz(
        n_agents=n, f=f, aggregator=jspec, attack=attack,
        momentum_alpha=alpha, agg_dtype=agg_dtype, draco_r=draco_r), jo))
    tstep = make_train_step(cfg, ByzantineConfig(
        n_agents=n, f=f, aggregator=spec, attack=attack,
        momentum_alpha=alpha, agg_dtype=agg_dtype, draco_r=draco_r), to,
        device="cpu")
    js, ts = jo.init(jp), to.init(tp)
    jm = tm = None
    if alpha:
        jm = jax.tree.map(lambda p: jnp.zeros((n,) + p.shape, jnp.float32),
                          jp)
        tm = init_momentum(n, int(flat_np(jax_params_numpy()).size), "cpu")
    out = []
    for step in range(steps):
        tb, jb = batch_np(100 + step, n, parallel=bool(draco_r))
        jp, js, jm, jmet = jstep(jp, js, jm, jb, jax.random.PRNGKey(7))
        tp, ts, tm, tmet = tstep(tp, ts, tm, tb)
        jax.effects_barrier()
        out.append((float(jmet["loss"]), float(tmet["loss"]),
                    flat_np(js["agg"]), flat_np(params_to_numpy(ts["agg"])),
                    flat_np(jp), flat_np(params_to_numpy(tp))))
        if resync:
            tp, ts = resync_state(jp, js)
            if alpha:
                tm = arena_from_numpy(jax.tree.map(np.asarray, jm))
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


def straggler_sim(mod, quorum=6):
    """The straggler profile: lognormal(0.8) latencies, quorum 6, max
    staleness 3 (at n = 8: six deliveries per step, staleness up to 2;
    bulyan's n = 11 takes quorum 9: nine deliveries, no step pure)."""
    return mod.SimConfig(faults=(mod.Straggler("lognormal", 0.8),),
                         quorum=quorum, max_staleness=3, seed=0)


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
              attack="sign_flip", n=N, quorum=6, resync=False, agg_dtype="",
              record=None, specs=None, attack_hyper=({}, {}), f=F,
              draco_r=0, fallback_r=0, sims=None, telemetry=None):
    """Per step (jax loss, torch loss, jax agg, torch agg, jax params,
    torch params, jax buffer, torch buffer, jax server_grad, torch
    server_grad) as flat numpy (the last two None for a stateless rule),
    the two steps fed the same trace rows, batches, weights and starting
    buffer, and each side's aggregator state threaded from step to step
    (bundled with a defense-aware attack's state, as the loops do).
    ``trace``: "stragglers" (``n`` and ``quorum`` size it), "churn" (n =
    8, rows 4-7) or "sync" (no fault: every row delivers in full).
    ``resync``: the torch side starts every step from the JAX side's
    parameters, optimizer state, momentum, buffer and aggregator state, so
    that each step is held from one state (for the rules whose aggregate
    is discontinuous in the gradients, where a flipped coordinate would
    otherwise move every later step apart).  ``agg_dtype`` and ``record``
    as in :func:`run_slice`.  ``specs``: ``trace -> (jax spec, torch
    spec)`` in place of the rule's kernel specs; ``attack_hyper``: the
    (jax, torch) attack hyper.  ``f``: the Byzantine budget; ``draco_r``
    / ``fallback_r``: the coded step / the coded fallback (a row that
    missed its quorum takes the code), on the parallel regime's batches;
    ``sims``: a (jax, torch) SimConfig pair in place of the trace's.
    ``telemetry``: a list; both steps are built with ``telemetry=True``
    and each step appends the (jax, torch) telemetry rows, as numpy."""
    cfg, jcfg = configs()
    jp = jax.tree.map(jnp.asarray, jax_params_numpy())
    tp = params_from_numpy(jax_params_numpy())
    jo = _jax_recording(jopt.adamw(jopt.constant(LR), eps=EPS))
    to = _torch_recording(topt.adamw(topt.constant(LR), eps=EPS))
    if trace == "churn":
        if specs is None:
            jspec = jax_make_spec(rule, f=jax_frac(0.25), impl="pallas",
                                  n=jax_elastic(N, (4, 6, 8)))
            tspec = make_spec(rule, f=frac(0.25), n=elastic(N, (4, 6, 8)))
        sims = sims or (churn_sim(JS), churn_sim(TS))
        rows = range(4, 4 + steps)
    elif specs is None:
        jspec = jax_make_spec(rule, f=f, impl="pallas", n=n)
        tspec = make_spec(rule, f=f, n=n)
    if trace == "sync":
        sims = sims or (JS.SimConfig(), TS.SimConfig())
        rows = range(steps)
    elif trace != "churn":
        sims = sims or (straggler_sim(JS, quorum), straggler_sim(TS, quorum))
        rows = range(steps)
    if specs is not None:
        jspec, tspec = specs(trace)
    else:
        assert tspec.impl == "kernel"
    if record is not None:
        jspec, tspec = recording_specs(jspec, tspec, record)
    jbz = JaxBz(n_agents=n, f=f, aggregator=jspec, attack=attack,
                attack_hyper=attack_hyper[0], momentum_alpha=alpha,
                agg_dtype=agg_dtype, draco_r=draco_r)
    tbz = ByzantineConfig(n_agents=n, f=f, aggregator=tspec, attack=attack,
                          attack_hyper=attack_hyper[1], momentum_alpha=alpha,
                          agg_dtype=agg_dtype, draco_r=draco_r)
    jst, tst = initial_agg_states(jbz, tbz, jp, tp)
    jtr = JS.plan_arrivals(sims[0], n, rows[-1] + 1)
    ttr = TS.plan_arrivals(sims[1], n, rows[-1] + 1)
    jw, tw = (JS.staleness_weights(sims[0], jtr),
              TS.staleness_weights(sims[1], ttr))
    np.testing.assert_array_equal(tw, jw)
    jsteps, tsteps = {}, {}
    js, ts = jo.init(jp), to.init(tp)
    buf0 = in_flight_np(1, n)
    jbuf = jax.tree.map(jnp.asarray, buf0)
    tbuf = arena_from_numpy(buf0)
    jm = tm = None
    if alpha:
        m0 = in_flight_np(2, n)
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
            jsteps[b] = jax.jit(JS.make_async_step(
                jcfg, jbz, jo, fallback_r=fallback_r, bucket=b,
                telemetry=telemetry is not None))
            tsteps[b] = TS.make_async_step(cfg, tbz, to, device="cpu",
                                           fallback_r=fallback_r, bucket=b,
                                           telemetry=telemetry is not None)
        tb, jb = batch_np(300 + k, n, parallel=bool(draco_r or fallback_r))
        refresh = jtr.refresh[r]
        use_coded = bool(fallback_r) and not ttr.quorum_met[r]
        jp, js, jm, jbuf, jst, jmet = jsteps[b](
            jp, js, jm, jbuf, jst, jb, jax.random.PRNGKey(7),
            jnp.asarray(refresh), jnp.asarray(jw[r]), jnp.asarray(use_coded),
            *extra_j)
        tp, ts, tm, tbuf, tst, tmet = tsteps[b](
            tp, ts, tm, tbuf, tst, tb, None, refresh,
            torch.from_numpy(tw[r]), use_coded, *extra_t)
        jax.effects_barrier()
        if telemetry is not None:
            telemetry.append(
                ({k: np.asarray(v) for k, v in jmet["telemetry"].items()},
                 {k: v.numpy() for k, v in tmet["telemetry"].items()}))
        out.append((float(jmet["loss"]), float(tmet["loss"]),
                    flat_np(js["agg"]), flat_np(params_to_numpy(ts["agg"])),
                    flat_np(jp), flat_np(params_to_numpy(tp)),
                    np.concatenate([x.reshape(n, -1)
                                    for x in leaves_np(jbuf)], axis=1),
                    tbuf.numpy().copy(), *server_grads(jst, tst)))
        if resync:
            tp, ts = resync_state(jp, js)
            tbuf = arena_from_numpy(jax.tree.map(np.asarray, jbuf))
            if alpha:
                tm = arena_from_numpy(jax.tree.map(np.asarray, jm))
            tst = agg_state_from_numpy(jax.tree.map(np.asarray, jst))
    return out


def initial_agg_states(jbz, tbz, jp, tp):
    """The two loops' initial aggregator states: ``spec.init_state`` of a
    stateful spec (else {}), bundled as {"agg", "atk"} with a defense-
    aware attack's initial state, as ``async_train_loop`` builds them."""
    from repro.core.attacks import is_adaptive_attack as jax_adaptive
    from repro.core.attacks import make_adaptive_attack as jax_attack
    from repro_torch.core.attacks import make_adaptive_attack
    jspec, tspec = jbz.resolve_spec(), tbz.resolve_spec()
    jst = (jspec.init_state(jax.tree.map(
        lambda p: jnp.zeros(p.shape, jnp.float32), jp))
        if jspec.stateful else {})
    tst = tspec.init_state(tp) if tspec.stateful else {}
    if jax_adaptive(jbz.attack):
        jst = {"agg": jst, "atk": jax_attack(
            jbz.attack, jspec, **jbz.attack_hyper).init_state()}
        tst = {"agg": tst, "atk": make_adaptive_attack(
            tbz.attack, tspec, **tbz.attack_hyper).init_state("cpu")}
    return jst, tst


def server_grads(jst, tst):
    """The carried ``server_grad`` of each side's state as flat numpy
    (through a {"agg", "atk"} bundle), or (None, None)."""
    jst, tst = jst.get("agg", jst), tst.get("agg", tst)
    if "server_grad" not in tst:
        return None, None
    return (flat_np(jst["server_grad"]),
            tst["server_grad"].numpy().copy())


def check_async(rule, alpha, trace="stragglers", n=N, quorum=6,
                telemetry=False):
    """Losses, aggregates, post-step parameters and the in-flight buffer
    within the slice-1 bars (loss 1e-5, the rest 1e-4) after each of 4
    steps.  ``telemetry``: both steps also emit their telemetry rows, and
    each step's are held to each other (the selected support and the
    delivery mask and weights exactly, sel_w within 3e-6)."""
    rows = [] if telemetry else None
    for step, (jl, tl, ja, ta, jpar, tpar, jbuf, tbuf, *_) in enumerate(
            run_async(rule, alpha, trace, n=n, quorum=quorum,
                      telemetry=rows)):
        msg = f"{rule} alpha={alpha} n={n} {trace} step {step}"
        np.testing.assert_allclose(tl, jl, rtol=LOGIT_TOL, atol=LOGIT_TOL,
                                   err_msg=msg)
        assert ta.dtype == np.float32       # the fp32 buffer's aggregate
        np.testing.assert_allclose(ta, ja, rtol=GRAD_TOL, atol=GRAD_TOL,
                                   err_msg=msg)
        np.testing.assert_allclose(tpar, jpar, rtol=GRAD_TOL, atol=GRAD_TOL,
                                   err_msg=msg)
        np.testing.assert_allclose(tbuf, jbuf, rtol=GRAD_TOL, atol=GRAD_TOL,
                                   err_msg=msg)
    for step, (jt, tt) in enumerate(rows or ()):
        msg = f"{rule} {trace} telemetry step {step}"
        np.testing.assert_array_equal(tt["mask"], jt["mask"], err_msg=msg)
        np.testing.assert_array_equal(tt["contrib_w"], jt["contrib_w"],
                                      err_msg=msg)
        np.testing.assert_array_equal(tt["sel_w"] > 0, jt["sel_w"] > 0,
                                      err_msg=msg)
        np.testing.assert_allclose(tt["sel_w"], jt["sel_w"], rtol=3e-6,
                                   atol=3e-6, err_msg=msg)


def check_async_resynced(rule, n=N, quorum=6, share=1e-5, agg_dtype=""):
    """For the rules whose aggregate is discontinuous in the gradients
    (bulyan, ROADMAP.md P8; sign_sgd, P11): the two frameworks' per-agent
    gradients differ by about an ulp, so a few coordinates of the
    aggregate flip, and each flip moves every later step apart.  Each of
    the 4 steps therefore starts from the JAX side's state
    (``resync=True``) and is held there: the loss within 1e-5 and the
    in-flight buffer within 1e-4 everywhere, the aggregate and the
    post-step parameters within 1e-4 on all but ``share`` of the
    coordinates."""
    for step, (jl, tl, ja, ta, jpar, tpar, jbuf, tbuf, *_) in enumerate(
            run_async(rule, 0.0, n=n, quorum=quorum, resync=True,
                      agg_dtype=agg_dtype)):
        msg = f"{rule} n={n} step {step}"
        np.testing.assert_allclose(tl, jl, rtol=LOGIT_TOL, atol=LOGIT_TOL,
                                   err_msg=msg)
        np.testing.assert_allclose(tbuf, jbuf, rtol=GRAD_TOL, atol=GRAD_TOL,
                                   err_msg=msg)
        for name, ours, ref in (("aggregate", ta, ja), ("params", tpar,
                                                        jpar)):
            flipped = ~np.isclose(ours, ref, rtol=GRAD_TOL, atol=GRAD_TOL)
            assert flipped.sum() <= share * ours.size, (
                msg, name, int(flipped.sum()))


# ---------------------------------------------------------------------------
# the compressed exchange (agg_dtype int8 / float8_e4m3fn)

# ROADMAP.md P14: quantization is discontinuous in the gradients.  The two
# frameworks' per-agent gradients differ by about an ulp, so where x /
# scale sits on a rounding boundary a code moves by one step.  In the first
# synchronous smoke step 21 of 11,544,576 int8 codes move (1.8e-6) and 628
# float8_e4m3fn codes (5.4e-5: e4m3 rounds every value to 3 mantissa
# bits, so far more values sit near a boundary than under int8's fixed
# step).  The bar on the share of moved codes is set above those; the
# aggregate and the parameters follow the moved codes (2-6 of 1,443,072
# coordinates under int8, 7-12 under fp8), so their bar scales with it
# too.  Every aggregate coordinate that moves must sit where a code moved.
CODE_SHARE = {"int8": 1e-5, "float8_e4m3fn": 1e-4}
AGG_SHARE = {"int8": 1e-5, "float8_e4m3fn": 5e-5}


def code_ordinals(raw, agg_dtype):
    """int8 codes, or e4m3 bytes mapped onto the ordered code grid (+-0
    both 0), as int64: neighbouring codes differ by 1."""
    if agg_dtype == "int8":
        return raw.view(np.int8).astype(np.int64)
    mag = (raw & 0x7F).astype(np.int64)
    return np.where(raw & 0x80, -mag, mag)


def check_quantized(rule, agg_dtype, loop="sync", agg_share=None):
    """The compressed slice held to JAX: each step starts from the JAX
    side's state (``resync``), since a moved code moves every later step
    apart.  Every step: the loss within 1e-5 (and the async buffer within
    1e-4).  The first step: the row scales within 1e-5 relative; the codes
    equal on all but ``CODE_SHARE`` of the values, each moved code one
    step from JAX's; the aggregate and the parameters within 1e-4 on all
    but ``AGG_SHARE`` of the coordinates (``agg_share`` where given), and
    every aggregate coordinate outside the bar one where a code moved."""
    rec = {}
    if loop == "sync":
        out = run_slice(rule, 0.0, agg_dtype=agg_dtype, resync=True,
                        record=rec)
    else:
        out = run_async(rule, 0.0, agg_dtype=agg_dtype, resync=True,
                        record=rec)
    assert len(rec["jax"]) == len(rec["torch"]) == len(out)
    for step, o in enumerate(out):
        msg = f"{rule} {agg_dtype} {loop} step {step}"
        np.testing.assert_allclose(o[1], o[0], rtol=LOGIT_TOL,
                                   atol=LOGIT_TOL, err_msg=msg)
        if loop != "sync":
            np.testing.assert_allclose(o[7], o[6], rtol=GRAD_TOL,
                                       atol=GRAD_TOL, err_msg=msg)
    _, _, ja, ta, jpar, tpar = out[0][:6]
    (jc, jqs, jagg), (tc, tqs, tagg) = rec["jax"][0], rec["torch"][0]
    assert jqs is not None and tqs is not None
    assert jc.shape == tc.shape and jc.dtype == tc.dtype == np.uint8
    np.testing.assert_allclose(tqs, jqs, rtol=1e-5, atol=0)
    moved = jc != tc
    assert moved.sum() <= CODE_SHARE[agg_dtype] * moved.size, (
        rule, agg_dtype, int(moved.sum()))
    steps = np.abs(code_ordinals(jc, agg_dtype)
                   - code_ordinals(tc, agg_dtype))
    assert steps.max(initial=0) <= 1, (rule, agg_dtype, int(steps.max()))
    for name, ours, ref in (("aggregate", ta, ja), ("params", tpar, jpar)):
        off = ~np.isclose(ours, ref, rtol=GRAD_TOL, atol=GRAD_TOL)
        share = AGG_SHARE[agg_dtype] if agg_share is None else agg_share
        assert off.sum() <= share * ours.size, (name, int(off.sum()))
    off = ~np.isclose(tagg, jagg, rtol=GRAD_TOL, atol=GRAD_TOL)
    assert not (off & ~moved.any(axis=0)).any(), (
        "an aggregate coordinate moved where no code did")
