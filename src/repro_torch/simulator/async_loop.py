"""Bounded-staleness asynchronous training over the fault-injection
simulator (counterpart of ``repro.simulator.async_loop``): the execution
layer of the survey's non-Byzantine fault modes (crash/recover,
stragglers, message loss, churn) and of bounded-staleness asynchrony.

Per server step t (one parameter version):

  1. the host reads row t of the precompiled :class:`AsyncTrace` (who
     dispatches, who delivers, how stale);
  2. the agents dispatching at version t compute fresh gradients against
     the current parameters into the (n, P) fp32 in-flight buffer (worker
     momentum on those rows only); their delivery may land versions later.
     Every agent's loss is computed (the metric averages the honest ones),
     but only the dispatching agents run a backward pass;
  3. the attack rewrites a COPY of the buffer (stale honest gradients stay
     honest), and ``spec.aggregate_flat(rows, mask=, weights=)`` aggregates
     the delivered rows with their staleness discounts — with
     ``impl="auto"`` the masked kernels K5 (coordinate rules) or K6 -> K3
     -> K7 (krum);
  4. one unravel (fp32: the buffer's dtype), the aggregator's state
     update, and the server optimizer.

Defenses with memory and defense-aware attacks: the aggregator's state
(``spec.init_state``, ``server_grad`` one fp32 (P,) vector) threads
through every step as ``agg_state`` and is advanced from the unraveled
aggregate after it (``spec.update_state``).  A defense-aware attack is
built against the spec the step runs (the bucket's under elastic
membership), runs on the fp32 in-flight buffer before any ``agg_dtype``
cast or quantization, reads the defense's carried center, and its own
state rides in the same slot: ``agg_state = {"agg": ..., "atk": ...}``.
With a stateful spec or a defense-aware attack every trace row runs the
general async step, even a synchronous one, as in JAX.

``agg_dtype`` (the compressed exchange) acts at delivery, after the
attack, as in the synchronous step: int8 / float8_e4m3fn quantize the
delivered fp32 rows per row (the buffer itself stays fp32) and the masked
engine aggregates codes and scales (K19 / K20 dequantize in registers);
a float dtype casts them, and the aggregate unravels to that dtype.

Gradient coding: with ``bz.draco_r`` every row aggregates with the
repetition code's decode over the delivered rows (its vote needs no
quorum); with ``SimConfig.coded_fallback_r`` a row that missed its quorum
takes the coded aggregate in place of the rule's.  JAX computes both and
selects with ``jnp.where``; the host knows here which one the row uses,
so only that one is computed.  Under a quantized exchange the coded paths
see the fake-quantized fp32 rows (with a fallback, the rule too, as in
JAX).  The group tables of the elastic buckets are built when the run
starts, so a bad r fails before any step.

The synchronous loop is the degenerate case: a "pure" row (the full
roster dispatches and delivers with zero staleness) runs the exact
synchronous step of :mod:`repro_torch.training.step`, so ``train_loop``
with ``sim=None`` is bit for bit the slice-1 loop.  A row where nothing
was delivered skips the update and defers its dispatches to the next step
that runs.

Elastic membership: with Join/Rejoin/Churn/SamplingPolicy specs the trace
carries a per-step roster, and an elastic spec (``make_spec(...,
n=elastic(n_max, buckets))``) packs the LIVE agents into per-bucket
stacks.  Step functions are built lazily, at most one per bucket (and one
synchronous step); each build counts once in
:mod:`repro_torch.obs.counters`.
"""
from __future__ import annotations

import dataclasses
import time
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from repro_torch.core.aggregators import staleness_discount_table
from repro_torch.core.attacks import (get_attack, is_adaptive_attack,
                                      make_adaptive_attack,
                                      make_byzantine_mask)
from repro_torch.core.flat import (FlatPlan, dtype_name, fake_quantize,
                                   quantize_rows)
from repro_torch.core.momentum import init_momentum, worker_momentum
from repro_torch.core.redundancy.coding import (coding_groups,
                                                flat_draco_aggregate)
from repro_torch.data import label_flip
from repro_torch.device import make_generator, resolve_device
from repro_torch.models import init_params, loss_fn
from repro_torch.obs.counters import count_trace
from repro_torch.optim import apply_updates
from repro_torch.simulator.events import AsyncTrace, simulate_arrivals
from repro_torch.simulator.faults import compile_schedule
from repro_torch.tree import tree_leaves


@dataclass(frozen=True)
class SimConfig:
    """Cluster-simulation knobs for :func:`async_train_loop`."""
    faults: tuple = ()                    # fault specs (simulator.faults)
    quorum: Optional[int] = None          # None -> n_agents (full barrier)
    max_staleness: Optional[int] = None   # None -> unbounded
    staleness_weighting: str = "poly"     # none | poly | exp
    staleness_power: float = 1.0          # poly: (1 + s)^-power
    staleness_gamma: float = 0.7          # exp: gamma^s
    base_delay: float = 1.0               # virtual time of one computation
    seed: int = 0                         # fault-schedule seed
    coded_fallback_r: int = 0             # >0: draco(r) when quorum missed


def staleness_weights(sim: SimConfig, atrace: AsyncTrace) -> np.ndarray:
    """(steps, n) float32 per-delivery weights: the staleness discount on
    contributors, 0 elsewhere."""
    s = atrace.staleness.astype(np.float64)
    w = staleness_discount_table(s, sim.staleness_weighting,
                                 sim.staleness_power, sim.staleness_gamma)
    return (w * atrace.contrib).astype(np.float32)


def plan_arrivals(sim: SimConfig, n_agents: int, steps: int) -> AsyncTrace:
    """Compile the fault schedule and run the virtual clock exactly as
    :func:`async_train_loop` will."""
    ftrace = compile_schedule(sim.faults, n_agents, steps + 1, seed=sim.seed,
                              base_delay=sim.base_delay)
    return simulate_arrivals(ftrace, steps, quorum=sim.quorum,
                             max_staleness=sim.max_staleness)


def _host_bools(x, n: int) -> np.ndarray:
    """(n,) host bool array of a numpy array, list or CPU tensor."""
    if isinstance(x, torch.Tensor):
        x = x.cpu().numpy()
    x = np.asarray(x, bool)
    if x.shape != (n,):
        raise ValueError(f"refresh must be (n={n},), got {x.shape}")
    return x


def _refuse_staleness_aware(spec):
    if spec.staleness_aware:                 # recurses through wrappers
        # this loop already turns staleness into discount multipliers
        # (SimConfig.staleness_weighting): a staleness_aware spec would
        # read those multipliers as round counts and invert the discounts
        raise ValueError(
            f"{spec.name} consumes raw staleness counts, but the async "
            "loop passes discount multipliers — configure "
            "SimConfig.staleness_weighting and use the inner spec instead")


# wrappers whose aggregate is their inner rule's, in its dtype
_DELEGATING_WRAPPERS = ("clipped", "bucketed", "staleness_discounted")


def _fp32_aggregate(spec) -> bool:
    """True iff the rule chain ends its aggregate in fp32 whatever the
    exchange dtype (the JAX tree law of server_momentum's momentum
    step)."""
    while spec.name in _DELEGATING_WRAPPERS:
        spec = spec.inner
    return spec.name == "server_momentum"


def make_async_step(cfg, bz, optimizer, device=None, fallback_r: int = 0,
                    bucket: int | None = None, telemetry: bool = False):
    """Returns ``async_step(params, opt_state, momentum, buffer, agg_state,
    batch, gen, refresh, contrib_w, use_coded=False, roster_idx=None,
    roster_valid=None) -> (params, opt_state, momentum, buffer,
    agg_state, metrics)``.

    ``fallback_r`` > 0 builds the coded fallback: a step called with
    ``use_coded=True`` (its row missed the quorum) aggregates with the
    repetition code's decode of the delivered rows instead of the rule.

    ``buffer``    (n, P) fp32 in-flight gradients, updated in place;
    ``agg_state`` the aggregator's state (``spec.init_state``; {} for a
                  stateless rule), bundled as ``{"agg": ..., "atk":
                  ...}`` with a defense-aware attack's state;
    ``refresh``   (n,) bool on the HOST — the agents computing a fresh
                  gradient this step (it decides which agents run a
                  backward pass);
    ``contrib_w`` (n,) fp32 staleness-discounted delivery weights (0 =
                  not delivered), on ``device``: the mask, the counts and
                  the scale are computed from it there, with no host sync;
    ``roster_idx`` (bucket,) int64 / ``roster_valid`` (bucket,) bool on
                  ``device`` when ``bucket`` is set: the live slots padded
                  by repeating a live slot, and which slots are real.

    ``params`` and ``opt_state`` are updated in place, as in the
    synchronous step.  ``device`` defaults to ``cuda`` and raises when
    CUDA is missing."""
    from repro_torch.training.step import (attack_arena, exchange_dtype,
                                           unsupported)
    dev = resolve_device(device)
    why = unsupported(bz, telemetry)
    if why:
        raise NotImplementedError(why)
    quant, xdt = exchange_dtype(bz)
    # the aggregate of the fp32 buffer unravels to fp32 leaves, that of a
    # cast exchange to leaves of its dtype
    agg_dtype = dtype_name(xdt) if xdt is not None and not quant else (
        "float32")
    spec = bz.resolve_spec()
    _refuse_staleness_aware(spec)
    if bucket is not None or spec.elastic_n is not None:
        spec = spec.respecialize(bucket if bucket is not None
                                 else bz.n_agents)
    if not spec.flat_capable:
        raise NotImplementedError(f"{spec.describe()} has no flat path")
    if _fp32_aggregate(spec) and not bz.draco_r:
        # server_momentum's fp32 momentum step (the JAX tree law) leaves
        # fp32 leaves whatever the exchange dtype; the coded decode
        # unravels to the exchange dtype
        agg_dtype = "float32"
    # the group table of the code in use, built here, once per (bucket, r)
    r_code = bz.draco_r if bz.draco_r > 0 else fallback_r
    groups = (coding_groups(bucket if bucket is not None else bz.n_agents,
                            r_code, allow_ragged=bucket is not None)
              if r_code > 0 else None)
    stateful = spec.stateful
    # a defense-aware attack is built against the spec this step runs
    adaptive = (make_adaptive_attack(bz.attack, spec, **bz.attack_hyper)
                if is_adaptive_attack(bz.attack) else None)
    attack_fn = (get_attack(bz.attack, **bz.attack_hyper)
                 if bz.attack != "none" and adaptive is None else None)
    n = bz.n_agents
    byz_mask = make_byzantine_mask(n, bz.f, device=dev)
    honest = (~byz_mask).float()
    count_trace("async_step")

    def async_step(params, opt_state, momentum, buffer, agg_state, batch,
                   gen, refresh, contrib_w, use_coded=False,
                   roster_idx=None, roster_valid=None):
        if use_coded and not fallback_r:
            raise ValueError("use_coded=True needs a step built with "
                             "fallback_r > 0")
        if (roster_idx is None) != (bucket is None):
            raise ValueError("roster_idx/roster_valid go with bucket=")
        refresh = _host_bools(refresh, n)
        leaves = tree_leaves(params)
        for leaf in leaves:
            if leaf.device != dev:
                raise ValueError(f"parameters on {leaf.device}, step built "
                                 f"for {dev}")
            leaf.requires_grad_(True)
        plan = FlatPlan.for_proto(params)
        if (buffer.shape != (n, plan.total) or buffer.dtype != torch.float32
                or buffer.device != dev):
            raise ValueError(f"buffer must be ({n}, {plan.total}) float32 "
                             f"on {dev}, got {tuple(buffer.shape)} "
                             f"{buffer.dtype} on {buffer.device}")

        # (2) every agent's loss; fresh gradients of the dispatching
        # agents go straight into their buffer rows (fp32)
        losses = torch.empty((n,), dtype=torch.float32, device=dev)
        for i in range(n):
            agent_batch = {k: v[i] for k, v in batch.items()}
            if refresh[i]:
                loss = loss_fn(cfg, params, agent_batch, remat=bz.remat)
                grads = torch.autograd.grad(loss, leaves)
                with torch.no_grad():
                    plan.write_row(buffer, i, grads)
                    if bz.momentum_alpha > 0.0:
                        # agents send momentum: m_i <- (1 - a) m_i + a g_i
                        worker_momentum(momentum[i:i + 1],
                                        buffer[i:i + 1], bz.momentum_alpha)
                        buffer[i].copy_(momentum[i])
                del grads
            else:
                with torch.no_grad():
                    loss = loss_fn(cfg, params, agent_batch)
            with torch.no_grad():
                losses[i] = loss.detach()
            del loss

        with torch.no_grad():
            atk_state = None
            if adaptive is not None:
                atk_state, agg_state = agg_state["atk"], agg_state["agg"]
            # (3) Byzantine corruption at delivery time, on a copy of what
            # is in flight: the buffer itself stays honest
            sent = buffer
            if attack_fn is not None:
                sent = torch.empty_like(buffer)
                attack_arena(attack_fn, gen, plan, buffer, byz_mask,
                             out=sent)
            elif adaptive is not None:
                # on the whole fp32 arena (min-max needs whole-row
                # geometry), reading the defense's carried center
                dvec = (agg_state["server_grad"]
                        if stateful and "server_grad" in agg_state
                        else None)
                sent, atk_state = adaptive(gen, buffer, byz_mask,
                                           atk_state, dvec)
            # the exchange: per-row codes and scales, or a cast; the
            # coded paths (and the rule beside a coded fallback) take the
            # fake-quantized fp32 rows
            qs = None
            if quant and r_code:
                sent = fake_quantize(sent, xdt)
            elif quant:
                sent, qs = quantize_rows(sent, xdt)
            elif xdt is not None:
                sent = sent.to(xdt)
            cw = contrib_w.to(device=dev, dtype=torch.float32)
            if bucket is not None:
                # the live roster packed into the bucket's stack; pad
                # slots carry weight 0 and are masked out
                w_b = torch.where(roster_valid, cw[roster_idx],
                                  torch.zeros((), device=dev))
                rows, rmask, rw = sent[roster_idx], w_b > 0, w_b
                rqs = None if qs is None else qs[roster_idx]
            else:
                rows, rmask, rw, rqs = sent, cw > 0, cw, qs
            if bz.draco_r or use_coded:
                # the repetition code votes among the delivered rows
                vec = flat_draco_aggregate(rows, r_code, mask=rmask,
                                           groups=groups)
            else:
                vec = spec.aggregate_flat(
                    rows, mask=rmask, weights=rw, scale=rqs,
                    state=agg_state if stateful else None)
            del rows, sent, qs, rqs
            agg = plan.as_dtype(agg_dtype).unravel(vec)
            # the state advances from the aggregate as unraveled (with
            # its exchange-dtype rounding), as in JAX
            if stateful:
                agg_state = spec.update_state(agg_state, agg)
            if adaptive is not None:
                agg_state = {"agg": agg_state, "atk": atk_state}

            # (4) server-side optimizer
            updates, opt_state = optimizer.update(agg, opt_state, params)
            apply_updates(params, updates)

            gnorm = torch.sqrt(sum(torch.sum(torch.square(l.float()))
                                   for l in tree_leaves(agg)))
            metrics = {
                "loss": torch.sum(losses * honest) / torch.sum(honest),
                "loss_all": torch.mean(losses),
                "grad_norm": gnorm,
            }
        return params, opt_state, momentum, buffer, agg_state, metrics

    return async_step


def _masked_kernel_missing(spec):
    """Why a rule of ``spec``'s chain that runs on the kernel impl has no
    masked kernel path (None when each has one: a masked kernel, or its
    own flat law, centered_clip's)."""
    from repro_torch.kernels.dispatch import (FLAT_SELF_KERNELED,
                                              kernel_masked_supported,
                                              masked_kernel_missing)
    while spec is not None:
        if (spec.impl == "kernel" and spec.name not in FLAT_SELF_KERNELED
                and not kernel_masked_supported(spec.name)):
            return masked_kernel_missing(spec.name)
        spec = spec.inner
    return None


def async_train_loop(cfg, bz, optimizer, dataset, steps: int,
                     sim: Optional[SimConfig] = None, seed: int = 0,
                     device=None, params=None, log_fn=print,
                     log_every: int = 10, poison_labels: bool = False,
                     ckpt_dir: str | None = None, recorder=None,
                     telemetry: Optional[bool] = None):
    """Returns (params, history list of metric dicts).

    ``sim=None`` (or any schedule whose trace stays synchronous) is the
    slice-1 synchronous loop bit for bit.  One explicit
    ``torch.Generator`` (seeded from ``seed``, on the device) draws the
    initial parameters, each step's batch and any attack noise.
    ``device`` defaults to ``cuda`` and raises when CUDA
    is missing; pass ``device="cpu"`` to run on the CPU."""
    from repro_torch.training.step import make_train_step
    if ckpt_dir:
        raise NotImplementedError("checkpoints come with ROADMAP.md slice 9")
    if recorder is not None or telemetry:
        raise NotImplementedError(
            "the flight recorder and selection telemetry come with "
            "ROADMAP.md slice 7")
    dev = resolve_device(device)
    sim = sim if sim is not None else SimConfig()
    n = bz.n_agents
    spec = bz.resolve_spec()
    _refuse_staleness_aware(spec)
    atrace = plan_arrivals(sim, n, steps)
    roster = atrace.roster                 # (steps, n) bool | None
    el = spec.elastic_n                    # a wrapper chain delegates
    r_code = bz.draco_r if bz.draco_r > 0 else sim.coded_fallback_r
    if r_code:
        coding_groups(n, r_code)           # the full roster: r must divide n
    if el is not None:
        if el.n_max != n:
            raise ValueError(
                f"elastic aggregator {spec.describe()} was built for "
                f"n_max={el.n_max} but the config declares n_agents={n}")
        if r_code:
            # every bucket's group table now, so that a bad r fails
            # before any step runs
            for b in el.buckets:
                coding_groups(int(b), r_code, allow_ragged=True)
        if roster is None:
            # membership never changes: the n_max bucket's concrete spec
            bz = dataclasses.replace(bz, aggregator=spec.respecialize(n))
            spec = bz.resolve_spec()
            el = None
    stateful = spec.stateful
    adaptive = is_adaptive_attack(bz.attack)
    contrib_w = staleness_weights(sim, atrace)

    gen = make_generator(seed, dev)
    if params is None:
        params = init_params(cfg, gen)
    opt_state = optimizer.init(params)
    total = FlatPlan.for_proto(params).total
    momentum = (init_momentum(n, total, dev) if bz.momentum_alpha > 0.0
                else None)
    agg_state = spec.init_state(params) if stateful else {}
    if adaptive:
        # the attack's state rides in the same slot; its structure does
        # not depend on the bucket, so it threads across respecializations
        agg_state = {"agg": agg_state,
                     "atk": make_adaptive_attack(
                         bz.attack, spec, **bz.attack_hyper).init_state(dev)}

    # step functions, built on first use: the synchronous step, the
    # async step, and one async step per elastic bucket
    built: dict = {}

    def step_fn(key):
        if key not in built:
            if key == "sync":
                built[key] = make_train_step(cfg, bz, optimizer, device=dev)
            else:
                built[key] = make_async_step(
                    cfg, bz, optimizer, device=dev,
                    fallback_r=sim.coded_fallback_r,
                    bucket=None if key == "async" else key)
        return built[key]

    byz_mask = make_byzantine_mask(n, bz.f, device=dev)
    # a row is pure iff it is exactly the synchronous step: the FULL
    # roster dispatches AND delivers with zero staleness
    pure = (atrace.contrib.all(1) & atrace.refresh.all(1)
            & (atrace.staleness.max(1, initial=0) == 0))
    if roster is not None:
        pure &= roster.all(1)
    if stateful or adaptive:
        # their state must see every step: the general async step, always
        pure = np.zeros(steps, bool)
    # a row that is not pure aggregates through the masked engine: refuse
    # a kernel spec without a masked kernel before any step runs, rather
    # than failing mid-run or quietly running the gather law
    masked_rows = ~pure & atrace.contrib.any(1)
    missing = _masked_kernel_missing(spec)
    if masked_rows.any() and missing and not bz.draco_r:
        raise NotImplementedError(
            f"{missing} (trace rows "
            f"{np.flatnonzero(masked_rows)[:8].tolist()} are not "
            "synchronous)")

    # the in-flight buffer (fp32 whatever the parameter dtype), zero until
    # the first async step writes it, and the dispatches deferred across
    # update-less rows (the parameters are unchanged there, so the
    # gradient is computed at the right version)
    buffer = None
    pending_refresh = np.zeros(n, bool)

    history = []
    t0 = time.time()
    for step in range(steps):
        batch = dataset.batch(dataset.draw_starts(gen))
        if poison_labels:
            batch = label_flip(batch, byz_mask, cfg.vocab_size)
        arrived = int(atrace.contrib[step].sum())
        if pure[step]:
            params, opt_state, momentum, metrics = step_fn("sync")(
                params, opt_state, momentum, batch, gen)
        elif arrived == 0:
            # nobody delivered: version unchanged, defer this row's
            # dispatches to the next step that runs
            pending_refresh |= atrace.refresh[step]
            metrics = None
        else:
            refresh = atrace.refresh[step] | pending_refresh
            pending_refresh = np.zeros(n, bool)
            use_coded = bool(not atrace.quorum_met[step]
                             and sim.coded_fallback_r > 0)
            if buffer is None:
                buffer = torch.zeros((n, total), dtype=torch.float32,
                                     device=dev)
            cw = torch.as_tensor(contrib_w[step]).to(dev)
            if el is not None:
                # pack the live roster into its bucket's fixed shape (a
                # contributor is a member, so the roster is not empty)
                b, idx, valid = el.pack(np.flatnonzero(roster[step]))
                (params, opt_state, momentum, buffer, agg_state,
                 metrics) = step_fn(int(b))(
                    params, opt_state, momentum, buffer, agg_state, batch,
                    gen, refresh, cw, use_coded,
                    torch.as_tensor(idx, dtype=torch.int64).to(dev),
                    torch.as_tensor(valid).to(dev))
            else:
                (params, opt_state, momentum, buffer, agg_state,
                 metrics) = step_fn("async")(
                    params, opt_state, momentum, buffer, agg_state, batch,
                    gen, refresh, cw, use_coded)
        if step % log_every == 0 or step == steps - 1:
            if metrics is None:
                m = {"loss": float("nan"), "loss_all": float("nan"),
                     "grad_norm": 0.0}
            else:
                m = {k: float(v) for k, v in metrics.items()}
            m["step"] = step
            m["wall_s"] = time.time() - t0
            m["arrived"] = arrived
            m["n_live"] = atrace.n_live(step)
            m["staleness_mean"] = (
                float(atrace.staleness[step][atrace.contrib[step]].mean())
                if arrived else 0.0)
            m["vclock"] = float(atrace.vclock[step])
            history.append(m)
            extra = ("" if pure[step] else
                     f"  arr {arrived:2d}  stal {m['staleness_mean']:.2f}")
            log_fn(f"step {step:5d}  loss {m['loss']:.4f}  "
                   f"gnorm {m['grad_norm']:.3f}{extra}")
    return params, history
