"""Peer-to-peer (decentralized) fault-tolerant DGD — survey §3.3.5
(counterpart of ``repro.core.p2p.dgd``).

In the p2p architecture agents broadcast their local ESTIMATES x_i (not
gradients, eq. 14).  Byzantine agents broadcast arbitrary vectors.  Honest
agent i combines the received values with a local rule, then takes a local
(sub)gradient step with a diminishing step size:

  x_i^{t+1} = Combine_i({x_j : j in N_i^in} ∪ {x_i}) - eta_t * grad Q_i(x_i)

Combine rules:
  * plain    — Metropolis-weighted average (non-robust DGD baseline), one
               ``W @ states`` product;
  * lf       — Local Filtering dynamics (Sundaram–Gharesifard [105]):
               coordinate-wise remove the f largest and f smallest neighbour
               values, average the rest; sound on (2f+1)-robust graphs;
  * ce       — Comparative Elimination (Gupta–Doan–Vaidya [48]): drop the f
               neighbour estimates FARTHEST (euclidean) from own, average the
               rest with own;
  * any stateless :class:`~repro_torch.core.aggregators.AggregatorSpec` —
    every receiver aggregates the broadcasts over its in-neighbourhood
    (self included) with the spec's masked law, one ``spec.aggregate``
    call per receiver (on the card: the rule's masked kernels), then mixes
    the result with its own estimate.

The JAX package builds the dense (n, n, d) tensor of received values for
lf and ce.  Here lf works per receiver on the (deg, d) rows that reach it
and ce on the (n, d) states, both over blocks of ``CHUNK`` columns, so a
round's scratch stays a few hundred MB at any d.  The arithmetic is JAX's:
lf's ``total - top_f - bottom_f`` form (the cancellation included) and
ce's stable ascending order of the distances (identical broadcasts tie
exactly, and the lower index is kept first).

Randomness comes from a ``torch.Generator`` where JAX takes a key:
``byz_fn(gen, t, states)``.  The data-injection attack of Wu et al. [114]
and its detection metric are provided for the adversarial-models section
(§4.1); its noise can also be handed over by value (``noise=``)."""
from __future__ import annotations

import math

import numpy as np
import torch

from repro_torch.core.p2p.graph import metropolis_weights
from repro_torch.device import make_generator, resolve_device

# columns per block of the lf and ce combines
CHUNK = 1 << 21


def _mix(own, other):
    """The conservative mixing of lf and the spec combine: half own
    estimate, half the neighbourhood's."""
    return 0.5 * own + 0.5 * other


def combine_plain(adj, W, states, f):
    return torch.as_tensor(W, dtype=states.dtype,
                           device=states.device) @ states


def combine_lf(adj, W, states, f):
    """Trimmed-mean local filtering, coordinate-wise per receiver: the
    neighbours' total minus their f largest and f smallest values, over
    max(deg - 2f, 1).  A degraded receiver (deg <= 2f, or deg == 0 when f =
    0) keeps its own estimate: the trim would remove more values than
    exist, and a partitioned or crashing graph reaches both cases."""
    n, d = states.shape
    inc = np.asarray(adj, bool).T                     # inc[i, j]: j -> i
    deg = inc.sum(1)
    out = torch.empty_like(states)
    for i in range(n):
        own = states[i]
        if not (deg[i] > 2 * f if f else deg[i] > 0):
            out[i] = _mix(own, own)
            continue
        nbrs = torch.as_tensor(np.flatnonzero(inc[i]), device=states.device)
        cnt = float(max(deg[i] - 2 * f, 1))
        for c0 in range(0, d, CHUNK):
            rows = states[nbrs, c0:c0 + CHUNK]        # (deg, w)
            trimmed = torch.sum(rows, dim=0)
            if f:
                srt = torch.sort(rows, dim=0).values
                trimmed = (trimmed - torch.sum(srt[deg[i] - f:], dim=0)
                           - torch.sum(srt[:f], dim=0))
            out[i, c0:c0 + CHUNK] = _mix(own[c0:c0 + CHUNK], trimmed / cnt)
    return out


def _sq_dists(states):
    """(n, n) fp32: [i, j] = ||states[j] - states[i]||^2, summed block by
    block over the columns."""
    n, d = states.shape
    d2 = torch.zeros((n, n), dtype=states.dtype, device=states.device)
    for c0 in range(0, d, CHUNK):
        x = states[:, c0:c0 + CHUNK]
        d2 += torch.sum(torch.square(x[None, :, :] - x[:, None, :]), dim=-1)
    return d2


def combine_ce(adj, W, states, f):
    """Comparative elimination: drop the f farthest-from-own, average the
    rest with own."""
    n = states.shape[0]
    inc = torch.as_tensor(np.asarray(adj, bool).T, device=states.device)
    d2 = torch.where(inc, _sq_dists(states), math.inf)
    keep_k = torch.clamp_min(inc.sum(1) - f, 0)
    order = torch.argsort(d2, dim=1, stable=True)    # nearest first
    rank = torch.argsort(order, dim=1, stable=True)
    keep = ((rank < keep_k[:, None]) & inc).cpu().numpy()
    out = torch.empty_like(states)
    for i in range(n):
        kept = np.flatnonzero(keep[i])
        total = torch.zeros_like(states[i])
        for j in kept:
            total += states[j]
        out[i] = (total + states[i]) / float(len(kept) + 1)
    return out


COMBINE = {"plain": combine_plain, "lf": combine_lf, "ce": combine_ce}


def make_combine_spec(spec):
    """Wrap a STATELESS :class:`~repro_torch.core.aggregators.AggregatorSpec`
    as a p2p combine rule: receiver i aggregates the broadcast estimates
    over the mask {j : j -> i} ∪ {i} with ``spec`` (the masked law; absent
    rows are whatever the rule's masked engine makes of them), then keeps
    half its own estimate — the conservative mixing of the lf dynamics.
    ``spec.f`` is the per-neighbourhood Byzantine budget (the run-level
    ``f`` argument is ignored).

    Stateful rules (zeno, zeno_pp) are rejected: there is no server in the
    decentralized architecture to hold their validation state, and per-
    receiver state threading is not implemented."""
    if spec.stateful:
        raise ValueError(
            f"{spec.name} is stateful and cannot be a p2p combine rule "
            "(no server-side state in the decentralized architecture); "
            "use a stateless spec")

    def comb(adj, W, states, f):
        n = states.shape[0]
        inc = np.asarray(adj, bool).T                 # inc[i, j]: j -> i
        masks = torch.as_tensor(inc | np.eye(n, dtype=bool),
                                device=states.device)
        out = torch.empty_like(states)
        for i in range(n):
            agg = spec.aggregate(states, mask=masks[i])
            out[i] = _mix(states[i], agg.to(states.dtype))
        return out
    return comb


def _faulted_adj(adj, trace, t):
    """Effective directed adjacency at round t under a FaultTrace: partition
    severs cross-group links, crashed agents neither send nor receive, a
    dropped broadcast removes all of the sender's outgoing edges (adj[a, b]
    is the edge a -> b), and a churned-out roster member is silenced exactly
    like a crashed agent — no broadcast, no reception, Metropolis weights
    rebuilt over the live subgraph (decentralized membership IS the crash
    handling: there is no server to repack a roster)."""
    h = trace.horizon
    v = min(t, h - 1)
    a = adj.copy()
    if trace.adj is not None:
        a &= trace.adj[v]
    alive = trace.alive[v]
    if trace.roster is not None:
        alive = alive & trace.roster[v]
    a &= alive[:, None] & alive[None, :]
    a[trace.drop[v]] = False
    return a, alive


def _host_bool(x, n):
    if x is None:
        return np.zeros((n,), bool)
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.asarray(x, bool)


def p2p_dgd_run(adj, grad_fn, x0, steps: int, f: int = 0,
                combine="plain", byz_mask=None, byz_fn=None,
                eta0: float = 0.5, eta_decay: float = 1.0, generator=None,
                seed: int = 0, fault_schedule=None, fault_seed: int = 0,
                device=None):
    """Simulate T rounds of p2p DGD on ``device`` (None: the card; raises
    without CUDA unless the caller passes ``device="cpu"``).

    grad_fn(i, x) -> gradient of Q_i at x, called for every agent i.
    byz_fn(gen, t, states) -> (n, d) broadcast values of the Byzantine
    agents (the rows of ``byz_mask``), ``gen`` the run's generator
    (``generator=``, or a new one seeded with ``seed``).
    x0 -> (n, d) initial estimates, numpy or a tensor, taken by value
    (numpy float64 becomes float32, as ``jnp.asarray`` makes it).
    combine -> "plain" | "lf" | "ce" or a stateless AggregatorSpec (a
    registered robust rule applied per in-neighbourhood; spec.f governs).
    fault_schedule -> a compiled
    :class:`repro_torch.simulator.faults.FaultTrace` or an iterable of
    fault specs (compiled here with ``fault_seed``): the graph becomes
    time-varying — partitions cut links, crash/recover faults freeze
    agents (no broadcast, no update), message drops silence a sender's
    round, and membership schedules (Join/Rejoin/Churn) silence
    churned-out agents the same way crashes do.  Metropolis weights are
    rebuilt per round.
    Returns the (steps + 1, n, d) trajectory."""
    from repro_torch.simulator.faults import FaultTrace, compile_schedule
    dev = resolve_device(device)
    adj = np.asarray(adj, bool)
    x = torch.as_tensor(x0)
    if x.dtype == torch.float64 and not isinstance(x0, torch.Tensor):
        x = x.float()
    n, d = x.shape
    trace = None
    if fault_schedule is not None:
        trace = (fault_schedule if isinstance(fault_schedule, FaultTrace)
                 else compile_schedule(tuple(fault_schedule), n, steps + 1,
                                       seed=fault_seed))
        assert trace.n_agents == n, (trace.n_agents, n)
    W = metropolis_weights(adj)
    comb = (COMBINE[combine] if isinstance(combine, str)
            else make_combine_spec(combine))
    byz = _host_bool(byz_mask, n)
    byz_t = torch.as_tensor(byz, device=dev)[:, None]
    gen = generator if generator is not None else make_generator(seed, dev)

    traj = torch.empty((steps + 1, n, d), dtype=x.dtype, device=dev)
    traj[0].copy_(x)
    states = traj[0]
    for t in range(steps):
        adj_t, W_t, alive = adj, W, None
        if trace is not None:
            adj_t, alive = _faulted_adj(adj, trace, t)
            # receivers mix over IN-neighbours: message drops make the
            # faulted graph asymmetric, and metropolis rows weight the
            # passed matrix's out-edges — hand it the transpose (no-op for
            # the symmetric un-faulted topologies)
            W_t = metropolis_weights(adj_t.T)
        sent = states
        if byz_fn is not None:
            sent = torch.where(byz_t, byz_fn(gen, t, states), states)
        mixed = comb(adj_t, W_t, sent, f)
        eta = eta0 / (1.0 + eta_decay * t)     # diminishing (appendix A.2)
        new = traj[t + 1]
        for i in range(n):
            torch.sub(mixed[i], eta * grad_fn(i, mixed[i]), out=new[i])
        for i in np.flatnonzero(byz):
            new[i] = sent[i]
        if alive is not None:                  # crashed agents are frozen
            for i in np.flatnonzero(~alive):
                new[i] = states[i]
        del sent, mixed            # free the round's scratch before the next
        states = new
    return traj


# ---------------------------------------------------------------------------
# data-injection attack + detection metric (Wu et al. [114], §4.1)


def data_injection_attack(target, sigma0: float = 1.0, decay: float = 0.05,
                          noise=None):
    """Adversary broadcasts  target + z_t  with ||z_t|| -> 0 a.s. — it fakes
    convergence toward its target point.  z_t is sigma0 exp(-decay t) times
    a standard normal (n, d) draw from the run's generator, or ``noise[t]``
    when the draws are handed over by value (a (steps, n, d) array)."""
    def byz_fn(gen, t, states):
        n, d = states.shape
        if noise is None:
            z = torch.randn((n, d), generator=gen, dtype=states.dtype,
                            device=states.device)
        else:
            z = torch.as_tensor(noise[t], dtype=states.dtype,
                                device=states.device)
        z = sigma0 * math.exp(-decay * t) * z
        tgt = torch.as_tensor(target, dtype=states.dtype,
                              device=states.device)
        return tgt[None, :] + z
    return byz_fn


def detect_injection(traj, adj, window: int = 10):
    """Local detect metric (simplified from [114]): for receiver i and
    in-neighbour j, the accumulated deviation of j's broadcast from the
    neighbourhood consensus.  Large score -> flag j as adversarial.
    Returns (n, n) numpy scores (i's suspicion of j)."""
    adj = np.asarray(adj, bool)
    x = traj[-window:]
    x = (x.detach().cpu().numpy() if isinstance(x, torch.Tensor)
         else np.asarray(x))                        # (w, n, d)
    n = adj.shape[0]
    scores = np.zeros((n, n))
    for i in range(n):
        nbrs = np.flatnonzero(adj[:, i])
        if len(nbrs) == 0:
            continue
        center = x[:, nbrs].mean(axis=1)            # (w, d)
        for j in nbrs:
            scores[i, j] = np.mean(
                np.linalg.norm(x[:, j] - center, axis=-1))
    return scores
