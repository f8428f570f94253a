"""Copied from ``repro.simulator.events`` (numpy only, no JAX): the same
virtual clock, so one fault trace gives the port the JAX package's
arrival trace.

Virtual-clock event queue: latency samples -> arrival times & staleness.

Models the asynchronous server of the survey's §4 (and the Zeno++/Kardam
staleness-aware line of work): agents compute gradients against the latest
parameter version they saw, deliveries arrive out of order, and the server
forms parameter version t+1 as soon as a *quorum* of gradients has arrived.

The simulation runs entirely on the host over a compiled
:class:`~repro_torch.simulator.faults.FaultTrace` and produces an
:class:`AsyncTrace` of fixed-shape per-step arrays — the jitted async step
consumes one row per server step, so fault injection never causes
recompilation.

Protocol simulated (one server, n agents, virtual time in units of one base
gradient computation):

  * an agent dispatched at parameter version v computes for
    ``trace.delay[v, agent]`` virtual seconds, then its gradient arrives;
  * the server collects arrivals; when ``quorum`` of them are in (plus any
    others that arrived by the same instant), it applies update t, creating
    version t+1; contributors immediately re-dispatch against version t+1;
  * an agent that is down at its dispatch version waits until the first
    version at which it is alive (crash/recover) — or forever (permanent
    crash), leaving the quorum;
  * a dropped message is discovered at its would-be arrival instant; the
    agent retries against the then-current version (a retry is never
    re-dropped, so the virtual clock always advances);
  * a gradient older than ``max_staleness`` versions on arrival is discarded
    (bounded staleness); the agent re-dispatches fresh.

Elastic membership (``trace.roster`` — :class:`~repro_torch.simulator.faults.Join`
/ ``Rejoin`` / ``Churn`` schedules, and the *chosen* rosters a
:class:`~repro_torch.simulator.faults.SamplingPolicy` emits — client sampling is
just another membership schedule here): an agent absent from the roster can
neither dispatch, arrive, nor count toward quorum.  A delivery in flight
when its sender leaves the roster is discarded at the server (the agent is
gone); the agent re-dispatches fresh at its next membership version.  The
effective quorum at step t is ``min(quorum, n_live(t))`` (``quorum=None``
means the full LIVE roster), so a shrunken cluster still makes progress and
a grown one is awaited in full.

Two arrivals sharing an instant are processed in AGENT-ID order (the heap
key is ``(vtime, agent, seq)``): the outcome of a same-instant tie is
pinned by the trace alone, never by internal dispatch order.

If the quorum cannot be met (too many agents crashed or in flight), the
step is marked ``quorum_met[t] = False`` and proceeds with whatever arrived
— the training loop may then fall back to coded aggregation
(:mod:`repro.core.redundancy.coding`).
"""
from __future__ import annotations

import heapq
from dataclasses import dataclass
from typing import Optional

import numpy as np

from repro_torch.simulator.faults import FaultTrace


@dataclass(frozen=True)
class AsyncTrace:
    """Per-server-step execution trace (all arrays fixed-shape)."""
    contrib: np.ndarray       # (steps, n) bool — gradient used in update t
    staleness: np.ndarray     # (steps, n) int64 — versions behind, contribs
    refresh: np.ndarray       # (steps, n) bool — agent dispatched at version t
    vclock: np.ndarray        # (steps,) float64 — virtual completion time
    quorum_met: np.ndarray    # (steps,) bool
    # (steps, n) bool per-step membership; None = the full static roster.
    # The training loops thread row t into the jitted step (fixed shape),
    # and elastic-n specs re-specialize their plans from its live count.
    roster: Optional[np.ndarray] = None

    @property
    def steps(self) -> int:
        return self.contrib.shape[0]

    def n_live(self, t: int) -> int:
        return (self.contrib.shape[1] if self.roster is None
                else int(self.roster[t].sum()))

    def is_synchronous(self) -> bool:
        """True iff every step is the degenerate synchronous case: all n
        agents (the full static roster) contribute a zero-staleness
        gradient computed at the current version."""
        return (bool(self.contrib.all()) and bool(self.refresh.all())
                and int(self.staleness.max(initial=0)) == 0
                and (self.roster is None or bool(self.roster.all())))

    def staleness_histogram(self):
        """{staleness value: count} over contributing deliveries."""
        vals = self.staleness[self.contrib]
        uniq, cnt = np.unique(vals, return_counts=True)
        return {int(u): int(c) for u, c in zip(uniq, cnt)}

    def summary(self) -> dict:
        """Aggregate statistics of the trace, roster-aware.

        On top of the historical means: staleness and per-step arrival
        percentiles (p50/p95/max), ``n_live`` statistics under rosters
        (min/p50 — previously the roster was silently ignored here), and
        ``live_fraction`` — the fraction of steps each agent was a roster
        member (all-ones without a roster)."""
        n = self.contrib.shape[1]
        arrived = self.contrib.sum(1)
        stal = self.staleness[self.contrib]
        live = (np.full(self.steps, n)
                if self.roster is None else self.roster.sum(1))

        def pct(v, q):
            return float(np.percentile(np.asarray(v, np.float64), q))
        return {
            "steps": int(self.steps),
            "mean_live": float(live.mean()) if self.steps else 0.0,
            "min_live": int(live.min()) if self.steps else 0,
            "live_p50": pct(live, 50) if self.steps else 0.0,
            "mean_arrived": float(arrived.mean()) if self.steps else 0.0,
            "arrived_p50": pct(arrived, 50) if self.steps else 0.0,
            "arrived_p95": pct(arrived, 95) if self.steps else 0.0,
            "min_arrived": int(arrived.min()) if self.steps else 0,
            "mean_staleness": float(stal.mean()) if stal.size else 0.0,
            "staleness_p50": pct(stal, 50) if stal.size else 0.0,
            "staleness_p95": pct(stal, 95) if stal.size else 0.0,
            "max_staleness": int(stal.max()) if stal.size else 0,
            "virtual_time": float(self.vclock[-1]) if self.steps else 0.0,
            "quorum_misses": int((~self.quorum_met).sum()),
            "staleness_hist": self.staleness_histogram(),
            "live_fraction": ([1.0] * n if self.roster is None else
                              [float(x) for x in
                               self.roster[:self.steps].mean(0)]),
        }


def poisson_arrival_times(rate: float, horizon: float, seed: int = 0,
                          t0: float = 0.0, max_events: int | None = None
                          ) -> np.ndarray:
    """Seed-deterministic Poisson-process event times on the virtual clock.

    The arrival side of a SERVING workload: requests hit the front door as
    a Poisson process of ``rate`` events per virtual second (i.i.d.
    exponential gaps), the same virtual-time axis :func:`simulate_arrivals`
    runs training deliveries on — so an offered-load sweep composes with
    the :mod:`~repro_torch.simulator.faults` schedules driving the replicas.
    Returns the (k,) float64 sorted event times in ``[t0, t0 + horizon)``;
    ``rate <= 0`` yields no events, ``max_events`` truncates (admission
    control belongs to the consumer — see
    :class:`repro.serving.sched.RequestQueue`)."""
    if rate <= 0.0 or horizon <= 0.0:
        return np.zeros(0, np.float64)
    rng = np.random.default_rng(seed)
    # draw in chunks: E[k] = rate * horizon, pad generously, extend rarely
    times, t = [], float(t0)
    end = t0 + horizon
    while t < end and (max_events is None or len(times) < max_events):
        gaps = rng.exponential(1.0 / rate, size=max(16, int(rate * horizon)))
        for g in gaps:
            t += g
            if t >= end or (max_events is not None
                            and len(times) >= max_events):
                break
            times.append(t)
    return np.asarray(times, np.float64)


def simulate_arrivals(trace: FaultTrace, steps: int,
                      quorum: Optional[int] = None,
                      max_staleness: Optional[int] = None) -> AsyncTrace:
    """Run the virtual clock over a FaultTrace.

    quorum=None means the full live roster (fully synchronous barrier);
    quorum=k applies the update as soon as k gradients are in — capped per
    step at the live roster size, so a shrunken cluster keeps making
    progress (roster-aware quorum accounting)."""
    n = trace.n_agents
    h = trace.horizon
    assert h >= steps, (h, steps)
    q0 = n if quorum is None else max(1, min(int(quorum), n))

    contrib = np.zeros((steps, n), bool)
    staleness = np.zeros((steps, n), np.int64)
    refresh = np.zeros((steps, n), bool)
    vclock = np.zeros(steps)
    quorum_met = np.ones(steps, bool)

    # heap key (arrival_vtime, agent, seq): same-instant ties resolve by
    # AGENT ID, so the accepted set is a function of the trace alone and
    # never of internal dispatch order (seq only breaks exact re-pushes)
    heap = []                 # (arrival_vtime, agent, seq, version, immune)
    waiting = {}              # version -> [agents waiting for it to exist]
    seq = 0

    def dispatch(agent: int, vtime: float, version: int,
                 immune: bool = False):
        nonlocal seq
        v = version
        while v < steps and not (trace.alive[min(v, h - 1), agent]
                                 and trace.member(v, agent)):
            v += 1            # down or out of roster: wait to re-enter
        if v >= steps:
            return            # never returns within the horizon
        if v > version:
            waiting.setdefault(v, []).append((agent, immune))
            return
        refresh[v, agent] = True
        heapq.heappush(
            heap, (vtime + float(trace.delay[min(v, h - 1), agent]),
                   agent, seq, v, immune))
        seq += 1

    for i in range(n):
        dispatch(i, 0.0, 0)

    now = 0.0
    for t in range(steps):
        got = []
        live_t = trace.n_live(t)
        q_t = min(q0, live_t) if quorum is not None else live_t

        def receive(vt, agent, version, immune) -> bool:
            """True if the delivery is accepted into update t."""
            if trace.roster is not None and not trace.roster[
                    min(version, h - 1):min(t, h - 1) + 1, agent].all():
                # the sender left the roster at some point while its
                # gradient was in flight (its state is gone — even if it
                # already rejoined by the arrival instant): discard; it
                # re-dispatches fresh at its next membership version
                dispatch(agent, vt, t)
                return False
            if (not immune) and trace.drop[min(version, h - 1), agent]:
                dispatch(agent, vt, t, immune=True)     # retry, never re-drop
                return False
            if max_staleness is not None and t - version > max_staleness:
                dispatch(agent, vt, t)                  # too stale: recompute
                return False
            got.append((agent, version))
            return True

        while len(got) < q_t and heap:
            vt, agent, _, version, immune = heapq.heappop(heap)
            now = max(now, vt)
            receive(vt, agent, version, immune)
        # everything that arrived by the quorum instant joins the update
        while heap and heap[0][0] <= now:
            vt, agent, _, version, immune = heapq.heappop(heap)
            receive(vt, agent, version, immune)

        if len(got) < q_t or live_t == 0:
            quorum_met[t] = False
        for agent, version in got:
            contrib[t, agent] = True
            staleness[t, agent] = t - version
        vclock[t] = now
        # version t+1 now exists: contributors re-dispatch against it, and
        # recovered agents that were waiting for it wake up
        for agent, _ in got:
            dispatch(agent, now, t + 1)
        for agent, immune in waiting.pop(t + 1, ()):
            dispatch(agent, now, t + 1, immune=immune)

    roster = (None if trace.roster is None
              else trace.roster[:steps].copy())
    return AsyncTrace(contrib=contrib, staleness=staleness, refresh=refresh,
                      vclock=vclock, quorum_met=quorum_met, roster=roster)
