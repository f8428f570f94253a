"""Copied from ``repro.simulator.faults`` (numpy only, no JAX): the same
specs and the same rng draws, so one seed gives the port the JAX
package's fault trace.

Composable, seed-deterministic fault schedules — survey §2 fault taxonomy.

The survey's fault spectrum is wider than Byzantine gradients: crash/recover
faults, permanent crashes, stragglers (slow agents), message loss, and
network partitions (§2.2–§2.3, §4).  A :class:`FaultSchedule` is a tuple of
fault *specs*; compiling it against (n_agents, horizon, seed) yields a
:class:`FaultTrace` of plain per-version arrays that both the event-driven
cluster simulator (:mod:`repro_torch.simulator.events`) and the p2p DGD loop
(:mod:`repro.core.p2p.dgd`) consume:

  ``alive[v, i]``  agent i is up while computing the gradient it dispatches
                   at parameter version v (crash during computation is
                   modelled as not dispatching at that version);
  ``drop[v, i]``   the message dispatched at version v by agent i is lost in
                   transit (computed, never delivered — the agent retries
                   once it discovers the loss, retries are never re-dropped);
  ``delay[v, i]``  compute + network latency, in virtual-time units of one
                   base gradient computation, for the dispatch at version v;
  ``adj[v]``       (n, n) bool link mask for decentralized topologies
                   (``None`` unless a :class:`Partition` spec is present);
  ``roster[v, i]`` agent i is a MEMBER of the cluster at version v (``None``
                   unless a membership spec — :class:`Join`, :class:`Rejoin`,
                   :class:`Churn`, :class:`SamplingPolicy` — is present).
                   Membership is a stronger notion than liveness: a crashed
                   agent is still expected back and still counts toward the
                   deployment's (n, f) bookkeeping, while a non-member can
                   neither dispatch, arrive, nor count toward quorum
                   (elastic membership — agents joining/rejoining, not just
                   leaving).  :class:`SamplingPolicy` flips the roster from
                   *observed* churn to a *chosen* schedule: federated
                   client sampling emitted through the same machinery.

Everything is sampled from one ``numpy.random.default_rng(seed)`` in spec
order, so a schedule is a pure function of (specs, n, horizon, seed) — the
property the determinism tests pin down.  The arrays are host-side numpy on
purpose: the training loop indexes one row per step and feeds it to the
jitted step function as ordinary jnp inputs (fixed shapes, one compile).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np


def _agent_idx(agents, n):
    return np.arange(n) if agents is None else np.asarray(agents, np.int64)


# ---------------------------------------------------------------------------
# fault specs


@dataclass(frozen=True)
class Straggler:
    """Multiplicative slowdown of compute latency (survey §2.3 "slow
    agents").  Per dispatch, with probability ``prob``, the latency is
    multiplied by a sample from ``dist``:

      lognormal — exp(sigma * N(0,1))          (heavy-ish tail, median 1)
      exp       — 1 + Exponential(scale)
      pareto    — 1 + Pareto(alpha=scale)      (heavy tail)
      constant  — scale                        (deterministic slow agent)
    """
    dist: str = "lognormal"
    scale: float = 1.0
    prob: float = 1.0
    agents: Optional[Tuple[int, ...]] = None

    def apply(self, rng, alive, drop, delay, adj, roster):
        h, n = delay.shape
        sel = _agent_idx(self.agents, n)
        shape = (h, len(sel))
        if self.dist == "lognormal":
            factor = np.exp(self.scale * rng.standard_normal(shape))
        elif self.dist == "exp":
            factor = 1.0 + rng.exponential(self.scale, shape)
        elif self.dist == "pareto":
            factor = 1.0 + rng.pareto(self.scale, shape)
        elif self.dist == "constant":
            factor = np.full(shape, self.scale)
        else:
            raise KeyError(self.dist)
        hit = rng.random(shape) < self.prob
        delay[:, sel] *= np.where(hit, factor, 1.0)


@dataclass(frozen=True)
class CrashRecover:
    """Crash/recover (fail-stop with repair, survey §2.2): while up, an agent
    crashes each version with probability ``rate``; downtime is geometric
    with mean ``mean_down`` versions."""
    rate: float = 0.05
    mean_down: float = 3.0
    agents: Optional[Tuple[int, ...]] = None

    def apply(self, rng, alive, drop, delay, adj, roster):
        h, n = alive.shape
        sel = _agent_idx(self.agents, n)
        p_up = 1.0 / max(self.mean_down, 1.0)       # geometric recovery
        for i in sel:
            up = True
            for v in range(h):
                if up:
                    if rng.random() < self.rate:
                        up = False
                else:
                    if rng.random() < p_up:
                        up = True
                alive[v, i] &= up


@dataclass(frozen=True)
class PermanentCrash:
    """Fail-stop without repair from version ``at`` onward."""
    agents: Tuple[int, ...]
    at: int = 0

    def apply(self, rng, alive, drop, delay, adj, roster):
        sel = _agent_idx(self.agents, alive.shape[1])
        alive[self.at:, sel] = False


@dataclass(frozen=True)
class MessageDrop:
    """Iid message loss: the gradient dispatched at version v is lost in
    transit with probability ``p`` (omission fault, survey §2.2)."""
    p: float = 0.1
    agents: Optional[Tuple[int, ...]] = None

    def apply(self, rng, alive, drop, delay, adj, roster):
        h, n = drop.shape
        sel = _agent_idx(self.agents, n)
        drop[:, sel] |= rng.random((h, len(sel))) < self.p


# ---------------------------------------------------------------------------
# membership (elastic roster) specs — survey §2.2's churn beyond fail-stop:
# real federated/swarm deployments have agents joining and rejoining, and
# every Table-2 guarantee is a function of the LIVE (n, f)


@dataclass(frozen=True)
class Join:
    """Agents that are not founding members: they enter the roster at
    version ``at`` and stay (barring later membership specs)."""
    agents: Tuple[int, ...]
    at: int

    def apply(self, rng, alive, drop, delay, adj, roster):
        sel = _agent_idx(self.agents, roster.shape[1])
        roster[:self.at, sel] = False


@dataclass(frozen=True)
class Rejoin:
    """A scheduled leave/rejoin cycle: members until ``leave_at``, out of
    the roster during [leave_at, rejoin_at), members again after.  A
    gradient in flight when the agent leaves is discarded (the agent is
    gone); on rejoining it dispatches fresh against the then-current
    version."""
    agents: Tuple[int, ...]
    leave_at: int
    rejoin_at: int

    def apply(self, rng, alive, drop, delay, adj, roster):
        if self.rejoin_at < self.leave_at:
            raise ValueError((self.leave_at, self.rejoin_at))
        sel = _agent_idx(self.agents, roster.shape[1])
        roster[self.leave_at:self.rejoin_at, sel] = False


@dataclass(frozen=True)
class Churn:
    """Stochastic membership churn (two-state Markov chain per agent, the
    roster-level analogue of :class:`CrashRecover`): while a member, an
    agent leaves each version with probability ``rate``; time out of the
    roster is geometric with mean ``mean_out`` versions."""
    rate: float = 0.05
    mean_out: float = 3.0
    agents: Optional[Tuple[int, ...]] = None

    def apply(self, rng, alive, drop, delay, adj, roster):
        h, n = roster.shape
        sel = _agent_idx(self.agents, n)
        p_in = 1.0 / max(self.mean_out, 1.0)        # geometric re-entry
        for i in sel:
            member = True
            for v in range(h):
                if member:
                    if rng.random() < self.rate:
                        member = False
                else:
                    if rng.random() < p_in:
                        member = True
                roster[v, i] &= member


@dataclass(frozen=True)
class SamplingPolicy:
    """Client-sampling policy (federated §4): the roster as a CHOSEN
    schedule, not an observed fault — the same move the federated
    client-sampling literature makes on top of gradient coding's
    roster-aware groups.

    Each round of ``round_len`` versions the server selects ``m`` agents
    from those still in the roster at the round's first version:

      uniform       — iid uniform without replacement (FedAvg sampling)
      staleness     — P(i) ∝ 1 / mean latency over the round: prefer FAST
                      agents (staleness-aware participation)
      contribution  — P(i) ∝ expected delivery rate over the round (alive
                      and not dropped): prefer RELIABLE agents

    Scores are read from the already-composed ``alive``/``drop``/``delay``
    arrays, so place the policy AFTER the fault specs it should react to
    (specs apply in order).  The choice is INTERSECTED into the roster:
    agents a prior membership spec removed are never chosen, and a later
    ``Churn`` can still evict a chosen agent.  ``temperature`` flattens
    (>1) or sharpens (<1) the preference.  Counts as a membership spec —
    compiling a schedule containing one allocates a roster, which the
    flight recorder logs as per-step membership deltas."""
    m: int
    policy: str = "uniform"             # uniform | staleness | contribution
    round_len: int = 1
    temperature: float = 1.0

    def apply(self, rng, alive, drop, delay, adj, roster):
        if self.m <= 0:
            raise ValueError(f"SamplingPolicy needs m >= 1, got m={self.m}")
        if self.policy not in ("uniform", "staleness", "contribution"):
            raise KeyError(self.policy)
        if self.round_len <= 0:
            raise ValueError(
                f"SamplingPolicy needs round_len >= 1, got {self.round_len}")
        h, n = roster.shape
        for t0 in range(0, h, self.round_len):
            t1 = min(t0 + self.round_len, h)
            avail = np.flatnonzero(roster[t0])
            if avail.size == 0:
                continue
            if self.policy == "uniform":
                score = np.ones(avail.size)
            elif self.policy == "staleness":
                score = 1.0 / np.maximum(
                    delay[t0:t1, avail].mean(axis=0), 1e-9)
            else:
                score = (alive[t0:t1, avail]
                         & ~drop[t0:t1, avail]).mean(axis=0) + 1e-3
            p = score ** (1.0 / max(self.temperature, 1e-6))
            p = p / p.sum()
            chosen = rng.choice(avail, size=min(self.m, avail.size),
                                replace=False, p=p)
            keep = np.zeros(n, bool)
            keep[chosen] = True
            roster[t0:t1] &= keep[None, :]


@dataclass(frozen=True)
class Partition:
    """Network partition during versions [start, end): only links within the
    same group survive.  Agents not named in any group form one implicit
    residual group."""
    groups: Tuple[Tuple[int, ...], ...]
    start: int = 0
    end: int = 10 ** 9

    def apply(self, rng, alive, drop, delay, adj, roster):
        assert adj is not None
        h, n, _ = adj.shape
        gid = np.full(n, len(self.groups), np.int64)      # residual group
        for g, members in enumerate(self.groups):
            gid[np.asarray(members, np.int64)] = g
        same = gid[:, None] == gid[None, :]
        lo, hi = max(self.start, 0), min(self.end, h)
        adj[lo:hi] &= same[None]


FAULT_SPECS = (Straggler, CrashRecover, PermanentCrash, MessageDrop,
               Partition, Join, Rejoin, Churn, SamplingPolicy)
MEMBERSHIP_SPECS = (Join, Rejoin, Churn, SamplingPolicy)


# ---------------------------------------------------------------------------
# compiled trace


@dataclass(frozen=True)
class FaultTrace:
    alive: np.ndarray                 # (horizon, n) bool
    drop: np.ndarray                  # (horizon, n) bool
    delay: np.ndarray                 # (horizon, n) float64
    adj: Optional[np.ndarray] = None  # (horizon, n, n) bool, partitions only
    seed: int = 0
    # (horizon, n) bool membership; None = the full static roster
    # (membership specs only — see the module docstring)
    roster: Optional[np.ndarray] = None

    @property
    def horizon(self) -> int:
        return self.alive.shape[0]

    @property
    def n_agents(self) -> int:
        return self.alive.shape[1]

    @property
    def base_delay(self) -> float:
        return float(np.min(self.delay)) if self.delay.size else 1.0

    def member(self, version: int, agent: int) -> bool:
        """Roster membership at ``version`` (clamped to the horizon)."""
        if self.roster is None:
            return True
        return bool(self.roster[min(version, self.horizon - 1), agent])

    def n_live(self, version: int) -> int:
        """Live roster size at ``version`` (= n_agents without churn)."""
        if self.roster is None:
            return self.n_agents
        return int(self.roster[min(version, self.horizon - 1)].sum())

    def is_trivial(self) -> bool:
        """True iff the trace can never desynchronize a quorum-n loop:
        nobody crashes, nothing drops, all latencies are equal, and the
        roster is the full static membership."""
        return (bool(self.alive.all()) and not bool(self.drop.any())
                and bool((self.delay == self.delay.flat[0]).all())
                and self.adj is None
                and (self.roster is None or bool(self.roster.all())))


def compile_schedule(specs, n_agents: int, horizon: int, seed: int = 0,
                     base_delay: float = 1.0) -> FaultTrace:
    """Sample a concrete FaultTrace from composable fault specs.

    Deterministic in (specs, n_agents, horizon, seed): one rng, consumed in
    spec order.  ``horizon`` must cover every parameter version the run can
    dispatch at (the loops use steps + 1)."""
    specs = tuple(specs or ())
    rng = np.random.default_rng(seed)
    alive = np.ones((horizon, n_agents), bool)
    drop = np.zeros((horizon, n_agents), bool)
    delay = np.full((horizon, n_agents), float(base_delay))
    adj = (np.ones((horizon, n_agents, n_agents), bool)
           if any(isinstance(s, Partition) for s in specs) else None)
    roster = (np.ones((horizon, n_agents), bool)
              if any(isinstance(s, MEMBERSHIP_SPECS) for s in specs)
              else None)
    for spec in specs:
        spec.apply(rng, alive, drop, delay, adj, roster)
    return FaultTrace(alive=alive, drop=drop, delay=delay, adj=adj,
                      seed=seed, roster=roster)


def no_faults(n_agents: int, horizon: int,
              base_delay: float = 1.0) -> FaultTrace:
    """The degenerate trace: all agents up, zero-variance latency."""
    return compile_schedule((), n_agents, horizon, seed=0,
                            base_delay=base_delay)
