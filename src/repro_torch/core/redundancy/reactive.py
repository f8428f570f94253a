"""Randomized reactive redundancy, Gupta & Vaidya (counterpart of
``repro.core.redundancy.reactive``; survey §3.3.3).

Instead of paying the coding overhead every iteration, the server runs
the redundancy check only with probability q, and plain DGD (the mean of
the still-active agents) otherwise.  With a FIXED Byzantine set, a
detected agent is removed for good, so the amortized overhead is O(q).

Protocol (the parallel setting):
 1. the server draws check-or-plain before assigning work
    (:func:`should_check`); in a checking iteration, consecutive active
    agents are paired on identical data shards;
 2. a mismatching pair is resolved by the server recomputing that shard
    itself, which exposes the liar(s).

Detection changes the active set: sequential, rare and on the host.  The
draw takes an explicit ``torch.Generator`` (the port cannot reproduce
JAX's PRNG stream); :func:`reactive_step` also takes the decision itself
(``check=``), so a caller can replay a schedule drawn elsewhere.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch


@dataclass
class ReactiveState:
    active: torch.Tensor         # (n,) bool: agents not yet exposed
    checks_run: int = 0
    detected: int = 0


def init_reactive(n: int, device="cpu") -> ReactiveState:
    return ReactiveState(active=torch.ones((n,), dtype=torch.bool,
                                           device=device))


def should_check(gen, q: float) -> bool:
    """One uniform draw from ``gen`` (a ``torch.Generator``) below q."""
    return bool(torch.rand((), generator=gen, device=gen.device) < q)


def check_pairs(state: ReactiveState):
    """The consecutive pairing of the active agents (the announced
    assignment)."""
    idx = [int(i) for i in np.flatnonzero(state.active.cpu().numpy())]
    return list(zip(idx[0::2], idx[1::2]))


def plain_aggregate(g, state: ReactiveState):
    w = state.active.to(device=g.device, dtype=g.dtype)
    return torch.sum(g * w[:, None], dim=0) / torch.clamp_min(torch.sum(w),
                                                              1.0)


def check_and_aggregate(g, state: ReactiveState, server_recompute,
                        tol: float = 1e-6):
    """A checking iteration: the two agents of a pair computed the SAME
    shard, so honest pairs agree exactly; a disagreement triggers the
    server's recomputation and the removal of whoever differs from it."""
    gn = g.detach().cpu().double().numpy()
    active = state.active.cpu().numpy().copy()
    detected = state.detected
    scale = max(float(np.max(np.sum(gn ** 2, axis=-1))), 1e-30)
    for a, b in check_pairs(state):
        if np.sum((gn[a] - gn[b]) ** 2) > tol * scale:
            truth = np.asarray(torch.as_tensor(server_recompute(int(a)))
                               .cpu().double())
            for c in (a, b):
                if np.sum((gn[c] - truth) ** 2) > tol * scale:
                    active[c] = False
                    detected += 1
    new_state = ReactiveState(
        active=torch.as_tensor(active, device=state.active.device),
        checks_run=state.checks_run + 1, detected=detected)
    return plain_aggregate(g, new_state), new_state


def reactive_step(gen, g, state: ReactiveState, q: float,
                  server_recompute=None, tol: float = 1e-6, check=None):
    """Draw (or take ``check``), then check or run plain."""
    if server_recompute is None:
        return plain_aggregate(g, state), state
    if check is None:
        check = should_check(gen, q)
    if check:
        return check_and_aggregate(g, state, server_recompute, tol)
    return plain_aggregate(g, state), state
