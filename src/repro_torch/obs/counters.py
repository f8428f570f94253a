"""Process-global counters (counterpart of the counter store of
``repro.obs.counters``; its gauges come with ROADMAP.md slice 7).

The JAX package counts a site once per jit TRACE, i.e. once per compile.
The port has no jit: its meaning of "a compile" is one step BUILD —
``make_async_step`` counts ``"async_step"`` and ``make_train_step``
counts ``"train_step"`` once each time it builds a step function.  The
async loop builds at most one step per elastic bucket, and the tests and
``chip_smoke.py`` hold it to that budget by diffing :func:`snapshot`
around a run.

Counters are monotonic; consumers snapshot before/after rather than
resetting (tests sharing the process must not clobber each other).
"""
from __future__ import annotations

from collections import Counter

COUNTERS: Counter = Counter()


def inc(name: str, by: int = 1) -> None:
    """Increment a counter (monotonic)."""
    COUNTERS[name] += by


def count_trace(site: str) -> None:
    """Record one build of the step function ``site``."""
    inc(site)


def trace_count(site: str) -> int:
    return COUNTERS[site]


def snapshot() -> dict:
    """Point-in-time copy ``{"counters": {...}}`` (a plain dict, detached
    from the live store)."""
    return {"counters": dict(COUNTERS)}


def counter_delta(before: dict, after: dict | None = None) -> dict:
    """Per-site increments between two :func:`snapshot` calls
    (``after=None`` means now); sites with zero delta are omitted."""
    after = after if after is not None else snapshot()
    b = before.get("counters", {})
    out = {}
    for site, n in after.get("counters", {}).items():
        d = n - b.get(site, 0)
        if d:
            out[site] = d
    return out


__all__ = ["COUNTERS", "inc", "count_trace", "trace_count", "snapshot",
           "counter_delta"]
