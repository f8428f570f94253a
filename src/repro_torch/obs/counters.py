"""Process-global counters and gauges (counterpart of
``repro.obs.counters``).

The JAX package counts a site once per jit TRACE, i.e. once per compile.
The port has no jit: its meaning of "a compile" is one step BUILD —
``make_async_step`` counts ``"async_step"`` and ``make_train_step``
counts ``"train_step"`` once each time it builds a step function.  The
async loop builds at most one step per elastic bucket, and the tests and
``chip_smoke.py`` hold it to that budget by diffing :func:`snapshot`
around a run.

Counters are monotonic; consumers snapshot before/after rather than
resetting (tests sharing the process must not clobber each other).  The
flight recorder (:mod:`repro_torch.obs.recorder`) diffs :func:`snapshot`
around every step for its build ledger.  Gauges are last-write-wins host
values (live roster size, arrived count) for a scraper that wants the
current state without parsing a trace.
"""
from __future__ import annotations

from collections import Counter

COUNTERS: Counter = Counter()
GAUGES: dict = {}


def inc(name: str, by: int = 1) -> None:
    """Increment a counter (monotonic)."""
    COUNTERS[name] += by


def count_trace(site: str) -> None:
    """Record one build of the step function ``site``."""
    inc(site)


def trace_count(site: str) -> int:
    return COUNTERS[site]


def set_gauge(name: str, value) -> None:
    """Publish a last-write-wins host-side gauge value."""
    GAUGES[name] = value


def gauge(name: str, default=None):
    return GAUGES.get(name, default)


def snapshot() -> dict:
    """Point-in-time copy ``{"counters": {...}, "gauges": {...}}`` (plain
    dicts, detached from the live stores)."""
    return {"counters": dict(COUNTERS), "gauges": dict(GAUGES)}


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


def reset(name: str | None = None) -> None:
    """Clear counters and gauges (one name, or everything).  Prefer
    snapshot-diffing in tests; reset is for interactive sessions."""
    if name is None:
        COUNTERS.clear()
        GAUGES.clear()
    else:
        COUNTERS.pop(name, None)
        GAUGES.pop(name, None)


def reset_traces(site: str | None = None) -> None:
    """:func:`reset` restricted to the counters."""
    if site is None:
        COUNTERS.clear()
    else:
        COUNTERS.pop(site, None)


__all__ = ["COUNTERS", "GAUGES", "inc", "count_trace", "trace_count",
           "set_gauge", "gauge", "snapshot", "counter_delta", "reset",
           "reset_traces"]
