"""The run recorder: structured JSONL event logs + Chrome-trace export
(counterpart of ``repro.obs.recorder``).

A :class:`Recorder` is a cheap host-side event sink the sync and async
training loops feed.  Events are plain dicts, appended in memory and
(when a path is given) written one JSON line at a time, so a crashed run
keeps everything up to the last completed step.  Event kinds:

  ``meta``        run metadata: the provenance fingerprint and the
                  caller's fields, emitted once at recorder creation;
  ``run``         the loop's run description (dispatch record, trace
                  settings), once a run;
  ``step``        one optimizer step: span timing, scalar metrics, the
                  telemetry row (sel_w / mask / contrib_w) and the roster;
  ``compile``     one step BUILD of a counted site (the port's meaning of
                  a compile, :mod:`repro_torch.obs.counters`): the
                  recorder diffs the counters around every step, so each
                  build lands on the step that paid for it;
  ``membership``  roster deltas (joined / left agent ids);
  ``fault``       fault annotations (a missed quorum);
  ``note``        anything else.

:func:`chrome_trace` converts the event list into the Chrome trace-event
JSON that ``chrome://tracing`` and ui.perfetto.dev load: step spans as
"X" duration events, builds and faults as "i" instants on their own rows,
live / arrived / staleness as "C" counter tracks.

Every hook runs on the host between steps, on values the loop already
read back: attaching a recorder changes no parameter bit.
"""
from __future__ import annotations

import json
import time

import numpy as np

from repro_torch.obs import counters
from repro_torch.obs.provenance import provenance


def _jsonable(x):
    """Recursively convert numpy scalars and arrays and torch tensors (read
    back to the host) for json.dump."""
    if isinstance(x, dict):
        return {str(k): _jsonable(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_jsonable(v) for v in x]
    if isinstance(x, (bool, int, float, str)) or x is None:
        return x
    if isinstance(x, (np.bool_, np.integer)):
        return int(x)
    if isinstance(x, np.floating):
        return float(x)
    if hasattr(x, "detach"):          # a torch tensor, on any device
        return _jsonable(x.detach().cpu().tolist())
    if hasattr(x, "tolist"):          # np.ndarray
        return _jsonable(x.tolist())
    return str(x)


class Recorder:
    """Append-only event sink with optional JSONL persistence.

    ``path=None`` keeps events in memory only (tests, examples);
    otherwise every event is written as one JSON line immediately.
    ``meta`` extra fields for the opening metadata event (config echo,
    dispatch record, ...).
    """

    def __init__(self, path=None, meta: dict | None = None):
        self.events: list[dict] = []
        self.path = None if path is None else str(path)
        self._fh = open(self.path, "w") if self.path else None
        self._t0 = time.perf_counter()
        self._snap = counters.snapshot()
        self._roster = None
        self._subscribers: list = []
        self.emit("meta", provenance=provenance(), **(meta or {}))

    # -- core -----------------------------------------------------------
    def now(self) -> float:
        """Seconds since recorder creation (use for step t0/t1 spans)."""
        return time.perf_counter() - self._t0

    def subscribe(self, callback):
        """Stream events to ``callback(event_dict)`` as they are emitted.

        The live half of the recorder: a subscriber sees every event the
        JSONL file gets (same dicts, same order, including any emitted
        before it unsubscribes) without re-parsing the file.
        Subscription is purely additive: file emission stays byte
        identical whether zero or many subscribers are attached, and a
        subscriber registered mid-run simply starts at the next event
        (replay ``recorder.events`` yourself if you need history).
        Returns a zero-argument unsubscribe callable."""
        self._subscribers.append(callback)

        def unsubscribe():
            if callback in self._subscribers:
                self._subscribers.remove(callback)
        return unsubscribe

    def emit(self, kind: str, **fields) -> dict:
        ev = {"kind": kind, "t": round(self.now(), 6)}
        ev.update(_jsonable(fields))
        self.events.append(ev)
        if self._fh is not None:
            self._fh.write(json.dumps(ev) + "\n")
            self._fh.flush()
        for cb in tuple(self._subscribers):
            cb(ev)
        return ev

    # -- convenience hooks the loops call -------------------------------
    def step(self, step: int, t0: float | None = None,
             t1: float | None = None, metrics: dict | None = None,
             telemetry: dict | None = None, roster=None, **fields):
        """Record one completed step.

        Diffs the build counters first so the build events precede (and
        are attributable to) the step that paid for them, then emits any
        roster-delta annotation, then the step event itself."""
        delta = counters.counter_delta(self._snap)
        if delta:
            self._snap = counters.snapshot()
            for site, k in delta.items():
                self.emit("compile", step=step, site=site, count=k)
        if roster is not None:
            r = np.asarray(roster, bool)
            if self._roster is not None and not np.array_equal(r, self._roster):
                joined = np.flatnonzero(r & ~self._roster)
                left = np.flatnonzero(~r & self._roster)
                self.emit("membership", step=step,
                          joined=joined.tolist(), left=left.tolist(),
                          n_live=int(r.sum()))
            self._roster = r
        ev = {"step": int(step)}
        if t0 is not None:
            ev["t0"] = round(float(t0), 6)
            ev["t1"] = round(float(t1 if t1 is not None else self.now()), 6)
        if metrics:
            ev["metrics"] = metrics
        if telemetry:
            ev["telemetry"] = telemetry
        if roster is not None:
            ev["roster"] = np.asarray(roster, bool).tolist()
        ev.update(fields)
        return self.emit("step", **ev)

    def fault(self, step: int, fault: str, agents=(), **fields):
        return self.emit("fault", step=int(step), fault=str(fault),
                         agents=list(agents), **fields)

    def note(self, message: str, **fields):
        return self.emit("note", message=str(message), **fields)

    def close(self):
        # flush any builds since the last step so the ledger is complete
        delta = counters.counter_delta(self._snap)
        if delta:
            self._snap = counters.snapshot()
            for site, k in delta.items():
                self.emit("compile", step=-1, site=site, count=k)
        if self._fh is not None:
            self._fh.close()
            self._fh = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # -- exports --------------------------------------------------------
    def chrome_trace(self) -> dict:
        return chrome_trace(self.events)

    def dump_chrome_trace(self, path) -> str:
        path = str(path)
        with open(path, "w") as fh:
            json.dump(self.chrome_trace(), fh)
        return path


def read_trace(path) -> list[dict]:
    """Load a JSONL trace back into the recorder's event-list form."""
    events = []
    with open(str(path)) as fh:
        for line in fh:
            line = line.strip()
            if line:
                events.append(json.loads(line))
    return events


def chrome_trace(events) -> dict:
    """Convert recorder events to Chrome trace-event JSON.

    Rows (tids) under one process: 0 = step spans, 1 = build instants,
    2 = fault/membership annotations; counter tracks for live/arrived/
    staleness ride as "C" events.  Timestamps are µs; steps without
    explicit t0/t1 spans fall back to 1 ms synthetic slots so the track
    still renders in order."""
    out = []
    pid = 0
    for tid, label in ((0, "steps"), (1, "compiles"), (2, "faults")):
        out.append({"ph": "M", "pid": pid, "tid": tid,
                    "name": "thread_name", "args": {"name": label}})
    for i, ev in enumerate(events):
        kind = ev.get("kind")
        ts = ev.get("t", i * 1e-3) * 1e6
        if kind == "step":
            if "t0" in ev:
                ts = ev["t0"] * 1e6
                dur = max((ev.get("t1", ev["t0"]) - ev["t0"]) * 1e6, 1.0)
            else:
                ts, dur = ev.get("step", i) * 1e3, 1e3
            args = {"step": ev.get("step")}
            args.update(ev.get("metrics") or {})
            out.append({"ph": "X", "pid": pid, "tid": 0,
                        "name": f"step {ev.get('step')}",
                        "ts": ts, "dur": dur, "cat": "step", "args": args})
            m = ev.get("metrics") or {}
            for key in ("n_live", "arrived", "staleness_mean", "quorum_ok"):
                if key in m:
                    out.append({"ph": "C", "pid": pid, "tid": 0, "ts": ts,
                                "name": key, "args": {key: m[key]}})
            if ev.get("roster") is not None:
                out.append({"ph": "C", "pid": pid, "tid": 0, "ts": ts,
                            "name": "roster_live",
                            "args": {"live": int(sum(ev["roster"]))}})
        elif kind == "compile":
            out.append({"ph": "i", "pid": pid, "tid": 1, "ts": ts, "s": "t",
                        "cat": "compile",
                        "name": f"compile:{ev.get('site')}",
                        "args": {"site": ev.get("site"),
                                 "count": ev.get("count"),
                                 "step": ev.get("step")}})
        elif kind in ("fault", "membership"):
            name = (ev.get("fault") if kind == "fault" else
                    f"roster Δ +{ev.get('joined')} -{ev.get('left')}")
            out.append({"ph": "i", "pid": pid, "tid": 2, "ts": ts, "s": "t",
                        "cat": kind, "name": str(name),
                        "args": {k: v for k, v in ev.items()
                                 if k not in ("kind", "t")}})
    return {"traceEvents": out,
            "displayTimeUnit": "ms",
            "otherData": {"source": "repro_torch.obs.recorder"}}


__all__ = ["Recorder", "read_trace", "chrome_trace"]
