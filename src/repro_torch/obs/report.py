"""Render a recorded flight-recorder trace into human-readable tables
(counterpart of ``repro.obs.report``).

Consumed by ``python -m repro_torch.launch.report <trace.jsonl>``: the
per-agent suspicion table (selection rate against the uniform baseline),
staleness / quorum percentiles, the build ledger (which step paid for
which step build; the JAX package's recompile ledger) and the
rule-dispatch breakdown stamped at run start.
Pure functions from an event list (a :class:`repro_torch.obs.recorder.
Recorder`'s, or :func:`repro_torch.obs.recorder.read_trace`'s) to
strings, with no torch import, so the CLI starts at once on a laptop
reading a card run's trace.  A trace of the JAX package renders as that
package renders it."""
from __future__ import annotations

import numpy as np

from repro_torch.obs.telemetry import agent_series, suspicion_scores


def _fmt_table(headers, rows) -> str:
    cols = [len(h) for h in headers]
    srows = [[str(c) for c in row] for row in rows]
    for row in srows:
        cols = [max(w, len(c)) for w, c in zip(cols, row)]
    fmt = "  ".join(f"{{:>{w}}}" for w in cols)
    lines = [fmt.format(*headers), fmt.format(*("-" * w for w in cols))]
    lines += [fmt.format(*row) for row in srows]
    return "\n".join(lines)


def _steps(events):
    return [e for e in events if e.get("kind") == "step"]


def render_dispatch(events) -> str:
    """Rule-dispatch breakdown from the run metadata event(s)."""
    runs = [e for e in events if e.get("kind") == "run"]
    if not runs:
        return "dispatch: no run metadata recorded"
    lines = ["rule dispatch"]
    for run in runs:
        d = run.get("dispatch") or {}
        while d:
            bits = [f"rule={d.get('rule')}", f"impl={d.get('impl')}",
                    f"f={d.get('f')}", f"n={d.get('n')}"]
            if d.get("elastic_buckets"):
                bits.append(f"buckets={d['elastic_buckets']}")
            if d.get("trim_b") is not None:
                bits.append(f"trim_b={d['trim_b']}")
            if d.get("flat"):
                bits.append("flat-arena")
            if d.get("stateful"):
                bits.append("stateful")
            lines.append("  " + "  ".join(bits))
            d = d.get("inner") or {}
    return "\n".join(lines)


def render_suspicion(events, top: int | None = None) -> str:
    """Per-agent suspicion table (most suspicious first)."""
    ser = agent_series(events)
    if ser["sel_w"].shape[0] == 0:
        return ("suspicion: no telemetry rows in trace "
                "(record with telemetry enabled)")
    scores = suspicion_scores(ser["sel_w"], ser["mask"], ser["roster"])
    scores = sorted(scores, key=lambda s: -s["suspicion"])
    if top:
        scores = scores[:top]
    rows = [[s["agent"], f"{s['live_frac']:.2f}",
             f"{s['delivered_frac']:.2f}",
             "--" if s["sel_rate"] is None else f"{s['sel_rate']:.3f}",
             f"{s['suspicion']:.3f}",
             "#" * int(round(10 * s["suspicion"]))] for s in scores]
    hdr = ["agent", "live", "delivered", "sel_rate", "suspicion", ""]
    return (f"per-agent suspicion ({ser['sel_w'].shape[0]} telemetry "
            "steps; sel_rate 1.0 = uniform)\n" + _fmt_table(hdr, rows))


def _pcts(values) -> dict:
    v = np.asarray(values, np.float64)
    if v.size == 0:
        return {"p50": 0.0, "p95": 0.0, "max": 0.0}
    return {"p50": float(np.percentile(v, 50)),
            "p95": float(np.percentile(v, 95)),
            "max": float(v.max())}


def render_percentiles(events) -> str:
    """Staleness / arrival / quorum statistics over the recorded steps."""
    steps = _steps(events)
    metrics = [e.get("metrics") or {} for e in steps]
    if not metrics:
        return "percentiles: no step events in trace"
    rows = []
    for key, label in (("staleness_mean", "staleness(mean/step)"),
                       ("staleness_max", "staleness(max/step)"),
                       ("arrived", "arrived"),
                       ("n_live", "n_live")):
        vals = [m[key] for m in metrics if key in m]
        if vals:
            p = _pcts(vals)
            rows.append([label, f"{p['p50']:.2f}", f"{p['p95']:.2f}",
                         f"{p['max']:.2f}"])
    out = [f"step statistics over {len(steps)} recorded steps"]
    if rows:
        out.append(_fmt_table(["metric", "p50", "p95", "max"], rows))
    quorum = [m.get("quorum_ok") for m in metrics
              if m.get("quorum_ok") is not None]
    if quorum:
        misses = sum(1 for q in quorum if not q)
        out.append(f"quorum: {len(quorum) - misses}/{len(quorum)} steps met"
                   f" ({misses} missed)")
    return "\n".join(out)


def render_compile_ledger(events) -> str:
    """Which step paid for which build (``compile`` events): the
    recompile ledger, in the JAX package's words."""
    compiles = [e for e in events if e.get("kind") == "compile"]
    n_steps = len(_steps(events))
    if not compiles:
        return f"recompile ledger: 0 traces over {n_steps} steps"
    per_site: dict = {}
    for e in compiles:
        site = e.get("site", "?")
        per_site.setdefault(site, []).append(
            (e.get("step", -1), e.get("count", 1)))
    rows = []
    for site, hits in sorted(per_site.items()):
        total = sum(c for _, c in hits)
        at = ", ".join(f"step {s}" + (f" (x{c})" if c > 1 else "")
                       for s, c in hits)
        rows.append([site, total, at])
    head = (f"recompile ledger: {sum(r[1] for r in rows)} traces over "
            f"{n_steps} steps")
    return head + "\n" + _fmt_table(["site", "traces", "paid at"], rows)


def render_membership(events) -> str:
    rows = [[e.get("step"), f"+{e.get('joined')}", f"-{e.get('left')}",
             e.get("n_live")] for e in events
            if e.get("kind") == "membership"]
    if not rows:
        return ""
    return ("membership changes\n"
            + _fmt_table(["step", "joined", "left", "n_live"], rows))


def render_report(events, top: int | None = None) -> str:
    """The full report ``python -m repro_torch.launch.report`` prints."""
    meta = next((e for e in events if e.get("kind") == "meta"), {})
    prov = meta.get("provenance") or {}
    where = f"{prov.get('backend', '?')}/{prov.get('device_kind', '?')}"
    if "torch_version" in prov:
        bits = [f"torch {prov['torch_version']}",
                f"cuda {prov.get('cuda_version')}", where]
    else:                   # a trace of the JAX package
        bits = [f"jax {prov.get('jax_version', '?')}", where,
                f"interpret={prov.get('interpret')}"]
    head = ("flight-recorder report  ["
            + " | ".join(bits + [f"git {str(prov.get('git_sha', '?'))[:12]}"])
            + "]")
    sections = [head, render_dispatch(events), render_suspicion(events, top),
                render_percentiles(events), render_compile_ledger(events),
                render_membership(events)]
    return "\n\n".join(s for s in sections if s)


__all__ = ["render_report", "render_dispatch", "render_suspicion",
           "render_percentiles", "render_compile_ledger",
           "render_membership"]
