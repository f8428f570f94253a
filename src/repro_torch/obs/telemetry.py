"""Aggregation telemetry: dispatch records, per-agent series, suspicion
(counterpart of ``repro.obs.telemetry``).

The per-step half lives on the spec (:meth:`repro_torch.core.aggregators.
AggregatorSpec.selection_weights`, read by the loops with
``telemetry=True``).  This module is the HOST side: the dispatch record
stamped into a run's ``run`` event, the accumulation of per-step
telemetry rows into per-agent time series, and the derived *suspicion
scores*, the signal the survey's detection-based defenses start from.

Suspicion: a robust rule that keeps excluding an agent's rows is
evidence against that agent.  Per delivered row the rule's application
weights become *selection shares* (normalized to sum 1 over the
delivered set), compared with the uniform baseline ``1/arrived``:

    rate_i      = mean_t[ share_i(t) * arrived(t) | delivered_i(t) ]
    suspicion_i = clip(1 - rate_i, 0, 1)

Under plain averaging every delivered agent has rate 1 (suspicion 0); an
agent Krum never selects has rate 0 (suspicion 1).  Rates above uniform
clamp to suspicion 0: over-selection is consensus, not evidence.
"""
from __future__ import annotations

import numpy as np


# ---------------------------------------------------------------------------
# static dispatch record: the rule's impl, the elastic bucket table and the
# static plan sizes, stamped once per run into the recorder's trace


def dispatch_record(spec, bucket: int | None = None) -> dict:
    """Host-side static description of how ``spec`` will dispatch.

    Everything here is known at spec-build time: rule, impl
    (``gather|kernel``), (n, f), the elastic bucket table, whether the
    flat arena path applies, and the trimmed mean's trim count, so the
    record costs nothing per step."""
    from repro_torch.core.aggregators import trim_count
    rec = {
        "rule": spec.name,
        "impl": spec.impl,
        "f": int(spec.f) if isinstance(spec.f, int) else str(spec.f),
        "n": None if spec.n is None else int(spec.n),
        "flat": bool(spec.flat_capable),
        "stateful": bool(spec.stateful),
    }
    if bucket is not None:
        rec["bucket"] = int(bucket)
    if spec.name == "trimmed_mean" and spec.n is not None:
        rec["trim_b"] = int(trim_count(spec.n, spec.f, spec.hp("beta")))
    el = spec.elastic_n
    if el is not None:
        rec["elastic_buckets"] = [int(b) for b in el.buckets]
    if spec.inner is not None:
        rec["inner"] = dispatch_record(spec.inner)
    return rec


# ---------------------------------------------------------------------------
# host-side accumulation: recorder events -> per-agent time series


def agent_series(events, n: int | None = None) -> dict:
    """Stack the per-step telemetry rows of a recorded run.

    ``events``: the event list of a :class:`repro_torch.obs.recorder.
    Recorder` (or :func:`repro_torch.obs.recorder.read_trace`).  Returns fixed-shape
    arrays over the T steps that carried telemetry:

      ``sel_w``     (T, n) — the rule's application weights;
      ``mask``      (T, n) bool — delivered rows;
      ``contrib_w`` (T, n) — staleness-discounted delivery weights
                    (all-ones when the run never set them);
      ``roster``    (T, n) bool — live membership (all-True when static);
      ``step``      (T,) int — source step indices.
    """
    rows = [e for e in events
            if e.get("kind") == "step" and e.get("telemetry")]
    if not rows:
        z = np.zeros((0, n or 0))
        return {"sel_w": z, "mask": z.astype(bool), "contrib_w": z,
                "roster": z.astype(bool), "step": np.zeros(0, int)}
    first = rows[0]["telemetry"]
    n = n if n is not None else len(first["sel_w"])

    def col(key, default):
        return np.asarray([r["telemetry"].get(key, default)
                           for r in rows])
    sel = col("sel_w", [0.0] * n).astype(np.float64)
    mask = col("mask", [True] * n).astype(bool)
    contrib = col("contrib_w", [1.0] * n).astype(np.float64)
    roster = np.asarray([r.get("roster", [True] * n) for r in rows],
                        bool)
    step = np.asarray([r.get("step", i) for i, r in enumerate(rows)], int)
    return {"sel_w": sel, "mask": mask, "contrib_w": contrib,
            "roster": roster, "step": step}


def suspicion_scores(sel_w, mask, roster=None) -> list[dict]:
    """Per-agent selection statistics and suspicion scores.

    ``sel_w`` (T, n) application weights, ``mask`` (T, n) delivered,
    ``roster`` (T, n) live membership (None = always live).  Returns one
    dict per agent: live/delivered fractions, mean selection share
    relative to uniform (``sel_rate``, 1.0 = uniform), and
    ``suspicion`` in [0, 1] (see module docstring).  Agents that never
    delivered report ``sel_rate=None`` and inherit suspicion 0 — no
    evidence is not evidence of attack (crashed != Byzantine)."""
    sel_w = np.asarray(sel_w, np.float64)
    mask = np.asarray(mask, bool)
    T, n = sel_w.shape if sel_w.ndim == 2 else (0, 0)
    roster = (np.ones((T, n), bool) if roster is None
              else np.asarray(roster, bool))
    out = []
    # selection shares: normalize each step's weights over the delivered
    # set so rules whose weights sum below 1 (cgc attenuation) and
    # discount-scaled rows compare on the same uniform baseline
    tot = np.sum(np.where(mask, sel_w, 0.0), axis=1, keepdims=True)
    share = np.where(mask, sel_w, 0.0) / np.maximum(tot, 1e-30)
    arrived = mask.sum(1)
    for i in range(n):
        live_frac = float(roster[:, i].mean()) if T else 0.0
        live_steps = max(int(roster[:, i].sum()), 1)
        del_frac = float(mask[:, i].sum() / live_steps) if T else 0.0
        d = mask[:, i]
        if d.any():
            rate = float(np.mean(share[d, i] * arrived[d]))
            susp = float(np.clip(1.0 - rate, 0.0, 1.0))
        else:
            rate, susp = None, 0.0
        out.append({
            "agent": i,
            "live_frac": live_frac,
            "delivered_frac": del_frac,
            "sel_rate": rate,
            "suspicion": susp,
        })
    return out


__all__ = ["dispatch_record", "agent_series", "suspicion_scores"]
