"""Flight-recorder observability (counterpart of ``repro.obs``).

:mod:`repro_torch.obs.counters`
    Process-global build counters and host-side gauges with a
    ``snapshot()`` / ``reset()`` API: the substrate of the step-build
    budget tests and of the recorder's build ledger.

:mod:`repro_torch.obs.telemetry`
    The host side of the selection telemetry: the dispatch record, the
    per-agent series of the recorded ``sel_w`` rows, and suspicion scores
    (selection rate against the uniform baseline).

:mod:`repro_torch.obs.recorder`
    :class:`Recorder`: a JSONL event log (run metadata, step spans,
    telemetry rows, builds, membership and fault annotations) and its
    Chrome-trace / Perfetto export.

:mod:`repro_torch.obs.report`
    Renders a recorded trace (``python -m repro_torch.launch.report
    trace.jsonl``).

The contract: telemetry off is the step as it was (the flag is a Python
branch: the same launches, no new host sync); telemetry on computes the
(n,) selection weights apart from the aggregate, so the trained
parameters stay bit for bit the same and no step is built more often.
"""
from repro_torch.obs import counters
from repro_torch.obs.provenance import provenance
from repro_torch.obs.recorder import Recorder, chrome_trace, read_trace
from repro_torch.obs.telemetry import (agent_series, dispatch_record,
                                       suspicion_scores)

__all__ = [
    "counters", "provenance", "Recorder", "chrome_trace", "read_trace",
    "agent_series", "dispatch_record", "suspicion_scores",
]
