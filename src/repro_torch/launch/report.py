"""Render a flight-recorder trace:
    python -m repro_torch.launch.report trace.jsonl

Prints the per-agent suspicion table, staleness / quorum percentiles,
the build ledger, the rule-dispatch breakdown and the membership changes
of a recorded run (``train_loop(..., recorder=...)``,
``async_train_loop``, or ``python -m repro_torch.launch.train --record``).
``--perfetto`` also exports the Chrome-trace JSON that
``chrome://tracing`` / ui.perfetto.dev load."""
from __future__ import annotations

import argparse
import json


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.launch.report",
        description="Render a repro_torch.obs flight-recorder trace "
                    "(JSONL).")
    ap.add_argument("trace", help="trace JSONL written by a Recorder")
    ap.add_argument("--top", type=int, default=None,
                    help="only the TOP most-suspicious agents")
    ap.add_argument("--perfetto", default=None, metavar="OUT_JSON",
                    help="also export a Chrome-trace/Perfetto JSON")
    args = ap.parse_args(argv)

    from repro_torch.obs.recorder import chrome_trace, read_trace
    from repro_torch.obs.report import render_report

    events = read_trace(args.trace)
    print(render_report(events, top=args.top))
    if args.perfetto:
        with open(args.perfetto, "w") as fh:
            json.dump(chrome_trace(events), fh)
        print(f"\nperfetto trace written to {args.perfetto}")


if __name__ == "__main__":
    main()
