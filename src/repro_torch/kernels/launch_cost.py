"""Where the time of a launch-bound selection wrapper goes: the card's own
time a launch against the host's time a call, on a host with an NVIDIA
GPU:

    python -m repro_torch.kernels.launch_cost

Two tables, one JSON line a row (the kernels' device-only times, this
checkout's against another's, come from ``compare``):

* ``event`` — ``compare.time_ms`` (CUDA events around 1000 calls, as
  chip_smoke.py times the launch-bound rows) of each wrapper, K3
  ``krum_select``, K8 ``cge_select``, K9 ``multi_krum_order`` and K10
  ``iterative_order`` (3 picks), and of ``build.empty_launch``, at n = 8,
  11, 16, 33 and 64, beside the kernel's device-only time in a trace of
  the same call (``compare.device_ms``).  The larger of the card's time
  and the host's time a call sets the event time: ``set_by`` is the card
  where the device time is at least 0.9 of it, else the host.
* ``host`` — ``time.perf_counter`` over 10,000 calls with no synchronise,
  at n = 8: each wrapper, ``build.empty_launch``, and the pieces of
  ``select.krum_select``'s call alone (the checks, ``torch.empty``,
  ``build.lib``, the two ``data_ptr`` reads, the stream handle, the
  ctypes call with its arguments ready, and the status check with the
  counter).  The kernel runs for a few microseconds, so the queue never
  fills: these are host times.

A first line checks that ``build.stream_ptr`` gives the pointer of
``torch.cuda.current_stream(dev).cuda_stream``.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import torch

from . import build, select
from .compare import NS, device_ms, f_of, gram_of, time_ms

HOST_CALLS = 10_000
EVENT_REPS = 1000


def host_us(call, calls: int = HOST_CALLS) -> float:
    """Host microseconds a call over ``calls`` calls, no synchronise
    inside the loop."""
    call()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        call()
    t = time.perf_counter() - t0
    torch.cuda.synchronize()
    return t / calls * 1e6


def wrappers(gr):
    """label -> (the kernel's name in a trace, the wrapper's call on Gram
    ``gr`` as a training step makes it)."""
    n, f = gr.shape[0], f_of(gr.shape[0])
    return {"krum_select": ("krum_select_kernel",
                            lambda: select.krum_select(gr, f)),
            "cge_select": ("cge_select_kernel",
                           lambda: select.cge_select(gr, n - f)),
            "multi_krum_order": ("multi_krum_order_kernel",
                                 lambda: select.multi_krum_order(gr, f, 3)),
            "iterative_order": ("iterative_order_kernel",
                                lambda: select.iterative_order(gr, f,
                                                               min(3, n))),
            "empty_launch": ("empty_kernel",
                             lambda: build.empty_launch(gr))}


def host_pieces(gr):
    """label -> one piece of ``select.krum_select``'s call alone."""
    n, f = gr.shape[0], f_of(gr.shape[0])
    L = build.lib()
    out = torch.empty((n,), device="cuda")
    args = (gr.data_ptr(), out.data_ptr(), n, f, build.stream_ptr(gr))
    dev = gr.device

    def counted():
        build.check(0, "krum_select")
        select.krum_select.launches += 1

    return {"checks": lambda: select._check_gram("krum_select", gr),
            "torch.empty": lambda: torch.empty(
                (n,), dtype=torch.float32, device=dev),
            "build.lib": build.lib,
            "data_ptr x2": lambda: (gr.data_ptr(), out.data_ptr()),
            "build.stream_ptr": lambda: build.stream_ptr(gr),
            "ctypes call (launch)": lambda: L.rt_krum_select(*args),
            "check + counter": counted}


def emit(card, table, **kw):
    print(json.dumps({"table": table, **kw, "card": card}), flush=True)


def main(argv=None):
    argparse.ArgumentParser(description=__doc__.splitlines()[0]).parse_args(
        argv)
    if not torch.cuda.is_available():
        raise SystemExit("launch_cost: needs an NVIDIA GPU")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    gen = torch.Generator(device="cuda").manual_seed(0)
    grams = {n: gram_of(n, gen) for n in NS}
    gr = grams[8]
    emit(card, "stream", torch=torch.__version__,
         stream_ptr_equals_current_stream=build.stream_ptr(gr) == (
             torch.cuda.current_stream(gr.device).cuda_stream))
    for n, g in grams.items():
        for label, (event, call) in wrappers(g).items():
            ms = time_ms(call, EVENT_REPS)
            dev_ms = device_ms(event, call)[0]
            emit(card, "event", call=label, n=n, ms=ms, device_ms=dev_ms,
                 set_by=("card" if isinstance(dev_ms, float)
                         and dev_ms >= 0.9 * ms else "host"))
    calls = {label: call for label, (_, call) in wrappers(gr).items()}
    for label, call in {**calls, **host_pieces(gr)}.items():
        emit(card, "host", call=label, n=8, us=host_us(call))
    return 0


if __name__ == "__main__":
    sys.exit(main())
