"""Fault-injection cluster simulator + staleness-aware async training
(counterpart of ``repro.simulator``).

Layers (each usable on its own):
  faults      — composable seed-deterministic fault schedules -> FaultTrace
  events      — virtual-clock event queue -> arrival/staleness AsyncTrace
  async_loop  — bounded-staleness training loop (sync loop = degenerate case)
"""
from repro_torch.simulator.faults import (Churn, CrashRecover, FaultTrace,
                                          Join, MessageDrop, Partition,
                                          PermanentCrash, Rejoin,
                                          SamplingPolicy, Straggler,
                                          compile_schedule, no_faults)
from repro_torch.simulator.events import (AsyncTrace, poisson_arrival_times,
                                          simulate_arrivals)
from repro_torch.simulator.async_loop import (SimConfig, async_train_loop,
                                              make_async_step, plan_arrivals,
                                              staleness_weights)

__all__ = [
    "Straggler", "CrashRecover", "PermanentCrash", "MessageDrop",
    "Partition", "Join", "Rejoin", "Churn", "SamplingPolicy",
    "FaultTrace", "compile_schedule", "no_faults",
    "AsyncTrace", "simulate_arrivals", "poisson_arrival_times",
    "SimConfig", "async_train_loop", "make_async_step", "plan_arrivals",
    "staleness_weights",
]
