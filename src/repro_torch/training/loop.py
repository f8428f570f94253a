"""Host-side training loop (counterpart of ``repro.training.train_loop``).

The synchronous loop is the degenerate case of the asynchronous one
(:mod:`repro_torch.simulator.async_loop`): with no faults every trace row
is "pure" and runs the exact synchronous train step, so this wrapper is
bit for bit the slice-1 loop.  Pass ``sim=``
:class:`~repro_torch.simulator.async_loop.SimConfig` to inject crashes,
stragglers, message loss, churn or bounded-staleness asynchrony."""
from __future__ import annotations

from repro_torch.simulator.async_loop import SimConfig, async_train_loop


def train_loop(cfg, bz, optimizer, dataset, steps: int, seed: int = 0,
               device=None, params=None, log_fn=print, log_every: int = 10,
               poison_labels: bool = False, sim: SimConfig | None = None):
    """Returns (params, history list of metric dicts).  ``device``
    defaults to ``cuda`` and raises when CUDA is missing; pass
    ``device="cpu"`` to run on the CPU."""
    return async_train_loop(cfg, bz, optimizer, dataset, steps, sim=sim,
                            seed=seed, device=device, params=params,
                            log_fn=log_fn, log_every=log_every,
                            poison_labels=poison_labels)
