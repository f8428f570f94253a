"""Host-side synchronous training loop (counterpart of the synchronous
case of ``repro.training.train_loop``; the fault/async simulator comes
with ROADMAP.md slice 2).

One explicit ``torch.Generator`` (seeded from ``seed``, on the device)
draws the initial parameters, each step's batch ``starts`` and any attack
noise.  The numbers differ from the JAX package's PRNG streams; the laws
do not."""
from __future__ import annotations

import time

from repro_torch.core.momentum import init_momentum
from repro_torch.core.flat import FlatPlan
from repro_torch.core.attacks import make_byzantine_mask
from repro_torch.data import label_flip
from repro_torch.device import make_generator, resolve_device
from repro_torch.models import init_params
from repro_torch.training.step import make_train_step


def train_loop(cfg, bz, optimizer, dataset, steps: int, seed: int = 0,
               device=None, params=None, log_fn=print, log_every: int = 10,
               poison_labels: bool = False):
    """Returns (params, history list of metric dicts).  ``device``
    defaults to ``cuda`` and raises when CUDA is missing; pass
    ``device="cpu"`` to run on the CPU."""
    dev = resolve_device(device)
    gen = make_generator(seed, dev)
    if params is None:
        params = init_params(cfg, gen)
    opt_state = optimizer.init(params)
    momentum = None
    if bz.momentum_alpha > 0.0:
        momentum = init_momentum(bz.n_agents,
                                 FlatPlan.for_proto(params).total, dev)
    step_fn = make_train_step(cfg, bz, optimizer, device=dev)
    byz_mask = make_byzantine_mask(bz.n_agents, bz.f, device=dev)

    history = []
    t0 = time.time()
    for step in range(steps):
        batch = dataset.batch(dataset.draw_starts(gen))
        if poison_labels:
            batch = label_flip(batch, byz_mask, cfg.vocab_size)
        params, opt_state, momentum, metrics = step_fn(
            params, opt_state, momentum, batch, gen)
        if step % log_every == 0 or step == steps - 1:
            m = {k: float(v) for k, v in metrics.items()}
            m["step"] = step
            m["wall_s"] = time.time() - t0
            history.append(m)
            log_fn(f"step {step:5d}  loss {m['loss']:.4f}  "
                   f"gnorm {m['grad_norm']:.3f}")
    return params, history
