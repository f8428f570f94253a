"""Server-side optimizers (counterpart of ``repro.optim.optimizers``).

State lives in fp32 whatever the parameter dtype (mixed precision);
updates are cast back to the parameter dtype on apply.  Trees are nested
dicts of tensors.  Unlike the JAX package, ``update`` advances the moment
buffers IN PLACE (each is parameter-sized fp32, so a functional copy
would double the optimizer's memory); it still returns the state dict so
call sites read like the reference."""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import numpy as np
import torch

from repro_torch.tree import (tree_items, tree_leaves, tree_map,
                              tree_unflatten)


@dataclass(frozen=True)
class Optimizer:
    init: Callable
    update: Callable       # (grads, state, params) -> (updates, state)


def _zeros_f32(p):
    return torch.zeros(p.shape, dtype=torch.float32, device=p.device)


@torch.no_grad()
def apply_updates(params, updates):
    """p <- (p.f32 + u.f32).astype(p.dtype), in place."""
    for p, u in zip(tree_leaves(params), tree_leaves(updates)):
        p.copy_(p.float() + u.float())
    return params


def sgd(lr, momentum: float = 0.0, nesterov: bool = False,
        weight_decay: float = 0.0):
    def init(params):
        state = {"step": 0}
        if momentum != 0.0:
            state["mu"] = tree_map(_zeros_f32, params)
        return state

    @torch.no_grad()
    def update(grads, state, params):
        step = state["step"]
        eta = float(lr(step))
        g = tree_map(lambda gr, p: gr.float() + weight_decay * p.float(),
                     grads, params)
        if momentum == 0.0:
            return tree_map(lambda gr: -eta * gr, g), {"step": step + 1}
        for m, gr in zip(tree_leaves(state["mu"]), tree_leaves(g)):
            m.mul_(momentum).add_(gr)
        if nesterov:
            upd = tree_map(lambda m, gr: -eta * (momentum * m + gr),
                           state["mu"], g)
        else:
            upd = tree_map(lambda m: -eta * m, state["mu"])
        return upd, {"step": step + 1, "mu": state["mu"]}

    return Optimizer(init, update)


def adamw(lr, b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
          weight_decay: float = 0.0):
    """AdamW with fp32 moments, an integer ``step`` counter and bias
    correction 1 - b^t, as ``repro.optim.adamw``."""
    def init(params):
        return {"step": 0, "m": tree_map(_zeros_f32, params),
                "v": tree_map(_zeros_f32, params)}

    @torch.no_grad()
    def update(grads, state, params):
        step = state["step"] + 1
        eta = float(lr(state["step"]))
        t = np.float32(step)
        bc1 = float(np.float32(1) - np.float32(b1) ** t)
        bc2 = float(np.float32(1) - np.float32(b2) ** t)
        updates = []
        for m, v, g, p in zip(tree_leaves(state["m"]), tree_leaves(state["v"]),
                              tree_leaves(grads), tree_leaves(params)):
            gf = g.float()
            m.mul_(b1).add_(gf * (1 - b1))
            v.mul_(b2).add_(torch.square(gf) * (1 - b2))
            upd = (m / bc1) / (torch.sqrt(v / bc2) + eps)
            if weight_decay:
                upd = upd + weight_decay * p.float()
            updates.append(upd.mul_(-eta))
        paths = [path for path, _ in tree_items(params)]
        return (tree_unflatten(paths, updates),
                {"step": step, "m": state["m"], "v": state["v"]})

    return Optimizer(init, update)

