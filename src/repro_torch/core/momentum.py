"""Worker-side momentum (counterpart of ``repro.core.momentum``).

Agents send m_i^t = (1 - alpha) m_i^{t-1} + alpha g_i^t instead of raw
stochastic gradients (Karimireddy et al.; survey section 3.3.4).  The
port keeps the momentum as one (n, P) fp32 tensor laid out like the
gradient arena, and updates it IN PLACE (a functional copy would cost
another (n, P) fp32 buffer at model scale)."""
from __future__ import annotations

import torch


def init_momentum(n: int, total: int, device):
    """Zero (n, P) fp32 momentum buffers."""
    return torch.zeros((n, total), dtype=torch.float32, device=device)


@torch.no_grad()
def worker_momentum(momentum, grads, alpha: float = 0.1):
    """m <- ((1 - alpha) m + alpha g) in fp32, in place; returns
    (sent_updates, new_momentum), both the updated buffer, as the JAX
    function returns (new_m, new_m)."""
    momentum.mul_(1.0 - alpha).add_(grads.float() * alpha)
    return momentum, momentum
