"""Static Byzantine attack models (counterpart of
``repro.core.attacks.gradient``).

An attack rewrites the rows of the f Byzantine agents.  Signature:
``attack(gen, g, byz_mask, **hyper) -> g_attacked`` with ``g: (n, d)``
fp32 and ``byz_mask: (n,)`` bool (True = Byzantine); ``gen`` is a
``torch.Generator`` for the attacks that draw noise.  ``gaussian`` also
takes the noise itself (``noise=``), which is how a test feeds both
packages the same numbers.  The defense-aware attacks are in
:mod:`.adaptive`.
"""
from __future__ import annotations

import functools
import math

import torch

ATTACKS: dict = {}


def register(name):
    def deco(fn):
        ATTACKS[name] = fn
        return fn
    return deco


def get_attack(name: str, **hyper):
    fn = ATTACKS[name]
    return functools.partial(fn, **hyper) if hyper else fn


def make_byzantine_mask(n: int, f: int, device=None):
    """The first f agents are Byzantine (the fixed-identity mask)."""
    return torch.arange(n, device=device) < f


def honest_moments(g, byz_mask):
    """Per-coordinate mean and std of the honest rows only."""
    w = (~byz_mask).to(g.dtype)[:, None]
    cnt = torch.clamp_min(torch.sum(w), 1.0)
    mu = torch.sum(g * w, dim=0) / cnt
    var = torch.sum(torch.square(g - mu[None]) * w, dim=0) / cnt
    return mu, torch.sqrt(var + 1e-12)


def _replace(g, byz_mask, bad):
    return torch.where(byz_mask[:, None], bad, g)


@register("none")
def none(gen, g, byz_mask):
    return g


@register("sign_flip")
def sign_flip(gen, g, byz_mask, scale: float = 1.0):
    """Send -scale * (honest mean): the classic reversal attack."""
    mu, _ = honest_moments(g, byz_mask)
    return _replace(g, byz_mask, -scale * mu[None, :])


@register("gaussian")
def gaussian(gen, g, byz_mask, sigma: float = 10.0, noise=None):
    if noise is None:
        noise = torch.randn(g.shape, generator=gen, dtype=g.dtype,
                            device=g.device)
    return _replace(g, byz_mask, sigma * noise)


@register("large_value")
def large_value(gen, g, byz_mask, magnitude: float = 1e6):
    return _replace(g, byz_mask, torch.full_like(g, magnitude))


@register("constant_drift")
def constant_drift(gen, g, byz_mask, target=None, scale: float = 1.0):
    """Push the aggregate toward a fixed direction."""
    d = g.shape[-1]
    if target is None:
        target = torch.ones((d,), dtype=g.dtype, device=g.device) / math.sqrt(d)
    return _replace(g, byz_mask, scale * target[None, :])


@register("alie")
def alie(gen, g, byz_mask, z: float = 1.5):
    """"A little is enough": mean - z * std per coordinate."""
    mu, sd = honest_moments(g, byz_mask)
    return _replace(g, byz_mask, (mu - z * sd)[None, :])


@register("ipm")
def ipm(gen, g, byz_mask, epsilon: float = 0.5):
    """Inner-product manipulation: -epsilon * honest mean."""
    mu, _ = honest_moments(g, byz_mask)
    return _replace(g, byz_mask, -epsilon * mu[None, :])


@register("mimic")
def mimic(gen, g, byz_mask, victim: int = -1):
    """All Byzantine agents copy one honest agent."""
    if victim < 0:
        victim = g.shape[0] - 1
    return _replace(g, byz_mask, g[victim][None, :])


@register("zero")
def zero(gen, g, byz_mask):
    """Stalling attack: contribute nothing."""
    return _replace(g, byz_mask, torch.zeros_like(g[0])[None, :])


@register("saddle_push")
def saddle_push(gen, g, byz_mask, saddle_dir=None, scale: float = 1.0):
    """Cancel the honest mean (and optionally push along a direction)."""
    mu, _ = honest_moments(g, byz_mask)
    n_byz = torch.clamp_min(torch.sum(byz_mask.to(g.dtype)), 1.0)
    n_hon = torch.sum((~byz_mask).to(g.dtype))
    cancel = -(n_hon / n_byz) * mu
    if saddle_dir is not None:
        cancel = cancel + scale * saddle_dir
    return _replace(g, byz_mask, cancel[None, :])
