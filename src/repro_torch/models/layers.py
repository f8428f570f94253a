"""Shared model building blocks: norms, the activation, RoPE, the SwiGLU
MLP, init laws.

Counterpart of ``repro.models.layers``.  Parameters are plain nested dicts
of tensors with the JAX package's layout (weights stored (in, out), used
as ``x @ w``), so weights cross between the two packages by value."""
from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

# ---------------------------------------------------------------------------
# init laws (drawn from an explicit torch.Generator; the numbers differ from
# jax.random's, the laws do not)


def dense_init(gen, shape, dtype, scale: float | None = None):
    """normal * 1/sqrt(fan_in), drawn in fp32 and cast."""
    fan_in = shape[0] if len(shape) >= 2 else max(shape[-1], 1)
    if scale is None:
        scale = 1.0 / np.sqrt(fan_in)
    x = torch.randn(shape, generator=gen, dtype=torch.float32,
                    device=gen.device)
    return (x * scale).to(dtype)


def embed_init(gen, shape, dtype):
    x = torch.randn(shape, generator=gen, dtype=torch.float32,
                    device=gen.device)
    return (x * 0.02).to(dtype)


# ---------------------------------------------------------------------------
# norms


def rms_norm(x, scale, eps: float = 1e-5):
    """RMSNorm with the ``(1 + scale)`` law, fp32 inside."""
    dt = x.dtype
    xf = x.float()
    var = torch.mean(torch.square(xf), dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps)
    return (out * (1.0 + scale.float())).to(dt)


def apply_norm(cfg, x, scale):
    if cfg.norm != "rms":
        raise NotImplementedError(
            f"norm={cfg.norm!r}: only rms is ported (ROADMAP.md slice 10b)")
    return rms_norm(x, scale, cfg.norm_eps)


# ---------------------------------------------------------------------------
# activations


def activate(cfg, gate, up):
    """SwiGLU's gate: silu(gate) * up.  GELU comes with slice 10b."""
    if cfg.act != "silu":
        raise NotImplementedError(
            f"act={cfg.act!r}: only SwiGLU is ported (ROADMAP.md slice 10b)")
    return F.silu(gate) * up


# ---------------------------------------------------------------------------
# rotary embeddings


def rope_freqs(head_dim: int, theta: float):
    half = head_dim // 2
    return 1.0 / (theta ** (np.arange(0, half, dtype=np.float32) / half))


@functools.lru_cache(maxsize=None)
def _rope_freqs_on(head_dim: int, theta: float, device: torch.device):
    """The (hd/2,) frequencies on ``device``, copied there once: a fresh
    host-to-device copy per call would stall the host on every layer."""
    return torch.from_numpy(rope_freqs(head_dim, theta)).to(device)


def apply_rope(x, positions, theta: float):
    """Split-half RoPE.  x: (..., T, H, hd); positions broadcastable to
    (..., T)."""
    hd = x.shape[-1]
    freqs = _rope_freqs_on(hd, theta, x.device)
    angles = positions[..., None].float() * freqs            # (..., T, hd/2)
    angles = angles[..., None, :]                            # (..., T, 1, hd/2)
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# dense MLP


def init_mlp(gen, cfg, dtype):
    D, Fd = cfg.d_model, cfg.d_ff
    if cfg.act != "silu":
        raise NotImplementedError(
            f"act={cfg.act!r}: only SwiGLU is ported (ROADMAP.md slice 10b)")
    return {
        "w_gate": dense_init(gen, (D, Fd), dtype),
        "w_up": dense_init(gen, (D, Fd), dtype),
        "w_down": dense_init(gen, (Fd, D), dtype),
    }


def mlp(cfg, params, x):
    """SwiGLU: silu(x W_gate) * (x W_up) W_down."""
    h = activate(cfg, x @ params["w_gate"], x @ params["w_up"])
    return h @ params["w_down"]
