"""Mamba2 (SSD — state-space duality) block, chunked matmul form: the
training / prefill forward.

Counterpart of ``repro.models.ssm`` (arXiv:2405.21060's "minimal SSD"):
intra-chunk terms are dense attention-like contractions through the
1-semiseparable decay mask, inter-chunk terms pass an (h, p, n) state.
Plain torch ops: the JAX package has no kernel here.

Casts follow the JAX package point for point: the decay factors ``L``,
``decay_states``, ``carried`` and ``state_decay`` are rounded to the
operand dtype before their contractions, and the contractions accumulate
in fp32 (JAX's ``preferred_element_type``).  A bf16 product is exact in
fp32, so the operands are upcast and multiplied in fp32.  JAX's 3- and
4-operand einsums are written out as pairwise contractions, so the order
does not depend on an einsum path optimizer.

The O(1) decode recurrence and its caches come with serving (ROADMAP.md
item 20).
"""
from __future__ import annotations

import functools

import torch
import torch.nn.functional as F

from repro_torch.models.layers import dense_init, rms_norm

# ---------------------------------------------------------------------------
# params


def init_ssm(gen, cfg, dtype):
    D = cfg.d_model
    di = cfg.d_inner
    g, n = cfg.ssm_groups, cfg.ssm_state
    h = cfg.ssm_num_heads
    kq = cfg.ssm_conv
    dev = gen.device
    conv_dim = di + 2 * g * n
    f32 = torch.float32
    return {
        "in_proj": dense_init(gen, (D, 2 * di + 2 * g * n + h), dtype),
        "conv_w": dense_init(gen, (kq, conv_dim), dtype, scale=0.5),
        "conv_b": torch.zeros((conv_dim,), dtype=dtype, device=dev),
        "A_log": torch.zeros((h,), dtype=f32, device=dev),   # A = -1
        "dt_bias": torch.zeros((h,), dtype=f32, device=dev),
        "D_skip": torch.ones((h,), dtype=f32, device=dev),
        "norm_scale": torch.zeros((di,), dtype=dtype, device=dev),
        "out_proj": dense_init(gen, (di, D), dtype),
    }


# ---------------------------------------------------------------------------
# SSD core


@functools.lru_cache(maxsize=None)
def _tril(T: int, device: torch.device):
    """The (T, T) lower-triangular mask on ``device``, made once."""
    return torch.ones(T, T, dtype=torch.bool, device=device).tril()


def _segsum(x, cs=None):
    """Stable segment-sum: out[..., i, j] = sum_{j<k<=i} x[..., k] (i>=j),
    -inf above the diagonal; ``cs`` is x's cumulative sum where the
    caller has it.  The -inf entries are a constant of the ``where``: no
    gradient reads them (exp's backward multiplies by exp(-inf) = 0)."""
    cs = torch.cumsum(x, dim=-1) if cs is None else cs
    seg = cs[..., :, None] - cs[..., None, :]
    return torch.where(_tril(x.shape[-1], x.device), seg, -torch.inf)


def _pad_time(x, pad):
    """Zero-pad axis 1 (time) at its end by ``pad`` steps."""
    return F.pad(x, (0, 0) * (x.dim() - 2) + (0, pad))


def ssd_chunked(x, a, B, C, chunk: int, initial_state=None):
    """Chunked SSD scan.

    x: (b, t, h, p)   pre-multiplied by dt
    a: (b, t, h)      log-decay per step (dt * A, negative), fp32
    B, C: (b, t, g, n) with h % g == 0
    Returns y: (b, t, h, p) in x's dtype, final_state: (b, h, p, n) fp32.
    """
    b, t, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    t_orig = t
    pad = (-t) % chunk
    if pad:
        # zero x / B / C contribute nothing to the state; a = 0 (decay 1)
        # carries the state through the padding
        x, a, B, C = (_pad_time(v, pad) for v in (x, a, B, C))
        t = t + pad
    c = t // chunk
    rep = h // g
    dt = C.dtype
    f32 = torch.float32

    xr = x.reshape(b, c, chunk, h, p).to(f32)
    ar = a.reshape(b, c, chunk, h).permute(0, 3, 1, 2)         # (b,h,c,l)
    Br = B.reshape(b, c, chunk, g, n).repeat_interleave(rep, dim=3)
    Cr = C.reshape(b, c, chunk, g, n).repeat_interleave(rep, dim=3)
    Bf, Cf = Br.to(f32), Cr.to(f32)                             # (b,c,l,h,n)

    a_cs = torch.cumsum(ar, dim=-1)                             # (b,h,c,l)
    L = torch.exp(_segsum(ar, a_cs))                            # (b,h,c,l,l)

    # intra-chunk (diagonal blocks): (C.B) * L, then against x
    cb = torch.einsum("bclhn,bcshn->bhcls", Cf, Bf)
    w = cb * L.to(dt).to(f32)
    y_diag = torch.einsum("bhcls,bcshp->bclhp", w, xr)

    # per-chunk final states
    decay_states = torch.exp(a_cs[..., -1:] - a_cs)             # (b,h,c,l)
    bd = Bf * decay_states.to(dt).to(f32).permute(0, 2, 3, 1)[..., None]
    states = torch.einsum("bclhn,bclhp->bchpn", bd, xr)

    # inter-chunk recurrence over c via the segsum decay matrix
    if initial_state is None:
        initial_state = torch.zeros((b, h, p, n), dtype=f32, device=x.device)
    states = torch.cat([initial_state[:, None].to(f32), states], dim=1)
    chunk_decay = a_cs[..., -1]                                 # (b,h,c)
    padded = F.pad(chunk_decay, (1, 0))
    decay_chunk = torch.exp(_segsum(padded))                    # (b,h,c+1,c+1)
    decay_chunk = torch.where(torch.isfinite(decay_chunk), decay_chunk, 0.0)
    new_states = torch.einsum("bhzc,bchpn->bzhpn", decay_chunk, states)
    carried, final_state = new_states[:, :-1], new_states[:, -1]

    # contribution of the carried state to each chunk position
    state_decay = torch.exp(a_cs)                               # (b,h,c,l)
    cs_ = Cf * state_decay.to(dt).to(f32).permute(0, 2, 3, 1)[..., None]
    y_off = torch.einsum("bclhn,bchpn->bclhp", cs_,
                         carried.to(dt).to(f32))

    y = (y_diag + y_off).reshape(b, t, h, p)[:, :t_orig]
    return y.to(x.dtype), final_state


# ---------------------------------------------------------------------------
# causal conv


def causal_conv(x, w, b):
    """Depthwise causal conv.  x: (B, T, C); w: (k, C)."""
    k = w.shape[0]
    T = x.shape[1]
    xp = F.pad(x, (0, 0, k - 1, 0))
    out = sum(xp[:, i:i + T] * w[i] for i in range(k))
    return F.silu(out + b)


# ---------------------------------------------------------------------------
# full block


def _split_proj(cfg, zxbcdt):
    di = cfg.d_inner
    gn = cfg.ssm_groups * cfg.ssm_state
    h = cfg.ssm_num_heads
    z = zxbcdt[..., :di]
    xBC = zxbcdt[..., di:di + di + 2 * gn]
    dt = zxbcdt[..., di + di + 2 * gn:]
    assert dt.shape[-1] == h
    return z, xBC, dt


def softplus(x):
    """JAX's softplus law: logaddexp(x, 0)."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype,
                                          device=x.device))


def mamba_block(cfg, params, x):
    """Training / prefill forward.  x: (B, T, D) -> (y, final_state)."""
    Bsz, T, D = x.shape
    di, g, n = cfg.d_inner, cfg.ssm_groups, cfg.ssm_state
    h, p = cfg.ssm_num_heads, cfg.ssm_head_dim

    zxbcdt = x @ params["in_proj"]
    z, xBC, dt = _split_proj(cfg, zxbcdt)
    xBC = causal_conv(xBC, params["conv_w"], params["conv_b"])
    xs = xBC[..., :di].reshape(Bsz, T, h, p)
    Bm = xBC[..., di:di + g * n].reshape(Bsz, T, g, n)
    Cm = xBC[..., di + g * n:].reshape(Bsz, T, g, n)

    dt = softplus(dt.float() + params["dt_bias"])
    A = -torch.exp(params["A_log"])                     # (h,)
    y, state = ssd_chunked(xs * dt[..., None].to(xs.dtype), dt * A, Bm, Cm,
                           cfg.ssm_chunk)
    y = y + (params["D_skip"][:, None] * xs.float()).to(y.dtype)
    y = y.reshape(Bsz, T, di)
    y = rms_norm(y * F.silu(z.float()).to(y.dtype), params["norm_scale"],
                 cfg.norm_eps)
    return y @ params["out_proj"], state
