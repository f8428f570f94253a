"""GQA attention, full-sequence (training) path.

Counterpart of ``repro.models.attention.attention``.  Layouts follow the
JAX package:

  q:      (B, T, H, hd)
  k, v:   (B, S, K, hd)          K = kv heads, H % K == 0

Scores are grouped as (B, K, H/K, T, S) and kept in fp32; the causal
(sliding-window) mask writes ``NEG_INF``.  Plain torch ops: the JAX
package has no kernel here.  The KV ring cache of decode comes with
serving (ROADMAP.md item 20); M-RoPE and ``qkv_bias`` with slice 10b.
"""
from __future__ import annotations

import math

import torch

from repro_torch.models.layers import apply_rope, dense_init

NEG_INF = -1e30


def init_attention(gen, cfg, dtype):
    D = cfg.d_model
    hd = cfg.resolved_head_dim
    if cfg.qkv_bias:
        raise NotImplementedError("qkv_bias is not ported (ROADMAP.md "
                                  "slice 10b)")
    return {
        "wq": dense_init(gen, (D, cfg.num_heads * hd), dtype),
        "wk": dense_init(gen, (D, cfg.num_kv_heads * hd), dtype),
        "wv": dense_init(gen, (D, cfg.num_kv_heads * hd), dtype),
        "wo": dense_init(gen, (cfg.num_heads * hd, D), dtype),
    }


def gqa_scores(cfg, q, k):
    """(B,T,H,hd) x (B,S,K,hd) -> (B,K,H/K,T,S) fp32 grouped logits.

    bf16 products are exact in fp32, so upcasting the operands gives the
    fp32-accumulated result JAX asks for with ``preferred_element_type``."""
    B, T, H, hd = q.shape
    K = k.shape[2]
    q = q.reshape(B, T, K, H // K, hd)
    scores = torch.einsum("btkgh,bskh->bkgts", q.float(), k.float())
    return scores / math.sqrt(hd)


def gqa_out(cfg, probs, v, params):
    B, K, G, T, S = probs.shape
    out = torch.einsum("bkgts,bskh->btkgh", probs.to(v.dtype), v)
    out = out.reshape(B, T, K * G * v.shape[-1])
    return out @ params["wo"]


def _causal_window_mask(T, S, q_offset, window: int, device=None):
    """Mask (T, S): query i (abs pos q_offset+i) attends key j iff
    j <= pos and pos - j < window (window=0 -> unlimited)."""
    q_pos = q_offset + torch.arange(T, device=device)[:, None]
    k_pos = torch.arange(S, device=device)[None, :]
    m = k_pos <= q_pos
    if window:
        m &= (q_pos - k_pos) < window
    return m


def attention(cfg, params, x, positions=None):
    """Causal (sliding-window when ``cfg.sliding_window``) full-sequence
    attention.  x: (B, T, D) -> (B, T, D)."""
    if cfg.positional != "rope":
        raise NotImplementedError(
            f"positional={cfg.positional!r}: only RoPE attention is ported "
            "(ROADMAP.md slice 10b)")
    B, T, _ = x.shape
    hd = cfg.resolved_head_dim
    q = (x @ params["wq"]).reshape(B, T, cfg.num_heads, hd)
    k = (x @ params["wk"]).reshape(B, T, cfg.num_kv_heads, hd)
    v = (x @ params["wv"]).reshape(B, T, cfg.num_kv_heads, hd)
    if positions is None:
        positions = torch.arange(T, device=x.device)[None, :]
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    scores = gqa_scores(cfg, q, k)
    mask = _causal_window_mask(T, T, 0, cfg.sliding_window, x.device)
    scores = scores.masked_fill(~mask, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    return gqa_out(cfg, probs, v, params)
