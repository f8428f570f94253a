"""The dense decoder stack: init, forward_train, loss_fn.

Counterpart of the dense branch of ``repro.models.transformer``.  Per-layer
parameters are STACKED on a leading L axis (``blocks.attn.wq`` is
(L, D, H*hd)), exactly as the JAX package stores them, so a parameter tree
crosses by value and the flat (n, P) arena lines up coordinate for
coordinate.  ``lax.scan`` over layers becomes a Python loop over the
unbound layer slices (unbind's backward is one stack, not L scatters).
"""
from __future__ import annotations

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.models import attention as attn_lib
from repro_torch.models.layers import (apply_norm, dense_init, embed_init,
                                       init_mlp, mlp)
from repro_torch.tree import tree_items, tree_map, tree_unflatten

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
          "float16": torch.float16}


def torch_dtype(cfg):
    return DTYPES[cfg.dtype]


def _check_family(cfg):
    if cfg.family != "dense" or cfg.is_encdec or cfg.frontend != "none":
        raise NotImplementedError(
            f"family={cfg.family!r}: only the dense stack is ported "
            "(ROADMAP.md slice 10)")


def _init_dense_block(gen, cfg, dtype):
    dev = gen.device
    return {
        "attn_norm": torch.zeros((cfg.d_model,), dtype=dtype, device=dev),
        "attn": attn_lib.init_attention(gen, cfg, dtype),
        "mlp_norm": torch.zeros((cfg.d_model,), dtype=dtype, device=dev),
        "mlp": init_mlp(gen, cfg, dtype),
    }


def init_params(cfg, gen: torch.Generator):
    """Random dense parameters on ``gen.device`` (JAX layout)."""
    _check_family(cfg)
    dtype = torch_dtype(cfg)
    layers = [_init_dense_block(gen, cfg, dtype)
              for _ in range(cfg.num_layers)]
    blocks = tree_map(lambda *ls: torch.stack(ls), *layers)
    params = {
        "embed": embed_init(gen, (cfg.vocab_size, cfg.d_model), dtype),
        "final_norm": torch.zeros((cfg.d_model,), dtype=dtype,
                                  device=gen.device),
        "blocks": blocks,
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = dense_init(gen, (cfg.d_model, cfg.vocab_size),
                                       dtype)
    return params


# ---------------------------------------------------------------------------
# forward


def _dense_body(cfg, h, *leaves, paths):
    blk = tree_unflatten(paths, leaves)
    a = apply_norm(cfg, h, blk["attn_norm"])
    h = h + attn_lib.attention(cfg, blk["attn"], a)
    m = apply_norm(cfg, h, blk["mlp_norm"])
    return h + mlp(cfg, blk["mlp"], m)


def _backbone(cfg, params, x, remat: bool = False):
    """Run the stacked decoder blocks over (B, T, D).  ``remat``: per-layer
    activation checkpointing (the counterpart of the JAX package's
    ``layer_remat``)."""
    items = tree_items(params["blocks"])
    paths = [p for p, _ in items]
    per_leaf = [leaf.unbind(0) for _, leaf in items]
    for i in range(cfg.num_layers):
        leaves = [u[i] for u in per_leaf]
        if remat:
            x = checkpoint(_dense_body, cfg, x, *leaves, paths=paths,
                           use_reentrant=False)
        else:
            x = _dense_body(cfg, x, *leaves, paths=paths)
    return x


def forward_train(cfg, params, batch, remat: bool = False):
    """Full forward.  Returns (logits (B, T, V), aux_loss)."""
    _check_family(cfg)
    tokens = batch["tokens"]
    x = params["embed"][tokens]
    h = _backbone(cfg, params, x, remat)
    h = apply_norm(cfg, h, params["final_norm"])
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    logits = h @ head
    return logits, torch.zeros((), dtype=torch.float32, device=h.device)


def loss_fn(cfg, params, batch, remat: bool = False):
    """Mean next-token NLL (fp32 log-softmax) + aux."""
    logits, aux = forward_train(cfg, params, batch, remat)
    labels = batch["labels"]
    logp = torch.log_softmax(logits.float(), dim=-1)
    nll = -torch.gather(logp, -1, labels[..., None].long())[..., 0]
    mask = batch.get("mask")
    if mask is None:
        mask = torch.ones_like(nll)
    loss = torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1.0)
    return loss + aux


# ---------------------------------------------------------------------------
# the module


class _ParamTree(nn.Module):
    """nn.Module mirror of a nested parameter dict."""

    def __init__(self, tree):
        super().__init__()
        for k in sorted(tree):
            v = tree[k]
            if isinstance(v, dict):
                self.add_module(k, _ParamTree(v))
            else:
                self.register_parameter(k, nn.Parameter(v))

    def tree(self):
        out = {k: p for k, p in self._parameters.items()}
        out.update({k: m.tree() for k, m in self._modules.items()})
        return out


class Transformer(nn.Module):
    """Holds the stacked dense parameters; ``forward(batch)`` is
    :func:`loss_fn`.  ``tree()`` gives the nested parameter dict in the
    JAX layout (``named_parameters()`` gives the same leaves as dotted
    names)."""

    def __init__(self, cfg, params, remat: bool = False):
        super().__init__()
        _check_family(cfg)
        self.cfg = cfg
        self.remat = remat
        self.params = _ParamTree(params)

    def tree(self):
        return self.params.tree()

    def forward(self, batch):
        return loss_fn(self.cfg, self.tree(), batch, self.remat)
