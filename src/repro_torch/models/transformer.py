"""The decoder-only stacks (dense, sliding-window, MoE, SSM, hybrid):
init, forward_train, loss_fn.

Counterpart of the text branches of ``repro.models.transformer``.
Per-layer parameters are STACKED on a leading L axis (``blocks.attn.wq``
is (L, D, H*hd)), exactly as the JAX package stores them, so a parameter
tree crosses by value and the flat (n, P) arena lines up coordinate for
coordinate.  ``lax.scan`` over layers becomes a Python loop over the
unbound layer slices (unbind's backward is one stack, not L scatters).
The hybrid (Zamba2) runs ``hybrid_attn_every`` SSM layers, then the one
shared attention block, per group, and the remaining SSM layers as a
tail.  The encoder-decoder (whisper) and the vision frontend (qwen2-vl)
come with slice 10b; the decode path with serving (ROADMAP.md item 20).
"""
from __future__ import annotations

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.models import attention as attn_lib
from repro_torch.models import moe as moe_lib
from repro_torch.models import ssm as ssm_lib
from repro_torch.models.layers import (apply_norm, dense_init, embed_init,
                                       init_mlp, mlp)
from repro_torch.tree import tree_items, tree_map, tree_unflatten

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
          "float16": torch.float16}


def torch_dtype(cfg):
    return DTYPES[cfg.dtype]


def _check_family(cfg):
    if cfg.is_encdec or cfg.frontend != "none":
        raise NotImplementedError(
            f"{cfg.name}: the encoder-decoder and the modality frontends "
            "are not ported (ROADMAP.md slice 10b)")
    if cfg.family not in ("dense", "moe", "ssm", "hybrid"):
        raise NotImplementedError(
            f"family={cfg.family!r}: not ported (ROADMAP.md slice 10b)")


def _init_dense_block(gen, cfg, dtype):
    dev = gen.device
    return {
        "attn_norm": torch.zeros((cfg.d_model,), dtype=dtype, device=dev),
        "attn": attn_lib.init_attention(gen, cfg, dtype),
        "mlp_norm": torch.zeros((cfg.d_model,), dtype=dtype, device=dev),
        "mlp": init_mlp(gen, cfg, dtype),
    }


def _init_moe_block(gen, cfg, dtype):
    dev = gen.device
    return {
        "attn_norm": torch.zeros((cfg.d_model,), dtype=dtype, device=dev),
        "attn": attn_lib.init_attention(gen, cfg, dtype),
        "mlp_norm": torch.zeros((cfg.d_model,), dtype=dtype, device=dev),
        "moe": moe_lib.init_moe(gen, cfg, dtype),
    }


def _init_ssm_block(gen, cfg, dtype):
    return {
        "norm": torch.zeros((cfg.d_model,), dtype=dtype, device=gen.device),
        "ssm": ssm_lib.init_ssm(gen, cfg, dtype),
    }


def _block_init_fn(cfg):
    if cfg.family == "moe":
        return _init_moe_block
    if cfg.family in ("ssm", "hybrid"):
        return _init_ssm_block
    return _init_dense_block


def init_params(cfg, gen: torch.Generator):
    """Random parameters on ``gen.device`` (JAX's laws and tree layout:
    stacked layers; the SSM's ``A_log`` / ``dt_bias`` / ``D_skip`` and the
    MoE router in fp32 beside leaves of ``cfg.dtype``)."""
    _check_family(cfg)
    dtype = torch_dtype(cfg)
    init_block = _block_init_fn(cfg)
    layers = [init_block(gen, cfg, dtype) for _ in range(cfg.num_layers)]
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
    if cfg.family == "hybrid":
        params["shared_attn"] = _init_dense_block(gen, cfg, dtype)
    return params


# ---------------------------------------------------------------------------
# forward


def _dense_body(cfg, h, *leaves, paths):
    blk = tree_unflatten(paths, leaves)
    a = apply_norm(cfg, h, blk["attn_norm"])
    h = h + attn_lib.attention(cfg, blk["attn"], a)
    m = apply_norm(cfg, h, blk["mlp_norm"])
    return h + mlp(cfg, blk["mlp"], m)


def _moe_body(cfg, h, *leaves, paths):
    blk = tree_unflatten(paths, leaves)
    a = apply_norm(cfg, h, blk["attn_norm"])
    h = h + attn_lib.attention(cfg, blk["attn"], a)
    m = apply_norm(cfg, h, blk["mlp_norm"])
    out, aux = moe_lib.moe_block(cfg, blk["moe"], m)
    return h + out, aux


def _ssm_body(cfg, h, *leaves, paths):
    blk = tree_unflatten(paths, leaves)
    a = apply_norm(cfg, h, blk["norm"])
    out, _ = ssm_lib.mamba_block(cfg, blk["ssm"], a)
    return h + out


def _hybrid_groups(cfg):
    """(layers in whole groups, groups, tail layers)."""
    k = cfg.hybrid_attn_every
    n_full = (cfg.num_layers // k) * k
    return n_full, n_full // k, cfg.num_layers - n_full


def _layers(blocks):
    """(paths, per-layer leaf lists) of a stacked block tree."""
    items = tree_items(blocks)
    per_leaf = [leaf.unbind(0) for _, leaf in items]
    return [p for p, _ in items], list(zip(*per_leaf))


def _call(body, remat, cfg, h, leaves, paths):
    """One layer's ``body``, under activation checkpointing when
    ``remat``."""
    if remat:
        return checkpoint(body, cfg, h, *leaves, paths=paths,
                          use_reentrant=False)
    return body(cfg, h, *leaves, paths=paths)


def _backbone(cfg, params, x, remat: bool = False):
    """Run the stacked decoder blocks over (B, T, D); returns (h, aux),
    aux the MoE load-balance loss summed over layers (0 elsewhere).
    ``remat``: per-layer activation checkpointing (the counterpart of the
    JAX package's ``layer_remat``), of each layer and each use of the
    hybrid's shared block."""
    paths, layers = _layers(params["blocks"])
    if cfg.family == "moe":
        auxs = []
        for leaves in layers:
            x, a = _call(_moe_body, remat, cfg, x, leaves, paths)
            auxs.append(a)
        return x, torch.sum(torch.stack(auxs))
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if cfg.family == "hybrid":
        # each whole group of k SSM layers is followed by the shared
        # block, then the tail (JAX's _split_stacked, as list slices)
        k = cfg.hybrid_attn_every
        n_full, groups, _ = _hybrid_groups(cfg)
        s_items = tree_items(params["shared_attn"])
        s_paths, shared = [p for p, _ in s_items], [l for _, l in s_items]
        for g in range(groups):
            for leaves in layers[g * k:(g + 1) * k]:
                x = _call(_ssm_body, remat, cfg, x, leaves, paths)
            x = _call(_dense_body, remat, cfg, x, shared, s_paths)
        layers = layers[n_full:]
    body = _dense_body if cfg.family == "dense" else _ssm_body
    for leaves in layers:
        x = _call(body, remat, cfg, x, leaves, paths)
    return x, aux


def forward_train(cfg, params, batch, remat: bool = False):
    """Full forward.  Returns (logits (B, T, V), aux_loss)."""
    _check_family(cfg)
    tokens = batch["tokens"]
    x = params["embed"][tokens]
    h, aux = _backbone(cfg, params, x, remat)
    h = apply_norm(cfg, h, params["final_norm"])
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    logits = h @ head
    return logits, aux


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
    """Holds the stacked parameters; ``forward(batch)`` is
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
