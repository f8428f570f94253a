"""Cross parameters and optimizer state between the two packages by value.

The JAX side hands over ``jax.tree.map(np.asarray, params)``: a nested
dict of numpy arrays in the JAX layout, which the port shares.  bf16
leaves arrive as ml_dtypes ``bfloat16`` arrays; they are moved bit for
bit through a ``uint16`` view (keyed on ``arr.dtype.name``, so neither
jax nor ml_dtypes is imported here).  An aggregator state crosses with
:func:`agg_state_from_numpy` / :func:`agg_state_to_numpy`: the JAX
``server_grad`` tree is the port's one (P,) vector in the same leaf order.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.tree import (tree_items, tree_leaves, tree_map,
                              tree_unflatten)


def tensor_from_numpy(arr, device="cpu"):
    arr = np.asarray(arr)
    if arr.dtype.name == "bfloat16":
        t = torch.from_numpy(np.array(arr, copy=True).view(np.uint16))
        t = t.view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(arr, copy=True))
    return t.to(device)


def tensor_to_numpy(t, like=None):
    """A numpy copy of ``t``.  bf16 tensors come back as ``like.dtype``
    (an ml_dtypes bfloat16 array from the JAX side) when ``like`` is
    given, else as exact fp32."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        if like is not None and np.asarray(like).dtype.name == "bfloat16":
            return t.view(torch.int16).numpy().view(np.asarray(like).dtype)
        return t.float().numpy()
    return t.numpy().copy()


def params_from_numpy(tree, device="cpu"):
    """Nested dict of numpy arrays -> nested dict of tensors on
    ``device``."""
    return tree_map(lambda a: tensor_from_numpy(a, device), tree)


def params_to_numpy(tree, like=None):
    """Nested dict of tensors -> nested dict of numpy arrays (see
    :func:`tensor_to_numpy` for bf16 leaves)."""
    if like is None:
        return tree_map(tensor_to_numpy, tree)
    return tree_map(tensor_to_numpy, tree, like)


def arena_from_numpy(tree, device="cpu"):
    """A tree of (n, ...) numpy leaves (the JAX async loop's fp32 in-flight
    buffer, or its worker momentum) -> the port's (n, P) fp32 arena, the
    leaves' columns in FlatPlan order."""
    leaves = [np.asarray(l) for l in tree_leaves(tree)]
    n = leaves[0].shape[0]
    arena = np.concatenate([l.reshape(n, -1).astype(np.float32)
                            for l in leaves], axis=1)
    return torch.from_numpy(arena).to(device)


def opt_state_from_numpy(state, device="cpu"):
    """The JAX optimizer state (``{"step", "m", "v"}`` or ``{"step",
    "mu"}``) -> the port's (``step`` becomes a Python int)."""
    out = {"step": int(np.asarray(state["step"]))}
    for k in ("m", "v", "mu"):
        if k in state:
            out[k] = params_from_numpy(state[k], device)
    return out


def opt_state_to_numpy(state):
    out = {"step": np.asarray(state["step"], np.int32)}
    for k in ("m", "v", "mu"):
        if k in state:
            out[k] = params_to_numpy(state[k])
    return out


def agg_state_from_numpy(state, device="cpu"):
    """A JAX aggregator state (``spec.init_state`` / the async loop's
    ``agg_state``, numpy leaves) -> the port's: every ``server_grad``
    tree ravelled into one fp32 (P,) vector in its leaf order, nested
    ``"inner"`` states and the ``{"agg", "atk"}`` bundle kept, any other
    leaf (``atk``'s ``t``) a tensor."""
    out = {}
    for k, v in state.items():
        if k == "server_grad":
            leaves = [np.asarray(l, np.float32).reshape(-1)
                      for l in tree_leaves(v)]
            out[k] = torch.from_numpy(np.concatenate(leaves)).to(device)
        elif isinstance(v, dict):
            out[k] = agg_state_from_numpy(v, device)
        else:
            out[k] = tensor_from_numpy(v, device)
    return out


def agg_state_to_numpy(state, proto):
    """The port's aggregator state -> the JAX form: each ``server_grad``
    vector unravelled into an fp32 numpy tree shaped like ``proto`` (a
    single-agent parameter tree, numpy or tensors)."""
    shapes = [tuple(np.shape(l)) for l in tree_leaves(proto)]
    out = {}
    for k, v in state.items():
        if k == "server_grad":
            flat = tensor_to_numpy(v)
            parts, o = [], 0
            for shp in shapes:
                size = int(np.prod(shp, dtype=np.int64))
                parts.append(flat[o:o + size].reshape(shp))
                o += size
            out[k] = tree_unflatten([p for p, _ in tree_items(proto)],
                                    parts)
        elif isinstance(v, dict):
            out[k] = agg_state_to_numpy(v, proto)
        else:
            out[k] = tensor_to_numpy(v)
    return out
