"""Tree checkpoints on the host: one npz per step (counterpart of
``repro.checkpoint.io``, with its layout).

``<dir>/step_%08d.npz`` holds one array per leaf, keyed by the leaf's
tree path (dict keys joined by ``/``, in the JAX leaf order); dtypes
numpy lacks (bf16, fp8) are saved as fp32.  :func:`restore` rebuilds the
structure, dtypes and devices of a like-structured prototype, so no tree
definition is pickled.  The port keeps the JAX tree layout, so a
parameter file written by either package restores in the other."""
from __future__ import annotations

import os
import re

import numpy as np
import torch

from repro_torch.tree import tree_items, tree_unflatten

_NUMPY_FLOATS = (torch.float16, torch.float32, torch.float64)


def _path_key(path) -> str:
    return "/".join(str(p) for p in path)


def _to_numpy(leaf):
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach()
        if t.is_floating_point() and t.dtype not in _NUMPY_FLOATS:
            t = t.float()
        return t.cpu().numpy()
    return np.asarray(leaf)


def save(ckpt_dir: str, step: int, tree) -> str:
    """Write ``tree`` to ``<ckpt_dir>/step_<step>.npz`` (through a
    temporary file and an atomic rename); returns the path."""
    os.makedirs(ckpt_dir, exist_ok=True)
    arrays = {_path_key(path): _to_numpy(leaf)
              for path, leaf in tree_items(tree)}
    out = os.path.join(ckpt_dir, f"step_{step:08d}.npz")
    tmp = out + ".tmp"
    with open(tmp, "wb") as fh:
        np.savez(fh, **arrays)
    os.replace(tmp, out)
    return out


def latest_step(ckpt_dir: str):
    """The largest step saved in ``ckpt_dir``, or None."""
    if not os.path.isdir(ckpt_dir):
        return None
    steps = [int(m.group(1)) for f in os.listdir(ckpt_dir)
             if (m := re.match(r"step_(\d+)\.npz$", f))]
    return max(steps) if steps else None


def _like(arr, proto):
    """``arr`` as a leaf like ``proto``: a tensor of its dtype on its
    device, a numpy array of its dtype, or a Python scalar of its type."""
    if isinstance(proto, torch.Tensor):
        return torch.from_numpy(np.array(arr)).to(device=proto.device,
                                                  dtype=proto.dtype)
    if isinstance(proto, np.ndarray):
        return np.asarray(arr, proto.dtype)
    return type(proto)(arr.item())


def restore(ckpt_dir: str, like, step: int | None = None):
    """``(tree, step)``: the checkpoint of ``step`` (the latest when None)
    restored into the structure, dtypes and devices of ``like``; a
    ``KeyError`` on a missing leaf, a ``ValueError`` on a shape
    mismatch."""
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {ckpt_dir}")
    items = tree_items(like)
    leaves = []
    with np.load(os.path.join(ckpt_dir, f"step_{step:08d}.npz")) as data:
        for path, proto in items:
            key = _path_key(path)
            if key not in data.files:
                raise KeyError(f"checkpoint missing leaf {key}")
            arr = data[key]
            shape = tuple(getattr(proto, "shape", ()))
            if tuple(arr.shape) != shape:
                raise ValueError(
                    f"shape mismatch for {key}: {arr.shape} vs {shape}")
            leaves.append(_like(arr, proto))
    return tree_unflatten([p for p, _ in items], leaves), step
