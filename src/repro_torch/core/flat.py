"""FlatPlan: the ravel/unravel plan of the flat (n, P) gradient arena.

Counterpart of ``repro.core.flat.FlatPlan``.  Leaves are ordered as
``jax.tree.flatten`` orders them (dict keys sorted at every level), so
the offsets are the JAX plan's and the torch arena lines up with the JAX
arena coordinate for coordinate.

The training step does not build the arena with a concatenate: it
preallocates the (n, P) arena and copies each agent's gradient straight
into its row (:meth:`FlatPlan.write_row`) — that copy is the one ravel.
The aggregate is unraveled once, at optimizer-apply.

Wire quantization (the compressed exchange, ``ByzantineConfig.agg_dtype``
int8 or float8_e4m3fn): :func:`quantize_rows` turns the fp32 arena into
per-row symmetric codes and an fp32 scale per row, and the scaled kernels
dequantize inside the tile with :func:`dequantize_rows`' arithmetic.
The arithmetic is the JAX package's, operation for operation; where the
two packages' CPUs part (subnormal rows, ROADMAP.md P13) the port keeps
IEEE arithmetic, as the card does.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Optional

import torch

from repro_torch.tree import tree_items, tree_unflatten


def dtype_name(dt: torch.dtype) -> str:
    return str(dt).replace("torch.", "")


@dataclass(frozen=True)
class FlatPlan:
    """Ravel/unravel plan.  ``shapes``/``dtypes`` are the per-leaf
    TRAILING shapes (agent axis stripped); ``offsets[i]:offsets[i] +
    sizes[i]`` is leaf i's slice of the (n, P) arena; ``total`` is P."""
    paths: tuple
    shapes: tuple
    dtypes: tuple
    offsets: tuple
    sizes: tuple
    total: int
    uniform_dtype: Optional[str]

    @staticmethod
    def for_tree(tree) -> "FlatPlan":
        """The plan of ``tree``, whose leaves carry a leading agent axis."""
        items = tree_items(tree)
        return _plan(tuple(p for p, _ in items),
                     tuple(tuple(l.shape[1:]) for _, l in items),
                     tuple(dtype_name(l.dtype) for _, l in items))

    @staticmethod
    def for_proto(proto) -> "FlatPlan":
        """The plan of a SINGLE-AGENT prototype (no leading agent axis)."""
        items = tree_items(proto)
        return _plan(tuple(p for p, _ in items),
                     tuple(tuple(l.shape) for _, l in items),
                     tuple(dtype_name(l.dtype) for _, l in items))

    def as_dtype(self, dtype: str) -> "FlatPlan":
        """The same layout with every leaf in ``dtype`` (the fp32 in-flight
        buffer of a bf16 model unravels to fp32 leaves)."""
        return _plan(self.paths, self.shapes, (dtype,) * len(self.paths))

    @property
    def arena_dtype(self) -> torch.dtype:
        """The uniform leaf dtype when there is one, fp32 otherwise."""
        return (getattr(torch, self.uniform_dtype) if self.uniform_dtype
                else torch.float32)

    def empty_arena(self, n: int, device, dtype=None):
        return torch.empty((n, self.total), device=device,
                           dtype=dtype if dtype is not None
                           else self.arena_dtype)

    def write_row(self, arena, i: int, leaves):
        """Copy one agent's leaves (in plan order) into arena row ``i``."""
        row = arena[i]
        for o, s, leaf in zip(self.offsets, self.sizes, leaves):
            row[o:o + s].copy_(leaf.reshape(-1))

    def leaf_columns(self, arena):
        """Per-leaf (n, size) column views of the arena, in plan order."""
        return [arena[:, o:o + s] for o, s in zip(self.offsets, self.sizes)]

    def ravel(self, tree, dtype=None):
        """(tree with leading n) -> one (n, P) arena."""
        leaves = [l for _, l in tree_items(tree)]
        n = leaves[0].shape[0]
        dt = dtype if dtype is not None else self.arena_dtype
        return torch.cat([l.reshape(n, -1).to(dt) for l in leaves], dim=1)

    def unravel(self, vec):
        """(P,) -> single-agent tree (leaf dtypes restored)."""
        out = [vec[o:o + s].reshape(shp).to(getattr(torch, dt))
               for o, s, shp, dt in zip(self.offsets, self.sizes,
                                        self.shapes, self.dtypes)]
        return tree_unflatten(self.paths, out)

    def unravel_stack(self, arena):
        """(n, P) -> tree with leading n (leaf dtypes restored)."""
        n = arena.shape[0]
        out = [arena[:, o:o + s].reshape((n,) + shp).to(getattr(torch, dt))
               for o, s, shp, dt in zip(self.offsets, self.sizes,
                                        self.shapes, self.dtypes)]
        return tree_unflatten(self.paths, out)


@functools.lru_cache(maxsize=None)
def _plan(paths, shapes, dtypes) -> FlatPlan:
    sizes = tuple(int(torch.Size(s).numel()) for s in shapes)
    offsets, o = [], 0
    for s in sizes:
        offsets.append(o)
        o += s
    uniform = dtypes[0] if len(set(dtypes)) == 1 else None
    return FlatPlan(paths=paths, shapes=shapes, dtypes=dtypes,
                    offsets=tuple(offsets), sizes=sizes, total=o,
                    uniform_dtype=uniform)


# ---------------------------------------------------------------------------
# wire quantization: per-row symmetric codes + an fp32 scale per row
#
# qmax is the symmetric code range: 127 for int8, 448 for float8_e4m3fn
# (its largest finite value).  Each agent row gets its own scale, so one
# outlier agent does not crush the others' resolution.

QUANT_DTYPES = {"int8": 127.0, "float8_e4m3fn": 448.0}


def quantize_rows(x, dtype):
    """fp32 (n, P) -> (codes (n, P) ``dtype``, scale (n,) fp32), per-row
    symmetric: ``scale_i = amax_i / qmax`` (1.0 for a row whose amax is
    not > 0: an all-zero row, or a NaN row), ``codes = x / scale`` rounded
    half to even and clipped to [-qmax, qmax] (int8), or clipped and cast
    (fp8, rounding to nearest even).

    Both divisions divide by a tensor: PyTorch on the card turns a
    division by a Python scalar into a multiply by its reciprocal, which
    rounds differently.  A NaN code (a NaN value, or inf / inf in an inf
    row) is 0 in int8, pinned here before the cast (``nan_to_num_``): a
    float-to-int8 cast of NaN is no defined value.  fp8 keeps the NaN.
    ``amax`` is ``max(max x, -min x)`` per row, equal to ``max |x|`` (NaN
    included) without an (n, P) ``|x|`` temporary; the division runs in
    place when ``x.float()`` is already a copy (a bf16 arena), and round,
    clip and the pin in place on the quotient, so the call holds at most
    one fp32 (n, P) temporary."""
    name = dtype_name(dtype) if isinstance(dtype, torch.dtype) else dtype
    qmax = QUANT_DTYPES[name]
    xf = x.float()
    lo, hi = torch.aminmax(xf, dim=1)
    amax = torch.maximum(hi, -lo)
    q = torch.full((), qmax, dtype=torch.float32, device=xf.device)
    one = torch.ones((), dtype=torch.float32, device=xf.device)
    scale = torch.where(amax > 0.0, amax / q, one)
    codes = (xf.div_(scale[:, None]) if xf is not x
             else xf / scale[:, None])
    if name == "int8":
        codes.round_().clamp_(-qmax, qmax).nan_to_num_(nan=0.0)
    else:
        # |x / scale| passes qmax by more than an ulp only when the scale
        # is subnormal (ROADMAP.md P13); clipping first keeps the fp8 cast
        # off its overflow, where casts disagree (NaN or saturation)
        codes.clamp_(-qmax, qmax)
    return codes.to(getattr(torch, name)), scale


def dequantize_rows(codes, scale):
    """(codes (n, P), scale (n,) fp32) -> fp32 (n, P): one fp32 multiply,
    ``codes.float() * scale[:, None]``.  The scaled kernels compute
    exactly this per value, so it is their parity oracle."""
    return codes.float() * scale[:, None]


def fake_quantize(x, dtype):
    """The quantize-dequantize round trip: the fp32 stack that a path
    without a scale-aware entry sees, so the compressed exchange means
    the same on every path."""
    return dequantize_rows(*quantize_rows(x, dtype))


__all__ = ["FlatPlan", "dtype_name", "QUANT_DTYPES", "quantize_rows",
           "dequantize_rows", "fake_quantize"]
