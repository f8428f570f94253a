"""K1 and K23: coordinate-wise order statistics over the agent axis, and
the full per-coordinate sorted stack.

* K1 :func:`coord_stat` replaces the Pallas TPU kernel
  ``repro/kernels/coord_stats.py:coord_stat`` with the CUDA kernel
  ``csrc/coord_stat.cu`` on the order-statistic template
  ``csrc/order_stat.cuh`` (K18's and K19's): 16-byte loads of each row,
  Batcher's network on NaN-free coordinates and the odd-even network's
  law on the others (the source notes say what bounds it on the H100 and
  what the design does about that).
* K23 :func:`coord_sort` replaces ``repro/kernels/coord_stats.py:
  coord_sort`` with ``csrc/coord_sort.cu``: the odd-even network of
  ``csrc/coord_stat.cuh`` (K5's), every rank written (the legacy ``ops``
  statistics read it).

Each wrapper runs its plain PyTorch version (:func:`coord_stat_plain`,
:func:`coord_sort_plain`) for a CPU tensor; for a CUDA tensor it checks
the input and launches the kernel, or raises.  ``<wrapper>.launches``
counts kernel launches (nothing else adds to it).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build

STATS = {"median": 0, "trimmed_mean": 1}
MAX_N = 64


def _sort_network(rows):
    """Odd-even transposition sort of a list of (d,) rows.  torch.minimum /
    torch.maximum propagate NaN exactly as jnp.minimum / jnp.maximum do,
    so a NaN spreads through the network as it does in the TPU kernel."""
    rows = list(rows)
    n = len(rows)
    for p in range(n):
        for i in range(p % 2, n - 1, 2):
            lo = torch.minimum(rows[i], rows[i + 1])
            hi = torch.maximum(rows[i], rows[i + 1])
            rows[i], rows[i + 1] = lo, hi
    return rows


def stat_from_sorted(rows, stat: str, b: int = 0):
    """Median 0.5 * (s[(n-1)//2] + s[n//2]), or the mean of ranks
    [b, n - b) summed in ascending order (the kernel's order)."""
    n = len(rows)
    if stat == "median":
        return 0.5 * (rows[(n - 1) // 2] + rows[n // 2])
    if stat == "trimmed_mean":
        kept = rows[b:n - b]
        acc = kept[0].clone()
        for r in kept[1:]:
            acc = acc + r
        return acc / float(n - 2 * b)
    raise KeyError(stat)


def coord_stat_plain(g, stat: str, b: int = 0):
    """(n, d) any float -> (d,) fp32: the plain version of the kernel."""
    return stat_from_sorted(_sort_network(g.float().unbind(0)), stat, b)


def _check(g, stat, b):
    if stat not in STATS:
        raise KeyError(f"coord_stat: unknown stat {stat!r}")
    if g.dim() != 2:
        raise ValueError(f"coord_stat: need an (n, d) stack, got "
                         f"{tuple(g.shape)}")
    n = g.shape[0]
    if not 1 <= n <= MAX_N:
        raise ValueError(f"coord_stat: n={n} outside [1, {MAX_N}]")
    if stat == "trimmed_mean" and not (0 <= b and n - 2 * b >= 1):
        raise ValueError(f"coord_stat: trim b={b} leaves no rank of n={n}")


def coord_stat(g, stat: str, b: int = 0):
    """g: (n, d) -> (d,) fp32 order statistic (``median`` or
    ``trimmed_mean`` with per-side trim ``b``)."""
    _check(g, stat, b)
    if g.device.type == "cpu":
        return coord_stat_plain(g, stat, b)
    if g.device.type != "cuda":
        raise ValueError(f"coord_stat: unsupported device {g.device}")
    if g.stride(1) != 1:
        raise ValueError("coord_stat: rows must be contiguous")
    code = build.dtype_code(g)
    n, d = g.shape
    out = torch.empty((d,), dtype=torch.float32, device=g.device)
    rc = build.lib().rt_coord_stat(
        g.data_ptr(), code, out.data_ptr(), n, d, g.stride(0),
        STATS[stat], int(b), build.stream_ptr(g))
    build.check(rc, "coord_stat")
    coord_stat.launches += 1
    return out


coord_stat.launches = 0


def coord_sort_plain(g):
    """(n, d) any float -> (n, d) fp32: the plain version of K23, the
    network's ranks stacked (NaN where the network spreads it, not last
    as ``torch.sort`` puts it)."""
    return torch.stack(_sort_network(g.float().unbind(0)))


def coord_sort(g):
    """g: (n, d) fp32 or bf16 -> (n, d) fp32, each column sorted ascending
    by the odd-even network."""
    if g.dim() != 2:
        raise ValueError(f"coord_sort: need an (n, d) stack, got "
                         f"{tuple(g.shape)}")
    n, d = g.shape
    if not 1 <= n <= MAX_N:
        raise ValueError(f"coord_sort: n={n} outside [1, {MAX_N}]")
    if g.device.type == "cpu":
        return coord_sort_plain(g)
    if g.device.type != "cuda":
        raise ValueError(f"coord_sort: unsupported device {g.device}")
    if g.stride(1) != 1:
        raise ValueError("coord_sort: rows must be contiguous")
    code = build.dtype_code(g)
    out = torch.empty((n, d), dtype=torch.float32, device=g.device)
    rc = build.lib().rt_coord_sort(g.data_ptr(), code, out.data_ptr(), n, d,
                                   g.stride(0), build.stream_ptr(g))
    build.check(rc, "coord_sort")
    coord_sort.launches += 1
    return out


coord_sort.launches = 0
